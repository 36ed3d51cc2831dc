"""The port's fault layer (`repro_torch.faults`) against the reference on the
CPU: the spec's validation and activity, the crash timeline's window arrays
byte for byte over several windows with a growing clock, the backoff and
horizon, and the serving injector's failure sequence. All of it is numpy
on the host, so everything must be identical."""
import dataclasses

import numpy as np
import pytest

from repro import faults as JF
from repro_torch import faults as TF


def _pair(**kw):
    return JF.FaultSpec(**kw), TF.FaultSpec(**kw)


# ---------------------------------------------------------------- spec
BAD = [dict(mtbf=-1.0), dict(mttr=0.0), dict(max_down_events=0),
       dict(straggler_prob=1.5), dict(straggler_factor=0.5),
       dict(max_retries=-1), dict(exec_max_attempts=0),
       dict(backoff_base=-1.0), dict(exec_error_prob=2.0),
       dict(degrade_steps_frac=1.5)]


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) for k in BAD])
def test_spec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as j:
        JF.FaultSpec(**kw)
    with pytest.raises(ValueError) as t:
        TF.FaultSpec(**kw)
    assert str(j.value) == str(t.value)


def test_spec_activity_and_presets():
    for name in ("none", "chaos"):
        j = getattr(JF.FaultSpec, name)() if name == "none" \
            else JF.FaultSpec.chaos(7)
        t = getattr(TF.FaultSpec, name)() if name == "none" \
            else TF.FaultSpec.chaos(7)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.active == t.active
        assert JF.faults_active(j) == TF.faults_active(t)
    assert not TF.faults_active(None) and not TF.FaultSpec.none().active
    assert TF.FaultSpec(straggler_prob=0.1).active
    assert hash(TF.FaultSpec.chaos(1)) == hash(TF.FaultSpec.chaos(1))
    assert set(JF.__all__) == set(TF.__all__)
    assert JF.FAULT_COLS == TF.FAULT_COLS and JF.RETRY_COL == TF.RETRY_COL


# ------------------------------------------------------------- timeline
SPECS = {
    "chaos": dict(seed=3, mtbf=120.0, mttr=30.0, straggler_prob=0.25,
                  straggler_factor=3.0, max_retries=2),
    "dense crashes, few slots": dict(seed=11, mtbf=20.0, mttr=15.0,
                                     max_down_events=3),
    "stragglers only": dict(seed=5, straggler_prob=0.6, straggler_factor=2.0,
                            cold_restart=False),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_window_arrays_byte_identical(name):
    """Six windows over 3 streams x 5 servers, each stream's clock moving
    by its own random step: every array equal byte for byte, and the
    counters."""
    js, ts = _pair(**SPECS[name])
    B, E = 3, 5
    jt, tt = JF.FaultTimeline(js, E, B), TF.FaultTimeline(ts, E, B)
    rng = np.random.default_rng(0)
    t0 = np.zeros(B, np.float64)
    horizon = JF.fault_horizon(600.0, js)
    assert horizon == TF.fault_horizon(600.0, ts)
    for w in range(6):
        ja = jt.window_arrays(w, t0, horizon)
        ta = tt.window_arrays(w, t0, horizon)
        assert list(ja) == list(ta) == list(JF.FAULT_COLS)
        for k in ja:
            assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape
            assert ja[k].tobytes() == ta[k].tobytes(), (w, k)
        assert jt.counters() == tt.counters(), w
        t0 = t0 + rng.uniform(0.0, 400.0, B)
    if name == "dense crashes, few slots":
        assert tt.counters()["down_events_truncated"] > 0
    with pytest.raises(ValueError, match="t0 must be shape"):
        tt.window_arrays(6, np.zeros(B + 1), horizon)


@pytest.mark.parametrize("retries", [0, 1, 2, 3, 5, 9])
def test_backoff_and_horizon(retries):
    js, ts = _pair(**SPECS["chaos"])
    assert JF.retry_backoff(js, retries) == TF.retry_backoff(ts, retries)
    for spec in (None, ts):
        assert TF.fault_horizon(1024.0, spec) == JF.fault_horizon(
            1024.0, None if spec is None else js)


# ------------------------------------------------------------- injector
@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_exec_fault_injector_same_failures(p):
    """The same spec and calls fail at the same attempts with the same
    messages, before and after a reset; a None spec never fails."""
    js, ts = _pair(seed=9, exec_error_prob=p)

    def attempts(inj, n=40):
        out = []
        for i in range(n):
            try:
                inj.maybe_fail("prefill" if i % 2 else "decode")
                out.append(None)
            except Exception as e:       # noqa: BLE001 - compared by type
                out.append((type(e).__name__, str(e)))
        return out
    j, t = JF.ExecFaultInjector(js), TF.ExecFaultInjector(ts)
    assert j.enabled == t.enabled
    first = attempts(t)
    assert first == attempts(j)
    assert t.counters() == j.counters()
    t.reset()
    j.reset()
    assert t.counters() == {"exec_errors_injected": 0}
    assert attempts(t) == attempts(j) == first
    assert isinstance(TF.InjectedExecutorError("x"), TF.ExecutorFault)
    assert issubclass(TF.ExecutorTimeout, TF.ExecutorFault)
    none = TF.ExecFaultInjector(None)
    assert not none.enabled and attempts(none, 5) == [None] * 5
