"""The port's slow timescale (`repro_torch.placement`) against the reference
on the CPU: the spec, `DemandStats`, each policy's weights, the planner
(`plan_gangs`, `plan_stream`) and the manager's carry rewrite must be
identical on the same demand history and layouts (all numpy on the host;
the manager reads the carry's tensors once and writes new ones on their
device), and `PlacementSpec.none()` must leave a port stream identical to
one with no spec."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import placement as JP
from repro.core import env as JEV
from repro_torch import placement as TP
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core.workload import TraceConfig
from repro_torch.traffic import stream as TS
from repro_torch.traffic.arrivals import PoissonArrivals

M, E, K = 3, 8, 16
SUP = (1, 2, 4, 8)


def _demand(rng, B, windows, shift=0):
    """`windows` (B, K) model / c column pairs; models drift with the
    window so the forecast's trend has something to see."""
    out = []
    for w in range(windows):
        p = np.roll(np.array([0.6, 0.3, 0.1]), (w + shift) // 2)
        model = rng.choice(M, (B, K), p=p).astype(np.int32)
        model[:, 0] = -1                            # out of range: ignored
        c = rng.choice([1, 2, 3, 4, 8], (B, K)).astype(np.int32)
        out.append((model, c))
    return out


def _stats(mod, B, cols, history=64):
    st = mod.DemandStats(B, M, SUP, history=history)
    for model, c in cols:
        st.observe(model, c)
    return st


# ---------------------------------------------------------------- spec
BAD = [dict(policy="nope"), dict(policy="lfu", interval=0),
       dict(policy="lfu", ewma_alpha=0.0), dict(policy="lfu", trend_gain=-1),
       dict(policy="lfu", period=-1), dict(policy="lfu", max_gangs_per_cell=-1),
       dict(policy="static", model_probs=(-1.0, 2.0)),
       dict(policy="static", c_probs=(0.0, 0.0))]


@pytest.mark.parametrize("kw", BAD, ids=[str(i) for i in range(len(BAD))])
def test_spec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as j:
        JP.PlacementSpec(**kw)
    with pytest.raises(ValueError) as t:
        TP.PlacementSpec(**kw)
    assert str(j.value) == str(t.value)


def test_spec_registry_and_activity():
    assert JP.known_policies() == TP.known_policies()
    assert set(JP.__all__) == set(TP.__all__)
    assert not TP.PlacementSpec.none().active
    assert not TP.placement_active(None)
    assert TP.placement_active(TP.PlacementSpec(policy="lfu"))
    with pytest.raises(ValueError, match="active spec"):
        TP.PlacementManager(TP.PlacementSpec.none(), TEV.EnvConfig())
    with pytest.raises(KeyError, match="unknown placement policy"):
        TP.get_placement_policy("nope")


# ---------------------------------------------------------------- stats
def test_demand_stats_identical():
    rng = np.random.default_rng(1)
    cols = _demand(rng, 2, 7)
    j, t = _stats(JP, 2, cols, history=5), _stats(TP, 2, cols, history=5)
    assert j.windows == t.windows == 7
    np.testing.assert_array_equal(j.total, t.total)
    for b in range(2):
        np.testing.assert_array_equal(j.last(b), t.last(b))
        for a, c in zip(j.history(b), t.history(b)):
            np.testing.assert_array_equal(a, c)
        for alpha in (0.3, 1.0):
            np.testing.assert_array_equal(j.ewma(b, alpha), t.ewma(b, alpha))
        for period, phase in ((1, 0), (2, 1), (3, 2), (9, 4)):
            np.testing.assert_array_equal(j.seasonal(b, period, phase),
                                          t.seasonal(b, period, phase))
    with pytest.raises(ValueError, match="c_support"):
        TP.DemandStats(1, M, (2, 1))
    with pytest.raises(ValueError, match="expected"):
        t.observe(np.zeros((3, K), np.int32), np.zeros((3, K), np.int32))


SPEC_KW = {
    "static": dict(policy="static", model_probs=(0.5, 0.3, 0.2)),
    "lfu": dict(policy="lfu"),
    "forecast": dict(policy="forecast", ewma_alpha=0.4, trend_gain=2.0),
    "forecast, seasonal": dict(policy="forecast", period=3,
                               c_probs=(0.5, 0.5)),
    "none": dict(policy="none"),
}


@pytest.mark.parametrize("name", list(SPEC_KW))
@pytest.mark.parametrize("windows", [0, 1, 6])
def test_policy_weights_identical(name, windows):
    rng = np.random.default_rng(2)
    cols = _demand(rng, 2, windows)
    js, ts = JP.PlacementSpec(**SPEC_KW[name]), TP.PlacementSpec(
        **SPEC_KW[name])
    j, t = _stats(JP, 2, cols), _stats(TP, 2, cols)
    jf, tf = JP.get_placement_policy(js.policy), TP.get_placement_policy(
        ts.policy)
    for b in range(2):
        np.testing.assert_array_equal(jf(js, j, b), tf(ts, t, b))
    np.testing.assert_array_equal(JP.prior_weights(js, M, SUP),
                                  TP.prior_weights(ts, M, SUP))


# ---------------------------------------------------------------- plan
def _layout(rng):
    """A random (idle, model, gang, size) layout: intact and broken gangs,
    warm and cold servers, busy ones among them."""
    model = -np.ones(E, np.int32)
    gang = -np.ones(E, np.int32)
    size = np.zeros(E, np.int32)
    servers, i = rng.permutation(E), 0
    while i < E and rng.random() < 0.8:
        c = min(int(rng.choice([1, 2, 4])), E - i)
        mem = servers[i:i + c]
        gang[mem] = K + int(mem.min())
        size[mem] = c if rng.random() < 0.85 else c + 1
        model[mem] = int(rng.integers(0, M))
        i += c
    idle = rng.random(E) < 0.7
    return idle, model, gang, size


@pytest.mark.parametrize("seed", range(8))
def test_plan_identical(seed):
    rng = np.random.default_rng(10 + seed)
    w = rng.random((M, len(SUP))) * (rng.random((M, len(SUP))) < 0.7)
    cap = int(rng.integers(0, E + 1))
    cells = int(rng.integers(0, 3))
    assert JP.plan_gangs(w, cap, SUP, cells) == TP.plan_gangs(w, cap, SUP,
                                                              cells)
    idle, model, gang, size = _layout(rng)
    j = JP.plan_stream(w, idle, model, gang, size, SUP, K, cells)
    t = TP.plan_stream(w, idle, model, gang, size, SUP, K, cells)
    for f in JP.StreamPlacement._fields:
        a, b = getattr(j, f), getattr(t, f)
        if f == "counters":
            assert a == b
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
    # busy servers are never touched
    np.testing.assert_array_equal(t.model[~idle], model[~idle])


# ---------------------------------------------------------------- manager
def _carry_pair(rng, B):
    st = TEV.reset(TEV.EnvConfig(num_servers=E, max_tasks=K,
                                 num_models=M), B, device="cpu")
    layouts = [_layout(rng) for _ in range(B)]
    free = np.stack([np.where(idle, 0.0, rng.uniform(1, 50, E))
                     for idle, *_ in layouts]).astype(np.float32)
    fields = dict(server_free_at=free,
                  server_model=np.stack([x[1] for x in layouts]),
                  server_gang=np.stack([x[2] for x in layouts]),
                  server_gang_size=np.stack([x[3] for x in layouts]))
    tcarry = st._replace(**{k: torch.from_numpy(v.copy())
                            for k, v in fields.items()})
    jcarry = JEV.EnvState(*(jnp.asarray(x.numpy()) for x in tcarry))
    return jcarry, tcarry


@pytest.mark.parametrize("name", ["static", "lfu", "forecast",
                                  "forecast, seasonal"])
def test_manager_rewrites_the_carry_identically(name):
    B = 3
    rng = np.random.default_rng(4)
    jecfg = JEV.EnvConfig(num_servers=E, max_tasks=K, num_models=M)
    tecfg = TEV.EnvConfig(num_servers=E, max_tasks=K, num_models=M)
    kw = dict(SPEC_KW[name], interval=2)
    jm = JP.PlacementManager(JP.PlacementSpec(**kw), jecfg, B)
    tm = TP.PlacementManager(TP.PlacementSpec(**kw), tecfg, B)
    jc, tc = _carry_pair(rng, B)
    for w, (model, c) in enumerate(_demand(rng, B, 6)):
        jm.observe_window(w, {"model": model, "c": c})
        tm.observe_window(w, {"model": model, "c": c})
        jc, jd = jm.apply(jc, w)
        tc, td = tm.apply(tc, w)
        assert (jd is None) == (td is None) == (w % 2 == 0)
        if td is not None:
            assert jd.counters == td.counters and jd.window == td.window
            for a, b in zip(jd.streams, td.streams):
                np.testing.assert_array_equal(a.prefetch, b.prefetch)
                np.testing.assert_array_equal(a.evict, b.evict)
        for f in TEV.EnvState._fields:
            x = getattr(tc, f)
            assert x.device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                          x.numpy(), err_msg=f"{w} {f}")
        # a new layout frees nothing: busy servers keep their state
        _, tc2 = _carry_pair(np.random.default_rng(100 + w), B)
        tc = tc._replace(server_free_at=tc2.server_free_at)
        jc = jc._replace(server_free_at=jnp.asarray(tc2.server_free_at.numpy()))
    assert jm.counters() == tm.counters()
    assert tm.counters()["placement_decisions"] == 3


def _stream(placement, faults=None):
    ecfg = TEV.EnvConfig(num_servers=4, queue_window=4, max_tasks=12,
                         time_limit=600.0, max_steps=96, num_models=2)
    src = TS.ProcessTaskSource(
        PoissonArrivals(rate=0.3), TraceConfig(num_tasks=12, max_servers=4,
                                               num_models=2),
        torch.Generator().manual_seed(3), num_streams=2, device="cpu")
    return TS.run_stream(ecfg, TRO.greedy_policy(ecfg), None, src,
                         torch.Generator().manual_seed(4),
                         TS.StreamConfig(num_windows=3, num_streams=2,
                                         placement=placement, faults=faults),
                         device="cpu")


def test_placement_none_identical_to_no_spec():
    base = _stream(None)
    none = _stream(TP.PlacementSpec.none())
    assert base.summary == none.summary
    assert base.per_window == none.per_window
    for a, b in zip(base.final_carry, none.final_carry):
        assert torch.equal(a, b)
    assert none.placement_counters == {}
    placed = _stream(TP.PlacementSpec(policy="lfu"))
    pc = placed.placement_counters
    assert pc["placement_decisions"] == 3 and set(pc["per_model"]) == {0, 1}
    # the arrivals are the same; only where they ran moves
    assert [r["injected"] for r in placed.per_window] == \
        [r["injected"] for r in base.per_window]
