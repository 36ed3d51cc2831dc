"""The port's arrival processes, workload helpers and scenario grids
(`repro_torch.traffic.arrivals`, `repro_torch.core.workload`,
`repro_torch.core.scenarios`) against the reference on the CPU.

The processes take the reference's draws, rebuilt here from its key
splits, and must give its gaps: exactly for Poisson, MMPP, flash crowds and
replay (divisions and sums in the same order), within 1e-6 relative for the
diurnal process (its `sin` is another library's). The grids must list the
reference's cells, and `run_scenario` on the reference's traces must give
its metrics (fifo, closed loop; 1e-6 on float metrics, 1e-5 relative on
returns).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rollout as JRO
from repro.core import scenarios as JSC
from repro.core import workload as JWL
from repro.traffic import arrivals as JAR
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core import scenarios as TSC
from repro_torch.core import workload as TWL
from repro_torch.traffic import arrivals as TAR

N = 48


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------ arrival processes
def _reference_draws(kind, proc, key, n):
    """(init draws, sample draws) the reference's `init(key)` then
    `sample(state, n)` take, rebuilt from its splits; batch of one."""
    if kind == "poisson":
        _, k = jax.random.split(key)
        return {}, {"exp": jax.random.exponential(k, (n,))[None]}
    if kind == "mmpp":
        key, k = jax.random.split(key)
        init = {"phase": jax.random.randint(k, (), 0, len(proc.rates))[None]}
        _, k_scan = jax.random.split(key)
        d = {"exp": [], "switch": [], "jump": []}
        for kk in jax.random.split(k_scan, n):
            ke, ks, kp = jax.random.split(kk, 3)
            d["exp"].append(jax.random.exponential(ke))
            d["switch"].append(jax.random.bernoulli(ks, proc.switch))
            d["jump"].append(jax.random.randint(kp, (), 1,
                                                max(len(proc.rates), 2)))
        return init, {k: np.stack([_np(x) for x in v])[None]
                      for k, v in d.items()}
    # the rate-modulated processes: one exponential per arrival
    _, k_scan = jax.random.split(key)
    return {}, {"exp": np.stack([_np(jax.random.exponential(k))
                                 for k in jax.random.split(k_scan, n)])[None]}


PROCS = {
    "poisson": (JAR.PoissonArrivals(0.13), TAR.PoissonArrivals(0.13), 0.0),
    "mmpp": (JAR.MMPPArrivals(rates=(0.02, 0.3, 0.11), switch=0.3),
             TAR.MMPPArrivals(rates=(0.02, 0.3, 0.11), switch=0.3), 0.0),
    "diurnal": (JAR.DiurnalArrivals(0.1, 0.6, 400.0),
                TAR.DiurnalArrivals(0.1, 0.6, 400.0), 1e-6),
    "flash": (JAR.FlashCrowdArrivals(0.05, 0.5, 300.0, 60.0),
              TAR.FlashCrowdArrivals(0.05, 0.5, 300.0, 60.0), 0.0),
}


@pytest.mark.parametrize("kind", sorted(PROCS))
@pytest.mark.parametrize("seed", [0, 1])
def test_gaps_match_reference_on_its_draws(kind, seed):
    jproc, tproc, rtol = PROCS[kind]
    key = jax.random.PRNGKey(seed)
    _, want = jproc.sample(jproc.init(key), N)
    init_d, draws = _reference_draws(kind, jproc, key, N)
    st = tproc.init(1, device="cpu",
                    draws={k: _t(v) for k, v in init_d.items()} or None)
    st2, got = tproc.sample(st, N, draws={k: _t(v) for k, v in draws.items()})
    assert got.shape == (1, N) and got.dtype == torch.float32
    if rtol:
        np.testing.assert_allclose(got[0].numpy(), _np(want), rtol=rtol)
    else:
        np.testing.assert_array_equal(got[0].numpy(), _np(want))
    # the state carries on: a second chunk on the reference's next draws
    jstate = jproc.sample(jproc.init(key), N)[0]
    _, want2 = jproc.sample(jstate, N)
    jkey = jstate if kind == "poisson" else jstate[0]
    if kind == "mmpp":
        _, k_scan = jax.random.split(jkey)
        d = {"exp": [], "switch": [], "jump": []}
        for kk in jax.random.split(k_scan, N):
            ke, ks, kp = jax.random.split(kk, 3)
            d["exp"].append(_np(jax.random.exponential(ke)))
            d["switch"].append(_np(jax.random.bernoulli(ks, jproc.switch)))
            d["jump"].append(_np(jax.random.randint(kp, (), 1, 3)))
        draws2 = {k: np.stack(v)[None] for k, v in d.items()}
    elif kind == "poisson":
        draws2 = {"exp": _np(jax.random.exponential(
            jax.random.split(jkey)[1], (N,)))[None]}
    else:
        _, k_scan = jax.random.split(jkey)
        draws2 = {"exp": np.stack([_np(jax.random.exponential(k))
                                   for k in jax.random.split(k_scan, N)])[None]}
    _, got2 = tproc.sample(st2, N, draws={k: _t(v) for k, v in draws2.items()})
    np.testing.assert_allclose(got2[0].numpy(), _np(want2), rtol=rtol)


@pytest.mark.parametrize("stagger", [False, True])
def test_replay_matches_reference(stagger):
    arr = np.cumsum(np.random.default_rng(0).exponential(10.0, 12)).astype(
        np.float32)
    jproc = JAR.ReplayArrivals(times=arr, stagger=stagger)
    tproc = TAR.ReplayArrivals(times=arr, stagger=stagger)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    js = [jproc.init(k) for k in keys]
    draws = {"idx": _t(np.stack([_np(s[0]) for s in js]))} if stagger else None
    ts = tproc.init(4, device="cpu", draws=draws)
    for _ in range(3):                          # three chunks, wrapping
        outs = [jproc.sample(s, 7) for s in js]
        js = [o[0] for o in outs]
        ts, got = tproc.sample(ts, 7)
        np.testing.assert_array_equal(got.numpy(),
                                      np.stack([_np(o[1]) for o in outs]))
    assert tproc.mean_rate() == pytest.approx(jproc.mean_rate())


def test_processes_drawing_for_themselves():
    """From a generator: the long-run rates of the reference's checks, B
    streams at once, chunk by chunk."""
    gen = torch.Generator().manual_seed(0)
    for proc, n, rel in ((TAR.PoissonArrivals(0.1), 4000, 0.08),
                         (TAR.MMPPArrivals((0.02, 0.3), 0.05), 8000, 0.15),
                         (TAR.DiurnalArrivals(0.1, 0.6, 2000.0), 8000, 0.15),
                         (TAR.FlashCrowdArrivals(), 8000, 0.15)):
        st = proc.init(2, generator=gen, device="cpu")
        total = torch.zeros(2, dtype=torch.float64)
        for _ in range(4):
            st, gaps = proc.sample(st, n // 4, generator=gen)
            assert gaps.shape == (2, n // 4) and bool((gaps > 0).all())
            total += gaps.double().sum(1)
        rate = (n / total).numpy()
        np.testing.assert_allclose(rate, proc.mean_rate(), rtol=rel)


def test_registry_and_rate_scaling_match_reference():
    for kind in ("poisson", "mmpp", "diurnal", "flash"):
        j, t = JAR.make_process(kind), TAR.make_process(kind)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for f in (0.5, 1.0, 3.0):
            assert dataclasses.asdict(JAR.scale_rate(j, f)) == \
                dataclasses.asdict(TAR.scale_rate(t, f))
            assert TAR.scale_rate(t, f).mean_rate() == pytest.approx(
                JAR.scale_rate(j, f).mean_rate())
    with pytest.raises(ValueError):
        TAR.make_process("fractal")
    with pytest.raises(ValueError):
        TAR.scale_rate(TAR.ReplayArrivals(times=(1.0, 2.0)), 2.0)


# ------------------------------------------------------- workload helpers
def test_trace_from_arrivals_matches_reference():
    tc_kw = dict(num_tasks=16, max_servers=4, num_models=3,
                 model_probs=(0.7, 0.3))
    jtc, ttc = JWL.TraceConfig(**tc_kw), TWL.TraceConfig(**tc_kw)
    arr = np.cumsum(np.random.default_rng(1).exponential(8.0, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    want = JWL.make_trace_from_arrivals(key, jnp.asarray(arr), jtc)
    attrs = tuple(_t(x) for x in JWL.sample_task_attrs(key, jtc, 16))
    got = TWL.make_trace_from_arrivals(_t(arr), ttc, attrs=attrs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), k)
        assert got[k].dtype == {"arr_time": torch.float32, "noise": torch.float32,
                                "c": torch.int32, "model": torch.int32}[k]


def test_sample_task_attrs_marginals():
    tc = TWL.TraceConfig(num_tasks=8, max_servers=4, num_models=3,
                         model_probs=(0.0, 1.0))
    c, model, noise = TWL.sample_task_attrs(
        tc, (64, 8), generator=torch.Generator().manual_seed(0), device="cpu")
    assert c.shape == model.shape == noise.shape == (64, 8)
    assert set(c.unique().tolist()) <= {1, 2, 4}     # clipped to 4 servers
    assert set(model.unique().tolist()) == {1}
    assert float(noise.abs().max()) < 10 * tc.quality_noise


def test_make_trace_batch_is_its_draws():
    """make_trace_batch draws the gaps, then (c, model, noise) in that
    order from one generator: rebuilding the draws from the same seed and
    passing them to trace_from_draws gives the same traces."""
    tc = TWL.TraceConfig(num_tasks=8, max_servers=4, arrival_rate=0.1)
    got = TWL.make_trace_batch(tc, 3, generator=torch.Generator().manual_seed(9),
                               device="cpu")
    g = torch.Generator().manual_seed(9)
    gaps = torch.empty((3, 8)).exponential_(generator=g)
    probs = torch.tensor(tc.c_probs)
    probs = torch.where(torch.tensor(tc.c_support) <= 4, probs, 0.0)
    ci = torch.multinomial(probs.expand(3, -1), 8, replacement=True,
                           generator=g)
    model = torch.randint(0, 1, (3, 8), generator=g)
    noise = torch.randn((3, 8), generator=g)
    want = TWL.trace_from_draws(tc, gaps, torch.tensor(tc.c_support)[ci],
                                model, noise)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stack_traces_matches_reference():
    trs = [{"arr_time": np.arange(4, dtype=np.float32) + i,
            "c": np.full(4, i, np.int32)} for i in range(3)]
    want = JWL.stack_traces([{k: jnp.asarray(v) for k, v in t.items()}
                             for t in trs])
    got = TWL.stack_traces([{k: _t(v) for k, v in t.items()} for t in trs])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))


def test_generate_trace_schema():
    tc = TWL.TraceConfig(num_tasks=16, arrival_rate=0.1, max_servers=4)
    tr = TAR.generate_trace(TAR.MMPPArrivals(), tc, 5,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert set(tr) == {"arr_time", "c", "model", "noise"}
    assert tr["arr_time"].shape == (5, 16)
    assert bool((torch.diff(tr["arr_time"], dim=1) >= 0).all())
    assert bool((tr["arr_time"][:, 0] > 0).all())
    assert bool((tr["c"] <= 4).all())


# ------------------------------------------------------------------ grids
def _cell(sc):
    arr = None if sc.arrival is None else (
        type(sc.arrival).__name__, dataclasses.asdict(sc.arrival))
    return (sc.name, dataclasses.asdict(sc.ecfg), dataclasses.asdict(sc.tcfg),
            arr)


def _cells(scs):
    return [_cell(s) for s in scs]


def test_grids_match_reference():
    assert _cells(TSC.default_grid()) == _cells(JSC.default_grid())
    assert TSC.PAPER_RATE_GRID == JSC.PAPER_RATE_GRID
    for E in (4, 8, 12):
        assert _cells(TSC.arrival_sweep(E)) == _cells(JSC.arrival_sweep(E))
    for fn in ("poisson_scenario", "model_skew", "model_skew_flashcrowd",
               "multi_model_mix", "cold_start_heavy", "bursty_traffic",
               "diurnal_traffic", "flash_crowd"):
        assert _cell(getattr(TSC, fn)(12)) == _cell(getattr(JSC, fn)(12)), fn
    assert _cells(TSC.model_shift_cells()) == _cells(JSC.model_shift_cells())
    assert TSC.zipf_probs(4, 1.2) == JSC.zipf_probs(4, 1.2)


@pytest.mark.parametrize("num_models", [1, 3])
@pytest.mark.parametrize("procs", [True, False])
def test_training_curriculum_matches_reference(num_models, procs):
    kw = dict(num_servers=8, max_tasks=16, num_models=num_models,
              model_scale=(1.0, 0.6, 1.4)[:num_models] if num_models > 1
              else ())
    from repro.core import env as JEV
    jcells = JSC.training_curriculum(JEV.EnvConfig(**kw),
                                     include_arrival_processes=procs)
    tcells = TSC.training_curriculum(TEV.EnvConfig(**kw),
                                     include_arrival_processes=procs)
    assert _cells(tcells) == _cells(jcells)


def test_curriculum_picker():
    ecfg = TEV.EnvConfig(num_servers=4, max_tasks=8, queue_window=4)
    cells = TSC.training_curriculum(ecfg)
    pick = TSC.curriculum_picker(ecfg, cells)
    rng = np.random.default_rng(0)
    names = set()
    for _ in range(20):
        name, fn = pick(rng)
        names.add(name)
        tr = fn(torch.Generator().manual_seed(1), 3)
        assert tr["arr_time"].shape == (3, 8)
    assert len(names) > 2
    with pytest.raises(ValueError, match="different EnvConfig"):
        TSC.curriculum_picker(TEV.EnvConfig(num_servers=8), cells)


@pytest.mark.parametrize("name", ["paper-4srv", "paper-12srv", "bursty-8srv",
                                  "diurnal-8srv"])
def test_run_scenario_fifo_matches_reference(name):
    """fifo on the reference's traces of the cell: its metrics."""
    jsc = {s.name: s for s in JSC.default_grid()}[name]
    tsc = {s.name: s for s in TSC.default_grid()}[name]
    key = jax.random.PRNGKey(5)
    want = JSC.run_scenario(jsc, JRO.fifo_policy(jsc.ecfg), key, batch=4,
                            num_steps=160)
    k_trace, _ = jax.random.split(key)
    traces = (JWL.make_trace_batch(k_trace, jsc.tcfg, 4) if jsc.arrival is None
              else JSC.make_scenario_trace_batch(k_trace, jsc, 4))
    got = TSC.run_scenario(tsc, TRO.fifo_policy(tsc.ecfg), num_steps=160,
                           traces={k: _t(v) for k, v in traces.items()},
                           device="cpu")
    assert got["scenario"] == want["scenario"] and got["batch"] == 4
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("scenario", "batch"):
            continue
        if k.endswith(("num_scheduled", "num_done", "episode_len")) \
                and not k.startswith("mean_"):
            np.testing.assert_array_equal(got[k], v, k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_run_grid_draws_its_traces():
    g = TSC.run_grid(TSC.paper_scenarios()[:2], TRO.uniform_policy,
                     torch.Generator().manual_seed(0), batch=3, device="cpu")
    assert [m["scenario"] for m in g] == ["paper-4srv", "paper-8srv"]
    for m in g:
        assert m["episode_return"].shape == (3,)
        assert np.isfinite(m["mean_episode_return"])
