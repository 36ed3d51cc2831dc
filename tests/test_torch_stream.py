"""The port's streaming engine (`repro_torch.traffic.stream`) against the
reference on the CPU.

Both sides get the same tasks: the reference's task sources are wrapped to
record each refill (its gaps and attributes), and the port's sources replay
those draws (`draws=`), or both read the same explicit traces
(`TraceTaskSource`). With the deterministic policies (fifo, greedy) the
streams must then agree, window for window, with and without
`FaultSpec.chaos`-style faults and under each placement policy:

* exactly on every integer and boolean, the clocks (`elapsed`, `max_resp`,
  the carried state, the stream epochs), the latency histogram, the
  leftovers, the retry buffers and the fault and placement counters;
* within 1e-5 relative on the float sums over K (`sum_resp`,
  `sum_quality`, `sum_steps`, `busy_time`, and the record and summary
  values made from them, and the episode return): the reference sums them
  in XLA's order, the port in torch's.

Port-only checks: one window from a fresh carry equals `batch_rollout` on
the same generator state in every tensor, the seam ledger is conserved
window by window on a seeded sweep (`tests/test_stream_ledger_prop.py`'s
parameter space), and the seam keeps the reference's order among tied
arrival times.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as JEV
from repro.core import rollout as JRO
from repro.core.workload import TraceConfig as JTC
from repro.faults import FaultSpec as JFS
from repro.placement import PlacementSpec as JPS
from repro.traffic import stream as JS
from repro.traffic.arrivals import PoissonArrivals as JPoisson
from repro_torch.actors.policies import actor_policy
from repro_torch.core import agent as TAG
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core.workload import TraceConfig as TTC
from repro_torch.faults import FaultSpec as TFS
from repro_torch.placement import PlacementSpec as TPS
from repro_torch.traffic import stream as TS
from repro_torch.traffic.arrivals import PoissonArrivals as TPoisson

RTOL = 1e-5
K, E, B, W = 16, 8, 2, 4
ENV = dict(num_servers=E, queue_window=4, max_tasks=K, time_limit=600.0,
           max_steps=256)
JECFG, TECFG = JEV.EnvConfig(**ENV), TEV.EnvConfig(**ENV)
FAULTS = dict(seed=3, mtbf=120.0, mttr=30.0, straggler_prob=0.25,
              straggler_factor=3.0, max_retries=2, backoff_base=1.0,
              backoff_cap=16.0, retry_deadline=600.0)


def _recording(src):
    """Wrap a reference task source's samplers so every refill's gaps and
    attributes are recorded, in the port's `draws=` layout."""
    rec = []
    for i, (samp, attr) in enumerate(zip(src._samplers, src._attr_fns)):
        def s_(state, samp=samp):
            state, gaps = samp(state)
            rec.append({"gaps": np.asarray(gaps)})
            return state, gaps

        def a_(key, attr=attr):
            c, model, noise = attr(key)
            rec[-1].update(c=np.asarray(c), model=np.asarray(model),
                           noise=np.asarray(noise))
            return c, model, noise
        src._samplers[i], src._attr_fns[i] = s_, a_
    return rec


def _policies(name):
    if name == "fifo":
        return JRO.fifo_policy(JECFG), TRO.fifo_policy(TECFG)
    return JRO.greedy_policy(JECFG), TRO.greedy_policy(TECFG)


def _runners(policy, scfg_kw, *, rate=0.2, num_models=1, windows=W,
             streams=B, trace_source=None):
    """(reference runner, port runner) after `windows` windows each, the
    port fed the reference's refills."""
    jecfg = JEV.EnvConfig(**ENV, num_models=num_models)
    tecfg = TEV.EnvConfig(**ENV, num_models=num_models)
    jpol = (JRO.fifo_policy if policy == "fifo" else JRO.greedy_policy)(jecfg)
    tpol = (TRO.fifo_policy if policy == "fifo" else TRO.greedy_policy)(tecfg)
    key = jax.random.PRNGKey(0)
    if trace_source is None:
        jsrc = JS.ProcessTaskSource(JPoisson(rate=rate),
                                    JTC(num_tasks=K, num_models=num_models),
                                    key, num_streams=streams)
        rec = _recording(jsrc)
        tsrc = TS.ProcessTaskSource(None, TTC(num_tasks=K), draws=rec,
                                    num_streams=streams)
    else:
        jsrc = JS.TraceTaskSource(trace_source)
        tsrc = TS.TraceTaskSource({k: torch.from_numpy(v)
                                   for k, v in trace_source.items()})
    j = {k: v for k, v in scfg_kw.items()}
    t = dict(j)
    if "faults" in j:
        j["faults"], t["faults"] = JFS(**j["faults"]), TFS(**t["faults"])
    if "placement" in j:
        j["placement"] = JPS(**j["placement"])
        t["placement"] = TPS(**t["placement"])
    jr = JS.StreamRunner(jecfg, jpol, None, jsrc, key,
                         JS.StreamConfig(num_streams=streams, **j))
    tr = TS.StreamRunner(tecfg, tpol, None, tsrc, torch.Generator(),
                         TS.StreamConfig(num_streams=streams, **t),
                         device="cpu")
    for _ in range(windows):
        jw, tw = jr.run_window(), tr.run_window()
        _same_stats(jw.stats, tw.stats, jw.window)
    return jr, tr


FLOAT_STATS = ("sum_resp", "sum_quality", "sum_steps", "busy_time")


def _same_stats(js, ts, w):
    assert set(js) == set(ts), (w, set(js) ^ set(ts))
    for k in js:
        a, b = np.asarray(js[k]), np.asarray(ts[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (w, k)
        if k in FLOAT_STATS:
            np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=f"{w} {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{w} {k}")


def _close(a, b, ctx):
    if isinstance(a, (bool, int, np.integer)) or a is None:
        assert a == b, (ctx, a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-9, err_msg=ctx)


def _same_runs(jr, tr):
    """Everything a run leaves behind, as the module docstring states."""
    assert len(jr.per_window) == len(tr.per_window)
    for a, b in zip(jr.per_window, tr.per_window):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], f"window {a['window']} {k}")
    js, ts = jr.result().summary, tr.result().summary
    assert js.keys() == ts.keys()
    for k in js:
        _close(js[k], ts[k], f"summary {k}")
    for f in JEV.EnvState._fields:
        np.testing.assert_array_equal(getattr(tr.carry, f).numpy(),
                                      np.asarray(getattr(jr.carry, f)),
                                      err_msg=f"carry {f}")
    np.testing.assert_array_equal(tr.t0, jr.t0)
    for jl, tl in zip(jr.leftovers, tr.leftovers):
        assert jl.keys() == tl.keys()
        for c in jl:
            assert jl[c].dtype == tl[c].dtype, c
            np.testing.assert_array_equal(tl[c], jl[c], err_msg=c)
    if jr.faults is not None:
        for jb, tb in zip(jr._retry, tr._retry):
            for c in jb:
                assert jb[c].dtype == tb[c].dtype, c
                np.testing.assert_array_equal(tb[c], jb[c], err_msg=c)
    assert jr.fault_counters() == tr.fault_counters()
    assert jr.placement_counters() == tr.placement_counters()
    assert jr.pending_retry() == tr.pending_retry()
    assert jr.backlog() == tr.backlog()


MODES = {
    "plain": {},
    "chaos": {"faults": FAULTS},
    "chaos, static": {"faults": FAULTS, "placement": {"policy": "static"}},
    "chaos, lfu": {"faults": FAULTS, "placement": {"policy": "lfu"}},
    "chaos, forecast": {"faults": FAULTS,
                        "placement": {"policy": "forecast", "interval": 2}},
    "forecast, no faults": {"placement": {"policy": "forecast"}},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("policy", ["fifo", "greedy"])
def test_stream_matches_the_reference(policy, mode):
    kw = dict(MODES[mode], num_windows=W)
    # placement plans on servers idle at the seam: a lighter load has some
    placed = "placement" in kw
    jr, tr = _runners(policy, kw, num_models=2 if placed else 1,
                      rate=0.04 if placed else 0.2)
    _same_runs(jr, tr)
    s = tr.result().summary
    assert s["tasks_scheduled"] > 0
    if "faults" in kw:
        assert s["tasks_failed"] > 0, "the fault spec crashed nothing"
    if "placement" in kw:
        assert tr.placement_counters()["placement_gangs_planned"] > 0


def test_trace_task_source_and_tight_carry_match_the_reference():
    """Explicit traces through both `TraceTaskSource`s, greedy under faults
    with a carry of 2 (shedding every window) and short windows (leftovers
    every window)."""
    rng = np.random.default_rng(5)
    n = K * 6
    gaps = rng.exponential(2.0, (B, n)).astype(np.float32)
    traces = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
              "c": rng.choice([1, 2, 4, 8], (B, n)).astype(np.int32),
              "model": np.zeros((B, n), np.int32),
              "noise": (0.004 * rng.standard_normal((B, n))).astype(
                  np.float32)}
    traces["arr_time"][:, 3:7] = traces["arr_time"][:, 3:4]   # ties
    kw = {"faults": FAULTS, "max_carry": 2, "max_steps_per_window": 24,
          "num_windows": 4}
    jr, tr = _runners("greedy", kw, windows=4, trace_source=traces)
    _same_runs(jr, tr)
    assert tr.result().summary["tasks_dropped_shed"] > 0
    with pytest.raises(ValueError, match="exhausted"):
        for _ in range(10):
            tr.run_window()


def test_curriculum_source_matches_the_reference():
    """Two cells, the switch between windows on both sides; the port replays
    the reference's refills."""
    key = jax.random.PRNGKey(1)
    jcells = [(JPoisson(rate=0.05), JTC(num_tasks=K)),
              (JPoisson(rate=0.5), JTC(num_tasks=K))]
    jsrc = JS.CurriculumTaskSource(jcells, key, num_streams=B)
    rec = _recording(jsrc)
    tsrc = TS.CurriculumTaskSource([(None, TTC(num_tasks=K))] * 2,
                                   num_streams=B, draws=rec)
    jpol, tpol = _policies("fifo")
    jr = JS.StreamRunner(JECFG, jpol, None, jsrc, key,
                         JS.StreamConfig(num_streams=B))
    tr = TS.StreamRunner(TECFG, tpol, None, tsrc, None,
                         TS.StreamConfig(num_streams=B), device="cpu")
    for w in range(4):
        jsrc.set_cell(w // 2)
        tsrc.set_cell(w // 2)
        jr.run_window()
        tr.run_window()
    _same_runs(jr, tr)
    with pytest.raises(ValueError, match="out of range"):
        tsrc.set_cell(2)


def test_generator_sources_draw_in_order():
    """Sources driven by a generator: the same seed gives the same tasks,
    absolute arrival clocks grow, the refill is the chunk asked for."""
    def take(seed):
        src = TS.ProcessTaskSource(TPoisson(rate=0.3), TTC(num_tasks=8),
                                   torch.Generator().manual_seed(seed),
                                   num_streams=3, chunk_size=5, device="cpu")
        return [src.take(b, 12) for b in range(3)] + [src.take(1, 4)]
    a, b, c = take(0), take(0), take(1)
    for x, y in zip(a, b):
        for col in x:
            np.testing.assert_array_equal(x[col], y[col])
    assert not np.array_equal(a[0]["arr_time"], c[0]["arr_time"])
    for x in a:
        assert np.all(np.diff(x["arr_time"]) >= 0) and x["c"].dtype == np.int32
    assert a[1]["arr_time"][-1] < a[3]["arr_time"][0]
    with pytest.raises(ValueError, match="at least one cell"):
        TS.CurriculumTaskSource([], device="cpu")


# ---------------------------------------------------------------- port only
def _tiny_actor():
    acfg = TAG.AgentConfig(variant="eat", T=2, hidden=16)
    params = TAG.init_actor(TECFG, acfg, generator=torch.Generator()
                            .manual_seed(1), device="cpu")
    return actor_policy(TECFG, acfg, sampler="ddpm", device="cpu"), params


@pytest.mark.parametrize("policy", ["fifo", "uniform", "ddpm"])
def test_single_window_equals_batch_rollout(policy):
    """One window from a fresh carry over a whole trace (T = max_steps)
    equals `batch_rollout` on the same generator state in every tensor:
    metrics, collected transitions and the generator afterwards, and the
    window's carry, stats and leftovers are the seam of the rollout's
    final state."""
    if policy == "ddpm":
        pol, params = _tiny_actor()
    else:
        pol = (TRO.fifo_policy if policy == "fifo"
               else TRO.uniform_policy)(TECFG)
        params = {}
    rng = np.random.default_rng(2)
    traces = {"arr_time": np.cumsum(rng.exponential(4.0, (B, K)), axis=1,
                                    dtype=np.float32),
              "c": rng.choice([1, 2, 4], (B, K)).astype(np.int32),
              "model": np.zeros((B, K), np.int32),
              "noise": (0.004 * rng.standard_normal((B, K))).astype(
                  np.float32)}
    tt = {k: torch.from_numpy(v) for k, v in traces.items()}
    g1 = torch.Generator().manual_seed(7)
    ref = TRO.batch_rollout(TECFG, tt, pol, params, generator=g1,
                            collect=True, device="cpu")
    g2 = torch.Generator().manual_seed(7)
    runner = TS.StreamRunner(
        TECFG, pol, params, TS.TraceTaskSource(tt), g2,
        TS.StreamConfig(num_streams=B, max_steps_per_window=TECFG.max_steps),
        device="cpu")
    got = runner.run_window(collect=True)
    assert ref.metrics.keys() == got.metrics.keys()
    for k in ref.metrics:
        assert torch.equal(ref.metrics[k], got.metrics[k]), k
    for f in TRO.Transitions._fields[:-1]:
        assert torch.equal(getattr(ref.transitions, f),
                           getattr(got.transitions, f)), f
    for k, v in ref.transitions.extras.items():
        assert torch.equal(v, got.transitions.extras[k]), k
    assert torch.equal(g1.get_state(), g2.get_state())
    stats, carry, lcols, n_left = TS._window_seam(
        TECFG, tt, ref.final_state, runner._edges, runner._sla)
    for f in carry._fields:
        assert torch.equal(getattr(runner.carry, f), getattr(carry, f)), f
    for k, v in stats.items():
        np.testing.assert_array_equal(got.stats[k], v.numpy(), err_msg=k)
    for b, left in enumerate(runner.leftovers):
        for c, v in left.items():
            np.testing.assert_array_equal(v, lcols[c][b, :n_left[b]].numpy(),
                                          err_msg=c)
    assert got.stats["n_sched"].sum() == int(ref.metrics["num_scheduled"]
                                             .sum())


def _draw(rng):
    """The parameter space of tests/test_stream_ledger_prop.py."""
    mtbf = float(rng.choice([0.0, 40.0, 120.0, 300.0]))
    return dict(
        windows=int(rng.integers(1, 5)),
        streams=int(rng.integers(1, 4)),
        K=int(rng.choice([8, 12, 16])),
        max_carry=(None if rng.random() < 0.5
                   else int(rng.integers(0, 9))),
        fault_seed=int(rng.integers(0, 1000)),
        mtbf=mtbf,
        max_retries=int(rng.integers(0, 4)),
        rate=float(rng.choice([0.05, 0.2, 1.0])),
        key_seed=int(rng.integers(0, 1000)),
    )


@pytest.mark.parametrize("seed", range(6))
def test_ledger_conserved_every_window(seed):
    """injected == scheduled + dropped + failed_pending_retry + leftover
    after every window, with dropped = shed + retry-exhausted."""
    d = _draw(np.random.default_rng(seed))
    ecfg = TEV.EnvConfig(num_servers=4, queue_window=4, max_tasks=d["K"],
                         time_limit=600.0, max_steps=8 * d["K"])
    faults = None
    if d["mtbf"] > 0.0:
        faults = TFS(seed=d["fault_seed"], mtbf=d["mtbf"], mttr=30.0,
                     straggler_prob=0.2, max_retries=d["max_retries"],
                     backoff_base=2.0, backoff_cap=20.0,
                     retry_deadline=300.0)
    gen = torch.Generator().manual_seed(d["key_seed"])
    src = TS.ProcessTaskSource(TPoisson(rate=d["rate"]),
                               TTC(num_tasks=d["K"]), gen,
                               num_streams=d["streams"], device="cpu")
    runner = TS.StreamRunner(
        ecfg, TRO.greedy_policy(ecfg), None, src, gen,
        TS.StreamConfig(num_streams=d["streams"], max_carry=d["max_carry"],
                        faults=faults), device="cpu")
    for _ in range(d["windows"]):
        runner.run_window()
        s = runner.result().summary
        assert s["tasks_injected"] == (
            s["tasks_scheduled"] + s["tasks_dropped"]
            + s["tasks_failed_pending_retry"] + s["tasks_leftover"]), s
        assert s["tasks_dropped"] == (s["tasks_dropped_shed"]
                                      + s["tasks_dropped_retry_exhausted"])
        for k in ("tasks_scheduled", "tasks_dropped", "tasks_leftover",
                  "tasks_failed_pending_retry", "tasks_failed",
                  "tasks_retried"):
            assert s.get(k, 0) >= 0, (k, s)


def _seam_inputs(rng, faulty, n_models):
    """A random finished window: tasks in every status, arrival times with
    runs of ties (and the INF the leftovers' sort pads with), gangs intact,
    broken and carried."""
    Bs = 4
    arr = np.round(rng.uniform(0, 30, (Bs, K)) / 5) * 5      # many ties
    arr = np.sort(arr, axis=1).astype(np.float32)
    status = rng.choice([0, 1, 2, 3] if faulty else [0, 1, 2], (Bs, K))
    start = np.where(status > 0, arr + rng.uniform(0, 20, (Bs, K)), 0)
    finish = np.where(status > 0, start + rng.uniform(1, 200, (Bs, K)), 0)
    gang = rng.choice([-1, 0, 3, 5, K + 1], (Bs, E)).astype(np.int32)
    time = rng.uniform(10, 300, Bs).astype(np.float32)
    st = dict(
        time=time,
        server_free_at=(time[:, None] + rng.uniform(-50, 50, (Bs, E))
                        ).astype(np.float32),
        server_model=rng.integers(-1, n_models, (Bs, E)).astype(np.int32),
        server_gang=gang,
        server_gang_size=rng.integers(0, 4, (Bs, E)).astype(np.int32),
        task_status=status.astype(np.int32),
        task_start=start.astype(np.float32),
        task_finish=finish.astype(np.float32),
        task_steps=rng.integers(0, 50, (Bs, K)).astype(np.int32),
        task_quality=rng.uniform(0.1, 0.3, (Bs, K)).astype(np.float32),
        task_reload=rng.integers(0, 2, (Bs, K)).astype(np.int32),
        steps_taken=rng.integers(0, 99, Bs).astype(np.int32))
    traces = {"arr_time": arr,
              "c": rng.choice([1, 2, 4], (Bs, K)).astype(np.int32),
              "model": rng.integers(-1, n_models + 1, (Bs, K)).astype(
                  np.int32),
              "noise": rng.standard_normal((Bs, K)).astype(np.float32)}
    if faulty:
        ds = rng.uniform(-20, 400, (Bs, E, 3)).astype(np.float32)
        ds[rng.random((Bs, E, 3)) < 0.5] = 1e30
        traces.update(f_down_start=ds, f_down_end=ds + np.float32(5),
                      f_slow=np.ones((Bs, E), np.float32),
                      f_cold=(rng.random((Bs, 1)) < 0.7).astype(np.float32),
                      f_retries=rng.integers(0, 3, (Bs, K)).astype(np.int32))
    return traces, st


@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("per_model", [False, True])
def test_window_seam_matches_the_reference_with_ties(faulty, per_model):
    """The seam on the same finished window: stats, carry, leftovers and the
    failed set equal to the reference's (the leftovers' and failed tasks'
    order among tied arrival times is the stable sort's)."""
    M = 3
    rng = np.random.default_rng(11 + faulty + 2 * per_model)
    jcfg = JEV.EnvConfig(**ENV, num_models=M)
    tcfg = TEV.EnvConfig(**ENV, num_models=M)
    traces, st = _seam_inputs(rng, faulty, M)
    edges = np.asarray(JS.MX.DEFAULT_EDGES)
    jout = JS._window_seam(jcfg, {k: jnp.asarray(v) for k, v in
                                  traces.items()},
                           JEV.EnvState(**{k: jnp.asarray(v) for k, v in
                                           st.items()}),
                           jnp.asarray(edges), jnp.float32(120.0),
                           per_model=per_model)
    tout = TS._window_seam(tcfg, {k: torch.from_numpy(v) for k, v in
                                  traces.items()},
                           TEV.EnvState(**{k: torch.from_numpy(np.array(v))
                                           for k, v in st.items()}),
                           torch.from_numpy(edges), 120.0,
                           per_model=per_model)
    assert len(jout) == len(tout) == (6 if faulty else 4)
    _same_stats({k: np.asarray(v) for k, v in jout[0].items()},
                {k: v.numpy() for k, v in tout[0].items()}, "seam")
    for f in JEV.EnvState._fields:
        np.testing.assert_array_equal(getattr(tout[1], f).numpy(),
                                      np.asarray(getattr(jout[1], f)),
                                      err_msg=f)
    for i in range(2, len(jout)):
        j, t = jout[i], tout[i]
        if isinstance(j, dict):
            assert j.keys() == t.keys()
            for c in j:
                np.testing.assert_array_equal(t[c].numpy(), np.asarray(j[c]),
                                              err_msg=f"{i} {c}")
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_runner_options_and_refusals(monkeypatch):
    """`collect=True` gives (B, T, ...) transitions; a `rollout_fn` with
    `batch_rollout`'s signature (here its plain env step) gives the same
    stream; a policy swapped between windows is used; bad carries and a
    missing card are refused."""
    def run(**kw):
        rng = np.random.default_rng(3)
        gaps = rng.exponential(3.0, (B, K * 3)).astype(np.float32)
        traces = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
                  "c": rng.choice([1, 2, 4], (B, K * 3)).astype(np.int32),
                  "model": np.zeros((B, K * 3), np.int32),
                  "noise": np.zeros((B, K * 3), np.float32)}
        return TS.StreamRunner(TECFG, TRO.fifo_policy(TECFG), None,
                               TS.TraceTaskSource(traces), None,
                               TS.StreamConfig(num_streams=B,
                                               faults=TFS(**FAULTS)),
                               device="cpu", **kw)
    a, b = run(), run(rollout_fn=functools.partial(TRO.batch_rollout,
                                                   impl="ref"))
    wa = a.run_window(collect=True)
    wb = b.run_window()
    T = min(4 * K, TECFG.max_steps)
    assert wa.transitions.action.shape == (B, T, TECFG.action_dim)
    assert wb.transitions is None and wa.record == wb.record
    a.run_window(policy=TRO.greedy_policy(TECFG))
    assert a.policy is TRO.greedy_policy(TECFG)
    assert a.result().summary["num_windows"] == 2
    with pytest.raises(ValueError, match="max_carry"):
        TS.StreamRunner(TECFG, TRO.fifo_policy(TECFG), None, None, None,
                        TS.StreamConfig(max_carry=K), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.StreamRunner(TECFG, TRO.fifo_policy(TECFG), None, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.ProcessTaskSource(TPoisson(), TTC(num_tasks=K))
