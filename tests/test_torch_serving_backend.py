"""The port's stream-native serving backend (`repro_torch.serving.backend`,
`serving.runner`) on the CPU.

* Against the reference's `repro.serving.backend.ServingRollout` (which
  imports cleanly under this suite's warning filter), in mirror mode
  (`execute=False`) on the same numpy traces: fifo and greedy closed loop,
  and teacher-forced actions through `sequence_policy`, with and without
  fault columns. Final state, metrics, collected transitions and the pool
  ledger must agree: exact on every integer, boolean and clock value,
  within 1e-6 on quality and obs and 1e-5 on rewards.
* Against the port's own fused engine at batch 1, which is what the
  backend's design promises: every tensor and the generator state equal,
  EAT closed loop included, across stream windows.
* `step_info` (the `info` read from the state change) against
  `env.step_with_queue`'s `info`; `wall_patch` against the reference's
  `_wall_patch_prog` on the same inputs; the fault-tolerant generate's
  ledger against the reference's on the same injected errors.
* Real execution on reduced dense archs rides along without changing the
  MDP; wall-clock mode patches measured seconds in; the reference's
  default arch list builds and serves whisper-small; and the refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as JEV
from repro.core import rollout as JRO
from repro.faults import FaultSpec as JFS
from repro.serving import backend as JSB
from repro_torch import api
from repro_torch.common import config as TCFG
from repro_torch.core import agent as TAG
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core import scenarios as TSC
from repro_torch.core.workload import TraceConfig as TTC
from repro_torch.faults import FaultSpec as TFS
from repro_torch.placement import PlacementSpec as TPS
from repro_torch.serving import backend as TSB
from repro_torch.serving import runner as TSR
from repro_torch.telemetry import trace as TTR
from repro_torch.traffic import stream as TS

FLOAT_TOL = 1e-6
RTOL = 1e-5
E, K, T = 8, 16, 40
ENV = dict(num_servers=E, max_tasks=K, queue_window=4, max_steps=64,
           num_models=3, model_scale=(1.0, 0.6, 1.4))
JECFG, TECFG = JEV.EnvConfig(**ENV), TEV.EnvConfig(**ENV)
ARCHS = ("tinyllama-1.1b", "qwen2-1.5b", "llama3.2-3b")
INT_METRICS = ("num_scheduled", "num_done", "num_failed", "episode_len")


def _np_trace(seed, faults=False, rate=0.1, B=1):
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(size=(B, K)) / rate).astype(np.float32)
    tr = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
          "c": rng.choice([1, 2, 4, 8], (B, K),
                          p=[0.35, 0.35, 0.2, 0.1]).astype(np.int32),
          "model": rng.integers(0, 3, (B, K)).astype(np.int32),
          "noise": (0.004 * rng.standard_normal((B, K))).astype(np.float32)}
    if faults:
        F = 2
        ds = rng.uniform(0.0, 150.0, (B, E, F)).astype(np.float32)
        de = (ds + rng.uniform(5.0, 40.0, (B, E, F))).astype(np.float32)
        pad = rng.random((B, E, F)) < 0.5
        tr["f_down_start"] = np.where(pad, 1e30, ds).astype(np.float32)
        tr["f_down_end"] = np.where(pad, 1e30, de).astype(np.float32)
        tr["f_slow"] = rng.uniform(1.0, 1.5, (B, E)).astype(np.float32)
        tr["f_cold"] = np.ones((B, 1), np.float32)
    return tr


def _jax(tr):
    return {k: jnp.asarray(v) for k, v in tr.items()}


def _torch(tr):
    return {k: torch.from_numpy(np.array(v)) for k, v in tr.items()}


def _same(a, b, ctx, tol=None):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (ctx, a.shape, b.shape)
    if tol is None:
        np.testing.assert_array_equal(b, a, err_msg=ctx)
    else:
        np.testing.assert_allclose(b, a, rtol=tol, atol=FLOAT_TOL,
                                   err_msg=ctx)


# ------------------------------------------------ against the reference
CASES = ["fifo", "greedy", "greedy-faults", "teacher", "teacher-faults"]


@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_reference_serving_rollout(case):
    """Port mirror == reference mirror (both `execute=False`) on the same
    trace: closed loop for fifo / greedy, the same actions replayed
    otherwise; pool ledger included."""
    faults = case.endswith("faults")
    tr = _np_trace(3 + len(case), faults=faults)
    if case.startswith("teacher"):
        seq = np.random.default_rng(1).random((T, TECFG.action_dim),
                                              dtype=np.float32)
        jpol, tpol = JRO.sequence_policy(JECFG), TRO.sequence_policy(TECFG)
        jp, tp = {"seq": jnp.asarray(seq)}, {"seq": torch.from_numpy(seq)}
    else:
        name = case.split("-")[0]
        jpol = getattr(JRO, f"{name}_policy")(JECFG)
        tpol = getattr(TRO, f"{name}_policy")(TECFG)
        jp = tp = {}
    jsv = JSB.ServingRollout(E, archs=ARCHS, execute=False)
    want = jsv(JECFG, _jax(tr), jpol, jp,
               jax.random.split(jax.random.PRNGKey(0), 1), num_steps=T,
               collect=True)
    tsv = TSB.ServingRollout(E, archs=ARCHS, execute=False, device="cpu")
    got = tsv(TECFG, _torch(tr), tpol, tp, num_steps=T, collect=True)
    for f in JEV.EnvState._fields:
        _same(getattr(want.final_state, f), getattr(got.final_state, f),
              f, FLOAT_TOL if f == "task_quality" else None)
    for k in want.metrics:
        _same(want.metrics[k], got.metrics[k], k,
              None if k in INT_METRICS else RTOL)
    wt, gt = want.transitions, got.transitions
    for f, tol in (("obs", FLOAT_TOL), ("action", None), ("reward", RTOL),
                   ("next_obs", FLOAT_TOL), ("done", None), ("valid", None)):
        _same(getattr(wt, f), getattr(gt, f), f, tol)
    assert tsv.pool_counters() == jsv.pool_counters()
    assert tsv.fault_counters() == jsv.fault_counters()
    assert tsv.tasks_executed == jsv.tasks_executed > 0
    if faults:
        assert tsv.pool.crashed_tasks == jsv.pool.crashed_tasks


# ------------------------------------------------ against the fused engine
def _eat():
    acfg = TAG.AgentConfig(T=3, hidden=32)
    params = TAG.init_actor(TECFG, acfg,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    from repro_torch.actors.policies import actor_policy
    return actor_policy(TECFG, acfg, sampler="ddpm", device="cpu"), params


@pytest.mark.parametrize("name", ["fifo", "greedy", "random", "eat"])
def test_mirror_equals_fused_at_batch_one_across_windows(name):
    """ServingStreamRunner (mirror) == StreamRunner on the fused engine at
    B = 1: window records, stats, carry, transitions and the generator,
    exact, over three windows of the same tasks."""
    if name == "eat":
        pol, params = _eat()
    else:
        pol = getattr(TRO, {"random": "uniform"}.get(name, name)
                      + "_policy")(TECFG)
        params = {}
    tr = _torch(_np_trace(7, rate=0.2))
    big = {k: torch.cat([v] * 4, dim=1) for k, v in tr.items()}
    big["arr_time"] = torch.cumsum(torch.cat([torch.diff(
        tr["arr_time"], prepend=torch.zeros(1, 1), dim=1)] * 4, dim=1), 1)
    scfg = TS.StreamConfig(num_streams=1, max_steps_per_window=24)
    sv = TSB.ServingRollout(E, archs=ARCHS, execute=False, device="cpu")
    runs, gens = [], []
    for rollout_fn, cls in ((None, TS.StreamRunner),
                            (sv, TSR.ServingStreamRunner)):
        g = torch.Generator().manual_seed(5)
        r = cls(TECFG, pol, params, TS.TraceTaskSource(big), g, scfg,
                rollout_fn=rollout_fn, device="cpu")
        outs = [r.run_window(collect=True) for _ in range(3)]
        runs.append((r, outs))
        gens.append(g)
    (ra, oa), (rb, ob) = runs
    assert ra.per_window == rb.per_window
    for wa, wb in zip(oa, ob):
        for k in wa.stats:
            assert np.array_equal(wa.stats[k], wb.stats[k]), k
        for f in TRO.Transitions._fields[:-1]:
            assert torch.equal(getattr(wa.transitions, f),
                               getattr(wb.transitions, f)), f
        for k in wa.transitions.extras:
            assert torch.equal(wa.transitions.extras[k],
                               wb.transitions.extras[k]), k
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(ra.carry, f), getattr(rb.carry, f)), f
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    summary = rb.result().summary
    assert summary["wall_clock"] is False
    assert summary["model_loads"] + summary["model_reuses"] >= \
        summary["tasks_executed"] > 0


def test_simulator_serving_equals_fused_and_resets_pool():
    """`Simulator(ExecSpec(backend="serving"))` streaming with placement ==
    the fused backend's run; a second run starts from a fresh pool."""
    sc = TSC.Scenario("s", TECFG, TTC(num_tasks=K, arrival_rate=0.1,
                                      max_servers=E, num_models=3))
    wl = api.WorkloadSpec.streaming(sc, streams=1, num_windows=3,
                                    max_steps_per_window=24)
    place = TPS(policy="forecast", interval=1)
    fused = api.Simulator(wl, api.ExecSpec(placement=place),
                          device="cpu").run("greedy", 2)
    sim = api.Simulator(wl, api.ExecSpec(
        backend="serving", serving_archs=ARCHS, serving_execute=False,
        placement=place), device="cpu")
    a = sim.run("greedy", 2)
    b = sim.run("greedy", 2)
    assert a.per_window == fused.per_window == b.per_window
    assert a.summary["model_loads"] == b.summary["model_loads"] > 0
    assert a.summary["wall_clock"] is False
    assert a.backend == "serving"


# ------------------------------------------------ the pieces
@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_step_info_matches_step_with_queue(faults):
    """The info read from the state change == `env.step_with_queue`'s info
    at every decision of a random rollout."""
    tr = _torch(_np_trace(11, faults=faults, rate=0.3))
    st = TEV.reset(TECFG, 1, device="cpu")
    q, _ = TEV.reset_view(TECFG, tr, st)
    rng = np.random.default_rng(0)
    n_sched = 0
    for _ in range(48):
        a = torch.from_numpy(rng.random((1, TECFG.action_dim),
                                        dtype=np.float32))
        nst, nq, _, _, d, info = TEV.step_with_queue(TECFG, tr, st, q, a)
        got = TSB.step_info(st, nst, d)
        assert got.scheduled == bool(info["scheduled"][0])
        assert got.done == bool(d[0])
        if got.scheduled:
            n_sched += 1
            assert got.task == int(info["task"][0])
            assert got.steps == int(info["steps"][0])
            assert got.reuse == bool(info["reuse"][0])
            assert got.failed == bool(info.get("failed",
                                               torch.zeros(1, dtype=bool))[0])
            np.testing.assert_array_equal(
                got.sel, (nst.server_gang[0] == got.task).numpy())
        st, q = nst, nq
    assert n_sched > 3


def test_wall_patch_matches_reference():
    """`wall_patch` == the reference's `_wall_patch_prog` on the same
    scheduled decision and busy seconds."""
    tr = _np_trace(2, rate=0.5)
    jtr = {k: jnp.asarray(v[0]) for k, v in tr.items()}
    ttr = _torch(tr)
    jst = JEV.reset(JECFG)
    jq, _ = JEV.reset_view(JECFG, jtr, jst)
    tst = TEV.reset(TECFG, 1, device="cpu")
    tq, _ = TEV.reset_view(TECFG, ttr, tst)
    patch = JSB._wall_patch_prog(JECFG)
    rng = np.random.default_rng(3)
    checked = 0
    for i in range(30):
        a = rng.random(TECFG.action_dim, dtype=np.float32)
        a[0] = 0.2                              # execute
        jn, jnq, _, _, _, jinfo = JEV.step_with_queue(
            JECFG, jtr, jst, jq, jnp.asarray(a))
        tn, tnq, _, _, _, _ = TEV.step_with_queue(
            TECFG, ttr, tst, tq, torch.from_numpy(a)[None])
        if bool(jinfo["scheduled"]):
            k = int(jinfo["task"])
            sel = np.asarray(jn.server_gang == k)
            busy = np.float32(3.25 + i)
            want = patch(jtr, jq, jn, k, jnp.asarray(sel), busy)
            got = TSB.wall_patch(TECFG, ttr, tq, tn, k,
                                 torch.from_numpy(np.array(sel))[None],
                                 torch.tensor([busy]))
            for f in JEV.EnvState._fields:
                _same(getattr(want[0], f), getattr(got[0], f)[0], f,
                      FLOAT_TOL if f == "task_quality" else None)
            for f in ("idx", "valid", "queued"):
                _same(getattr(want[1], f), getattr(got[1], f)[0], f)
            _same(want[2], got[2][0], "obs", FLOAT_TOL)
            _same(want[3], got[3][0], "reward", RTOL)
            _same(want[4], got[4][0], "done")
            checked += 1
            # continue from the patched state on both sides
            jn, jnq = want[0], want[1]
            tn, tnq = got[0], got[1]
        jst, jq, tst, tq = jn, jnq, tn, tnq
    assert checked >= 3


class _StubExecutor:
    """Counts generate attempts; never runs a model."""

    def __init__(self):
        self.calls = []

    def generate(self, arch, params, prompt, c, steps, max_new_tokens,
                 deadline_s=0.0):
        self.calls.append(steps)


def test_tolerant_generate_ledger_matches_reference():
    """Retries, the degraded last attempt and give-ups on the same injected
    errors (`ExecFaultInjector` draws numpy, identically on both sides)."""
    kw = dict(seed=4, exec_error_prob=0.6, exec_max_attempts=3,
              degrade_steps_frac=0.5)
    j = JSB.ServingRollout(E, archs=ARCHS, execute=False, faults=JFS(**kw))
    t = TSB.ServingRollout(E, archs=ARCHS, execute=False, faults=TFS(**kw),
                           device="cpu")
    for sv in (j, t):
        sv.executor = _StubExecutor()
        for i in range(40):
            sv._generate_tolerant("tinyllama-1.1b", None, None, 2, 20 + i)
    assert t.fault_counters() == j.fault_counters()
    assert t.executor.calls == j.executor.calls
    c = t.fault_counters()
    assert c["exec_retries"] > 0 and c["exec_degraded"] > 0 \
        and c["exec_gave_up"] > 0


def test_real_execution_rides_along_and_wall_clock(tmp_path):
    """Executing reduced dense archs leaves the virtual-time MDP unchanged;
    wall-clock mode (warmup on) patches measured seconds into the finish
    times and traces the serving spans."""
    tr = _torch(_np_trace(5, rate=0.3))
    pol = TRO.greedy_policy(TECFG)
    mirror = TSB.ServingRollout(E, archs=ARCHS, execute=False, device="cpu")
    real = TSB.ServingRollout(E, archs=ARCHS, execute=True, prompt_len=6,
                              max_new_tokens=4, device="cpu")
    a = mirror(TECFG, tr, pol, {}, num_steps=24)
    b = real(TECFG, tr, pol, {}, num_steps=24)
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(a.final_state, f),
                           getattr(b.final_state, f)), f
    assert real.pool_counters() == mirror.pool_counters()
    assert real.tasks_executed == mirror.tasks_executed > 0
    TTR.reset_tracers()
    tcfg = TTR.TraceConfig(enabled=True, path=str(tmp_path / "s.json"))
    wall = TSB.ServingRollout(E, archs=("tinyllama-1.1b",), execute=True,
                              wall_clock=True, prompt_len=6,
                              max_new_tokens=4, tracer=TTR.tracer_for(tcfg),
                              device="cpu")
    assert wall.warmup
    c = wall(TECFG, tr, pol, {}, num_steps=24)
    n = wall.tasks_executed
    assert n > 0 and len(wall.measured_busy) == n
    st = c.final_state
    run = (st.task_status[0] >= 1).numpy()
    dur = (st.task_finish - st.task_start)[0].numpy()[run]
    np.testing.assert_allclose(np.sort(dur), np.sort(np.float32(
        wall.measured_busy)), rtol=1e-4, atol=1e-4)
    assert wall.executor._warmed
    stats = wall.serving_stats()
    assert stats["measured_busy_mean_s"] > 0 and stats["tasks_executed"] == n
    TTR.tracer_for(tcfg).write()
    from repro_torch.telemetry import schema as TSCH
    assert not TSCH.validate_trace(str(tmp_path / "s.json"),
                                   strict_names=True)
    import json
    names = {e["name"] for e in json.load(open(tmp_path / "s.json"))[
        "traceEvents"]}
    assert {"decision", "env_advance", "execute_task", "wall_patch",
            "model_load", "executor_warmup", "prefill", "decode"} <= names
    TTR.reset_tracers()


@pytest.mark.parametrize("case", ["batch", "servers", "arch", "streams",
                                  "rollout_fn", "device"])
def test_serving_refusals(case):
    tr = _torch(_np_trace(1, B=2))
    if case == "batch":
        sv = TSB.ServingRollout(E, archs=ARCHS, execute=False, device="cpu")
        with pytest.raises(ValueError, match="ONE physical cluster"):
            sv(TECFG, tr, TRO.fifo_policy(TECFG), {})
    elif case == "servers":
        sv = TSB.ServingRollout(4, archs=ARCHS, execute=False, device="cpu")
        with pytest.raises(ValueError, match="serving pool has 4 servers"):
            sv(TECFG, {k: v[:1] for k, v in tr.items()},
               TRO.fifo_policy(TECFG), {})
    elif case == "arch":
        # an unknown arch is refused when the backend is built; the
        # reference's default (ASSIGNED_ARCHS, every family) builds, and
        # model id 2 (whisper-small) is served on the CPU
        with pytest.raises(KeyError, match="unknown arch"):
            TSB.ServingRollout(E, archs=("tinyllama-1.1b", "no-such-arch"),
                               device="cpu")
        sv = TSB.ServingRollout(E, prompt_len=6, max_new_tokens=4,
                                device="cpu")
        assert sv.archs == TCFG.ASSIGNED_ARCHS
        tr = _np_trace(2)
        tr["model"][:] = 2
        sv(TECFG, _torch(tr), TRO.fifo_policy(TECFG), {}, num_steps=4)
        assert sv.tasks_executed >= 1
        assert {s.model_name for s in sv.pool.servers
                if s.params is not None} == {"whisper-small"}
    elif case == "streams":
        with pytest.raises(ValueError, match="num_streams=1"):
            TSR.ServingStreamRunner(TECFG, None, {}, None, None,
                                    TS.StreamConfig(num_streams=2),
                                    device="cpu")
    elif case == "rollout_fn":
        with pytest.raises(ValueError, match="serving rollout fn"):
            TSR.ServingStreamRunner(TECFG, None, {}, None, None,
                                    TS.StreamConfig(num_streams=1),
                                    rollout_fn=api.rollout_fn_for(),
                                    device="cpu")
    elif case == "device":
        sv = TSB.ServingRollout(E, archs=ARCHS, execute=False, device="cpu")
        with pytest.raises(ValueError, match="lives on cpu"):
            sv(TECFG, tr, TRO.fifo_policy(TECFG), {}, device="meta")


def test_serve_stream_and_lazy_spec():
    """`serve_stream` through the facade's lazy serving fn: one window,
    the pool ledger and the wall-clock flag in the summary."""
    fn = api.rollout_fn_for(api.ExecSpec(backend="serving",
                                         serving_archs=ARCHS,
                                         serving_execute=False))
    assert fn.backend == "serving" and fn.serving_stats() == {}
    tr = _torch(_np_trace(9, rate=0.2))
    res = TSR.serve_stream(TECFG, TRO.fifo_policy(TECFG), {},
                           TS.TraceTaskSource(tr), torch.Generator(),
                           TS.StreamConfig(num_windows=1, num_streams=1),
                           rollout_fn=fn, collect=True, device="cpu")
    assert res.summary["wall_clock"] is False
    assert res.summary["tasks_executed"] == res.summary["tasks_scheduled"]
    assert len(res.transitions) == 1
