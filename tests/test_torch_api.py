"""The port's API facade (`repro_torch.api`, `traffic.policies`,
`traffic.sweep`) on the CPU.

`repro.api` cannot be imported under this suite's warning filter (its
backends import a deprecated `shard_map`), so the facade is held to the
reference's lower layers, which it wraps:

* episodic runs: the Simulator's traces (made by the port's generator rule,
  `api.simulator.split_generator`) go through the reference's
  `core.rollout.batch_rollout`; fifo and greedy must then agree exactly on
  every integer, boolean and clock value, within 1e-6 / 1e-5 on quality,
  the float metrics and the return;
* streaming runs: the Simulator's task source is replaced by one replaying
  the reference's recorded refills (`tests/test_torch_stream.py`'s
  `draws=`), and its windows are held to the reference's `StreamRunner`;
* every run is also held to the port's own direct `batch_rollout` /
  `run_stream` on the same generator state, in every tensor.

Plus the registry against the reference's `@register` calls (read by
`ast`), a reference checkpoint restored through `PolicySpec`, the restored
repairs (`StreamConfig.chunk_size`, `TraceConfig`'s three fields, the
host-clock `profile_policy`), the telemetry files, the sweep's row schema,
the deprecated doors and every refusal.
"""
import ast
import dataclasses
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.checkpoint import save_checkpoint as jsave_checkpoint
from repro.core import agent as JAG
from repro.core import diffusion as JDF
from repro.core import env as JEV
from repro.core import rollout as JRO
from repro.core.workload import TraceConfig as JTC
from repro.faults import FaultSpec as JFS
from repro.placement import PlacementSpec as JPS
from repro.telemetry import trace as JTR
from repro.traffic import stream as JS
from repro.traffic.arrivals import PoissonArrivals as JPoisson
from repro_torch import api
from repro_torch.api import simulator as SIM
from repro_torch.api.simulator import split_generator
from repro_torch.common import checkpoint as TCK
from repro_torch.core import agent as TAG
from repro_torch.core import diffusion as TDF
from repro_torch.core import env as TEV
from repro_torch.core import ppo as TPPO
from repro_torch.core import replay as TRP
from repro_torch.core import rollout as TRO
from repro_torch.core import sac as TSAC
from repro_torch.core import scenarios as TSC
from repro_torch.core.workload import TraceConfig as TTC
from repro_torch.faults import FaultSpec as TFS
from repro_torch.placement import PlacementSpec as TPS
from repro_torch.telemetry import metrics as TMET
from repro_torch.telemetry import profile as TPROF
from repro_torch.telemetry import schema as TSCH
from repro_torch.telemetry import trace as TTR
from repro_torch.traffic import stream as TS
from repro_torch.traffic import sweep as TSW

ROOT = Path(__file__).resolve().parents[1]
FLOAT_TOL = 1e-6
RTOL = 1e-5
E, K, B = 4, 8, 4
ENV = dict(num_servers=E, max_tasks=K, queue_window=4, max_steps=64)
JECFG, TECFG = JEV.EnvConfig(**ENV), TEV.EnvConfig(**ENV)
ACFG = dict(T=3, hidden=32)
INT_METRICS = ("num_scheduled", "num_done", "num_failed", "episode_len")


def _scenario(name="cell", rate=0.05):
    return TSC.Scenario(name=name, ecfg=TECFG,
                        tcfg=TTC(num_tasks=K, arrival_rate=rate,
                                 max_servers=E))


def _sim(wl, **kw):
    return api.Simulator(wl, api.ExecSpec(**kw), device="cpu")


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", api.UntrainedPolicyWarning)
        return fn(*a, **kw)


def _sim_traces(sc, seed, batch=B):
    """The traces `Simulator.run(policy, seed)` draws: the data child of
    `split_generator`."""
    g_data, g_run, _ = split_generator(torch.Generator().manual_seed(seed), 3)
    return TSC.make_scenario_trace_batch(sc, batch, generator=g_data,
                                         device="cpu"), g_run


def _close_metrics(jm, tm, ctx):
    assert set(jm) == set(tm), ctx
    for k in jm:
        a, b = np.asarray(jm[k]), np.asarray(tm[k])
        if k in INT_METRICS:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=FLOAT_TOL,
                                       err_msg=f"{ctx} {k}")


# ------------------------------------------------------------- registry
def _reference_registrations():
    tree = ast.parse((ROOT / "src/repro/api/registry.py").read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                if (isinstance(dec, ast.Call)
                        and getattr(dec.func, "id", "") == "register"):
                    name = dec.args[0].value
                    kind = dec.args[1].id.lower()
                    out.append((name, kind))
    return out


def test_registry_names_and_kinds_match_reference():
    want = _reference_registrations()
    assert [n for n, _ in want] == list(api.available_policies())
    assert [(n, api.policy_kind(n)) for n in api.available_policies()] == want
    with pytest.raises(ValueError, match="unknown policy"):
        api.policy_kind("nope")


def test_specs_fields_match_reference():
    """Every spec keeps the reference's fields and defaults (TraceConfig's
    device profiler directory is named for torch)."""
    tree = ast.parse((ROOT / "src/repro/api/specs.py").read_text())
    ref = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            ref[node.name] = [s.target.id for s in node.body
                              if isinstance(s, ast.AnnAssign)]
        if isinstance(node, ast.Assign) and node.targets[0].id in (
                "BACKENDS", "SIM_BACKENDS", "MODES"):
            assert getattr(api, node.targets[0].id) == \
                ast.literal_eval(node.value)
    for cls in ("PolicySpec", "WorkloadSpec", "ExecSpec"):
        got = [f.name for f in dataclasses.fields(getattr(api, cls))]
        assert got == ref[cls], cls
    jt = [f.name for f in dataclasses.fields(JTR.TraceConfig)]
    tt = [f.name for f in dataclasses.fields(TTR.TraceConfig)]
    assert tt == [("profiler_dir" if n == "jax_profiler_dir" else n)
                  for n in jt]
    for f in ("metrics_path", "profile_decisions", "profile_iters"):
        assert getattr(TTR.TraceConfig(), f) == getattr(JTR.TraceConfig(), f)
    assert [f.name for f in dataclasses.fields(TS.StreamConfig)] == \
        [f.name for f in dataclasses.fields(JS.StreamConfig)]
    assert TS.StreamConfig().chunk_size == JS.StreamConfig().chunk_size == 0


def test_resolve_provenance():
    rp = api.resolve("fifo", TECFG, device="cpu")
    assert rp.trained and rp.kind == "baseline" and rp.program is not None
    with pytest.warns(api.UntrainedPolicyWarning):
        rp = api.resolve(api.PolicySpec("eat", options={"acfg": TAG.AgentConfig(
            **ACFG)}), TECFG, device="cpu")
    assert not rp.trained and rp.meta["sampler"] == "ddpm"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rp2 = api.resolve(api.PolicySpec("ppo", params=rp.params),
                          TECFG, device="cpu")
    assert rp2.trained and rp2.params is rp.params
    # a fresh init is a function of spec.seed alone
    a = _quiet(api.resolve, api.PolicySpec("ppo", seed=3), TECFG, device="cpu")
    b = _quiet(api.resolve, api.PolicySpec("ppo", seed=3), TECFG, device="cpu")
    assert torch.equal(a.params["actor"]["layers"][0]["w"],
                       b.params["actor"]["layers"][0]["w"])


@pytest.mark.parametrize("case", [
    "sharded", "fused_impl", "backend", "serving_batch", "placement_episodic",
    "arch_not_ported", "missing_checkpoint", "distilled_without_student",
    "offline_without_trace", "stream_train_distilled"])
def test_refusals(case, tmp_path):
    sc = _scenario()
    if case == "sharded":
        with pytest.raises(NotImplementedError, match="item 15"):
            api.rollout_fn_for(api.ExecSpec(backend="sharded"))
    elif case == "fused_impl":
        with pytest.raises(ValueError, match="fused_impl"):
            api.ExecSpec(fused_impl="pallas")
    elif case == "backend":
        with pytest.raises(ValueError, match="backend must be one of"):
            api.ExecSpec(backend="tpu")
    elif case == "serving_batch":
        with pytest.raises(ValueError, match="ONE physical cluster"):
            _sim(api.WorkloadSpec.episodic(sc, batch=2), backend="serving",
                 serving_archs=("tinyllama-1.1b",))
    elif case == "placement_episodic":
        with pytest.raises(ValueError, match="streaming-only"):
            _sim(api.WorkloadSpec.episodic(sc, batch=2),
                 placement=TPS(policy="forecast"))
    elif case == "arch_not_ported":
        # every arch of the zoo is ported: the default (the reference's
        # ASSIGNED_ARCHS) and olmoe build; an unknown arch is refused
        fn = api.rollout_fn_for(api.ExecSpec(backend="serving"))
        assert fn.backend == "serving"
        api.rollout_fn_for(api.ExecSpec(backend="serving",
                                        serving_archs=("olmoe-1b-7b",)))
        with pytest.raises(KeyError, match="unknown arch"):
            api.rollout_fn_for(api.ExecSpec(
                backend="serving", serving_archs=("no-such-arch",)))
    elif case == "missing_checkpoint":
        with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
            api.resolve(api.PolicySpec("ppo", checkpoint=str(tmp_path)),
                        TECFG, device="cpu")
    elif case == "distilled_without_student":
        p = TAG.init_actor(TECFG, TAG.AgentConfig(**ACFG), device="cpu")
        with pytest.raises(ValueError, match="needs params\\['student'\\]"):
            api.resolve(api.PolicySpec(
                "eat", params=p, sampler="distilled",
                options={"acfg": TAG.AgentConfig(**ACFG)}), TECFG,
                device="cpu")
    elif case == "offline_without_trace":
        with pytest.raises(ValueError, match="optimises an action sequence"):
            api.resolve("genetic", TECFG, device="cpu")
    elif case == "stream_train_distilled":
        from repro_torch.training.stream_train import StreamTrainConfig
        with pytest.raises(ValueError, match="distilled"):
            StreamTrainConfig(sampler="distilled")


# ------------------------------------------------------------- checkpoints
def test_reference_checkpoint_restored_through_policy_spec(tmp_path):
    """A reference actor saved by the reference's `save_checkpoint` resolves
    through `PolicySpec("eat", checkpoint=...)` to the same weights and,
    on the reference's draws, the same actions; the resolved policy acts as
    `actor_sample` does on the restored weights."""
    jacfg, tacfg = JAG.AgentConfig(**ACFG), TAG.AgentConfig(**ACFG)
    jp = JAG.init_actor(jax.random.PRNGKey(5), JECFG, jacfg)
    jsave_checkpoint(str(tmp_path), 3, jp)
    rp = api.resolve(api.PolicySpec("eat", checkpoint=str(tmp_path),
                                    options={"acfg": tacfg}), TECFG,
                     device="cpu")
    assert rp.trained
    for path, leaf in TCK.tree_paths(rp.params).items():
        want = np.asarray(TCK.tree_paths(jax.tree_util.tree_map(
            np.asarray, jp))[path])
        np.testing.assert_array_equal(leaf.numpy(), want, path)
    obs = np.random.default_rng(0).random((5,) + JECFG.obs_shape,
                                          dtype=np.float32)
    key = jax.random.PRNGKey(9)
    want = JAG.actor_sample(jp, jacfg, JECFG, JDF.vp_schedule(3),
                            jnp.asarray(obs), key, deterministic=True)
    kd, _ = jax.random.split(key)
    kx, kn = jax.random.split(kd)
    A = JECFG.action_dim
    x_T = torch.from_numpy(np.array(jax.random.normal(kx, (5, A))))
    noises = torch.from_numpy(np.array(jax.random.normal(kn, (3, 5, A))))
    got = TAG.actor_sample(rp.params, tacfg, TECFG,
                           TDF.vp_schedule(3, device="cpu"),
                           torch.from_numpy(obs), deterministic=True,
                           x_T=x_T, noises=noises)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=2e-5)
    env_a, _ = rp.policy(rp.params, torch.Generator().manual_seed(4), None,
                         None, torch.from_numpy(obs))
    a, *_ = TAG.actor_sample(rp.params, tacfg, TECFG,
                             TDF.vp_schedule(3, device="cpu"),
                             torch.from_numpy(obs), deterministic=True,
                             generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(env_a, TAG.to_env_action(a), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("fault", ["missing_key", "shape", "none"])
def test_restore_checkpoint(tmp_path, fault):
    target = {"a": torch.zeros(3, dtype=torch.float64),
              "b": [torch.zeros(2, 2)]}
    saved = {"a": np.arange(3.0, dtype=np.float32),
             "b": [np.ones((2, 2), np.float32)]}
    if fault == "missing_key":
        saved = {"a": saved["a"]}
    elif fault == "shape":
        saved["b"] = [np.ones((3, 2), np.float32)]
    jsave_checkpoint(str(tmp_path), 1, saved)
    if fault == "missing_key":
        with pytest.raises(KeyError, match="b/0"):
            api.restore_params(str(tmp_path), target)
    elif fault == "shape":
        with pytest.raises(ValueError, match="shape"):
            api.restore_params(str(tmp_path), target)
    else:
        got = api.restore_params(str(tmp_path), target)
        assert got["a"].dtype == torch.float64 and got["a"].tolist() == \
            [0.0, 1.0, 2.0]
        assert torch.equal(got["b"][0], torch.ones(2, 2))
        got = api.restore_params(str(tmp_path), target, step=1)
        assert torch.equal(got["b"][0], torch.ones(2, 2))


# ------------------------------------------------------------- episodic
@pytest.mark.parametrize("name", ["fifo", "greedy"])
@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_episodic_matches_reference_rollout(name, backend):
    """Simulator episodic fifo / greedy == the reference's batch_rollout on
    the Simulator's traces (exact on ints and the clock)."""
    sc = _scenario()
    res = _sim(api.WorkloadSpec.episodic(sc, batch=B), backend=backend).run(
        name, 7)
    traces, _ = _sim_traces(sc, 7)
    jpol = (JRO.fifo_policy if name == "fifo" else JRO.greedy_policy)(JECFG)
    want = JRO.batch_rollout(JECFG, {k: jnp.asarray(v.numpy())
                                     for k, v in traces.items()}, jpol, {},
                             jax.random.split(jax.random.PRNGKey(0), B),
                             fused_impl="ref")
    _close_metrics(want.metrics, res.metrics, f"{name} {backend}")
    for f in JEV.EnvState._fields:
        a = np.asarray(getattr(want.final_state, f))
        b = getattr(res.raw.final_state, f).numpy()
        if f == "task_quality":
            np.testing.assert_allclose(b, a, atol=FLOAT_TOL, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert res.summary["n_episodes"] == B and res.backend == backend
    assert res.summary["mean_num_scheduled"] == float(
        np.mean(res.metrics["num_scheduled"]))


def _policy_spec(name):
    opts = {"acfg": TAG.AgentConfig(**ACFG)} if name == "eat" else {}
    if name == "genetic":
        opts = {"population": 4, "generations": 2, "parents": 2, "elites": 1,
                "seq_len": 32}
    if name == "harmony":
        opts = {"memory_size": 4, "improvisations": 4, "improv_batch": 2,
                "seq_len": 32}
    return api.PolicySpec(name, options=opts, seed=2)


@pytest.mark.parametrize("name", ["random", "fifo", "greedy", "eat", "ppo",
                                  "genetic", "harmony"])
def test_episodic_equals_direct_rollout(name):
    """Every registered policy through the Simulator == a direct
    batch_rollout on the same traces and generator state, every tensor;
    the collected transitions too."""
    sc = _scenario()
    wl = api.WorkloadSpec.episodic(sc, batch=B, num_steps=40, collect=True)
    res = _quiet(_sim(wl).run, _policy_spec(name), 11)
    rp = _quiet(api.Simulator(wl, device="cpu").resolve, _policy_spec(name))
    traces, g_run = _sim_traces(sc, 11)
    want = TRO.batch_rollout(TECFG, traces, rp.policy, rp.params,
                             generator=g_run, num_steps=40, collect=True,
                             device="cpu")
    for k, v in want.metrics.items():
        np.testing.assert_array_equal(res.metrics[k], v.numpy(), k)
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(res.raw.final_state, f),
                           getattr(want.final_state, f)), f
    for f in TRO.Transitions._fields[:-1]:
        assert torch.equal(getattr(res.raw.transitions, f),
                           getattr(want.transitions, f)), f
    assert res.trained == (name not in ("eat", "ppo"))


def test_episodic_faults_and_evaluate_batch():
    """Faults attach window 0 of the timeline to the episodic traces on
    both sides; `evaluate_batch` (and its deprecated wrapper) equal the
    Simulator's rollout on explicit traces."""
    from repro_torch.core import baselines as TBL
    from repro_torch.faults import FaultTimeline, fault_horizon
    sc = _scenario()
    spec = TFS.chaos(1)
    res = _sim(api.WorkloadSpec.episodic(sc, batch=B), faults=spec).run(
        "greedy", 5)
    traces, _ = _sim_traces(sc, 5)
    fa = FaultTimeline(spec, E, B).window_arrays(
        0, np.zeros(B), fault_horizon(TECFG.time_limit, spec))
    ftr = dict(traces, **{k: torch.from_numpy(v) for k, v in fa.items()})
    jpol = JRO.greedy_policy(JECFG)
    want = JRO.batch_rollout(JECFG, {k: jnp.asarray(v.numpy())
                                     for k, v in ftr.items()}, jpol, {},
                             jax.random.split(jax.random.PRNGKey(0), B),
                             fused_impl="ref")
    _close_metrics(want.metrics, res.metrics, "greedy faults")
    assert "num_failed" in res.metrics
    got = api.evaluate_batch(TECFG, traces, "greedy",
                             exec_spec=api.ExecSpec(faults=spec),
                             device="cpu")
    for k in got:
        np.testing.assert_array_equal(got[k], res.metrics[k], k)
    with pytest.warns(DeprecationWarning, match="evaluate_batch"):
        old = TBL.evaluate_policy_batch(TECFG, traces, TRO.fifo_policy(TECFG),
                                        device="cpu")
    new = api.evaluate_batch(TECFG, traces, TRO.fifo_policy(TECFG),
                             device="cpu")
    for k in new:
        np.testing.assert_array_equal(old[k], new[k], k)


def test_sweep_policies_take_split_children():
    sc = _scenario()
    sim = _sim(api.WorkloadSpec.episodic(sc, batch=2))
    got = sim.sweep(["random", "random"], 3)
    kids = split_generator(torch.Generator().manual_seed(3), 2)
    for r, g in zip(got, kids):
        want = sim.run("random", g)
        np.testing.assert_array_equal(r.metrics["episode_return"],
                                      want.metrics["episode_return"])
    assert not np.array_equal(got[0].metrics["episode_return"],
                              got[1].metrics["episode_return"])


# ------------------------------------------------------------- streaming
def _recording(src):
    """Record each refill of a reference task source in the port's
    `draws=` layout (as tests/test_torch_stream.py does)."""
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


STREAM_CASES = {
    "fifo": ("fifo", {}),
    "greedy-faults-placement": ("greedy", dict(
        faults=dict(seed=3, mtbf=120.0, mttr=30.0, straggler_prob=0.25,
                    straggler_factor=3.0, max_retries=2, backoff_base=1.0,
                    backoff_cap=16.0, retry_deadline=600.0),
        placement=dict(policy="forecast", interval=2))),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streaming_matches_reference_runner(case, monkeypatch):
    """Simulator streaming == the reference's StreamRunner on the same
    refills: per-window records and stats, the summary's integer ledger."""
    name, kw = STREAM_CASES[case]
    rate, windows, streams = 0.2, 3, 2
    key = jax.random.PRNGKey(0)
    jsrc = JS.ProcessTaskSource(JPoisson(rate=rate), JTC(num_tasks=K), key,
                                num_streams=streams)
    rec = _recording(jsrc)
    jkw, tkw = {}, {}
    if "faults" in kw:
        jkw["faults"], tkw["faults"] = (JFS(**kw["faults"]),
                                        TFS(**kw["faults"]))
    if "placement" in kw:
        jkw["placement"], tkw["placement"] = (JPS(**kw["placement"]),
                                              TPS(**kw["placement"]))
    jpol = (JRO.fifo_policy if name == "fifo" else JRO.greedy_policy)(JECFG)
    jr = JS.StreamRunner(JECFG, jpol, None, jsrc, key,
                         JS.StreamConfig(num_streams=streams, **jkw))
    jstats = [jr.run_window().stats for _ in range(windows)]

    def replay(proc, tc, generator, num_streams, chunk_size, device):
        return TS.ProcessTaskSource(None, tc, draws=rec,
                                    num_streams=num_streams)
    monkeypatch.setattr(SIM, "ProcessTaskSource", replay)
    sc = _scenario(rate=rate)
    wl = api.WorkloadSpec.streaming(sc, streams=streams, num_windows=windows)
    res = _sim(wl, **tkw).run(name, 0)
    for w, (a, b) in enumerate(zip(jr.per_window, res.per_window)):
        assert set(a) == set(b), w
        for k in a:
            if k in ("mean_latency", "episode_return_mean"):
                assert b[k] == pytest.approx(a[k], rel=RTOL, abs=FLOAT_TOL)
            else:
                assert a[k] == b[k], (w, k)
    js = jr.result().summary
    for k in ("tasks_injected", "tasks_scheduled", "tasks_dropped",
              "tasks_leftover", "tasks_failed_pending_retry"):
        assert res.summary[k] == js[k], k
    assert len(jstats) == windows
    assert res.summary["arrival"] == "PoissonArrivals"
    if "placement" in kw:
        assert jr.placement_counters()["placement_decisions"] == \
            res.raw.placement_counters["placement_decisions"]
    if "faults" in kw:
        assert jr.fault_counters() == res.raw.fault_counters


@pytest.mark.parametrize("name", ["fifo", "eat"])
def test_streaming_equals_direct_run_stream(name):
    """Simulator streaming == `run_stream` on a source and generator made
    by the documented rule, every record and the final carry."""
    sc = _scenario(rate=0.1)
    wl = api.WorkloadSpec.streaming(sc, streams=2, num_windows=2,
                                    chunk_size=12, collect=True)
    spec = _policy_spec(name)
    res = _quiet(_sim(wl).run, spec, 4)
    rp = _quiet(api.Simulator(wl, device="cpu").resolve, spec)
    g_data, g_run, _ = split_generator(torch.Generator().manual_seed(4), 3)
    src = TS.ProcessTaskSource(sc.arrival or SIM.PoissonArrivals(0.1),
                               sc.tcfg, g_data, num_streams=2, chunk_size=12,
                               device="cpu")
    want = TS.run_stream(TECFG, rp.policy, rp.params, src, g_run,
                         TS.StreamConfig(num_windows=2, num_streams=2,
                                         chunk_size=12), collect=True,
                         device="cpu")
    assert res.per_window == want.per_window
    for f in TEV.EnvState._fields:
        assert torch.equal(getattr(res.raw.final_carry, f),
                           getattr(want.final_carry, f)), f
    for a, b in zip(res.raw.transitions, want.transitions):
        assert torch.equal(a.action, b.action) and torch.equal(a.obs, b.obs)


def test_telemetry_profile_and_metrics_files(tmp_path):
    """A traced run with `profile_decisions` and `metrics_path`: the summary
    has the host-clock decision latencies, the trace passes the strict
    schema, and both metrics snapshots are written."""
    TTR.reset_tracers()
    tcfg = TTR.TraceConfig(enabled=True, path=str(tmp_path / "t.json"),
                           metrics_path=str(tmp_path / "m.prom"),
                           profile_decisions=True, profile_iters=4)
    sc = _scenario()
    wl = api.WorkloadSpec.streaming(sc, streams=2, num_windows=2)
    res = _sim(wl, trace=tcfg).run("greedy", 0)
    assert res.summary["decision_latency_n"] == 4.0
    assert res.summary["decision_latency_p50_s"] > 0
    assert not TSCH.validate_trace(str(tmp_path / "t.json"),
                                   strict_names=True)
    names = {e["name"] for e in json.load(open(tmp_path / "t.json"))[
        "traceEvents"]}
    assert {"run", "resolve_policy", "profile_decisions", "window"} <= names
    parsed = TMET.parse_prometheus((tmp_path / "m.prom").read_text())
    assert any(k.startswith("eat_stream_") for k in parsed), sorted(parsed)
    assert (tmp_path / "m.prom.jsonl").read_text().strip()
    TTR.reset_tracers()


def test_profile_policy_reads_the_host_clock(monkeypatch):
    """`profile_policy` times each decision by `time.perf_counter()` (the
    reference's measure): a clock that advances 1 ms per read gives 1 ms
    decisions, and the summary has the reference's keys only."""
    ticks = iter(np.arange(0.0, 10.0, 1e-3))
    monkeypatch.setattr(TPROF.time, "perf_counter", lambda: float(next(ticks)))
    out = TPROF.profile_policy(TECFG, TRO.fifo_policy(TECFG), {},
                               torch.Generator(), iters=5, device="cpu")
    assert out["decision_latency_mean_s"] == pytest.approx(1e-3)
    assert set(out) == {"decision_latency_p50_s", "decision_latency_p95_s",
                        "decision_latency_p99_s", "decision_latency_mean_s",
                        "decision_latency_n"}


# ------------------------------------------------------------- sweep
def test_sweep_rows_in_reference_schema(tmp_path):
    """run_sweep rows carry the reference's keys: the facade's row keys,
    the reference stream summary's keys and the sweep's own."""
    jsrc = JS.ProcessTaskSource(JPoisson(rate=0.1), JTC(num_tasks=K),
                                jax.random.PRNGKey(0), num_streams=2)
    jsum = JS.run_stream(JECFG, JRO.fifo_policy(JECFG), None, jsrc,
                         jax.random.PRNGKey(1),
                         JS.StreamConfig(num_windows=1, num_streams=2)
                         ).summary
    cells = [_scenario("a", 0.1), _scenario("b", 0.2)]
    out = tmp_path / "rows.json"
    rows = TSW.run_sweep(cells, ["fifo", "greedy"], 0,
                         stream=TS.StreamConfig(num_windows=1, num_streams=2),
                         out=str(out), verbose=False, device="cpu")
    want = ({"policy", "trained", "mode", "exec_backend", "cell", "wall_s",
             "arrival", "num_servers", "tasks_per_wall_s"} | set(jsum))
    assert [r["cell"] for r in rows] == ["a", "a", "b", "b"]
    for r in rows:
        assert set(r) == want, set(r) ^ want
        assert r["exec_backend"] == "fused" and r["trained"]
    assert len(json.load(open(out))) == 4
    row = TSW.run_cell(cells[0], "fifo", 0,
                       stream=TS.StreamConfig(num_windows=1, num_streams=2,
                                              fused=False), device="cpu")
    assert row["exec_backend"] == "reference"


def test_make_policy_wrapper_warns_and_delegates():
    from repro_torch.traffic import policies as TPOLS
    assert TPOLS.available_policies() == ("random", "fifo", "greedy", "eat",
                                          "ppo")
    with pytest.warns(DeprecationWarning, match="make_policy is deprecated"):
        pol, params = TPOLS.make_policy("greedy", TECFG, device="cpu")
    assert pol is TRO.greedy_policy(TECFG) and params == {}


# ------------------------------------------------------------- hook-ups
def test_training_collection_through_exec_spec():
    """sac.collect_batch and train_ppo take an ExecSpec: the reference and
    fused backends collect the same transitions."""
    acfg = TAG.AgentConfig(**ACFG)
    traces, _ = _sim_traces(_scenario(), 2)
    params = TAG.init_actor(TECFG, acfg, device="cpu")
    got = []
    for backend in ("reference", "fused"):
        buf = TRP.ReplayBuffer(1000, TECFG.obs_shape, TECFG.action_dim)
        m, n = TSAC.collect_batch(TECFG, acfg, params, traces,
                                  torch.Generator().manual_seed(1), buf,
                                  exec_spec=api.ExecSpec(backend=backend),
                                  device="cpu")
        got.append((buf.sample(np.random.default_rng(0), 16), n))
    assert got[0][1] == got[1][1] > 0
    for k in got[0][0]:
        np.testing.assert_array_equal(got[0][0][k], got[1][0][k], k)

    def trace_fn(g, b):
        return TSC.make_scenario_trace_batch(_scenario(), b, generator=g,
                                             device="cpu")
    runs = [TPPO.train_ppo(TECFG, TPPO.PPOConfig(epochs=1), trace_fn, 2,
                           num_envs=2, log_every=0, device="cpu",
                           exec_spec=api.ExecSpec(backend=b))[1]
            for b in ("reference", "fused")]
    assert [h["episode_return"] for h in runs[0]] == \
        [h["episode_return"] for h in runs[1]]
