"""The port's sharded execution backend (`api.backends`, `ExecSpec(backend=
"sharded")`) on the CPU, where a mesh may hold any number of shards of
the host.

* fifo and greedy draw nothing: at 1, 2, 4 and 8 shards the sharded run
  equals the port's fused run in every tensor, and the reference's fused
  `batch_rollout` as the port's rollout tests hold it (integers, booleans
  and the clock exactly, quality-derived floats at 1e-6). The reference's
  own sharded backend cannot be imported on this tree (its `shard_map`
  deprecation), so its fused engine, which it equals, stands in.
* random and ddpm draw: one shard equals fused on the caller's generator;
  n shards equal the concatenation of n fused runs on the batch's slices,
  run s drawing from child s of `split_generator(generator, n)`.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import env as JEV
from repro.core import rollout as JRO
from repro_torch import api
from repro_torch.actors import policies as TPOL
from repro_torch.actors.program import actor_program
from repro_torch.api.simulator import split_generator
from repro_torch.core import agent as TAG
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core import sac as TSAC
from repro_torch.core import scenarios as TSC
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.workload import TraceConfig as TTC
from repro_torch.faults import FaultSpec
from repro_torch.launch import mesh as TMX
from repro_torch.training import stream_train as ST
from test_torch_rollout import (_assert_metrics, _assert_state, _np_traces,
                                _to_jax, _to_torch)

E, K, B = 4, 8, 16
ENV = dict(num_servers=E, max_tasks=K, queue_window=4, max_steps=40)
JECFG, TECFG = JEV.EnvConfig(**ENV), TEV.EnvConfig(**ENV)
ACFG = TAG.AgentConfig(T=3, hidden=32)


def _sharded(n=0, **kw):
    return api.rollout_fn_for(api.ExecSpec(backend="sharded", mesh_devices=n,
                                           **kw))


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


def _equal(a, b, ctx=""):
    """Every tensor of two RolloutResults (or trees of them) equal."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), ctx
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), ctx
        for k in a:
            _equal(a[k], b[k], f"{ctx}/{k}")
    elif a is None:
        assert b is None, ctx
    else:
        assert type(a) is type(b) and len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{ctx}/{getattr(a, '_fields', range(99))[i]}")


def _policy(name):
    if name == "fifo":
        return TRO.fifo_policy(TECFG), {}, JRO.fifo_policy(JECFG)
    if name == "greedy":
        return TRO.greedy_policy(TECFG), {}, JRO.greedy_policy(JECFG)
    if name == "random":
        return TRO.uniform_policy(TECFG), {}, None
    params = TAG.init_actor(TECFG, ACFG, generator=_gen(9), device="cpu")
    return (TPOL.actor_policy(TECFG, ACFG, sampler="ddpm", device="cpu"),
            params, None)


@pytest.mark.parametrize("name", ["fifo", "greedy"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_deterministic_policies_equal_fused_and_reference(name, n):
    tr = _np_traces(31, B, K, E)
    pol, params, jpol = _policy(name)
    fused = TRO.batch_rollout(TECFG, _to_torch(tr), pol, params,
                              device="cpu", collect=True)
    got = _sharded(n)(TECFG, _to_torch(tr), pol, params, device="cpu",
                      collect=True)
    _equal(got, fused, f"{name} n={n}")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jr = JRO.batch_rollout(JECFG, _to_jax(tr), jpol, {}, keys,
                           fused_impl="ref")
    ctx = f"{name} n={n} vs the reference"
    _assert_state(jr.final_state, got.final_state, ctx)
    _assert_metrics(jr.metrics, got.metrics, ctx)
    assert int(got.metrics["num_scheduled"].sum()) > 0


@pytest.mark.parametrize("name", ["random", "ddpm"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_drawing_policies_follow_the_generator_rule(name, n):
    tr = _to_torch(_np_traces(32, B, K, E))
    pol, params, _ = _policy(name)
    got = _sharded(n)(TECFG, tr, pol, params, generator=_gen(), device="cpu",
                      collect=True, num_steps=24)
    gens = [_gen()] if n == 1 else split_generator(_gen(), n)
    b = B // n
    parts = [TRO.batch_rollout(TECFG, {k: v[s * b:(s + 1) * b]
                                       for k, v in tr.items()},
                               pol, params, generator=gens[s], device="cpu",
                               collect=True, num_steps=24)
             for s in range(n)]
    want = parts[0] if n == 1 else TRO.RolloutResult(
        metrics={k: torch.cat([p.metrics[k] for p in parts])
                 for k in parts[0].metrics},
        final_state=TEV.EnvState(*(torch.cat(x) for x in zip(
            *(p.final_state for p in parts)))),
        transitions=TRO.Transitions(
            *(torch.cat(x) for x in zip(*(p.transitions[:-1]
                                         for p in parts))),
            extras={k: torch.cat([p.transitions.extras[k] for p in parts])
                    for k in parts[0].transitions.extras}))
    _equal(got, want, f"{name} n={n}")
    if n > 1:
        # the shards share one decision loop on one device, and shard 2's
        # run did not overwrite shard 1's results
        assert actor_program(TECFG, pol).loops_built >= 1
        t = got.transitions.action
        assert not torch.equal(t[:b], t[b:2 * b])


def test_carried_state_and_transitions():
    tr = _to_torch(_np_traces(33, B, K, E))
    pol = TRO.greedy_policy(TECFG)
    first = TRO.batch_rollout(TECFG, tr, pol, {}, device="cpu", num_steps=6)
    fused = TRO.batch_rollout(TECFG, tr, pol, {}, device="cpu", num_steps=9,
                              collect=True, init_state=first.final_state)
    for n in (2, 4):
        got = _sharded(n)(TECFG, tr, pol, {}, device="cpu", num_steps=9,
                          collect=True, init_state=first.final_state)
        _equal(got, fused, f"init_state n={n}")
        assert got.transitions.obs.shape[:2] == (B, 9)


def _cell(rate=0.1):
    return TSC.Scenario("sharded-cell", TECFG, TTC(num_tasks=K,
                                                   arrival_rate=rate,
                                                   max_servers=E))


@pytest.mark.parametrize("name,n", [("fifo", 2), ("greedy", 4),
                                    ("random", 1)])
def test_stream_windows_carry_state(name, n):
    """Two stream windows through `StreamRunner` (the Simulator's
    streaming mode): the second window resumes from a carried state that
    the backend splits by stream."""
    wl = api.WorkloadSpec.streaming(_cell(), streams=8, num_windows=2,
                                    window_tasks=K)
    runs = {}
    for backend, kw in (("fused", {}), ("sharded", {"mesh_devices": n})):
        sim = api.Simulator(wl, api.ExecSpec(backend=backend, **kw),
                            device="cpu")
        runs[backend] = sim.run(name, 3)
    a, b = runs["fused"], runs["sharded"]
    assert b.backend == "sharded" and len(b.per_window) == 2
    assert a.per_window == b.per_window
    assert a.summary == b.summary


def test_fault_trace_and_simulator_episodic():
    spec = FaultSpec.chaos(5)
    wl = api.WorkloadSpec.episodic(_cell(0.08), batch=8, num_steps=32)
    runs = {b: api.Simulator(wl, api.ExecSpec(backend=b, faults=spec,
                                              mesh_devices=4),
                             device="cpu").run("greedy", 21)
            for b in ("fused", "sharded")}
    assert runs["fused"].metrics["num_failed"].sum() > 0
    assert runs["fused"].summary == runs["sharded"].summary
    _equal(runs["sharded"].raw, runs["fused"].raw, "chaos")


def test_fallback_warning_and_mesh_argument():
    tr = _to_torch(_np_traces(34, 6, K, E))
    pol = TRO.fifo_policy(TECFG)
    fused = TRO.batch_rollout(TECFG, tr, pol, {}, device="cpu")
    with pytest.warns(UserWarning, match="batch 6 does not divide over 4 "
                      "devices; degrading to a 2-device mesh"):
        got = _sharded(4)(TECFG, tr, pol, {}, device="cpu")
    _equal(got, fused, "gcd fallback")
    assert api.resolve_shards(6, api.ExecSpec(backend="sharded",
                                              mesh_devices=4),
                              device="cpu") == 2
    assert api.resolve_shards(6, api.ExecSpec(backend="sharded"),
                              device="cpu") == 1
    assert api.device_count("cpu") == 1
    mesh = TMX.make_data_mesh(("cpu",) * 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = api.rollout_fn_for(api.ExecSpec(backend="sharded"),
                                 mesh=mesh)(TECFG, tr, pol, {}, device="cpu")
    _equal(got, fused, "an explicit mesh of 3")


def test_sac_collection_and_stream_training_on_sharded():
    tr = _to_torch(_np_traces(35, 8, K, E))
    params = TAG.init_actor(TECFG, ACFG, generator=_gen(9), device="cpu")
    out = []
    for spec in (api.ExecSpec(), api.ExecSpec(backend="sharded")):
        buf = ReplayBuffer(4096, TECFG.obs_shape, TECFG.action_dim)
        m, n = TSAC.collect_batch(TECFG, ACFG, params, tr, _gen(), buf,
                                  exec_spec=spec, device="cpu")
        out.append((m, n, buf))
    (ma, na, ba), (mb, nb, bb) = out
    assert na == nb > 0
    _equal(ma, mb, "collect metrics")
    for k in ("obs", "action", "reward"):
        np.testing.assert_array_equal(getattr(ba, k)[:na],
                                      getattr(bb, k)[:nb])
    stcfg = ST.StreamTrainConfig(rounds=2, streams=2,
                                 max_updates_per_round=2)
    scfg = TSAC.SACConfig(batch_size=16, warmup_steps=24)
    res = [ST.train_stream_sac(TECFG, ACFG, scfg, stcfg, scenario=_cell(),
                               seed=1, exec_spec=spec, device="cpu")
           for spec in (api.ExecSpec(), api.ExecSpec(backend="sharded"))]
    assert [r["transitions"] for r in res[0].history] == \
        [r["transitions"] for r in res[1].history]
    assert torch.equal(res[0].state.actor["denoiser"]["layers"][0]["w"],
                       res[1].state.actor["denoiser"]["layers"][0]["w"])
