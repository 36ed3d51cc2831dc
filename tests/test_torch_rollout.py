"""The port's batched rollout (`repro_torch.core.rollout`) against the
reference's fused engine on the CPU, plus the port's import and device
rules.

Rollout parity has two forms. A deterministic policy (fifo) runs closed
loop on both sides from the same numpy traces. A learned or random policy
forks once one ulp flips a discrete choice, so the reference's collected
actions are replayed through the port (teacher forcing). Either way every
integer, boolean and clock value must be equal; quality, obs and reward
(and the float metrics built from them) pass through exp and reordered sums
and are held to 1e-6 (absolute) and 1e-5 (relative, rewards).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actors.policies import actor_policy as jactor_policy
from repro.core import agent as JAG
from repro.core import env as JEV
from repro.core import rollout as JRO
from repro_torch.common import checkpoint as TCK
from repro_torch.core import agent as TAG
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core import workload as TWL
from repro_torch.actors import policies as TPOL

ROOT = Path(__file__).resolve().parents[1]
FLOAT_TOL = 1e-6
REWARD_RTOL = 1e-5
INT_METRICS = ("num_scheduled", "num_done", "num_failed", "episode_len")


def _cfgs(E, K, num_models=1, max_steps=64):
    ms = (1.0, 0.5) if num_models > 1 else ()
    kw = dict(num_servers=E, max_tasks=K, queue_window=4, max_steps=max_steps,
              num_models=num_models, model_scale=ms)
    return JEV.EnvConfig(**kw), TEV.EnvConfig(**kw)


def _np_traces(seed, B, K, E, num_models=1, rate=0.08, faults=False, F=2):
    rng = np.random.default_rng(seed)
    support = np.array([c for c in (1, 2, 4, 8) if c <= E])
    probs = np.array([0.35, 0.35, 0.2, 0.1])[:len(support)]
    gaps = (rng.exponential(size=(B, K)) / rate).astype(np.float32)
    tr = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
          "c": rng.choice(support, (B, K), p=probs / probs.sum()).astype(np.int32),
          "model": rng.integers(0, num_models, (B, K)).astype(np.int32),
          "noise": (0.004 * rng.standard_normal((B, K))).astype(np.float32)}
    if faults:
        ds = rng.uniform(0.0, 150.0, (B, E, F)).astype(np.float32)
        de = (ds + rng.uniform(5.0, 40.0, (B, E, F))).astype(np.float32)
        pad = rng.random((B, E, F)) < 0.5
        tr["f_down_start"] = np.where(pad, 1e30, ds).astype(np.float32)
        tr["f_down_end"] = np.where(pad, 1e30, de).astype(np.float32)
        tr["f_slow"] = rng.uniform(1.0, 1.5, (B, E)).astype(np.float32)
        tr["f_cold"] = np.ones((B, 1), np.float32)
    return tr


def _to_jax(tr):
    return {k: jnp.asarray(v) for k, v in tr.items()}


def _to_torch(tr):
    return {k: torch.from_numpy(np.array(v)) for k, v in tr.items()}


def _assert_state(js, ts, ctx):
    for f in JEV.EnvState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if f == "task_quality":
            np.testing.assert_allclose(b, a, atol=FLOAT_TOL, err_msg=f"{ctx} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {f}")


def _assert_metrics(jm, tm, ctx):
    assert set(jm) == set(tm), ctx
    for k in jm:
        a, b = np.asarray(jm[k]), tm[k].numpy()
        if k in INT_METRICS:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {k}")
        elif k == "episode_return":
            np.testing.assert_allclose(b, a, rtol=REWARD_RTOL, atol=FLOAT_TOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=f"{ctx} {k}")


@pytest.mark.parametrize("E,K,num_models,faults", [
    (4, 8, 1, False), (8, 16, 2, False), (4, 12, 1, True)])
def test_fifo_closed_loop_matches_reference(E, K, num_models, faults):
    jcfg, tcfg = _cfgs(E, K, num_models)
    tr = _np_traces(E + K, 4, K, E, num_models, faults=faults)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jr = JRO.batch_rollout(jcfg, _to_jax(tr), JRO.fifo_policy(jcfg), {}, keys,
                           fused_impl="ref")
    tr_ = TRO.batch_rollout(tcfg, _to_torch(tr), TRO.fifo_policy(tcfg), {},
                            device="cpu")
    ctx = f"fifo E={E} K={K} nm={num_models} faults={faults}"
    _assert_state(jr.final_state, tr_.final_state, ctx)
    _assert_metrics(jr.metrics, tr_.metrics, ctx)
    assert int(np.asarray(jr.metrics["num_scheduled"]).sum()) > 0


def _assert_teacher(tcfg, tr, jr, num_steps, ctx):
    """Replay the reference's collected actions through the port."""
    seq = torch.from_numpy(np.array(jr.transitions.action))
    got = TRO.batch_rollout(tcfg, _to_torch(tr), TRO.sequence_policy(tcfg),
                            {"seq": seq}, num_steps=num_steps, collect=True,
                            device="cpu")
    _assert_state(jr.final_state, got.final_state, ctx)
    _assert_metrics(jr.metrics, got.metrics, ctx)
    jt = jax.tree_util.tree_map(np.asarray, jr.transitions)
    for f in ("valid", "done"):
        np.testing.assert_array_equal(getattr(got.transitions, f).numpy(),
                                      getattr(jt, f), err_msg=f"{ctx} {f}")
    v = jt.valid                   # after done the replay repeats its last row
    np.testing.assert_array_equal(got.transitions.action.numpy()[v],
                                  jt.action[v], err_msg=f"{ctx} action")
    for f in ("obs", "next_obs"):
        np.testing.assert_allclose(getattr(got.transitions, f).numpy(),
                                   getattr(jt, f), atol=FLOAT_TOL,
                                   err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(got.transitions.reward.numpy(), jt.reward,
                               rtol=REWARD_RTOL, atol=FLOAT_TOL, err_msg=ctx)

@pytest.mark.parametrize("sampler", ["ddpm", "ddim:2"])
def test_eat_teacher_forced_matches_reference(sampler):
    """The reference's EAT actor acts; its actions replayed through the
    port's env give the same trajectory."""
    jcfg, tcfg = _cfgs(4, 8)
    acfg = JAG.AgentConfig(variant="eat", T=4, hidden=32)
    params = JAG.init_actor(jax.random.PRNGKey(1), jcfg, acfg)
    tr = _np_traces(3, 4, 8, 4)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    jr = JRO.batch_rollout(jcfg, _to_jax(tr),
                           jactor_policy(jcfg, acfg, sampler=sampler), params,
                           keys, num_steps=48, collect=True, fused_impl="ref")
    _assert_teacher(tcfg, tr, jr, 48, f"eat {sampler}")


def test_uniform_teacher_forced_matches_reference():
    jcfg, tcfg = _cfgs(8, 16, 2)
    tr = _np_traces(4, 4, 16, 8, 2, faults=True)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jr = JRO.batch_rollout(jcfg, _to_jax(tr), JRO.uniform_policy(jcfg), {},
                           keys, num_steps=64, collect=True, fused_impl="ref")
    _assert_teacher(tcfg, tr, jr, 64, "uniform faults")


def test_port_eat_rollout_replays_itself():
    """The port's own EAT rollout (drawing from a generator) is reproduced
    exactly by replaying its collected actions, and the generator makes
    it repeatable."""
    tcfg = TEV.EnvConfig(num_servers=4, max_tasks=8, queue_window=4,
                         max_steps=64)
    acfg = TAG.AgentConfig(T=3, hidden=32)
    params = TAG.init_actor(tcfg, acfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    tr = TWL.make_trace_batch(TWL.TraceConfig(num_tasks=8, max_servers=4,
                                              arrival_rate=0.08), 3,
                              generator=torch.Generator().manual_seed(1),
                              device="cpu")
    pol = TPOL.actor_policy(tcfg, acfg, sampler="ddim:2", device="cpu")
    runs = [TRO.batch_rollout(tcfg, tr, pol, params, collect=True, device="cpu",
                              generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    replay = TRO.batch_rollout(tcfg, tr, TRO.sequence_policy(tcfg),
                               {"seq": runs[0].transitions.action},
                               device="cpu")
    for other in (runs[1], replay):
        for f in TEV.EnvState._fields:
            assert torch.equal(getattr(runs[0].final_state, f),
                               getattr(other.final_state, f)), f
    assert runs[0].transitions.extras["agent_action"].shape[-1] == tcfg.action_dim


# ------------------------------------------------------------- port rules
def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in files[:-1]}
    assert {"launch/train.py", "training/train_loop.py", "training/data.py",
            "kernels/flash_attention/ops.py",
            "kernels/ssm_scan/ops.py", "launch/mesh.py", "launch/shapes.py",
            "launch/steps.py", "launch/serve.py", "sharding/specs.py",
            "sharding/context.py", "launch/dryrun.py",
            "launch/hlo_analysis.py", "launch/roofline.py",
            "launch/augment_roofline.py", "launch/reshard.py"} <= names
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_need_cuda_unless_told(monkeypatch, tmp_path):
    """device=None means CUDA: without it the entry points raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TEV.EnvConfig(num_servers=4, max_tasks=8, queue_window=4)
    tc = TWL.TraceConfig(num_tasks=8, max_servers=4)
    tr = TWL.make_trace_batch(tc, 2, device="cpu")
    acfg = TAG.AgentConfig(T=2, hidden=8)
    calls = [
        lambda: TRO.batch_rollout(tcfg, tr, TRO.fifo_policy(tcfg), {}),
        lambda: TWL.make_trace_batch(tc, 2),
        lambda: TAG.init_actor(tcfg, acfg),
        lambda: TPOL.actor_policy(tcfg, acfg),
        lambda: TCK.params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: TEV.reset(tcfg, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    jp = JAG.init_actor(jax.random.PRNGKey(0), JEV.EnvConfig(
        num_servers=4, max_tasks=8, queue_window=4), JAG.AgentConfig(T=2, hidden=8))
    from repro.common.checkpoint import save_checkpoint
    save_checkpoint(str(tmp_path), 1, jp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCK.load_params(str(tmp_path))
    # asked for explicitly, the CPU path runs
    res = TRO.batch_rollout(tcfg, tr, TRO.fifo_policy(tcfg), {}, device="cpu")
    assert res.final_state.time.device.type == "cpu"
