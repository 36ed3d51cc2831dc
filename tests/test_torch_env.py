"""The port's env core and fused env step (`repro_torch`) against the
reference (`repro`) on the CPU.

Inputs are made with numpy from a seed and handed to both sides. The
reference's fused step runs through its plain jnp version (`impl="ref"`),
which its own tests hold bitwise to the Pallas kernel; the port runs its
plain PyTorch version (CPU tensors). Every integer and boolean output and
the clock (`time`, `server_free_at`, `task_start`, `task_finish`) must be
equal. Quality and obs pass through exp / reciprocal multiplies computed by
two libraries and are held to 1e-6; the reward also sums over K in another
order and is held to a relative 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as JEV
from repro.core import quality as JQ
from repro.core import timemodel as JTM
from repro.kernels.env_step import ops as JEK
from repro_torch.core import env as TEV
from repro_torch.core import quality as TQ
from repro_torch.core import timemodel as TTM
from repro_torch.core import workload as TWL
from repro_torch.kernels.env_step import ops as TEK

OBS_TOL = 1e-6
QUALITY_TOL = 1e-6
REWARD_RTOL = 1e-5

# the reference's fused step, jitted once per shape (eager vmap is slow)
_jax_step = jax.jit(JEK.env_step_fused, static_argnums=0,
                    static_argnames=("impl",))


def _cfgs(E, K, num_models=1, l=4):
    ms = tuple([1.0, 0.5, 2.0][:num_models]) if num_models > 1 else ()
    kw = dict(num_servers=E, max_tasks=K, queue_window=l,
              num_models=num_models, model_scale=ms)
    return JEV.EnvConfig(**kw), TEV.EnvConfig(**kw)


def _np_traces(rng, B, K, E, num_models, rate=0.2, faults=False, F=3):
    support = np.array([c for c in (1, 2, 4, 8) if c <= E])
    probs = np.array([0.35, 0.35, 0.2, 0.1])[:len(support)]
    gaps = (rng.exponential(size=(B, K)) / rate).astype(np.float32)
    tr = {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
          "c": rng.choice(support, (B, K), p=probs / probs.sum()).astype(np.int32),
          "model": rng.integers(0, num_models, (B, K)).astype(np.int32),
          "noise": (0.004 * rng.standard_normal((B, K))).astype(np.float32)}
    if faults:
        ds = rng.uniform(0.0, 80.0, (B, E, F)).astype(np.float32)
        de = (ds + rng.uniform(1.0, 30.0, (B, E, F))).astype(np.float32)
        pad = rng.random((B, E, F)) < 0.4          # padded slots sit at INF
        tr["f_down_start"] = np.where(pad, 1e30, ds).astype(np.float32)
        tr["f_down_end"] = np.where(pad, 1e30, de).astype(np.float32)
        tr["f_slow"] = rng.uniform(1.0, 2.0, (B, E)).astype(np.float32)
        tr["f_cold"] = (rng.random((B, 1)) < 0.5).astype(np.float32)
    return tr


def _np_state(rng, E, K, num_models):
    """One semi-consistent env state: warm / cold servers, intact and broken
    gangs, labels from the in-episode range [0, K) and the carried range
    [K, K+E), tasks in every status (as the reference's kernel test)."""
    t = np.float32(rng.uniform(0.0, 60.0))
    free = np.where(rng.random(E) < 0.5, 0.0,
                    t + rng.uniform(-20.0, 40.0, E)).astype(np.float32)
    gang = -np.ones(E, np.int32)
    gsize = np.zeros(E, np.int32)
    model = -np.ones(E, np.int32)
    servers = rng.permutation(E)
    i = 0
    while i < E and rng.random() < 0.8:
        c = min(int(rng.choice([1, 2, 4, 8])), E - i)
        members = servers[i:i + c]
        gang[members] = int(rng.integers(0, K + E))
        # sometimes break the gang: report a wrong size on purpose
        gsize[members] = c if rng.random() < 0.8 else int(rng.integers(1, 9))
        model[members] = int(rng.integers(0, max(num_models, 1)))
        i += c
    status = rng.choice([0, 0, 1, 2], K).astype(np.int32)
    tstart = np.where(status >= 1, rng.uniform(0, t, K), 0).astype(np.float32)
    tfin = np.where(status >= 1, tstart + rng.uniform(1, 50, K),
                    0).astype(np.float32)
    return dict(time=t, server_free_at=free, server_model=model,
                server_gang=gang, server_gang_size=gsize, task_status=status,
                task_start=tstart, task_finish=tfin,
                task_steps=rng.integers(0, 50, K).astype(np.int32),
                task_quality=rng.uniform(0, 0.3, K).astype(np.float32),
                task_reload=rng.integers(0, 2, K).astype(np.int32),
                steps_taken=np.int32(rng.integers(0, 100)))


def _np_states(rng, B, E, K, num_models):
    one = [_np_state(rng, E, K, num_models) for _ in range(B)]
    return {k: np.stack([s[k] for s in one]) for k in one[0]}


def _np_actions(rng, B, A):
    a = rng.uniform(size=(B, A)).astype(np.float32)
    a[::2, 0] = 0.1                      # half the envs try to schedule
    return a


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_state(js, ts, ctx):
    for f in JEV.EnvState._fields:
        a, b = _np(getattr(js, f)), _np(getattr(ts, f))
        if f == "task_quality":
            np.testing.assert_allclose(b, a, rtol=0, atol=QUALITY_TOL,
                                       err_msg=f"{ctx}: {f}")
        else:           # ints and the clock: exact
            assert a.dtype == b.dtype, f"{ctx}: {f} {a.dtype} vs {b.dtype}"
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx}: {f}")


def _assert_queue(jq, tq, ctx):
    for f in ("idx", "valid", "queued"):
        np.testing.assert_array_equal(_np(getattr(tq, f)),
                                      _np(getattr(jq, f)),
                                      err_msg=f"{ctx}: queue {f}")


def _both(rng, E, K, num_models, B=8, faults=False):
    jcfg, tcfg = _cfgs(E, K, num_models)
    tr = _np_traces(rng, B, K, E, num_models, faults=faults)
    st = _np_states(rng, B, E, K, num_models)
    act = _np_actions(rng, B, jcfg.action_dim)
    jtr, ttr = _jax(tr), _torch(tr)
    jst, tst = JEV.EnvState(**_jax(st)), TEV.EnvState(**_torch(st))
    return jcfg, tcfg, jtr, ttr, jst, tst, jnp.asarray(act), torch.from_numpy(act)


# ------------------------------------------------------------- building blocks
def test_timemodel_and_quality_match_reference():
    c = np.array([1, 2, 4, 8, 2, 1], np.int32)
    steps = np.arange(10, 51, 8, dtype=np.int32)[:6]
    scale = np.float32(0.5)
    np.testing.assert_array_equal(
        TTM.init_time(torch.from_numpy(c), scale).numpy(),
        np.asarray(JTM.init_time(jnp.asarray(c), scale)))
    np.testing.assert_array_equal(
        TTM.exec_time(torch.from_numpy(c), torch.from_numpy(steps), scale).numpy(),
        np.asarray(JTM.exec_time(jnp.asarray(c), jnp.asarray(steps), scale)))
    all_steps = np.arange(0, 61, dtype=np.int32)
    noise = np.linspace(-0.01, 0.01, all_steps.size, dtype=np.float32)
    tq = TQ.quality_of(torch.from_numpy(all_steps), torch.from_numpy(noise))
    jq = JQ.quality_of(jnp.asarray(all_steps), jnp.asarray(noise))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=QUALITY_TOL)
    np.testing.assert_array_equal(
        TQ.quality_penalty(tq, 0.23, 2.0).numpy(),
        np.asarray(JQ.quality_penalty(jq, 0.23, 2.0)))


def test_trace_generation():
    """Generator-drawn traces have the reference's shapes, dtypes and
    support; given draws build the reference's trace."""
    tc = TWL.TraceConfig(num_tasks=12, arrival_rate=0.15, max_servers=2,
                         num_models=3, model_probs=(0.5, 0.5))
    g = torch.Generator().manual_seed(0)
    tr = TWL.make_trace_batch(tc, 5, generator=g, device="cpu")
    assert tr["arr_time"].shape == (5, 12) and tr["arr_time"].dtype == torch.float32
    assert tr["c"].dtype == torch.int32 and tr["model"].dtype == torch.int32
    assert set(tr["c"].unique().tolist()) <= {1, 2}        # clipped to E = 2
    assert set(tr["model"].unique().tolist()) <= {0, 1}    # model 2 has p = 0
    assert bool((tr["arr_time"].diff(dim=1) >= 0).all())
    one = TWL.make_trace(tc, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    np.testing.assert_array_equal(one["arr_time"].numpy(), tr["arr_time"][0].numpy())
    # the reference's make_trace is cumsum(exponential / rate) + attrs
    rng = np.random.default_rng(1)
    gaps = rng.exponential(size=12).astype(np.float32)
    noise = rng.standard_normal(12).astype(np.float32)
    c = rng.choice([1, 2], 12).astype(np.int32)
    got = TWL.trace_from_draws(tc, torch.from_numpy(gaps), torch.from_numpy(c),
                               torch.zeros(12, dtype=torch.int32),
                               torch.from_numpy(noise))
    want = jnp.cumsum(jnp.asarray(gaps) / tc.arrival_rate)
    np.testing.assert_allclose(got["arr_time"].numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["noise"].numpy(),
                                  np.float32(0.004) * noise)
    assert TWL.paper_rate_for(8) == 0.1 and TWL.paper_rate_for(12) == 0.15


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_reset_view_matches_reference(faults):
    """visible_queue and observe_from on a fresh reset, and on a random
    mid-episode state."""
    rng = np.random.default_rng(11)
    jcfg, tcfg, jtr, ttr, jst, tst, _, _ = _both(rng, 8, 20, 1, faults=faults)
    B = 8
    j0 = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                                JEV.reset(jcfg))
    t0 = TEV.reset(tcfg, B, device="cpu")
    _assert_state(j0, t0, "reset")
    # a fresh reset at t=0 sees nothing queued; move the clock so it does
    j0 = j0._replace(time=jnp.full((B,), 30.0, jnp.float32))
    t0 = t0._replace(time=torch.full((B,), 30.0))
    for name, js, ts in (("reset", j0, t0), ("random", jst, tst)):
        jq, jobs = jax.vmap(lambda tr, st: JEV.reset_view(jcfg, tr, st))(jtr, js)
        tq, tobs = TEV.reset_view(tcfg, ttr, ts)
        _assert_queue(jq, tq, name)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0,
                                   atol=OBS_TOL, err_msg=name)
        assert bool(np.asarray(jq.valid).any()), name


# ------------------------------------------------------------- the fused step
@pytest.mark.parametrize("E,K,num_models,faults", [
    (4, 12, 1, False), (8, 20, 1, False), (8, 20, 3, False),
    (4, 12, 1, True), (8, 20, 3, True),
])
def test_fused_step_matches_reference(E, K, num_models, faults):
    """Port's env_step_fused (plain, CPU) == reference env_step_fused
    (impl="ref") on randomized batched states, over several decisions."""
    rng = np.random.default_rng(E * 100 + K + num_models + 7 * faults)
    for trial in range(4):
        jcfg, tcfg, jtr, ttr, jst, tst, ja, ta = _both(rng, E, K, num_models,
                                                       faults=faults)
        jstat = jax.vmap(lambda tr: JEV.decision_statics(jcfg, tr))(jtr)
        tstat = TEV.decision_statics(tcfg, ttr)
        for key in jstat:
            np.testing.assert_array_equal(tstat[key].numpy(),
                                          np.asarray(jstat[key]), err_msg=key)
        jq = jax.vmap(lambda tr, st: JEV.visible_queue(jcfg, tr, st))(jtr, jst)
        tq = TEV.visible_queue(tcfg, ttr, tst)
        _assert_queue(jq, tq, "in")
        for step in range(3):       # chain decisions through the outputs
            ctx = f"E={E} K={K} nm={num_models} faults={faults} " \
                  f"trial={trial} step={step}"
            jout = _jax_step(jcfg, jstat, jst, ja, jq, impl="ref")
            tout = TEK.env_step_fused(tcfg, tstat, tst, ta, tq)
            _assert_state(jout[0], tout[0], ctx)
            _assert_queue(jout[1], tout[1], ctx)
            np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                                       rtol=0, atol=OBS_TOL, err_msg=ctx)
            np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                                       rtol=REWARD_RTOL, atol=1e-6,
                                       err_msg=ctx)
            np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]),
                                          err_msg=ctx)
            jst, jq, tst, tq = jout[0], jout[1], tout[0], tout[1]
            a = _np_actions(rng, 8, jcfg.action_dim)
            ja, ta = jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_nan_action_matches_reference(faults):
    """A NaN action takes the reference's path: a NaN preference score
    counts as the largest (jnp.argmax, first NaN first), so the slot stays
    in the queue, and a NaN step knob gives 0 steps."""
    rng = np.random.default_rng(21 + faults)
    jcfg, tcfg, jtr, ttr, jst, tst, _, _ = _both(rng, 8, 20, 3, faults=faults)
    a = _np_actions(rng, 8, jcfg.action_dim)
    a[:, 0] = 0.1                        # every env tries to schedule
    a[0, 3] = np.nan                     # one NaN score among finite ones
    a[1, 2:] = np.nan                    # every score NaN
    a[2:6, 1] = np.nan                   # NaN step knob
    a[3, 2:] = np.nan                    # NaN knob and scores
    a[6, :] = np.nan                     # NaN exec flag: a no-op
    jstat = jax.vmap(lambda tr: JEV.decision_statics(jcfg, tr))(jtr)
    tstat = TEV.decision_statics(tcfg, ttr)
    jq = jax.vmap(lambda tr, st: JEV.visible_queue(jcfg, tr, st))(jtr, jst)
    tq = TEV.visible_queue(tcfg, ttr, tst)
    jout = _jax_step(jcfg, jstat, jst, jnp.asarray(a), jq, impl="ref")
    tout = TEK.env_step_fused(tcfg, tstat, tst, torch.from_numpy(a), tq)
    _assert_state(jout[0], tout[0], "nan")
    _assert_queue(jout[1], tout[1], "nan")
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0,
                               atol=OBS_TOL)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               rtol=REWARD_RTOL, atol=1e-6)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    # the NaN rows did schedule: a task went out with 0 steps
    started = (tout[0].task_status.numpy() != 0) \
        & (tst.task_status.numpy() == 0)
    assert bool((started[2:6] & (tout[0].task_steps.numpy()[2:6] == 0)).any())
    assert bool(started[:2].any())


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_decision_step_and_info_match_reference(faults):
    """The compositional `decision_step` / `step_with_queue` (trace in,
    info out) agree with the reference's, vmapped there."""
    rng = np.random.default_rng(5 + faults)
    jcfg, tcfg, jtr, ttr, jst, tst, ja, ta = _both(rng, 8, 20, 3, faults=faults)
    jq = jax.vmap(lambda tr, st: JEV.visible_queue(jcfg, tr, st))(jtr, jst)
    tq = TEV.visible_queue(tcfg, ttr, tst)
    jns, jq2, jobs, jr, jd, jinfo = jax.vmap(
        lambda tr, st, q, a: JEV.step_with_queue(jcfg, tr, st, q, a))(
            jtr, jst, jq, ja)
    tns, tq2, tobs, tr_, td, tinfo = TEV.step_with_queue(tcfg, ttr, tst, tq, ta)
    _assert_state(jns, tns, "step_with_queue")
    _assert_queue(jq2, tq2, "step_with_queue")
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OBS_TOL)
    np.testing.assert_allclose(tr_.numpy(), np.asarray(jr), rtol=REWARD_RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert set(tinfo) == set(jinfo)
    for k in ("scheduled", "task", "reuse", "steps") + (("failed",) if faults else ()):
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tinfo["response"].numpy(),
                                  np.asarray(jinfo["response"]))
    np.testing.assert_allclose(tinfo["quality"].numpy(),
                               np.asarray(jinfo["quality"]), atol=QUALITY_TOL)
    assert bool(np.asarray(jinfo["scheduled"]).any())


def test_carried_gang_reuse():
    """A complete idle gang with a carried label in [K, K+E) is reused by
    both sides: same servers, no reload."""
    jcfg, tcfg = _cfgs(4, 8)
    K = 8
    tr = {"arr_time": np.arange(K, dtype=np.float32) * 0.01,
          "c": np.full(K, 2, np.int32), "model": np.zeros(K, np.int32),
          "noise": np.zeros(K, np.float32)}
    tr = {k: v[None] for k, v in tr.items()}
    st = {k: np.asarray(v)[None] for k, v in JEV.reset(jcfg)._asdict().items()}
    st.update(time=np.array([1.0], np.float32),
              server_gang=np.array([[K + 1, K + 1, -1, -1]], np.int32),
              server_gang_size=np.array([[2, 2, 0, 0]], np.int32),
              server_model=np.array([[0, 0, -1, -1]], np.int32))
    a = np.array([[0.0, 0.5, 1.0, 0.0, 0.0, 0.0]], np.float32)
    jtr, ttr = _jax(tr), _torch(tr)
    jst, tst = JEV.EnvState(**_jax(st)), TEV.EnvState(**_torch(st))
    jstat = jax.vmap(lambda x: JEV.decision_statics(jcfg, x))(jtr)
    jq = jax.vmap(lambda x, s: JEV.visible_queue(jcfg, x, s))(jtr, jst)
    tstat = TEV.decision_statics(tcfg, ttr)
    tq = TEV.visible_queue(tcfg, ttr, tst)
    jout = _jax_step(jcfg, jstat, jst, jnp.asarray(a), jq, impl="ref")
    tout = TEK.env_step_fused(tcfg, tstat, tst, torch.from_numpy(a), tq)
    _assert_state(jout[0], tout[0], "carried")
    assert int(tout[0].task_status[0, 0]) == 1
    assert int(tout[0].task_reload.sum()) == 0
    np.testing.assert_array_equal(tout[0].server_gang[0].numpy(), [0, 0, -1, -1])


# ------------------------------------------------------------- observe / step
@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_observe_and_step_match_reference(faults):
    """`observe` and the legacy `step` (queue view recomputed from the
    state) against the reference's, vmapped there, over a few decisions."""
    rng = np.random.default_rng(31 + faults)
    jcfg, tcfg, jtr, ttr, jst, tst, ja, ta = _both(rng, 8, 20, 3, faults=faults)
    for step in range(3):
        ctx = f"faults={faults} step={step}"
        jobs = jax.vmap(lambda tr, st: JEV.observe(jcfg, tr, st))(jtr, jst)
        np.testing.assert_allclose(TEV.observe(tcfg, ttr, tst).numpy(),
                                   np.asarray(jobs), atol=OBS_TOL, err_msg=ctx)
        jns, jobs2, jr, jd, jinfo = jax.vmap(
            lambda tr, st, a: JEV.step(jcfg, tr, st, a))(jtr, jst, ja)
        tns, tobs2, tr_, td, tinfo = TEV.step(tcfg, ttr, tst, ta)
        _assert_state(jns, tns, ctx)
        np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2),
                                   atol=OBS_TOL, err_msg=ctx)
        np.testing.assert_allclose(tr_.numpy(), np.asarray(jr),
                                   rtol=REWARD_RTOL, atol=1e-6, err_msg=ctx)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=ctx)
        assert set(tinfo) == set(jinfo)
        for k in ("scheduled", "task", "reuse", "steps"):
            np.testing.assert_array_equal(tinfo[k].numpy(),
                                          np.asarray(jinfo[k]), err_msg=k)
        jst, tst = jns, tns
        a = _np_actions(rng, 8, jcfg.action_dim)
        ja, ta = jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "faults"])
def test_step_equals_step_with_queue(faults):
    """`step` is `step_with_queue` on the state's own queue view, bit for
    bit, on every output."""
    rng = np.random.default_rng(41 + faults)
    _, tcfg, _, ttr, _, tst, _, ta = _both(rng, 8, 20, 3, faults=faults)
    for _ in range(4):
        got = TEV.step(tcfg, ttr, tst, ta)
        want = TEV.step_with_queue(tcfg, ttr, tst,
                                   TEV.visible_queue(tcfg, ttr, tst), ta)
        for f in TEV.EnvState._fields:
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
        for g, w in zip(got[1:4], (want[2], want[3], want[4])):
            assert torch.equal(g, w)
        assert got[4].keys() == want[5].keys()
        for k in got[4]:
            assert torch.equal(got[4][k], want[5][k]), k
        tst = got[0]
        ta = torch.from_numpy(_np_actions(rng, 8, tcfg.action_dim))
