"""The port's SAC training path (`repro_torch`) against the reference
(`repro`) on the CPU: the optimizer, the replay buffer, the critic, the
behaviour-cloning loss, one `update_step` from a carried-over train state,
the update schedule, and a short training run of the port.

Inputs are made with numpy from a seed; the reference's draws are rebuilt
from its keys and handed to the port, so both sides see the same numbers.
The reference's `collect_batch` and `train` are not called: they reach the
API facade, which the suite's warning filter refuses on this tree.

Tolerances: 1e-6 on the optimizer and on one network forward, relative
1e-5 on the SAC losses (a T-step chain through two libraries' matrix
products; 1e-6 absolute for the Q means, which nearly cancel at init),
rtol 1e-4 / atol 1e-6 on gradients. Adam's first step is
g / |g| per element, so an element whose gradient is near 0 may take the
other sign on the other side: new params are held to 2 lr everywhere and
to 1e-6 on at least 99 % of elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as JAG
from repro.core import diffusion as JDF
from repro.core import env as JEV
from repro.core import rollout as JRO
from repro.core import sac as JSAC
from repro.core.replay import ReplayBuffer as JReplayBuffer
from repro.training import optimizer as JOPT
from repro_torch.common.checkpoint import params_from_jax, train_state_from_jax
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import agent as TAG
from repro_torch.core import diffusion as TDF
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core import sac as TSAC
from repro_torch.core import workload as TWL
from repro_torch.core.replay import ReplayBuffer as TReplayBuffer
from repro_torch.training import optimizer as TOPT

ECFG = dict(num_servers=4, max_tasks=8, queue_window=4)
JECFG, TECFG = JEV.EnvConfig(**ECFG), TEV.EnvConfig(**ECFG)
A = JECFG.action_dim
T = 4
H = 32
LOSS_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _leaves_np(tree):
    """Leaves of a port tree (sorted dict keys) as numpy arrays, in the
    reference's leaf order."""
    return [t.detach().numpy() for t in tree_leaves(tree)]


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["no_wd", "wd"])
def test_adam_matches_reference_over_five_steps(wd):
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.standard_normal((5, 4)).astype(np.float32)},
              "layers": [{"b": rng.standard_normal(3).astype(np.float32)},
                         {"b": rng.standard_normal(2).astype(np.float32)}]}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(
        params, device="cpu")
    js, ts = JOPT.adam_init(jp), TOPT.adam_init(tp)
    for step in range(5):
        g = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * 10 ** rng.uniform(-4, 1))
            .astype(np.float32), params)
        ju, js = JOPT.adam_update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                  jp, 1e-2, weight_decay=wd)
        tu, ts = TOPT.adam_update(params_from_jax(g, device="cpu"), ts, tp,
                                  1e-2, weight_decay=wd)
        jp, tp = JOPT.apply_updates(jp, ju), TOPT.apply_updates(tp, tu)
        assert int(ts.step) == int(js.step) == step + 1
        for name, jt, tt in (("update", ju, tu), ("params", jp, tp),
                             ("mu", js.mu, ts.mu), ("nu", js.nu, ts.nu)):
            for a, b in zip(jax.tree_util.tree_leaves(jt), _leaves_np(tt)):
                _close(b, a, 1e-6, f"step {step} {name}")


def test_clip_by_global_norm_and_cosine_schedule():
    rng = np.random.default_rng(4)
    g = {"x": rng.standard_normal((6, 3)).astype(np.float32),
         "y": [rng.standard_normal(7).astype(np.float32)]}
    for max_norm in (0.5, 100.0):
        jc, jn = JOPT.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tc, tn = TOPT.clip_by_global_norm(params_from_jax(g, device="cpu"),
                                          max_norm)
        _close(tn, jn, 1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(jc), _leaves_np(tc)):
            _close(b, a, 1e-6, f"clip {max_norm}")
    _close(TOPT.global_norm(params_from_jax(g, device="cpu")),
           JOPT.global_norm(jax.tree_util.tree_map(jnp.asarray, g)), 1e-6)
    steps = np.array([0, 1, 5, 9, 10, 11, 40, 99, 100, 150], np.float32)
    _close(TOPT.cosine_schedule(_t(steps), 3e-4, 10, 100),
           JOPT.cosine_schedule(jnp.asarray(steps), 3e-4, 10, 100), 1e-9)
    for s in (0, 7, 55):          # plain Python steps too
        _close(TOPT.cosine_schedule(s, 1e-3, 10, 100, min_frac=0.2),
               JOPT.cosine_schedule(s, 1e-3, 10, 100, min_frac=0.2), 1e-9)


def test_replay_buffer_matches_reference():
    """Same insertions (one by one and in batches, wrapping the ring) and
    equal numpy generators give the same samples, exactly."""
    rng = np.random.default_rng(5)
    obs_shape = JECFG.obs_shape
    jb, tb = JReplayBuffer(50, obs_shape, A), TReplayBuffer(50, obs_shape, A)

    def tr(n):
        return (rng.standard_normal((n,) + obs_shape).astype(np.float32),
                rng.uniform(-1, 1, (n, A)).astype(np.float32),
                rng.standard_normal(n).astype(np.float32),
                rng.standard_normal((n,) + obs_shape).astype(np.float32),
                rng.random(n) < 0.3)
    for n in (7, 30, 0, 25):
        batch = tr(n)
        jb.add_batch(*batch)
        tb.add_batch(*batch)
        one = [x[0] for x in tr(1)]
        jb.add(*one)
        tb.add(*one)
    assert (tb.size, tb.ptr) == (jb.size, jb.ptr) == (50, 66 % 50)
    jr, tr_ = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        a, b = jb.sample(jr, 16), tb.sample(tr_, 16)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ------------------------------------------------------------- critic and BC
def _batch(rng, B):
    shape = (B,) + JECFG.obs_shape
    return {"obs": rng.uniform(0, 1.5, shape).astype(np.float32),
            "action": rng.uniform(-1, 1, (B, A)).astype(np.float32),
            "reward": rng.standard_normal(B).astype(np.float32),
            "next_obs": rng.uniform(0, 1.5, shape).astype(np.float32),
            "done": (rng.random(B) < 0.25).astype(np.float32)}


def test_critic_apply_matches_reference():
    jp = JAG.init_critic(jax.random.PRNGKey(1), JECFG, hidden=H)
    b = _batch(np.random.default_rng(6), 9)
    want = jax.jit(JAG.critic_apply)(jp, jnp.asarray(b["obs"]),
                                     jnp.asarray(b["action"]))
    got = TAG.critic_apply(params_from_jax(_np_tree(jp), device="cpu"),
                           _t(b["obs"]), _t(b["action"]))
    assert tuple(got.shape) == (9,)
    _close(got, want, 1e-6)
    tp = TAG.init_critic(TECFG, hidden=H, generator=torch.Generator(),
                         device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(tp)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jp)]


def test_bc_loss_matches_reference_with_injected_draws():
    key = jax.random.PRNGKey(7)
    p = JDF.init_denoiser(jax.random.PRNGKey(2), A, 8, H)
    rng = np.random.default_rng(7)
    f_s = rng.standard_normal((10, 8)).astype(np.float32)
    act = rng.uniform(-1, 1, (10, A)).astype(np.float32)
    js = JDF.vp_schedule(T)
    want = jax.jit(JDF.bc_loss)(p, js, jnp.asarray(f_s), jnp.asarray(act),
                                key)
    ki, kn = jax.random.split(key)
    i = np.asarray(jax.random.randint(ki, (10,), 0, T))
    noise = np.asarray(jax.random.normal(kn, (10, A)))
    got = TDF.bc_loss(params_from_jax(_np_tree(p), device="cpu"),
                      TDF.vp_schedule(T, device="cpu"), _t(f_s), _t(act),
                      i=_t(i), noise=_t(noise))
    _close(got, want, 1e-6)
    # drawn from a generator, the indices stay in [0, T)
    assert torch.isfinite(TDF.bc_loss(
        params_from_jax(_np_tree(p), device="cpu"),
        TDF.vp_schedule(T, device="cpu"), _t(f_s), _t(act),
        generator=torch.Generator().manual_seed(0)))


# ------------------------------------------------------------- update_step
def _actor_draws(key, B):
    """actor_sample's draws: key -> (kd, ks); kd -> (kx, kn)."""
    kd, ks = jax.random.split(key)
    kx, kn = jax.random.split(kd)
    return (np.asarray(jax.random.normal(kx, (B, A))),
            np.asarray(jax.random.normal(kn, (T, B, A))),
            np.asarray(jax.random.normal(ks, (B, A))))


def _update_draws(key, B):
    """update_step's draws, rebuilt from its key as the reference splits it."""
    k_next, k_actor, k_bc = jax.random.split(key, 3)
    d = dict(zip(("next_x_T", "next_noises", "next_eps"),
                 _actor_draws(k_next, B)))
    d.update(zip(("x_T", "noises", "eps"), _actor_draws(k_actor, B)))
    ki, kn = jax.random.split(k_bc)
    d["bc_i"] = np.asarray(jax.random.randint(ki, (B,), 0, T))
    d["bc_noise"] = np.asarray(jax.random.normal(kn, (B, A)))
    return {k: _t(v) for k, v in d.items()}


@pytest.mark.parametrize("variant,bc_coef", [("eat", 0.0), ("eat-da", 0.0),
                                             ("eat", 0.5)],
                         ids=["eat", "eat-da", "eat-bc"])
def test_update_step_matches_reference(variant, bc_coef):
    jacfg = JAG.AgentConfig(variant=variant, T=T, hidden=H)
    tacfg = TAG.AgentConfig(variant=variant, T=T, hidden=H)
    jscfg = JSAC.SACConfig(batch_size=16, bc_coef=bc_coef)
    tscfg = TSAC.SACConfig(batch_size=16, bc_coef=bc_coef)
    jts = JSAC.init_train_state(jax.random.PRNGKey(3), JECFG, jacfg)
    tts = train_state_from_jax(_np_tree(jts), device="cpu")
    b = _batch(np.random.default_rng(8), 16)
    key = jax.random.PRNGKey(11)
    jts2, jm = JSAC.update_step(jts, {k: jnp.asarray(v) for k, v in b.items()},
                                key, ecfg=JECFG, acfg=jacfg, scfg=jscfg)
    tts2, tm = TSAC.update_step(tts, {k: _t(v) for k, v in b.items()},
                                ecfg=TECFG, acfg=tacfg, scfg=tscfg,
                                draws=_update_draws(key, 16))
    assert set(tm) == set(jm)
    for k in jm:       # q_mean and q_batch are means of Q values that
        # nearly cancel at init: 1e-6 absolute covers their f32 sums
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert int(tts2.step) == int(jts2.step) == 1
    lr = jscfg.actor_lr
    for name in ("actor", "critic1", "critic2", "target1", "target2"):
        want = jax.tree_util.tree_leaves(getattr(jts2, name))
        got = _leaves_np(getattr(tts2, name))
        assert len(got) == len(want), name
        diffs = np.concatenate([np.abs(g - np.asarray(w)).ravel()
                                for g, w in zip(got, want)])
        assert diffs.max() <= 2 * lr, (name, diffs.max())
        assert np.mean(diffs <= 1e-6) >= 0.99, (name, np.mean(diffs <= 1e-6))
    # the gradients: from a fresh Adam state, mu' = (1 - b1) g
    for name in ("opt_actor", "opt_critic1", "opt_critic2"):
        js_, ts_ = getattr(jts2, name), getattr(tts2, name)
        assert int(ts_.step) == int(js_.step) == 1
        for g, w in zip(_leaves_np(ts_.mu), jax.tree_util.tree_leaves(js_.mu)):
            np.testing.assert_allclose(g / np.float32(0.1),
                                       np.asarray(w) / np.float32(0.1),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
    # the target nets moved toward the updated critics
    for tgt, old in (("target1", tts.target1), ("target2", tts.target2)):
        moved = [not torch.equal(a, b) for a, b in
                 zip(tree_leaves(getattr(tts2, tgt)), tree_leaves(old))]
        assert any(moved), tgt


def test_update_schedule_and_flatten_match_reference():
    """The update count and the replay draws follow the reference's
    schedule; collected transitions flatten to the same buffer rows."""
    rng = np.random.default_rng(10)
    B, S = 3, 7
    shape = (B, S) + JECFG.obs_shape
    valid = np.ones((B, S), bool)
    valid[0, 5:] = valid[2, 2:] = False
    arrays = dict(obs=rng.standard_normal(shape).astype(np.float32),
                  action=rng.uniform(0, 1, (B, S, A)).astype(np.float32),
                  reward=rng.standard_normal((B, S)).astype(np.float32),
                  next_obs=rng.standard_normal(shape).astype(np.float32),
                  done=(rng.random((B, S)) < 0.2).astype(np.float32),
                  valid=valid)
    agent_a = rng.uniform(-1, 1, (B, S, A)).astype(np.float32)
    jtr = JRO.Transitions(**arrays, extras={"agent_action": agent_a})
    ttr = TRO.Transitions(**{k: _t(v) for k, v in arrays.items()},
                          extras={"agent_action": _t(agent_a)})
    want, got = JSAC.flatten_valid_transitions(jtr), \
        TSAC.flatten_valid_transitions(ttr)
    assert len(got) == 5 and len(got[2]) == int(valid.sum())
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)

    jacfg = JAG.AgentConfig(variant="eat-da", T=T, hidden=H)
    tacfg = TAG.AgentConfig(variant="eat-da", T=T, hidden=H)
    jbuf, tbuf = (JReplayBuffer(64, JECFG.obs_shape, A),
                  TReplayBuffer(64, TECFG.obs_shape, A))
    assert JSAC.push_transitions(jbuf, jtr) == \
        TSAC.push_transitions(tbuf, ttr) == int(valid.sum())
    jts = JSAC.init_train_state(jax.random.PRNGKey(0), JECFG, jacfg)
    tts = train_state_from_jax(_np_tree(jts), device="cpu")
    for n_new, warm, cap in ((9, 8, None), (9, 8, 1), (9, 20, None)):
        jscfg = JSAC.SACConfig(batch_size=4, warmup_steps=warm, update_every=4)
        tscfg = TSAC.SACConfig(batch_size=4, warmup_steps=warm, update_every=4)
        jr, tr_ = np.random.default_rng(1), np.random.default_rng(1)
        _, _, jn = JSAC.run_update_schedule(
            jts, jbuf, jr, jax.random.PRNGKey(1), n_new, ecfg=JECFG,
            acfg=jacfg, scfg=jscfg, max_updates=cap)
        ts2, tn, tm = TSAC.run_update_schedule(
            tts, tbuf, tr_, torch.Generator().manual_seed(1), n_new,
            ecfg=TECFG, acfg=tacfg, scfg=tscfg, max_updates=cap)
        assert tn == jn == (0 if warm > jbuf.size else min(n_new // 4, cap or 9))
        assert int(ts2.step) == tn and (set(tm) == set() if tn == 0 else
                                        "critic_loss" in tm)
        assert jr.integers(1 << 30) == tr_.integers(1 << 30)   # same draws


def test_host_rng_comes_from_the_generator():
    a = TSAC.host_rng(torch.Generator().manual_seed(0)).integers(1 << 30, size=4)
    b = TSAC.host_rng(torch.Generator().manual_seed(0)).integers(1 << 30, size=4)
    c = TSAC.host_rng(torch.Generator().manual_seed(1)).integers(1 << 30, size=4)
    raw = np.random.default_rng(0).integers(1 << 30, size=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, raw)


def test_run_episode_matches_reference_for_a_deterministic_actor():
    """A deterministic Gaussian actor draws nothing, so the host-driven
    episode (policy_act + env.step) of both sides is the same episode."""
    kw = dict(num_servers=4, max_tasks=6, queue_window=4, max_steps=40)
    jcfg, tcfg = JEV.EnvConfig(**kw), TEV.EnvConfig(**kw)
    jacfg = JAG.AgentConfig(variant="eat-d", T=T, hidden=H)
    tacfg = TAG.AgentConfig(variant="eat-d", T=T, hidden=H)
    jp = JAG.init_actor(jax.random.PRNGKey(5), jcfg, jacfg)
    rng = np.random.default_rng(12)
    trace = {"arr_time": np.cumsum(rng.exponential(8.0, 6)).astype(np.float32),
             "c": rng.choice([1, 2, 4], 6).astype(np.int32),
             "model": np.zeros(6, np.int32),
             "noise": (0.004 * rng.standard_normal(6)).astype(np.float32)}
    jbuf = JReplayBuffer(64, jcfg.obs_shape, jcfg.action_dim)
    tbuf = TReplayBuffer(64, tcfg.obs_shape, tcfg.action_dim)
    want = JSAC.run_episode(jcfg, {k: jnp.asarray(v) for k, v in trace.items()},
                            jp, jacfg, jax.random.PRNGKey(0), buffer=jbuf,
                            deterministic=True)
    got = TSAC.run_episode(tcfg, {k: _t(v) for k, v in trace.items()},
                           params_from_jax(_np_tree(jp), device="cpu"), tacfg,
                           buffer=tbuf, deterministic=True, device="cpu")
    assert got.keys() == want.keys()
    assert got["episode_len"] == want["episode_len"] == tbuf.size == jbuf.size
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(tbuf.done, jbuf.done)
    np.testing.assert_allclose(tbuf.action, jbuf.action, atol=1e-6)


# ------------------------------------------------------------- the trainer
def test_port_train_runs_updates_and_schedules():
    """The analogue of tests/test_integration_rl.py at tier-1 size: a
    uniform warmup round, then an actor round with updates."""
    ecfg = TEV.EnvConfig(num_servers=4, max_tasks=6, queue_window=4,
                         max_steps=48)
    acfg = TAG.AgentConfig(T=4, hidden=H)
    scfg = TSAC.SACConfig(batch_size=8, warmup_steps=8, buffer_capacity=512,
                          update_every=4)
    tc = TWL.TraceConfig(num_tasks=6, max_servers=4, arrival_rate=0.05)
    seen = []
    ts, hist = TSAC.train(
        ecfg, acfg, scfg,
        lambda g, b: TWL.make_trace_batch(tc, b, generator=g, device="cpu"),
        2, num_envs=1, log_every=0, device="cpu",
        callback=lambda ep, em, ts_: seen.append(ep))
    assert seen == [0, 1] and len(hist) == 2
    assert [h["warmup"] for h in hist] == [True, False]
    assert all(h["num_scheduled"] >= 1 for h in hist)
    assert sum(h["updates"] for h in hist) > 0 and int(ts.step) > 0
    for k in ("critic_loss", "actor_loss", "q_mean", "entropy"):
        assert np.isfinite(hist[-1][k]), k
    # the same seed trains the same actor
    ts2, _ = TSAC.train(
        ecfg, acfg, scfg,
        lambda g, b: TWL.make_trace_batch(tc, b, generator=g, device="cpu"),
        2, num_envs=1, log_every=0, device="cpu")
    for a, b in zip(tree_leaves(ts.actor), tree_leaves(ts2.actor)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,match", [
    ({"curriculum": ["cell"]}, "scenarios"),
    ({"demo_episodes": 2}, "greedy_act"),
    ({"exec_spec": object()}, "API facade")])
def test_train_refuses_what_is_not_ported(kw, match):
    """An exec_spec that is not the API facade's `ExecSpec` is refused; a
    curriculum of anything but `core.scenarios.Scenario` cells, and
    demonstrations without a trace_fn to draw their traces, are refused
    too."""
    with pytest.raises(ValueError, match=match):
        TSAC.train(TECFG, TAG.AgentConfig(T=2, hidden=8), TSAC.SACConfig(),
                   None, 1, device="cpu", **kw)


def test_training_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    acfg = TAG.AgentConfig(T=2, hidden=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSAC.train(TECFG, acfg, TSAC.SACConfig(), None, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSAC.init_train_state(TECFG, acfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TAG.init_critic(TECFG)
