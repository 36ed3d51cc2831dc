"""The port's PPO baseline (`repro_torch.core.ppo`) and SAC's Greedy
demonstrations (`repro_torch.core.sac.seed_with_demonstrations`) against
the reference on the CPU.

GAE is numpy on both sides and must be exact on the same transitions. One
`ppo_update` from the reference's params (carried over) and the same batch
must give its losses within 1e-5 relative; the new params are held as the
SAC update's are in `tests/test_torch_training.py`: within 2 lr everywhere
(Adam's first step is g / |g| per element, so an element whose gradient is
near 0 may take the other sign) and within 1e-6 on at least 99 % of
elements. `train_ppo` itself reaches the API facade in the reference, so
the port's runs on its own. The demonstrations run the reference's greedy
episodes closed loop: actions and dones exact, observations within 1e-6,
rewards within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as JEV
from repro.core import ppo as JPPO
from repro.core import rollout as JRO
from repro.core import sac as JSAC
from repro.core.replay import ReplayBuffer as JReplayBuffer
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import tree_leaves
from repro_torch.core import env as TEV
from repro_torch.core import ppo as TPPO
from repro_torch.core import rollout as TRO
from repro_torch.core import sac as TSAC
from repro_torch.core import scenarios as TSC
from repro_torch.core import workload as TWL
from repro_torch.core.replay import ReplayBuffer as TReplayBuffer
from repro_torch.training.optimizer import adam_init

ECFG = dict(num_servers=4, max_tasks=8, queue_window=4, max_steps=64)
JECFG, TECFG = JEV.EnvConfig(**ECFG), TEV.EnvConfig(**ECFG)
A = JECFG.action_dim
OBS = JECFG.obs_shape


def _t(x):
    return torch.from_numpy(np.array(x))


def _transitions(seed, B=4, T=12):
    """Stacked (B, T) transitions with valid prefixes of assorted lengths
    (one empty row), done at each row's last valid step."""
    rng = np.random.default_rng(seed)
    lens = np.array([T, 5, 0, 9][:B])
    valid = np.arange(T)[None] < lens[:, None]
    done = np.zeros((B, T), np.float32)
    for b, L in enumerate(lens):
        if L:
            done[b, L - 1] = 1.0
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(obs=f(B, T, *OBS), action=rng.uniform(size=(B, T, A)).astype(
        np.float32), reward=f(B, T) * valid, next_obs=f(B, T, *OBS),
        done=done, valid=valid, extras={"agent_action": f(B, T, A),
                                        "logp": f(B, T), "value": f(B, T)})


@pytest.mark.parametrize("bootstrap", [False, True])
def test_pool_gae_matches_reference(bootstrap):
    raw = _transitions(0)
    jtr = JRO.Transitions(**{k: (v if k != "extras" else
                                 {kk: jnp.asarray(vv) for kk, vv in v.items()})
                             for k, v in raw.items()})
    ttr = TRO.Transitions(**{k: (_t(v) if k != "extras" else
                                 {kk: _t(vv) for kk, vv in v.items()})
                             for k, v in raw.items()})
    pcfg = JPPO.PPOConfig()
    last = np.array([0.5, -1.0, 2.0, 0.25], np.float32) if bootstrap else None
    want = JPPO.pool_gae(jtr, pcfg, last)
    got = TPPO.pool_gae(ttr, TPPO.PPOConfig(), last)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)
    assert len(got["adv"]) == 12 + 5 + 9


def test_compute_gae_matches_reference():
    rng = np.random.default_rng(1)
    r, v = rng.standard_normal((2, 20)).astype(np.float32)
    d = (rng.random(20) < 0.2).astype(np.float32)
    want = JPPO.compute_gae(r, v, d, 0.7, 0.95, 0.9)
    got = TPPO.compute_gae(r, v, d, 0.7, 0.95, 0.9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pool_gae_of_no_valid_step_is_empty():
    raw = _transitions(2)
    raw["valid"][:] = False
    ttr = TRO.Transitions(**{k: (_t(v) if k != "extras" else
                                 {kk: _t(vv) for kk, vv in v.items()})
                             for k, v in raw.items()})
    got = TPPO.pool_gae(ttr, TPPO.PPOConfig())
    assert got["obs"].shape == (0,) + OBS and got["adv"].shape == (0,)
    st = TPPO.init_ppo(TECFG, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert TPPO.run_ppo_epochs(st, got, np.random.default_rng(0), TECFG,
                               TPPO.PPOConfig())[1] == 0


def _carried_state(seed):
    jst = JPPO.init_ppo(jax.random.PRNGKey(seed), JECFG)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jst.params),
                             device="cpu")
    return jst, TPPO.PPOState(params=params, opt=adam_init(params),
                              step=torch.zeros((), dtype=torch.int32))


def _batch(seed, n=64):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n,) + OBS).astype(np.float32),
            "action": rng.uniform(-1, 1, (n, A)).astype(np.float32),
            "logp": rng.normal(-8.0, 1.0, n).astype(np.float32),
            "adv": rng.standard_normal(n).astype(np.float32),
            "ret": rng.standard_normal(n).astype(np.float32)}


def test_init_ppo_shapes_match_reference():
    jst, _ = _carried_state(0)
    tst = TPPO.init_ppo(TECFG, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    jl = jax.tree_util.tree_leaves(jst.params)
    tl = tree_leaves(tst.params)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    np.testing.assert_array_equal(tst.params["log_sigma"].numpy(),
                                  np.asarray(jst.params["log_sigma"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_ppo_update_matches_reference(seed):
    pcfg = JPPO.PPOConfig()
    jst, tst = _carried_state(seed)
    batch = _batch(seed)
    jst2, jm = JPPO.ppo_update(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                               ecfg=JECFG, pcfg=pcfg)
    tst2, tm = TPPO.ppo_update(tst, {k: _t(v) for k, v in batch.items()},
                               ecfg=TECFG, pcfg=TPPO.PPOConfig())
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(tst2.step) == int(jst2.step) == 1
    got = np.concatenate([x.numpy().ravel() for x in tree_leaves(tst2.params)])
    want = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(jst2.params)])
    err = np.abs(got - want)
    assert err.max() <= 2 * pcfg.lr
    assert np.mean(err <= 1e-6) >= 0.99


def test_ppo_act_matches_reference_on_its_noise():
    jst, tst = _carried_state(3)
    obs = np.random.default_rng(3).standard_normal((5,) + OBS).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ja, jl, jv = JPPO.ppo_act(jst.params, jnp.asarray(obs), key, ecfg=JECFG)
    eps = jax.random.normal(key, (5, A))
    ta, tl, tv = TPPO.ppo_act(tst.params, _t(obs), ecfg=TECFG, eps=_t(eps))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_ppo_policy_extras_are_its_act():
    """The rollout policy's extras (agent action, log-prob, value) are
    what ppo_act gives on the same draws; the factory is cached."""
    tst = TPPO.init_ppo(TECFG, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    pol = TPPO.ppo_policy(TECFG)
    assert pol is TPPO.ppo_policy(TECFG)
    obs = torch.randn((3,) + OBS, generator=torch.Generator().manual_seed(2))
    env_a, ex = pol(tst.params, torch.Generator().manual_seed(4), None, None,
                    obs)
    eps = torch.randn((3, A), generator=torch.Generator().manual_seed(4))
    a, logp, v = TPPO.ppo_act(tst.params, obs, ecfg=TECFG, eps=eps)
    assert torch.equal(ex["agent_action"], a) and torch.equal(ex["logp"], logp)
    assert torch.equal(ex["value"], v)
    assert torch.equal(env_a, (a + 1.0) * 0.5)


def test_train_ppo_runs_two_rounds():
    tc = TWL.TraceConfig(num_tasks=8, max_servers=4, arrival_rate=0.08)
    pcfg = TPPO.PPOConfig(epochs=2, minibatches=4)

    def trace_fn(gen, B):
        return TWL.make_trace_batch(tc, B, generator=gen, device="cpu")
    st, hist = TPPO.train_ppo(TECFG, pcfg, trace_fn, 4, num_envs=2,
                              log_every=0, device="cpu")
    assert [h["round"] for h in hist] == [0, 0, 1, 1]
    assert int(st.step) == sum({h["round"]: h["updates"] for h in hist}.values()) > 0
    assert all(np.isfinite(h["episode_return"]) for h in hist)
    for p in tree_leaves(st.params):
        assert bool(torch.isfinite(p).all())
    # the same seed trains the same policy; a curriculum trains too
    st2, _ = TPPO.train_ppo(TECFG, pcfg, trace_fn, 4, num_envs=2,
                            log_every=0, device="cpu")
    for a, b in zip(tree_leaves(st.params), tree_leaves(st2.params)):
        assert torch.equal(a, b)
    st3, hist3 = TPPO.train_ppo(TECFG, pcfg, None, 2, num_envs=2, log_every=0,
                                curriculum=TSC.training_curriculum(TECFG),
                                device="cpu")
    assert len(hist3) == 2 and int(st3.step) > 0
    with pytest.raises(ValueError, match="API facade"):
        TPPO.train_ppo(TECFG, pcfg, trace_fn, 1, exec_spec=object(),
                       device="cpu")


def _np_traces(seed, B):
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(size=(B, 8)) / 0.08).astype(np.float32)
    return {"arr_time": np.cumsum(gaps, axis=1, dtype=np.float32),
            "c": rng.choice([1, 2, 4], (B, 8)).astype(np.int32),
            "model": np.zeros((B, 8), np.int32),
            "noise": (0.004 * rng.standard_normal((B, 8))).astype(np.float32)}


def test_seed_with_demonstrations_matches_reference():
    tr = _np_traces(4, 3)
    queue = [{k: jnp.asarray(v[b]) for k, v in tr.items()} for b in range(3)]
    jbuf = JReplayBuffer(4096, OBS, A)
    n_ref = JSAC.seed_with_demonstrations(jbuf, JECFG, lambda k: queue.pop(0),
                                          jax.random.PRNGKey(0), episodes=3)
    tbuf = TReplayBuffer(4096, OBS, A)
    n = TSAC.seed_with_demonstrations(
        tbuf, TECFG, lambda gen, B: {k: _t(v) for k, v in tr.items()},
        torch.Generator().manual_seed(0), episodes=3, device="cpu")
    assert n == n_ref == jbuf.size == tbuf.size > 0
    s = slice(0, n)
    np.testing.assert_array_equal(tbuf.action[s], jbuf.action[s])
    np.testing.assert_array_equal(tbuf.done[s], jbuf.done[s])
    np.testing.assert_allclose(tbuf.obs[s], jbuf.obs[s], atol=1e-6)
    np.testing.assert_allclose(tbuf.next_obs[s], jbuf.next_obs[s], atol=1e-6)
    np.testing.assert_allclose(tbuf.reward[s], jbuf.reward[s], rtol=1e-5,
                               atol=1e-6)


def test_sac_train_with_demonstrations_and_curriculum():
    """`sac.train` takes `demo_episodes` and `curriculum=`: the buffer is
    seeded before the first round, which then collects with the actor."""
    from repro_torch.core import agent as TAG
    tc = TWL.TraceConfig(num_tasks=8, max_servers=4, arrival_rate=0.08)
    scfg = TSAC.SACConfig(batch_size=16, warmup_steps=8, buffer_capacity=4096,
                          update_every=32)
    ts, hist = TSAC.train(
        TECFG, TAG.AgentConfig(T=2, hidden=16), scfg,
        lambda gen, B: TWL.make_trace_batch(tc, B, generator=gen,
                                            device="cpu"),
        4, num_envs=2, log_every=0, demo_episodes=2,
        curriculum=TSC.training_curriculum(TECFG), device="cpu")
    assert len(hist) == 4 and not hist[0]["warmup"]
    assert int(ts.step) == sum({h["round"]: h["updates"] for h in hist}.values()) > 0
