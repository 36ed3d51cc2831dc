"""The port's actor (`repro_torch`) against the reference (`repro`) on the
CPU: activation, schedules, coefficient builders, encoders, the denoiser
chain, the samplers, `actor_sample` for every variant and params carried
across from the reference.

The reference's draws (x_T, chain noises, SAC-head eps) are reproduced from
its PRNG key here and handed to the port, so both sides see the same
numbers. Matrix products and transcendental functions come from two
libraries, so values are held to tolerances: 1e-6 on single elementwise
functions and schedules, 1e-5 on one network forward, 2e-5 on a whole
reverse chain (as the reference's own chain-vs-reverse_sample test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.actors import samplers as JSMP
from repro.common.checkpoint import save_checkpoint
from repro.core import agent as JAG
from repro.core import diffusion as JDF
from repro.core import networks as JNW
from repro.core.env import EnvConfig as JEnvConfig
from repro.kernels.denoiser import ref as JKREF
from repro.models.layers import mish as jmish
from repro_torch.actors import policies as TPOL
from repro_torch.actors import samplers as TSMP
from repro_torch.common.checkpoint import load_params, params_from_jax
from repro_torch.core import agent as TAG
from repro_torch.core import diffusion as TDF
from repro_torch.core import networks as TNW
from repro_torch.core.env import EnvConfig as TEnvConfig
from repro_torch.kernels.denoiser import kernel as TKER
from repro_torch.kernels.denoiser import ops as TKOPS
from repro_torch.kernels.denoiser import ref as TKREF
from repro_torch.models.layers import mish as tmish

ECFG = dict(num_servers=4, max_tasks=8, queue_window=4)
JECFG, TECFG = JEnvConfig(**ECFG), TEnvConfig(**ECFG)
A = JECFG.action_dim
T = 4
H = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _obs(rng, B):
    return rng.uniform(0.0, 1.5, (B,) + JECFG.obs_shape).astype(np.float32)


# ------------------------------------------------------------- building blocks
def test_mish_matches_reference():
    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [0.0, 1e-8, -1e-8, 19.9, 20.1]]).astype(np.float32)
    _close(tmish(_t(x)), jmish(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("T_", [1, 4, 10])
def test_schedules_and_coefficients_match_reference(T_):
    js, ts = JDF.vp_schedule(T_), TDF.vp_schedule(T_, device="cpu")
    for f in JDF.DiffusionSchedule._fields:
        _close(getattr(ts, f), getattr(js, f), 1e-6, f)
    i = np.arange(1, T_ + 1, dtype=np.int32)
    _close(TDF.timestep_embedding(_t(i), 16), JDF.timestep_embedding(jnp.asarray(i), 16),
           1e-6)
    for got, want in zip(TSMP.ddpm_coeffs(ts), JSMP.ddpm_coeffs(js)):
        _close(got, want, 1e-5)
    for K in range(1, T_ + 1):
        np.testing.assert_array_equal(TSMP.ddim_taus(T_, K), JSMP.ddim_taus(T_, K))
        for got, want in zip(TSMP.ddim_coeffs(ts, K), JSMP.ddim_coeffs(js, K)):
            _close(got, want, 1e-5, f"ddim K={K}")
    with pytest.raises(ValueError):
        TSMP.ddim_taus(T_, T_ + 1)


def test_parse_and_normalize_sampler():
    assert TSMP.parse_sampler(None) == ("ddpm", None)
    assert TSMP.parse_sampler(" DDIM:5 ") == ("ddim", 5)
    assert TSMP.normalize_sampler("ddim:3") == "ddim:3"
    assert TSMP.parse_sampler("distilled") == ("distilled", None)
    for bad in ("ddim:x", "ddim:0", "euler"):
        with pytest.raises(ValueError):
            TSMP.parse_sampler(bad)


@pytest.mark.parametrize("kind", ["attention", "mlp"])
def test_encoders_match_reference(kind):
    jp, jfn, jdim = JNW.make_encoder(kind, jax.random.PRNGKey(3),
                                     JECFG.obs_shape, 32)
    _, tfn, tdim = TNW.make_encoder(kind, TECFG.obs_shape, 32,
                                    generator=torch.Generator(), device="cpu")
    assert tdim == jdim
    obs = _obs(np.random.default_rng(0), 6)
    _close(tfn(_to_torch(jp), _t(obs)), jfn(jp, jnp.asarray(obs)), 1e-5)


# ------------------------------------------------------------- denoiser chain
def _chain_inputs(rng, B, A_, F, K, hidden=H):
    p = JDF.init_denoiser(jax.random.PRNGKey(int(rng.integers(1 << 30))),
                          A_, F, hidden)
    x = rng.standard_normal((B, A_)).astype(np.float32)
    noises = rng.standard_normal((K, B, A_)).astype(np.float32)
    f_s = rng.standard_normal((B, F)).astype(np.float32)
    tembs = np.asarray(JDF.timestep_embedding(jnp.arange(K) + 1, 16))
    cx = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    ce = (0.1 * rng.standard_normal(K)).astype(np.float32)
    cn = (0.1 * rng.uniform(size=K)).astype(np.float32)
    return p, (x, noises, f_s, tembs, cx, ce, cn)


@pytest.mark.parametrize("B,A_,F,K", [(8, 6, 8, 4), (3, 10, 16, 10), (5, 3, 7, 1)])
def test_denoiser_chain_ref_matches_reference(B, A_, F, K):
    rng = np.random.default_rng(B * 7 + K)
    p, arrays = _chain_inputs(rng, B, A_, F, K)
    w = [a for layer in p["layers"] for a in (layer["w"], layer["b"])]
    want = JKREF.denoiser_chain_ref(*map(jnp.asarray, arrays), *w)
    got = TKREF.denoiser_chain_ref(*map(_t, arrays), *(_t(a) for a in w))
    _close(got, want, 1e-5)
    # the ops door and the wrapper take the plain version for CPU tensors
    tp = _to_torch(p)
    for impl in ("auto", "ref"):
        _close(TKOPS.denoise_chain(tp, *map(_t, arrays), impl=impl), got, 0)
    assert TKER.denoiser_chain.launches == 0


def test_denoise_chain_rejects_wrong_layer_count():
    p = _to_torch(JDF.init_denoiser(jax.random.PRNGKey(0), 3, 8, 16))
    args = (torch.zeros(2, 3), torch.zeros(1, 2, 3), torch.zeros(2, 8),
            torch.zeros(1, 16), torch.ones(1), torch.ones(1), torch.zeros(1))
    for n in (2, 4):
        with pytest.raises(ValueError, match="exactly 3 MLP layers"):
            TKOPS.denoise_chain({"layers": (p["layers"] * 2)[:n]}, *args)
    with pytest.raises(ValueError, match="layers"):
        TKOPS.denoise_chain({"w": torch.zeros(())}, *args)
    with pytest.raises(ValueError, match="impl"):
        TKOPS.denoise_chain(p, *args, impl="pallas")


def _reverse_draws(key, batch, T_):
    """The reference's reverse_sample draws: key -> (kx, kn)."""
    kx, kn = jax.random.split(key)
    return (np.asarray(jax.random.normal(kx, batch + (A,))),
            np.asarray(jax.random.normal(kn, (T_,) + batch + (A,))))


@pytest.mark.parametrize("batch", [(), (5,)], ids=["single", "batched"])
def test_chain_sample_ddpm_matches_reverse_sample(batch):
    """chain_sample("ddpm") on the reference's draws equals the reference's
    reverse_sample within 2e-5; so does the port's own reverse_sample."""
    ks = jax.random.split(jax.random.PRNGKey(11), 3)
    F = 12
    p = JDF.init_denoiser(ks[0], A, F, hidden=24)
    js = JDF.vp_schedule(6)
    f_s = jax.random.normal(ks[1], batch + (F,))
    want = JDF.reverse_sample(p, js, f_s, ks[2], A)
    x_T, noises = _reverse_draws(ks[2], batch, 6)
    tp, ts, tf = _to_torch(p), TDF.vp_schedule(6, device="cpu"), _t(f_s)
    got = TSMP.chain_sample(tp, ts, tf,
                            A, kind="ddpm", x_T=_t(x_T), noises=_t(noises))
    _close(got, want, 2e-5)
    _close(TDF.reverse_sample(tp, ts, tf, A, x_T=_t(x_T), noises=_t(noises)),
           want, 2e-5)


def test_chain_sample_ddim_matches_reference():
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    p = JDF.init_denoiser(ks[0], A, 8, hidden=H)
    js = JDF.vp_schedule(10)
    f_s = jax.random.normal(ks[1], (4, 8))
    want = JSMP.chain_sample(p, js, f_s, ks[2], A, kind="ddim", K=3,
                             impl="ref")
    x_T = np.asarray(jax.random.normal(jax.random.split(ks[2])[0], (4, A)))
    got = TSMP.chain_sample(_to_torch(p), TDF.vp_schedule(10, device="cpu"),
                            _t(f_s), A, kind="ddim", K=3, x_T=_t(x_T))
    _close(got, want, 2e-5)


# ------------------------------------------------------------- the actor
@pytest.mark.parametrize("variant", ["eat", "eat-a", "eat-d", "eat-da"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["sample", "det"])
def test_actor_sample_matches_reference(variant, deterministic):
    jacfg = JAG.AgentConfig(variant=variant, T=T, hidden=H)
    tacfg = TAG.AgentConfig(variant=variant, T=T, hidden=H)
    key = jax.random.PRNGKey(21)
    jp = JAG.init_actor(jax.random.PRNGKey(2), JECFG, jacfg)
    obs = _obs(np.random.default_rng(1), 6)
    want = JAG.actor_sample(jp, jacfg, JECFG, JDF.vp_schedule(T),
                            jnp.asarray(obs), key, deterministic=deterministic)
    kd, ks = jax.random.split(key)
    x_T, noises = _reverse_draws(kd, (6,), T)
    eps = np.asarray(jax.random.normal(ks, (6, A)))
    got = TAG.actor_sample(_to_torch(jp), tacfg, TECFG,
                           TDF.vp_schedule(T, device="cpu"), _t(obs),
                           deterministic=deterministic, x_T=_t(x_T),
                           noises=_t(noises), eps=_t(eps))
    for name, g, w in zip(("action", "mean", "log_sigma", "entropy"), got, want):
        _close(g, w, 2e-5, name)
    _close(TAG.to_env_action(got[0]), JAG.to_env_action(want[0]), 2e-5)


@pytest.mark.parametrize("variant", ["eat", "eat-d"])
def test_actor_policy_matches_actor_sample(variant):
    """The rollout policy (mean through chain_sample) draws x_T, noises and
    eps from its generator in actor_sample's order and gives its action."""
    acfg = TAG.AgentConfig(variant=variant, T=T, hidden=H)
    p = TAG.init_actor(TECFG, acfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    obs = _t(_obs(np.random.default_rng(2), 5))
    pol = TPOL.actor_policy(TECFG, acfg, device="cpu")
    assert pol.sampler == "ddpm"
    env_a, extras = pol(p, torch.Generator().manual_seed(9), None, None, obs)
    a, *_ = TAG.actor_sample(p, acfg, TECFG, TDF.vp_schedule(T, device="cpu"),
                             obs, generator=torch.Generator().manual_seed(9))
    _close(extras["agent_action"], a, 2e-5)
    _close(env_a, TAG.to_env_action(a), 2e-5)
    if variant == "eat-d":
        with pytest.raises(ValueError, match="diffusion actor"):
            TPOL.actor_policy(TECFG, acfg, sampler="ddim:2", device="cpu")


# ------------------------------------------------------------- checkpoints
def test_params_carried_from_reference(tmp_path):
    """params_from_jax and an npz written by the reference's save_checkpoint
    give the same tensors, in the reference's layout."""
    jp = JAG.init_actor(jax.random.PRNGKey(4), JECFG, JAG.AgentConfig(hidden=H))
    direct = _to_torch(jp)
    save_checkpoint(str(tmp_path), 7, jp)
    loaded = load_params(str(tmp_path), device="cpu")
    assert load_params(str(tmp_path), 7, device="cpu").keys() == loaded.keys()
    jleaves = jax.tree_util.tree_leaves(jp)
    for tree in (direct, loaded):
        assert set(tree) == {"enc", "sigma_head", "denoiser"}
        assert len(tree["denoiser"]["layers"]) == 3
        assert tuple(tree["denoiser"]["layers"][0]["w"].shape) == (A + 16 + 8, H)
        tleaves = [tree["denoiser"]["layers"][i][k] for i in range(3)
                   for k in ("b", "w")] + [tree["enc"][k] for k in
                                          ("wk", "wo", "wq", "wv")] \
            + [tree["sigma_head"][k] for k in ("b", "w")]
        assert len(tleaves) == len(jleaves)
        for t_, j_ in zip(tleaves, jleaves):
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_))
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "missing"), device="cpu")
