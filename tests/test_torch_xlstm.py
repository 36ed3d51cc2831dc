"""The port's xLSTM blocks (`repro_torch.models.blocks`: mLSTM and sLSTM)
and the "xlstm" pattern of `models/lm.py` (xlstm-125m) against the
reference on the CPU.

Inputs come from numpy seeds and go to both sides; weights are drawn by the
reference (`init_mlstm`, `init_slstm`, `init_lm`) and carried across as
numpy through `params_from_jax`. The reference pads the mLSTM scan to
64-step chunks whose padded steps keep the state; the port loops over the
real steps only, so the states are held at prompt lengths on the chunk
(64), off it (1, 20, 100) and past two chunks (129). Tolerance `LM_TOL` =
1e-5 (rtol = atol) on the blocks' outputs and every state (C, n, m; c, n,
h, m) and on the LM's logits; the LM's layer states at `LM_STATE_TOL` =
5e-5: what three mLSTM layers' fp32 sums (in another order than the
reference's) leave in the sLSTM layer's input, its 20-step recurrence
carries (measured 1.4e-5 at most). `generate` tokens exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JCFG
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import tree_paths
from repro_torch.models import blocks as TB
from repro_torch.models import lm as TLM
from repro_torch.serving import ModelExecutor, chunkable

LM_TOL = 1e-5
LM_STATE_TOL = 5e-5
ARCH = "xlstm-125m"
CELLS = ("mlstm", "slstm")
MLSTM_KEYS, SLSTM_KEYS = ("C", "n", "m"), ("c", "n", "h", "m")


def _close(got, want, tol=LM_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _cfgs():
    return JCFG.get_config(ARCH).reduced(), TCFG.get_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _block(cell):
    """xlstm reduced (d 256, inner 512, 4 heads of 128): the reference's
    params of one cell, and the same carried across."""
    jc, tc = _cfgs()
    jp = getattr(JB, f"init_{cell}")(jax.random.PRNGKey(5), jc, jc.ssm)
    return jc, tc, jp, _carry(jp)


# the reference's cell prefill, jitted (one compile per prompt length)
J_PREFILL = {cell: jax.jit(getattr(JB, f"{cell}_prefill"),
                           static_argnums=(1, 2)) for cell in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_init_tree_and_cache_match_reference(cell):
    jc, tc, jp, _ = _block(cell)
    tp = getattr(TB, f"init_{cell}")(torch.Generator().manual_seed(0), tc,
                                     tc.ssm, lead=(2,), device="cpu")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        assert tuple(tflat[key].shape) == (2,) + j.shape, key
        if np.all(j == 0):                   # the gate biases
            assert torch.all(tflat[key] == 0), key
        else:                                # same init scale
            assert abs(float(tflat[key].std()) / float(np.std(j)) - 1) < 0.1
    jcache = getattr(JB, f"init_{cell}_cache")(jc, jc.ssm, 3)
    tcache = getattr(TB, f"init_{cell}_cache")(tc, tc.ssm, 3, device="cpu")
    assert sorted(tcache) == sorted(jcache)
    for key, j in jcache.items():
        t = tcache[key]
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape, key
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _random_cache(cell, cfg, rng, B):
    """A state mid-sequence: C, n, c, h random, n of sLSTM positive, the
    stabiliser m moderate."""
    inner = cfg.ssm.expand * cfg.d_model
    nh = cfg.ssm.mlstm_heads
    dh = inner // nh
    f32 = np.float32
    if cell == "mlstm":
        return {"C": rng.standard_normal((B, nh, dh, dh)).astype(f32),
                "n": rng.standard_normal((B, nh, dh)).astype(f32),
                "m": rng.uniform(-2, 2, (B, nh)).astype(f32)}
    return {"c": rng.standard_normal((B, nh, dh)).astype(f32),
            "n": rng.uniform(0.5, 3, (B, nh, dh)).astype(f32),
            "h": rng.standard_normal((B, nh, dh)).astype(f32),
            "m": rng.uniform(-2, 2, (B, nh, dh)).astype(f32)}


@pytest.mark.parametrize("start", ["initial", "random"])
@pytest.mark.parametrize("S", [1, 20, 64, 100, 129])
@pytest.mark.parametrize("cell", CELLS)
def test_prefill_then_decode_states_match_reference(cell, S, start):
    """Prefill S positions from the initial or a random state, then 3
    decode steps: every output and every state against the reference's."""
    jc, tc, jp, tp = _block(cell)
    rng = np.random.default_rng(S * 7 + len(start))
    B = 2
    if start == "initial":
        jcache = getattr(JB, f"init_{cell}_cache")(jc, jc.ssm, B)
    else:
        jcache = {k: jnp.asarray(v)
                  for k, v in _random_cache(cell, jc, rng, B).items()}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jy, jcache = J_PREFILL[cell](jp, jc, jc.ssm, jnp.asarray(x), jcache)
    ty, tcache = getattr(TB, f"{cell}_prefill")(tp, tc, tc.ssm,
                                                torch.from_numpy(x), tcache)
    _close(ty.numpy(), jy)
    for key in jcache:
        _close(tcache[key].numpy(), jcache[key])
    for _ in range(3):
        xd = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        jy, jcache = J_PREFILL[cell](jp, jc, jc.ssm, jnp.asarray(xd), jcache)
        ty, tcache = getattr(TB, f"{cell}_decode")(tp, tc, tc.ssm,
                                                   torch.from_numpy(xd),
                                                   tcache)
        _close(ty.numpy(), jy)
        for key in jcache:
            _close(tcache[key].numpy(), jcache[key])


@pytest.mark.parametrize("cell", CELLS)
def test_train_forward_matches_reference(cell):
    jc, tc, jp, tp = _block(cell)
    x = np.random.default_rng(11).standard_normal(
        (2, 70, jc.d_model)).astype(np.float32)
    want = getattr(JB, f"{cell}_train")(jp, jc, jc.ssm, jnp.asarray(x))
    got = getattr(TB, f"{cell}_train")(tp, tc, tc.ssm, torch.from_numpy(x))
    _close(got.numpy(), want)


# ------------------------------------------------------------------- LM
@functools.lru_cache(maxsize=None)
def _lm():
    jc, tc = _cfgs()
    jp = JLM.init_lm(jc, jax.random.PRNGKey(2))
    return jc, tc, jp, _carry(jp)


def test_period_spec_init_and_cache_trees():
    jc, tc, jp, _ = _lm()
    assert TLM.period_spec(tc) == JLM.period_spec(jc) == (
        ("mlstm", "none"),) * 3 + (("slstm", "none"),)
    assert TLM.n_periods(tc) == 1 and TLM.n_periods(
        TCFG.get_config(ARCH)) == 3
    assert not chunkable(tc)
    tp = TLM.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        assert tuple(tflat[key].shape) == j.shape, key
    jcache = tree_paths(jax.tree_util.tree_map(
        np.asarray, JLM.init_cache(jc, 2, 12, jnp.float32)["periods"]))
    tcache = tree_paths(TLM.init_cache(tc, 2, 12, torch.float32,
                                       device="cpu")["periods"])
    assert sorted(tcache) == sorted(jcache)
    for key, j in jcache.items():
        np.testing.assert_array_equal(tcache[key].numpy(), j)


def test_lm_prefill_decode_match_reference():
    jc, tc, jp, tp = _lm()
    tok = np.random.default_rng(4).integers(0, jc.vocab_size,
                                            (2, 20)).astype(np.int32)
    jcache = JLM.init_cache(jc, 2, 28, jnp.float32)
    tcache = TLM.init_cache(tc, 2, 28, torch.float32, device="cpu")
    jl, jcache = JLM.lm_prefill(jp, jc, jnp.asarray(tok), jcache,
                                compute_dtype=jnp.float32)
    tl, tcache = TLM.lm_prefill(tp, tc, torch.from_numpy(tok).long(),
                                tcache, torch.float32)
    _close(tl.numpy(), jl)
    for key in MLSTM_KEYS:
        _close(tcache["periods"]["blk0_mlstm"][key].numpy(),
               jcache["periods"]["blk0_mlstm"][key], LM_STATE_TOL)
    for key in SLSTM_KEYS:
        _close(tcache["periods"]["blk3_slstm"][key].numpy(),
               jcache["periods"]["blk3_slstm"][key], LM_STATE_TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        jl, jcache = JLM.lm_decode(jp, jc, jcache, jnp.asarray(nxt),
                                   compute_dtype=jnp.float32)
        tl, tcache = TLM.lm_decode(tp, tc, tcache,
                                   torch.from_numpy(nxt.copy()).long(),
                                   torch.float32)
        _close(tl.numpy(), jl)
    jlog, _ = JLM.lm_logits(jp, jc, jnp.asarray(tok))
    tlog, aux = TLM.lm_logits(tp, tc, torch.from_numpy(tok).long())
    _close(tlog.numpy(), jlog)
    assert float(aux) == 0.0
    # decode continues the full forward (the recurrence is slicing-invariant)
    cache = TLM.init_cache(tc, 2, 28, torch.float32, device="cpu")
    t = torch.from_numpy(tok).long()
    _, cache = TLM.lm_prefill(tp, tc, t[:, :19], cache, torch.float32)
    dec, _ = TLM.lm_decode(tp, tc, cache, t[:, 19:], torch.float32)
    torch.testing.assert_close(dec[:, 0], tlog[:, 19], rtol=1e-4, atol=1e-4)


def test_generate_matches_reference_tokens():
    """`ModelExecutor.generate` token for token against the reference's on
    carried params; xLSTM is not chunkable, so c = 2 prefills unchunked."""
    _, _, jp, tp = _lm()
    jex = JExecutor(reduced=True)
    tex = ModelExecutor(reduced=True, device="cpu")
    for prompt_len, c, steps in ((12, 1, 6), (9, 2, 4)):
        prompt = np.random.default_rng(prompt_len).integers(1, 900,
                                                            prompt_len)
        want = jex.generate(ARCH, jp, prompt.astype(np.int32), c, steps, 16)
        got = tex.generate(ARCH, tp, prompt, c, steps, 16)
        np.testing.assert_array_equal(got, want)
        assert tex.shape_key(ARCH, prompt_len, c, steps, 16) == \
            jex.shape_key(ARCH, prompt_len, c, steps, 16)
