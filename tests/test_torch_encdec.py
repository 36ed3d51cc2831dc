"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper-small),
its cross-attention (`models/blocks.py`) and the VLM frontend of
`models/lm.py` (internvl2-1b) against the reference on the CPU.

Inputs come from numpy seeds and go to both sides; weights are drawn by the
reference (`init_encdec`, `init_attn`, `init_lm`) and carried across as
numpy through `params_from_jax`. Tolerance `LM_TOL` = 1e-5 (rtol = atol)
on the encoder output, the caches and the logits; `generate` tokens
exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JCFG
from repro.models import blocks as JB
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.models.zoo import build_model as jbuild
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import tree_paths
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.models import blocks as TB
from repro_torch.models import encdec as TED
from repro_torch.models import lm as TLM
from repro_torch.models import zoo as TZOO
from repro_torch.serving import ModelExecutor, chunkable

LM_TOL = 1e-5
WHISPER, VLM = "whisper-small", "internvl2-1b"


def _close(got, want, tol=LM_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _whisper():
    """whisper reduced: d 256, 2 + 2 layers, 4 heads of 64, 16 frames."""
    jc = JCFG.get_config(WHISPER).reduced()
    tc = TCFG.get_config(WHISPER).reduced()
    jp = JED.init_encdec(jc, jax.random.PRNGKey(3))
    return jc, tc, jp, _carry(jp)


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- pieces
def test_sinusoid_pos_matches_reference():
    pos = np.arange(37) + 5
    _close(TED.sinusoid_pos(torch.from_numpy(pos), 64).numpy(),
           JED.sinusoid_pos(jnp.asarray(pos), 64), 1e-6)


@pytest.mark.parametrize("S,T", [(1, 16), (7, 16), (5, 23)])
def test_cross_attention_matches_reference(S, T):
    jc, tc, _, _ = _whisper()
    jp = JB.init_cross_attn(jax.random.PRNGKey(S), jc)
    tp = _carry(jp)
    rng = np.random.default_rng(S + T)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, T, jc.d_model)).astype(np.float32)
    jkv = JB.cross_attn_kv(jp, jc, jnp.asarray(enc))
    tkv = TB.cross_attn_kv(tp, tc, torch.from_numpy(enc))
    for key in ("k", "v"):
        _close(tkv[key].numpy(), jkv[key])
    want = JB.cross_attn_apply(jp, jc, jnp.asarray(x), jkv)
    got = TB.cross_attn_apply(tp, tc, torch.from_numpy(x), tkv)
    _close(got.numpy(), want)
    ref = TB.cross_attn_apply(tp, tc, torch.from_numpy(x), tkv, impl="ref")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_init_tree_and_cache_match_reference():
    jc, tc, jp, _ = _whisper()
    tp = TED.init_encdec(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        t = tflat[key]
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, key
        if np.all(j == j.flat[0]):           # layernorm ones and zeros
            assert torch.all(t == float(j.flat[0])), key
    jcache = JED.init_encdec_cache(jc, 2, 10, 16, jnp.float32)
    tcache = TED.init_encdec_cache(tc, 2, 10, 16, torch.float32,
                                   device="cpu")
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert tuple(tcache[part][key].shape) == jcache[part][key].shape
    assert tcache["pos"] == 0
    model = TZOO.build_model(tc)
    cache = model.make_cache(1, 12, torch.float32, device="cpu")
    assert cache["cross"]["k"].shape[2] == tc.frontend_tokens
    assert model.make_cache(1, 12, device="cpu", enc_len=5)[
        "cross"]["k"].shape[2] == 5


# ----------------------------------------------------------------- whisper
def test_encode_and_logits_match_reference():
    jc, tc, jp, tp = _whisper()
    frames = _frames(jc, 2, 1)
    tok = np.random.default_rng(2).integers(0, jc.vocab_size,
                                            (2, 9)).astype(np.int32)
    _close(TED.encode(tp, tc, torch.from_numpy(frames)).numpy(),
           JED.encode(jp, jc, jnp.asarray(frames)))
    want = JED.encdec_logits(jp, jc, jnp.asarray(frames), jnp.asarray(tok))
    got = TED.encdec_logits(tp, tc, torch.from_numpy(frames),
                            torch.from_numpy(tok).long())
    _close(got.numpy(), want)
    assert torch.all(got[..., tc.vocab_size:] == -1e30)


def test_prefill_decode_match_reference():
    """Prefill fills the self and cross caches; 4 greedy decode steps read
    them; the last decode equals the teacher-forced logits."""
    jc, tc, jp, tp = _whisper()
    frames = _frames(jc, 2, 4)
    tok = np.random.default_rng(5).integers(0, jc.vocab_size,
                                            (2, 11)).astype(np.int32)
    jcache = JED.init_encdec_cache(jc, 2, 20, jc.frontend_tokens,
                                   jnp.float32)
    tcache = TED.init_encdec_cache(tc, 2, 20, tc.frontend_tokens,
                                   torch.float32, device="cpu")
    jl, jcache = JED.encdec_prefill(jp, jc, jnp.asarray(frames),
                                    jnp.asarray(tok), jcache, jnp.float32)
    tl, tcache = TED.encdec_prefill(tp, tc, torch.from_numpy(frames),
                                    torch.from_numpy(tok).long(), tcache,
                                    torch.float32)
    _close(tl.numpy(), jl)
    assert tcache["pos"] == int(jcache["pos"]) == 11
    for part in ("self", "cross"):
        for key in ("k", "v"):
            _close(tcache[part][key].numpy(), jcache[part][key])
    seq = tok
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        seq = np.concatenate([seq, nxt.astype(np.int32)], axis=1)
        jl, jcache = JED.encdec_decode(jp, jc, jcache, jnp.asarray(nxt),
                                       jnp.float32)
        tl, tcache = TED.encdec_decode(tp, tc, tcache,
                                       torch.from_numpy(nxt.copy()).long(),
                                       torch.float32)
        _close(tl.numpy(), jl)
    _close(tcache["self"]["v"].numpy(), jcache["self"]["v"])
    full = TED.encdec_logits(tp, tc, torch.from_numpy(frames),
                             torch.from_numpy(seq).long())
    torch.testing.assert_close(tl[:, 0], full[:, -1], rtol=1e-4, atol=1e-4)


def test_prefill_launches_flash_per_attention(monkeypatch):
    """Each encoder layer, each decoder self-attention and each
    cross-attention of the prefill is one call of `ops.attention` (on the
    card under `impl="auto"`: one flash launch each, 12 + 12 + 12 at full
    width). On CPU tensors both impls take the plain blocked attention and
    never the kernel wrapper; both give the same logits."""
    _, tc, _, tp = _whisper()
    calls, kernel = [], []
    fa, blocked = TFA.flash_attention, TFA.blocked_attention

    def counted(log, fn):
        def wrapped(*args, **kw):
            log.append(kw.get("causal"))
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(TFA, "flash_attention", counted(kernel, fa))
    monkeypatch.setattr(TFA, "blocked_attention", counted(calls, blocked))
    model = TZOO.build_model(tc)
    batch = {"frames": torch.from_numpy(_frames(tc, 1, 6)),
             "tokens": torch.arange(1, 8)[None]}
    out = {}
    for impl in ("auto", "ref"):
        calls.clear()
        cache = model.make_cache(1, 12, torch.float32, device="cpu")
        out[impl], _ = model.prefill(params=tp, batch=batch, cache=cache,
                                     compute_dtype=torch.float32, impl=impl)
        n = tc.encoder_layers + 2 * tc.num_layers
        assert len(calls) == n, (impl, calls)
    assert kernel == []
    torch.testing.assert_close(out["auto"], out["ref"], rtol=0, atol=0)


# -------------------------------------------------------------------- VLM
@functools.lru_cache(maxsize=None)
def _vlm():
    """internvl2 reduced: d 256, 2 layers, 16 patch tokens of 256."""
    jc = JCFG.get_config(VLM).reduced()
    tc = TCFG.get_config(VLM).reduced()
    jp = JLM.init_lm(jc, jax.random.PRNGKey(8))
    return jc, tc, jp, _carry(jp)


def test_vlm_frontend_prefill_decode_match_reference():
    """The projected patch embeddings go in front of the prompt: the cache
    holds frontend_tokens more positions and `pos` counts them; prefill and
    3 decode steps against the reference's zoo model."""
    jc, tc, jp, tp = _vlm()
    assert sorted(tp) == sorted(jp) and "frontend_proj" in tp
    assert tuple(tp["frontend_proj"]["w"].shape) == (tc.frontend_dim,
                                                     tc.d_model)
    rng = np.random.default_rng(9)
    img = rng.standard_normal((2, tc.frontend_tokens,
                               tc.frontend_dim)).astype(np.float32)
    tok = rng.integers(0, jc.vocab_size, (2, 10)).astype(np.int32)
    jm, tm = jbuild(jc), TZOO.build_model(tc)
    jcache = jm.make_cache(2, 16, jnp.float32)
    tcache = tm.make_cache(2, 16, torch.float32, device="cpu")
    assert tcache["periods"]["blk0_attn"]["k"].shape[2] == \
        16 + tc.frontend_tokens == jcache["periods"]["blk0_attn"]["k"].shape[2]
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tok),
                                 "image_embeds": jnp.asarray(img)}, jcache,
                            compute_dtype=jnp.float32)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tok).long(),
                                 "image_embeds": torch.from_numpy(img)},
                            tcache, torch.float32)
    _close(tl.numpy(), jl)
    assert tcache["pos"] == int(jcache["pos"]) == 10 + tc.frontend_tokens
    _close(tcache["periods"]["blk0_attn"]["k"].numpy(),
           jcache["periods"]["blk0_attn"]["k"])
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(nxt),
                               compute_dtype=jnp.float32)
        tl, tcache = tm.decode(tp, tcache,
                               torch.from_numpy(nxt.copy()).long(),
                               torch.float32)
        _close(tl.numpy(), jl)
    jlog, _ = JLM.lm_logits(jp, jc, jnp.asarray(tok), jnp.asarray(img))
    tlog, _ = TLM.lm_logits(tp, tc, torch.from_numpy(tok).long(),
                            frontend=torch.from_numpy(img))
    assert tlog.shape[1] == 10 + tc.frontend_tokens
    _close(tlog.numpy(), jlog)


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_generate_matches_reference_tokens(arch):
    """`ModelExecutor.generate` token for token against the reference's on
    carried params, with the zero stub frontend inputs both executors pass;
    neither family is chunkable, so c = 2 prefills unchunked."""
    _, tc, jp, tp = _whisper() if arch == WHISPER else _vlm()
    jex = JExecutor(reduced=True)
    tex = ModelExecutor(reduced=True, device="cpu")
    assert not chunkable(tex.model(arch).cfg)
    batch = tex._full_batch(tc, np.arange(3))
    key = "frames" if arch == WHISPER else "image_embeds"
    width = tc.d_model if arch == WHISPER else tc.frontend_dim
    assert tuple(batch[key].shape) == (1, tc.frontend_tokens, width)
    assert not bool(batch[key].any())
    for prompt_len, c, steps in ((12, 1, 5), (9, 2, 4)):
        prompt = np.random.default_rng(prompt_len).integers(1, 900,
                                                            prompt_len)
        want = jex.generate(arch, jp, prompt.astype(np.int32), c, steps, 16)
        got = tex.generate(arch, tp, prompt, c, steps, 16)
        np.testing.assert_array_equal(got, want)
        assert tex.shape_key(arch, prompt_len, c, steps, 16) == \
            jex.shape_key(arch, prompt_len, c, steps, 16)
