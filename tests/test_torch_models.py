"""The port's model zoo (`repro_torch.models`, `repro_torch.kernels.
flash_attention`, `repro_torch.common.config`) against the reference on
the CPU.

Inputs come from numpy seeds and go to both sides; LM params are drawn by
the reference's `init_lm` and carried across as numpy. Tolerances: the
attention contract is held at the reference's kernel tolerances
(`tests/test_kernels.py`: 2e-5 fp32, 3e-2 bf16, rtol = atol); a reduced LM's
prefill and decode logits at 1e-5 (rtol = atol): two libraries' fp32
matrix products and transcendentals, two layers deep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JCFG
from repro.kernels.flash_attention.ops import attention as pallas_attention
from repro.models import attention as JATT
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.serving import latency_table as JLT
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import param_count, tree_paths
from repro_torch.kernels.flash_attention import kernel as TFK
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import zoo as TZOO
from repro_torch.serving import latency_table as TLT

FLASH_SHAPES = [            # tests/test_kernels.py's five shapes
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 16, True, 0),
    (2, 32, 96, 8, 4, 64, False, 0),
    (1, 128, 128, 4, 2, 32, True, 48),
    (1, 17, 33, 2, 1, 8, False, 0),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
DENSE = ("tinyllama-1.1b", "qwen2-1.5b", "llama3.2-3b", "gemma-7b")
LM_TOL = 1e-5


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,win", FLASH_SHAPES)
def test_attention_matches_pallas_and_jnp(b, s, t, h, kv, hd, causal, win,
                                          dname):
    jdt, tdt, tol = DTYPES[dname]
    rng = np.random.default_rng(s * 7 + t)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (_t(x, tdt) for x in (q, k, v))
    refs = {
        "pallas": pallas_attention(jq, jk, jv, causal=causal, window=win,
                                   block_q=32, block_k=32),
        "jnp": JATT.flash_attention_jnp(jq, jk, jv, causal=causal,
                                        window=win)}
    ports = {
        "ops": TFA.attention(tq, tk, tv, causal=causal, window=win),
        "ops_ref": TFA.attention(tq, tk, tv, causal=causal, window=win,
                                 impl="ref"),
        "models": TATT.flash_attention(tq, tk, tv, causal=causal,
                                       window=win, q_block=32, k_block=32),
        "models_default_blocks": TATT.flash_attention(
            tq, tk, tv, causal=causal, window=win)}
    for pname, got in ports.items():
        assert got.dtype == tdt and got.shape == (b, s, h, hd), pname
        for rname, want in refs.items():
            _close(got.float().numpy(), want.astype(jnp.float32), tol)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the head-major oracle and counts no
    launch; the entry point refuses unknown impls."""
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((2, 4, 40, 64)))
    k = _t(rng.standard_normal((2, 2, 40, 64)))
    v = _t(rng.standard_normal((2, 2, 40, 64)))
    before = TFK.flash_attention.launches
    got = TFK.flash_attention(q, k, v, causal=True, window=16)
    want = attention_ref(q, k, v, causal=True, window=16)
    assert torch.equal(got, want)
    assert TFK.flash_attention.launches == before
    with pytest.raises(ValueError, match="impl"):
        TFA.attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("window,ring,tensor_len", [
    (0, False, False), (0, False, True), (5, False, True), (8, True, False),
    (8, True, True)])
def test_decode_attention(window, ring, tensor_len):
    rng = np.random.default_rng(window + 10 * ring)
    b, h, kv, hd, t = 3, 4, 2, 16, 8 if ring else 24
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kc = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    lens = np.array([3, 11, 20], np.int32) if tensor_len else 13
    want = JATT.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lens),
                                 window=window, ring=ring)
    got = TATT.decode_attention(
        _t(q), _t(kc), _t(vc),
        torch.from_numpy(lens) if tensor_len else lens,
        window=window, ring=ring)
    _close(got.numpy(), want, 2e-5)


def test_simple_attention_q_offset():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    want = JATT.simple_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=4,
                                 q_offset=7)
    got = TATT.simple_attention(_t(q), _t(k), _t(v), causal=True, window=4,
                                q_offset=7)
    _close(got.numpy(), want, 2e-5)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("act", ["silu", "gelu", "geglu"])
def test_layers_match_reference(act):
    from repro.models import layers as JL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jp = JL.init_ffn(jax.random.PRNGKey(0), 16, 24, act)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    _close(TL.ffn(tp, _t(x), act).numpy(),
           JL.ffn(jp, jnp.asarray(x), act), 1e-5)
    norm = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32)}
    tnorm = {k: _t(v) for k, v in norm.items()}
    _close(TL.rmsnorm(tnorm, _t(x)).numpy(),
           JL.rmsnorm(norm, jnp.asarray(x)), 1e-6)
    _close(TL.layernorm(tnorm, _t(x)).numpy(),
           JL.layernorm(norm, jnp.asarray(x)), 1e-5)
    pos = np.arange(5)[None].repeat(2, 0)
    xr = x.reshape(2, 5, 2, 8)
    _close(TL.apply_rope(_t(xr), torch.from_numpy(pos), 500.0).numpy(),
           JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 500.0), 1e-6)
    tok = rng.integers(0, 7, (2, 3))
    table = rng.standard_normal((7, 16)).astype(np.float32)
    assert torch.equal(TL.embed({"table": _t(table)}, torch.from_numpy(tok)),
                       _t(table[tok]))


# ---------------------------------------------------------------- configs
def test_configs_copy_the_reference():
    assert TCFG.ASSIGNED_ARCHS == JCFG.ASSIGNED_ARCHS
    assert TCFG.list_configs() == JCFG.list_configs()
    for name in TCFG.ASSIGNED_ARCHS:
        for suffix in ("", "-reduced"):
            t = TCFG.get_config(name + suffix)
            j = JCFG.get_config(name + suffix)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            assert t.param_count() == j.param_count()
            assert t.param_count(True) == j.param_count(True)
            assert t.padded_vocab == j.padded_vocab
    assert TLT.arch_scales() == JLT.arch_scales()
    assert TLT.env_model_scales() == JLT.env_model_scales()
    with pytest.raises(KeyError):
        TCFG.get_config("no-such-arch")


def _shape_tree(tree):
    return {k: tuple(v.shape) for k, v in tree_paths(tree).items()}


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "olmoe-1b-7b",
                                  "qwen3-moe-30b-a3b", "whisper-small",
                                  "internvl2-1b", "xlstm-125m",
                                  "jamba-v0.1-52b-full-width"])
def test_build_model_refuses_what_is_not_ported(name):
    """Every config builds (reduced, and Jamba at full width) with the
    reference's period pattern, and its params tree has the reference's
    paths and shapes (drawn on the meta device: shapes only, no weights).
    Training, which the zoo refused before, is held to the reference in
    tests/test_torch_lm_train.py."""
    full = name.endswith("-full-width")
    jc = JCFG.get_config(name.removesuffix("-full-width"))
    tc = TCFG.get_config(name.removesuffix("-full-width"))
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    model = TZOO.build_model(tc)
    jinit = JED.init_encdec if jc.family == "audio" else JLM.init_lm
    want = _shape_tree(jax.eval_shape(lambda k: jinit(jc, k),
                                      jax.random.PRNGKey(0)))
    got = _shape_tree(model.init(torch.Generator(), device="meta"))
    assert got == want
    if jc.family != "audio":
        assert TLM.period_spec(tc) == JLM.period_spec(jc)
    if full and jc.layer_pattern == "jamba":
        assert TLM.period_spec(tc) == tuple(
            ("attn" if i == 7 else "mamba", "moe" if i % 2 else "dense")
            for i in range(8))


# ---------------------------------------------------------------- the LM
def _carried(name, seed=0):
    jc, tc = JCFG.get_config(name).reduced(), TCFG.get_config(name).reduced()
    jp = JLM.init_lm(jc, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("name", DENSE)
def test_init_lm_tree_matches_reference(name):
    jc, tc, jp, _ = _carried(name)
    tp = TLM.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = {k: np.asarray(v) for k, v in tree_paths(
        jax.tree_util.tree_map(np.asarray, jp)).items()}
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        t = tflat[key]
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, key
        assert str(j.dtype) == "float32", key
        if j.size >= 4096:          # same init scale (stddev within 10 %)
            assert abs(float(t.std()) / float(j.std()) - 1.0) < 0.1, key
        else:                       # norms' ones, biases' zeros
            if not np.all(j == j.flat[0]):
                continue
            assert torch.all(t == float(j.flat[0])), key
    assert param_count(tp) == sum(v.size for v in jflat.values())
    bf = TLM.init_lm(tc, torch.Generator().manual_seed(0), torch.bfloat16,
                     device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in tree_paths(bf).values())


@pytest.mark.parametrize("name", DENSE)
def test_lm_prefill_decode_match_reference(name):
    jc, tc, jp, tp = _carried(name)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    jcache = JLM.init_cache(jc, 2, 28, jnp.float32)
    tcache = TLM.init_cache(tc, 2, 28, torch.float32, device="cpu")
    jl, jcache = JLM.lm_prefill(jp, jc, jnp.asarray(tok), jcache,
                                compute_dtype=jnp.float32)
    tl, tcache = TLM.lm_prefill(tp, tc, torch.from_numpy(tok).long(),
                                tcache, torch.float32)
    _close(tl.numpy(), jl, LM_TOL)
    assert tcache["pos"] == int(jcache["pos"]) == 20
    _close(tcache["periods"]["blk0_attn"]["k"].numpy(),
           jcache["periods"]["blk0_attn"]["k"], LM_TOL)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        jl, jcache = JLM.lm_decode(jp, jc, jcache, jnp.asarray(nxt),
                                   compute_dtype=jnp.float32)
        tl, tcache = TLM.lm_decode(tp, tc, tcache,
                                   torch.from_numpy(nxt.copy()).long(),
                                   torch.float32)
        _close(tl.numpy(), jl, LM_TOL)
        assert tcache["pos"] == int(jcache["pos"])
    jlog, _ = JLM.lm_logits(jp, jc, jnp.asarray(tok))
    tlog, aux = TLM.lm_logits(tp, tc, torch.from_numpy(tok).long())
    _close(tlog.numpy(), jlog, LM_TOL)
    assert float(aux) == 0.0
    if tc.padded_vocab != tc.vocab_size:      # qwen2: the padding is masked
        assert torch.all(tlog[..., tc.vocab_size:] == -1e30)


def test_sliding_window_ring_cache_matches_reference():
    """A window smaller than the prompt: prefill keeps the tail in a ring
    (position p at p % window) and decode wraps, as the reference does."""
    jc0, tc0, jp, tp = _carried("tinyllama-1.1b", seed=3)
    jc = dataclasses.replace(jc0, sliding_window=8)
    tc = dataclasses.replace(tc0, sliding_window=8)
    rng = np.random.default_rng(8)
    tok = rng.integers(0, jc.vocab_size, (1, 13)).astype(np.int32)
    jcache = JLM.init_cache(jc, 1, 32, jnp.float32)
    tcache = TLM.init_cache(tc, 1, 32, torch.float32, device="cpu")
    assert tcache["periods"]["blk0_attn"]["k"].shape[2] == 8
    jl, jcache = JLM.lm_prefill(jp, jc, jnp.asarray(tok), jcache,
                                compute_dtype=jnp.float32)
    tl, tcache = TLM.lm_prefill(tp, tc, torch.from_numpy(tok).long(),
                                tcache, torch.float32)
    _close(tl.numpy(), jl, LM_TOL)
    _close(tcache["periods"]["blk0_attn"]["v"].numpy(),
           jcache["periods"]["blk0_attn"]["v"], LM_TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        jl, jcache = JLM.lm_decode(jp, jc, jcache, jnp.asarray(nxt),
                                   compute_dtype=jnp.float32)
        tl, tcache = TLM.lm_decode(tp, tc, tcache,
                                   torch.from_numpy(nxt.copy()).long(),
                                   torch.float32)
        _close(tl.numpy(), jl, LM_TOL)


def test_zoo_model_runs_the_lm():
    cfg = TCFG.get_config("qwen2-1.5b").reduced()
    model = TZOO.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    cache = model.make_cache(2, 12, torch.float32, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 9),
                        generator=torch.Generator().manual_seed(2))
    logits, cache = model.prefill(params, {"tokens": tok}, cache,
                                  torch.float32)
    want, _ = TLM.lm_logits(params, cfg, tok)
    torch.testing.assert_close(logits, want[:, -1:], rtol=LM_TOL, atol=LM_TOL)
    ref_logits, _ = model.prefill(params, {"tokens": tok},
                                  model.make_cache(2, 12, torch.float32,
                                                   device="cpu"),
                                  torch.float32, impl="ref")
    torch.testing.assert_close(logits, ref_logits)
    logits, cache = model.decode(params, cache, logits.argmax(-1),
                                 torch.float32)
    assert logits.shape == (2, 1, cfg.padded_vocab) and cache["pos"] == 10
