"""The port's MoE FFN (`repro_torch.models.blocks.init_moe` / `moe_apply`)
and the MoE families of `models/lm.py` (olmoe, qwen3-moe, Jamba with its
experts) against the reference on the CPU.

Inputs come from numpy seeds and go to both sides; weights are drawn by the
reference (`init_moe`, `init_lm`) and carried across as numpy through
`params_from_jax`. Tolerance `LM_TOL` = 1e-5 (rtol = atol) for the MoE
block, its aux loss and the MoE LMs' logits: the port multiplies only the
routed experts' rows where the reference multiplies a dense (E, cap, d)
buffer, so fp32 sums run in another order (the Jamba period's Mamba scan
too, as `tests/test_torch_mamba.py` says). `generate` tokens exactly.
"""
import dataclasses
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
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")


def _close(got, want, tol=LM_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


# ----------------------------------------------------------------- block
@pytest.fixture(scope="module")
def moe_block():
    """olmoe reduced: d 256, 4 experts, top-2, expert_d_ff 128."""
    jc, tc = (M.get_config("olmoe-1b-7b").reduced() for M in (JCFG, TCFG))
    jp = JB.init_moe(jax.random.PRNGKey(7), jc, jc.moe)
    return jc, tc, jp, _carry(jp)


def test_init_moe_tree_matches_reference(moe_block):
    jc, tc, jp, _ = moe_block
    tp = TB.init_moe(torch.Generator().manual_seed(0), tc, tc.moe,
                     lead=(3,), device="cpu")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == ["down", "gate", "router/w", "up"]
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        assert tuple(tflat[key].shape) == (3,) + j.shape, key
        assert abs(float(tflat[key].std()) / float(np.std(j)) - 1) < 0.1, key


def _slots(topi, e):
    """Each assignment's rank among its batch row's assignments to the
    same expert, in token-major order (numpy, the reference's cumsum)."""
    b = topi.shape[0]
    flat = topi.reshape(b, -1)
    onehot = np.eye(e, dtype=np.int64)[flat]                 # (B, S*k, E)
    pos = np.cumsum(onehot, axis=1) - onehot
    return np.take_along_axis(pos, flat[..., None], axis=2)[..., 0]


# (dropless, capacity_factor): the serving default, the training default,
# and a capacity that drops most of an over-full expert's assignments
MOE_MODES = {"dropless": (True, 1.25), "capacity": (False, 1.25),
             "capacity_drops": (False, 0.5)}
J_MOE = jax.jit(JB.moe_apply, static_argnums=(1, 2),
                static_argnames=("capacity_factor", "dropless"))


@pytest.mark.parametrize("mode", sorted(MOE_MODES))
@pytest.mark.parametrize("B,S", [(1, 1), (2, 24), (1, 33)])
def test_moe_apply_matches_reference(moe_block, mode, B, S):
    jc, tc, jp, tp = moe_block
    dropless, cf = MOE_MODES[mode]
    rng = np.random.default_rng(B * 100 + S)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jy, jaux = J_MOE(jp, jc, jc.moe, jnp.asarray(x), capacity_factor=cf,
                     dropless=dropless)
    ty, taux = TB.moe_apply(tp, tc, tc.moe, torch.from_numpy(x),
                            capacity_factor=cf, dropless=dropless)
    assert ty.shape == (B, S, jc.d_model) and ty.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(taux.numpy(), jaux)
    if mode == "capacity_drops" and S > 1:
        # the case really drops: some assignment's slot is past the cap,
        # and the output differs from the dropless one
        probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
        _, topi = jax.lax.top_k(probs, jc.moe.experts_per_token)
        e, k = jc.moe.num_experts, jc.moe.experts_per_token
        cap = max(1, min(S, int(np.ceil(S * k / e * cf))))
        assert (_slots(np.asarray(topi), e) >= cap).any()
        full, _ = TB.moe_apply(tp, tc, tc.moe, torch.from_numpy(x),
                               dropless=True)
        assert not torch.allclose(full, ty, atol=1e-3)


def test_moe_apply_reads_only_routed_experts(moe_block):
    """One token routed to k experts multiplies k experts' weights, not E
    (the product per expert is counted through `gate`'s row views)."""
    jc, tc, jp, tp = moe_block
    seen = []

    class Spy(dict):
        def __getitem__(self, key):
            val = dict.__getitem__(self, key)
            if key == "gate":
                return _Rows(val, seen)
            return val

    class _Rows:
        def __init__(self, t, log):
            self.t, self.log = t, log

        def __getitem__(self, i):
            self.log.append(i)
            return self.t[i]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 1, jc.d_model)).astype(np.float32))
    y, _ = TB.moe_apply(Spy(tp), tc, tc.moe, x, dropless=True)
    want, _ = TB.moe_apply(tp, tc, tc.moe, x, dropless=True)
    assert torch.equal(y, want)
    assert len(seen) == tc.moe.experts_per_token == len(set(seen))


# ------------------------------------------------------------------- LMs
# the reference's prefill and decode, jitted (compiled once per file)
J_PREFILL = jax.jit(JLM.lm_prefill, static_argnums=(1,),
                    static_argnames=("compute_dtype",))
J_DECODE = jax.jit(JLM.lm_decode, static_argnums=(1,),
                   static_argnames=("compute_dtype",))


@functools.lru_cache(maxsize=None)
def _carried(name):
    """(reference cfg, port cfg, reference params, carried params) of the
    reduced arch, drawn once per file."""
    jc, tc = JCFG.get_config(name).reduced(), TCFG.get_config(name).reduced()
    jp = JLM.init_lm(jc, jax.random.PRNGKey(1))
    return jc, tc, jp, _carry(jp)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_period_spec_and_init_tree(name):
    jc, tc, jp, _ = _carried(name)
    spec = TLM.period_spec(tc)
    assert spec == JLM.period_spec(jc)
    assert [f for _m, f in spec].count("moe") == (4 if name.startswith(
        "jamba") else 1)
    tp = TLM.init_lm(tc, torch.Generator(), device="meta")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        assert tuple(tflat[key].shape) == j.shape, key


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_lm_prefill_decode_match_reference(name):
    """Prefill, then 4 greedy decode steps, against the reference's; the
    full forward in both dispatch modes, with its summed aux loss."""
    jc, tc, jp, tp = _carried(name)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    jcache = JLM.init_cache(jc, 2, 28, jnp.float32)
    tcache = TLM.init_cache(tc, 2, 28, torch.float32, device="cpu")
    jl, jcache = J_PREFILL(jp, jc, jnp.asarray(tok), jcache,
                           compute_dtype=jnp.float32)
    tl, tcache = TLM.lm_prefill(tp, tc, torch.from_numpy(tok).long(),
                                tcache, torch.float32)
    _close(tl.numpy(), jl)
    assert tcache["pos"] == int(jcache["pos"]) == 20
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        jl, jcache = J_DECODE(jp, jc, jcache, jnp.asarray(nxt),
                              compute_dtype=jnp.float32)
        tl, tcache = TLM.lm_decode(tp, tc, tcache,
                                   torch.from_numpy(nxt.copy()).long(),
                                   torch.float32)
        _close(tl.numpy(), jl)
    for dropless in (False, True):
        jlog, jaux = JLM.lm_logits(jp, jc, jnp.asarray(tok),
                                   moe_dropless=dropless)
        tlog, taux = TLM.lm_logits(tp, tc, torch.from_numpy(tok).long(),
                                   moe_dropless=dropless)
        _close(tlog.numpy(), jlog)
        _close(taux.numpy(), jaux)
        assert float(taux) > 0.0


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_full_forward(name):
    """The port alone, as `tests/test_models.py` holds the reference:
    prefill of 16 tokens and one decode step equal the dropless full
    forward at positions 15 and 16."""
    _, tc, _, tp = _carried(name)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 17)))
    full, _ = TLM.lm_logits(tp, tc, tok, moe_dropless=True)
    cache = TLM.init_cache(tc, 2, 32, torch.float32, device="cpu")
    pre, cache = TLM.lm_prefill(tp, tc, tok[:, :16], cache, torch.float32)
    dec, _ = TLM.lm_decode(tp, tc, cache, tok[:, 16:17], torch.float32)
    torch.testing.assert_close(pre[:, 0], full[:, 15], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec[:, 0], full[:, 16], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_generate_matches_reference_tokens(name):
    """`ModelExecutor.generate` token for token against the reference's on
    carried params, c in {1, 2} (chunked where the arch is chunkable)."""
    _, _, jp, tp = _carried(name)
    jex = JExecutor(reduced=True)
    tex = ModelExecutor(reduced=True, device="cpu")
    assert chunkable(tex.model(name).cfg) == (not name.startswith("jamba"))
    for prompt_len, c, steps in ((12, 1, 6), (11, 2, 5)):
        prompt = np.random.default_rng(prompt_len).integers(1, 900,
                                                            prompt_len)
        want = jex.generate(name, jp, prompt.astype(np.int32), c, steps, 16)
        got = tex.generate(name, tp, prompt, c, steps, 16)
        np.testing.assert_array_equal(got, want)
        assert tex.shape_key(name, prompt_len, c, steps, 16) == \
            jex.shape_key(name, prompt_len, c, steps, 16)


def test_full_width_jamba_period_has_experts_on_odd_layers():
    """At full width one Jamba period carries an expert FFN on layers 1, 3,
    5 and 7 (7 the attention layer), 16 experts of (4096, 14336), as the
    reference's `period_spec` gives it (shapes only)."""
    cfg = dataclasses.replace(TCFG.get_config("jamba-v0.1-52b"), num_layers=8)
    jcfg = dataclasses.replace(JCFG.get_config("jamba-v0.1-52b"),
                               num_layers=8)
    assert TLM.period_spec(cfg) == JLM.period_spec(jcfg)
    tp = TLM.init_lm(cfg, torch.Generator(), device="meta")
    for i in range(8):
        assert (f"blk{i}_moe" in tp["periods"]) == (i % 2 == 1), i
    assert tuple(tp["periods"]["blk7_moe"]["gate"].shape) == (
        1, 16, 4096, 14336)
    assert "blk7_attn" in tp["periods"]
