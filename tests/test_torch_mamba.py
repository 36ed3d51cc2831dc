"""The port's Mamba path (`repro_torch.kernels.ssm_scan`, the Mamba block of
`models/blocks.py`, the "jamba" and "mamba" patterns of `models/lm.py`, and
a Jamba period served by `serving`) against the reference on the CPU.

Inputs come from numpy seeds and go to both sides; weights are drawn by the
reference (`init_mamba`, `init_lm`) and carried across as numpy. Tolerances:

* the scan at the reference kernel's 2e-5 (`tests/test_kernels.py`), fp32,
  against both the reference's sequential oracle and its Pallas kernel in
  interpret mode; bf16 at 1e-2 of max(1, max|y|): both sides round the same
  bf16 products, and y's one rounding to bf16 is 2^-8 of it at most;
* the block at 2e-5 (rtol = atol): the reference's chunked associative scan
  sums the same recurrence in another order than the port's sequential
  one (measured <= 2e-6 on y, the conv tail and the state);
* the LM's logits at 5e-5 (rtol = atol): that difference through up to 8
  layers of fp32 matrix products (measured <= 1.7e-5 on logits of
  magnitude ~17);
* `generate` token for token, and the engine's done records exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import config as JCFG
from repro.kernels.ssm_scan.ops import selective_scan as pallas_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_scan_ref
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.executor import ModelExecutor as JExecutor
from repro_torch.common import config as TCFG
from repro_torch.common.checkpoint import params_from_jax
from repro_torch.common.pytree import param_count, tree_paths
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.kernels.ssm_scan import kernel as TSK
from repro_torch.kernels.ssm_scan import ops as TSS
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import blocks as TB
from repro_torch.models import lm as TLM
from repro_torch.models import zoo as TZOO
from repro_torch.serving import (ModelExecutor, Request, ServingEngine,
                                 chunkable)

SCAN_TOL = 2e-5
BF16_TOL = 1e-2
BLOCK_TOL = 2e-5
LM_TOL = 5e-5
SCAN_SHAPES = [             # tests/test_kernels.py's four (B, S, I, N)
    (2, 32, 64, 16, 16, 64),
    (1, 100, 96, 8, 16, 32),
    (2, 64, 300, 16, 64, 256),
    (1, 7, 16, 4, 8, 16),
]
CUT = "jamba-v0.1-52b-8l-dense"     # one Jamba period, no experts


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _carry(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _scan_inputs(seed, B, S, I, N, h0=True):
    """The distributions of tests/test_kernels.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = [np.log1p(np.exp(rng.standard_normal((B, S, I)))).astype(f32),
           (-np.exp(rng.standard_normal((I, N)))).astype(f32),
           rng.standard_normal((B, S, N)).astype(f32),
           rng.standard_normal((B, S, N)).astype(f32),
           rng.standard_normal((B, S, I)).astype(f32)]
    if h0:
        out.append(rng.standard_normal((B, I, N)).astype(f32))
    return out


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("B,S,I,N,bs,bi", SCAN_SHAPES)
def test_scan_matches_reference_and_pallas(B, S, I, N, bs, bi):
    arrays = _scan_inputs(B * 1000 + S, B, S, I, N)
    jargs = [jnp.asarray(v) for v in arrays]
    targs = [torch.from_numpy(v) for v in arrays]
    refs = {"jax_ref": jax_scan_ref(*jargs),
            "pallas": pallas_scan(*jargs, block_s=bs, block_i=bi)}
    ports = {"ref": ssm_scan_ref(*targs),
             "ops": TSS.selective_scan(*targs),
             "ops_ref": TSS.selective_scan(*targs, impl="ref")}
    for pname, (y, hT) in ports.items():
        assert y.shape == (B, S, I) and y.dtype == torch.float32, pname
        assert hT.shape == (B, I, N) and hT.dtype == torch.float32, pname
        for rname, (yr, hTr) in refs.items():
            _close(y.numpy(), yr, SCAN_TOL)
            _close(hT.numpy(), hTr, SCAN_TOL)


def test_scan_zero_h0_default():
    dt, a, bm, cm, x = _scan_inputs(2, 1, 16, 32, 8, h0=False)
    want, _ = jax_scan_ref(*(jnp.asarray(v) for v in (dt, a, bm, cm, x)),
                           jnp.zeros((1, 32, 8)))
    pal, _ = pallas_scan(*(jnp.asarray(v) for v in (dt, a, bm, cm, x)))
    got, hT = TSS.selective_scan(*(torch.from_numpy(v)
                                   for v in (dt, a, bm, cm, x)))
    _close(got.numpy(), want, SCAN_TOL)
    _close(got.numpy(), pal, SCAN_TOL)
    assert hT.dtype == torch.float32 and hT.shape == (1, 32, 8)


def test_scan_bf16_matches_reference():
    arrays = _scan_inputs(9, 2, 40, 48, 16)
    jargs = [jnp.asarray(v).astype(jnp.bfloat16) for v in arrays[:5]]
    targs = [torch.from_numpy(v).to(torch.bfloat16) for v in arrays[:5]]
    h0 = arrays[5]
    yj, hj = jax_scan_ref(*jargs, jnp.asarray(h0))
    yt, ht = ssm_scan_ref(*targs, torch.from_numpy(h0))
    assert yt.dtype == torch.bfloat16 and ht.dtype == torch.float32
    scale = max(1.0, float(np.abs(np.asarray(yj, np.float32)).max()))
    err = np.abs(yt.float().numpy() - np.asarray(yj, np.float32)).max()
    assert err <= BF16_TOL * scale, (err, scale)
    _close(ht.numpy(), hj, SCAN_TOL)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain recurrence and counts no
    launch; other devices and unknown impls are refused."""
    targs = [torch.from_numpy(v) for v in _scan_inputs(1, 2, 9, 20, 4)]
    before = TSK.ssm_scan.launches
    got = TSK.ssm_scan(*targs)
    want = ssm_scan_ref(*targs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TSK.ssm_scan.launches == before
    with pytest.raises(ValueError, match="impl"):
        TSS.selective_scan(*targs, impl="pallas")
    with pytest.raises(ValueError, match="cpu or cuda"):
        TSK.ssm_scan(*(t.to("meta") for t in targs))


# ----------------------------------------------------------------- block
def _cut_cfg(module, **kw):
    """Jamba reduced (d 256, inner 512, N 16) without experts."""
    return dataclasses.replace(
        module.get_config("jamba-v0.1-52b").reduced(), moe=None, **kw)


@pytest.fixture(scope="module")
def mamba_block():
    jc, tc = _cut_cfg(JCFG), _cut_cfg(TCFG)
    jp = JB.init_mamba(jax.random.PRNGKey(3), jc, jc.ssm)
    return jc, tc, jp, _carry(jp)


def test_init_mamba_tree_matches_reference(mamba_block):
    jc, tc, jp, _ = mamba_block
    tp = TB.init_mamba(torch.Generator().manual_seed(0), tc, tc.ssm,
                       lead=(2,), device="cpu")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        t = tflat[key]
        assert tuple(t.shape) == (2,) + j.shape, key
        assert t.dtype == torch.float32, key
        if key in ("A_log", "D", "conv_b"):          # deterministic leaves
            _close(t[1].numpy(), j, 1e-7)
        elif key == "dt_proj/b":                     # softplus(b) in [1e-3, 0.1]
            dt = torch.nn.functional.softplus(t)
            assert float(dt.min()) >= 1e-3 * 0.99
            assert float(dt.max()) <= 0.1 * 1.01
        else:                                        # same init scale
            assert abs(float(t.std()) / float(np.std(j)) - 1.0) < 0.1, key


@pytest.mark.parametrize("S", [1, 3, 64, 100])
def test_mamba_prefill_decode_match_reference(mamba_block, S):
    """From a random cache: prefill (S crosses the reference's 64-step
    chunk and its padding; S = 1 and 3 leave a conv tail shorter than the
    conv), then 4 decode steps."""
    jc, tc, jp, tp = mamba_block
    rng = np.random.default_rng(S)
    inner, n = jc.ssm.expand * jc.d_model, jc.ssm.state_dim
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, jc.ssm.conv_width - 1, inner)).astype(
        np.float32)
    ssm = rng.standard_normal((2, inner, n)).astype(np.float32)
    jy, jcache = JB.mamba_prefill(jp, jc, jc.ssm, jnp.asarray(x),
                                  {"conv": jnp.asarray(conv),
                                   "ssm": jnp.asarray(ssm)})
    tcache = {"conv": torch.from_numpy(conv.copy()),
              "ssm": torch.from_numpy(ssm.copy())}
    ty, tcache = TB.mamba_prefill(tp, tc, tc.ssm, torch.from_numpy(x),
                                  tcache)
    _close(ty.numpy(), jy, BLOCK_TOL)
    for key in ("conv", "ssm"):
        _close(tcache[key].numpy(), jcache[key], BLOCK_TOL)
    for _ in range(4):
        xd = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        jy, jcache = JB.mamba_decode(jp, jc, jc.ssm, jnp.asarray(xd), jcache)
        ty, tcache = TB.mamba_decode(tp, tc, tc.ssm, torch.from_numpy(xd),
                                     tcache)
        _close(ty.numpy(), jy, BLOCK_TOL)
        for key in ("conv", "ssm"):
            _close(tcache[key].numpy(), jcache[key], BLOCK_TOL)
    y_train = TB.mamba_train(tp, tc, tc.ssm, torch.from_numpy(x))
    _close(y_train.numpy(), JB.mamba_train(jp, jc, jc.ssm, jnp.asarray(x)),
           BLOCK_TOL)


# ------------------------------------------------------------------- LM
LM_CASES = {
    "jamba": lambda M: _cut_cfg(M),
    "mamba": lambda M: _cut_cfg(M, name="mamba-d256-nffn",
                                layer_pattern="mamba", d_ff=0, num_layers=2),
}


@pytest.mark.parametrize("kind", sorted(LM_CASES))
def test_period_spec_and_init_tree(kind):
    jc, tc = LM_CASES[kind](JCFG), LM_CASES[kind](TCFG)
    assert TLM.period_spec(tc) == JLM.period_spec(jc)
    if kind == "jamba":
        assert TLM.period_spec(tc) == (("mamba", "dense"),) * 7 + (
            ("attn", "dense"),)
    else:
        assert TLM.period_spec(tc) == (("mamba", "none"),)
    assert not chunkable(tc)
    jp = JLM.init_lm(jc, jax.random.PRNGKey(0))
    tp = TLM.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = tree_paths(jax.tree_util.tree_map(np.asarray, jp))
    tflat = tree_paths(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, j in jflat.items():
        assert tuple(tflat[key].shape) == j.shape, key
    assert param_count(tp) == sum(v.size for v in jflat.values())
    jcache = JLM.init_cache(jc, 2, 12, jnp.bfloat16)
    tcache = TLM.init_cache(tc, 2, 12, torch.bfloat16, device="cpu")
    jcf = tree_paths(jax.tree_util.tree_map(np.asarray, jcache["periods"]))
    tcf = tree_paths(tcache["periods"])
    assert sorted(tcf) == sorted(jcf)
    for key, j in jcf.items():
        assert tuple(tcf[key].shape) == j.shape, key
        assert str(tcf[key].dtype).replace("torch.", "") == str(j.dtype), key


@pytest.mark.parametrize("kind", sorted(LM_CASES))
def test_lm_prefill_decode_logits_match_reference(kind):
    jc, tc = LM_CASES[kind](JCFG), LM_CASES[kind](TCFG)
    jp = JLM.init_lm(jc, jax.random.PRNGKey(1))
    tp = _carry(jp)
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
    _close(tcache["periods"]["blk0_mamba"]["ssm"].numpy(),
           jcache["periods"]["blk0_mamba"]["ssm"], LM_TOL)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1:, :jc.vocab_size], axis=-1))
        jl, jcache = JLM.lm_decode(jp, jc, jcache, jnp.asarray(nxt),
                                   compute_dtype=jnp.float32)
        tl, tcache = TLM.lm_decode(tp, tc, tcache,
                                   torch.from_numpy(nxt.copy()).long(),
                                   torch.float32)
        _close(tl.numpy(), jl, LM_TOL)
    jlog, _ = JLM.lm_logits(jp, jc, jnp.asarray(tok))
    tlog, aux = TLM.lm_logits(tp, tc, torch.from_numpy(tok).long())
    _close(tlog.numpy(), jlog, LM_TOL)
    assert float(aux) == 0.0


def test_prefill_dispatches_impl_to_both_kernels(monkeypatch):
    """`impl="auto"` sends every Mamba layer to the scan wrapper (on the
    card: one launch each), with A and the state in fp32 also under bf16
    compute, and `impl="ref"` none. Every attention layer is one call of
    the plain blocked attention under both impls on CPU tensors (on the
    card `impl="auto"` launches the flash kernel there), never of the
    kernel wrapper. Both give the same logits."""
    tc = _cut_cfg(TCFG)
    calls = {"attn": 0, "scan": 0, "flash_kernel": 0}
    fa, ss, blocked = TFA.flash_attention, TSS.ssm_scan, TFA.blocked_attention

    def count(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            if key == "scan":       # the kernel's contract: a, h0 in fp32
                assert args[1].dtype == args[5].dtype == torch.float32
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(TFA, "flash_attention", count("flash_kernel", fa))
    monkeypatch.setattr(TFA, "blocked_attention", count("attn", blocked))
    monkeypatch.setattr(TSS, "ssm_scan", count("scan", ss))
    model = TZOO.build_model(tc)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    tok = {"tokens": torch.arange(1, 12)[None]}
    for dtype in (torch.float32, torch.bfloat16):
        out = {}
        for impl in ("auto", "ref"):
            cache = model.make_cache(1, 16, dtype, device="cpu")
            out[impl], _ = model.prefill(params, tok, cache, dtype,
                                         impl=impl)
            want = {"attn": 1, "scan": 7 if impl == "auto" else 0,
                    "flash_kernel": 0}
            assert calls == want, (impl, calls)
            calls.update(attn=0, scan=0)
        assert out["auto"].dtype == dtype
        assert bool(torch.isfinite(out["auto"].float()).all())
        torch.testing.assert_close(out["auto"], out["ref"], rtol=0, atol=0)


# ------------------------------------------------------------ serving
@pytest.fixture
def cut_arch():
    """One Jamba period without experts, registered in both registries for
    the test and removed after it."""
    for M in (JCFG, TCFG):
        M.register(CUT)(lambda M=M: dataclasses.replace(
            M.get_config("jamba-v0.1-52b"), name=CUT, num_layers=8,
            moe=None))
    yield CUT
    for M in (JCFG, TCFG):
        M._REGISTRY.pop(CUT, None)


def test_cut_config_is_one_jamba_period(cut_arch):
    cfg = TCFG.get_config(cut_arch)
    assert (cfg.num_layers, cfg.d_model, cfg.moe) == (8, 4096, None)
    assert cfg.ssm.expand * cfg.d_model == 8192 and cfg.ssm.state_dim == 16
    assert TLM.n_periods(cfg) == 1
    assert cfg.param_count() == JCFG.get_config(cut_arch).param_count()


def test_generate_matches_reference_tokens(cut_arch):
    jex = JExecutor(reduced=True)
    jp = jex.init_params(cut_arch, jax.random.PRNGKey(4))
    tex = ModelExecutor(reduced=True, device="cpu")
    tp = _carry(jp)
    for prompt_len, c, steps in ((12, 1, 6), (10, 4, 5)):
        prompt = np.random.default_rng(prompt_len).integers(1, 1000,
                                                            prompt_len)
        want = jex.generate(cut_arch, jp, prompt.astype(np.int32), c, steps,
                            16)
        got = tex.generate(cut_arch, tp, prompt, c, steps, 16)
        assert got.dtype == np.int32 and len(got) == steps
        np.testing.assert_array_equal(got, want)
        assert tex.shape_key(cut_arch, prompt_len, c, steps, 16) == \
            jex.shape_key(cut_arch, prompt_len, c, steps, 16)


def test_engine_matches_reference_done_records(cut_arch):
    """A 4-server engine on the same requests and actions as the
    reference's: the same done records and QoS summary."""
    rng = np.random.default_rng(15)
    reqs = [(i, rng.integers(1, 1000, 8), int(rng.choice([1, 2, 4])),
             float(3.0 * i)) for i in range(5)]
    actions = rng.uniform(size=(30, 2 + 4)).astype(np.float32)
    actions[::4, 0] = 0.9
    actions[1::4, 0] = 0.1
    kw = dict(queue_window=4, reduced=True, time_dilation=1.0, s_min=2,
              s_max=6)
    j = JEngine(num_servers=4, archs=[cut_arch], **kw)
    t = ServingEngine(num_servers=4, archs=[cut_arch], device="cpu", **kw)
    pending = list(reqs)
    for a in actions:
        while pending and pending[0][3] <= j.now():
            rid, prompt, c, arrive = pending.pop(0)
            j.submit(JRequest(rid, cut_arch, prompt.astype(np.int32), c,
                              arrive, max_new_tokens=4))
            t.submit(Request(rid, cut_arch, prompt, c, arrive,
                             max_new_tokens=4))
        np.testing.assert_allclose(t.observe(), j.observe(), rtol=1e-6,
                                   atol=1e-6)
        assert (j.try_schedule(a) is None) == (t.try_schedule(a) is None)
        assert j.now() == t.now()
    assert len(t.done) == len(j.done) >= 3
    for rj, rt in zip(j.done, t.done):
        for f in ("rid", "start_t", "finish_t", "steps", "reused",
                  "quality", "patches", "arrive_t"):
            assert getattr(rj, f) == getattr(rt, f), f
        assert len(rt.tokens) == rt.steps
    qj, qt = j.qos_summary(), t.qos_summary()
    assert sorted(qj) == sorted(qt)
    for key, v in qj.items():
        if isinstance(v, float):
            assert qt[key] == pytest.approx(v, rel=1e-6, abs=1e-6), key
        else:
            assert qt[key] == v, key
    assert t.pool.counters() == j.pool.counters()
