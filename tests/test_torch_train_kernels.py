"""The backward of the port's two model kernels on the CPU: the flash
attention Function (`repro_torch.kernels.flash_attention.ops`) and the
selective-scan Function (`kernels/ssm_scan/ops.py`), with their plain
backward versions, against the reference.

Inputs come from numpy seeds and go to both sides. On the CPU each Function
runs its kernels' plain versions (`attention_lse_ref`,
`attention_bwd_ref`; `ssm_scan_ref` with chunk states, `ssm_scan_bwd_ref`),
the path the card's kernels are held to. `ops.attention` itself takes the
plain blocked attention on CPU tensors (`models.attention.
BlockedAttention`), which is held here too. Tolerances, relative to each
gradient's largest magnitude:

* flash attention against `jax.vjp` of the reference's `flash_attention_jnp`
  (its own custom VJP, the FlashAttention-2 backward), fp32: 1e-5; the two
  sum the same products blockwise in other orders;
* `attention_bwd_ref` against torch autograd through `attention_ref`:
  1e-5;
* the scan against `jax.vjp` of the reference's sequential oracle
  (`repro/kernels/ssm_scan/ref.py`): 1e-5; the plain backward rebuilds each
  chunk's states from its checkpoint, the same recurrence in the same
  order as the forward;
* the chunk states against the reference's final state of each prefix:
  2e-6 of max(1, max|h|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_scan_ref
from repro.models.attention import flash_attention_jnp
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import kernel as TFK
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.ssm_scan import kernel as TSK
from repro_torch.kernels.ssm_scan import ops as TSS
from repro_torch.kernels.ssm_scan import ref as TSR

GRAD_TOL = 1e-5
STATE_TOL = 2e-6


def _rel_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ------------------------------------------------------------ attention
# (case, B, S, T, H, KV, hd, causal, window)
FLASH_CASES = [
    ("causal, GQA", 2, 40, 40, 4, 2, 64, True, 0),
    ("window 7", 1, 50, 50, 4, 2, 64, True, 7),
    ("full, S != T", 2, 24, 40, 4, 4, 128, False, 0),
    ("causal, GQA, hd 128", 1, 33, 33, 6, 2, 128, True, 0),
    ("full, S != T, GQA 4:1", 1, 17, 29, 4, 1, 64, False, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_function_grads_match_reference_vjp(case):
    _, B, S, T, H, KV, hd, causal, window = case
    rng = np.random.default_rng(S * 7 + T)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    want_o, vjp = jax.vjp(
        lambda a, b, c: flash_attention_jnp(a, b, c, causal=causal,
                                            window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    # the card's Function (on the CPU its kernels' plain versions), and
    # the plain blocked Function `ops.attention` takes on CPU tensors
    for fn, function in (
            (lambda a, b, c: TFA.FlashAttention.apply(a, b, c, causal,
                                                      window),
             "FlashAttention"),
            (lambda a, b, c: TFA.attention(a, b, c, causal=causal,
                                           window=window),
             "BlockedAttention")):
        tq, tk, tv = _t(q), _t(k), _t(v)
        o = fn(tq, tk, tv)
        assert type(o.grad_fn).__name__ == function + "Backward"
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
        _rel_close(o.detach().numpy(), want_o, GRAD_TOL, "o")
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _rel_close(g.numpy(), w, GRAD_TOL, name)


@pytest.mark.parametrize("case", FLASH_CASES[:3],
                         ids=[c[0] for c in FLASH_CASES[:3]])
def test_attention_bwd_ref_matches_autograd(case):
    """The plain backward from (o, lse) against autograd through the plain
    forward, in the kernels' head-major layout."""
    _, B, S, T, H, KV, hd, causal, window = case
    g = torch.Generator().manual_seed(S + T)
    q = torch.randn((B, H, S, hd), generator=g, requires_grad=True)
    k = torch.randn((B, KV, T, hd), generator=g, requires_grad=True)
    v = torch.randn((B, KV, T, hd), generator=g, requires_grad=True)
    do = torch.randn((B, H, S, hd), generator=g)
    o = attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = attention_lse_ref(q.detach(), k.detach(), causal=causal,
                            window=window)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                            lse, do, causal=causal, window=window)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        _rel_close(gt.numpy(), wt.numpy(), GRAD_TOL, name)


def test_flash_forward_without_grad_is_the_plain_call():
    """No grad needed: the forward alone (no graph), the same values as
    with the Function; the kernel wrapper's plain version (with the lse)
    within the flash tolerance of it."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 20, 4, 64), generator=g) for _ in range(3))
    o = TFA.attention(q, k, v)
    assert o.grad_fn is None
    o2 = TFA.attention(q.requires_grad_(), k, v)
    assert o2.grad_fn is not None
    assert torch.equal(o, o2.detach())
    o3, lse = TFK.flash_attention(q.detach().transpose(1, 2),
                                  k.transpose(1, 2), v.transpose(1, 2),
                                  with_lse=True)
    _rel_close(o3.transpose(1, 2).numpy(), o.numpy(), 2e-5, "o")
    assert lse.shape == (1, 4, 20)


def test_flash_backward_smem_fits_and_refuses_other_head_dims():
    for dtype in (torch.float32, torch.bfloat16):
        for hd in TFK.HEAD_DIMS:
            for which in (0, 1):
                assert TFK.flash_bwd_plan(hd, dtype, which).smem_bytes \
                    <= 227 * 1024
        with pytest.raises(ValueError, match="head_dim 96"):
            TFK.flash_bwd_plan(96, dtype, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TFK.flash_bwd_plan(64, torch.float16, 1)


BWD_PLAN_KEYS = [(dtype, hd, which) for dtype in (torch.float32,
                                                  torch.bfloat16)
                 for hd in (64, 128, 256) for which in (0, 1)]


@pytest.mark.parametrize("key", BWD_PLAN_KEYS,
                         ids=[f"{str(d)[6:]}-hd{h}-{'dkdv' if w else 'dq'}"
                              for d, h, w in BWD_PLAN_KEYS])
def test_flash_backward_plan_tiles_are_wgmma_shapes(key):
    """Each plan's tiles are shapes `wgmma` takes: 64 rows a consumer
    warpgroup, streamed tiles of 32 or 64 rows (N of the first products,
    and whole 32-key chunks of the transposed fp32 parts), output columns in
    64-column blocks (N of the second products), tiles on 1024 bytes for
    the 128-byte swizzle; the accumulators a thread holds (S and dP, and
    dQ or dK and dV) stay at 160 registers or under."""
    dtype, hd, which = key
    plan = TFK.flash_bwd_plan(hd, dtype, which)
    es = 4 if dtype == torch.float32 else 2
    assert plan.rows in (64, 128)
    assert plan.threads == plan.rows * 2 + (128 if plan.rows == 128 else 32)
    assert plan.BN in (32, 64) and plan.BN % (8 if es == 4 else 16) == 0
    cols = hd // plan.splits
    assert hd % plan.splits == 0 and cols % 64 == 0 and cols <= 128
    assert plan.BN * hd * es % 1024 == 0 and cols * plan.BN * 4 % 1024 == 0
    assert plan.stages in (1, 2)
    accumulators = plan.BN + cols // 2 * (2 if which else 1)
    assert accumulators <= 160, accumulators
    # bf16 reads the resident rows' fragments from shared memory
    assert plan.rows_in_smem or es == 4


@pytest.mark.parametrize("B,H,KV,T,hd", [(1, 32, 4, 2048, 64),
                                          (2, 8, 2, 333, 64),
                                          (1, 16, 8, 512, 256),
                                          (1, 12, 12, 1500, 64)])
def test_flash_backward_scratch_shapes(B, H, KV, T, hd):
    """With G > 1 the dK / dV kernel writes (B, T, H, hd) fp32 partials and
    counts its CTAs on one counter per (batch row, KV head, key block,
    column split); with G = 1 it needs neither."""
    for dtype in (torch.float32, torch.bfloat16):
        got = TFK.bwd_scratch(B, H, KV, T, hd, dtype)
        if H == KV:
            assert got is None
            continue
        plan = TFK.flash_bwd_plan(hd, dtype, 1)
        assert got == ((B, T, H, hd), B * KV * -(-T // plan.rows) * plan.splits)


# ----------------------------------------------------------------- scan
def _scan_inputs(B, S, I, N, seed, rand_h0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, I)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((I, N))).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    x = rng.standard_normal((B, S, I)).astype(np.float32)
    h0 = (rng.standard_normal((B, I, N)) if rand_h0
          else np.zeros((B, I, N))).astype(np.float32)
    dy = rng.standard_normal((B, S, I)).astype(np.float32)
    dh = rng.standard_normal((B, I, N)).astype(np.float32)
    return (dt, a, bm, cm, x, h0), dy, dh


@pytest.mark.parametrize("S", [1, 64, 100, 129])
@pytest.mark.parametrize("rand_h0", [False, True], ids=["h0 zero", "h0 random"])
def test_scan_function_grads_match_reference_vjp(S, rand_h0):
    args, dy, dh = _scan_inputs(2, S, 6, 4, S + int(rand_h0), rand_h0)
    (want_y, want_h), vjp = jax.vjp(jax_scan_ref, *args)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    targs = [_t(a) for a in args]
    y, hT = TSS.selective_scan(*targs)
    assert "SelectiveScan" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y, hT), targs,
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    _rel_close(y.detach().numpy(), want_y, GRAD_TOL, "y")
    _rel_close(hT.detach().numpy(), want_h, GRAD_TOL, "hT")
    for name, g, w in zip(("ddt", "da", "dbm", "dcm", "dx", "dh0"), got, want):
        _rel_close(g.numpy(), w, GRAD_TOL, name)


@pytest.mark.parametrize("S", [64, 129, 200])
def test_scan_chunk_states_match_reference_prefixes(S):
    """hc[:, k] is the state after the first 64 k steps: h0 for k = 0, the
    reference's final state of the prefix after."""
    args, _, _ = _scan_inputs(2, S, 5, 16, S, True)
    y, hT, hc = TSK.ssm_scan(*(torch.from_numpy(a) for a in args),
                             with_chunks=True)
    assert hc.shape == (2, -(-S // 64), 5, 16) and hc.dtype == torch.float32
    dt, a, bm, cm, x, h0 = args
    for k in range(hc.shape[1]):
        if k == 0:
            want = h0
        else:
            s = 64 * k
            want = jax_scan_ref(dt[:, :s], a, bm[:, :s], cm[:, :s], x[:, :s],
                                h0)[1]
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        err = float(np.abs(hc[:, k].numpy() - np.asarray(want)).max())
        assert err <= STATE_TOL * scale, (k, err)


def test_scan_bwd_ref_holds_one_chunk_of_states(monkeypatch):
    """The plain backward never stacks more than one chunk's states: every
    (B, L, I, N) tensor it builds has L <= 64."""
    B, S, I, N = 1, 200, 3, 4
    args, dy, dh = _scan_inputs(B, S, I, N, 9, True)
    targs = [torch.from_numpy(a) for a in args]
    _, _, hc = TSR.ssm_scan_ref(*targs, chunk_states=True)
    built = []
    stack = torch.stack

    def spy(tensors, dim=0):
        out = stack(tensors, dim)
        built.append(tuple(out.shape))
        return out
    monkeypatch.setattr(TSR.torch, "stack", spy)
    grads = TSR.ssm_scan_bwd_ref(*targs[:5], hc, torch.from_numpy(dy),
                                 torch.from_numpy(dh))
    states = [s for s in built if len(s) == 4]
    assert [s[1] for s in states] == [200 - 192, 64, 64, 64]
    assert all(s[0] == B and s[2:] == (I, N) for s in states)
    assert [tuple(g.shape) for g in grads] == [
        (B, S, I), (I, N), (B, S, N), (B, S, N), (B, S, I), (B, I, N)]


def test_scan_backward_smem_fits_and_refuses_other_states():
    for n in TSK.STATE_DIMS:
        for elt in (4, 2):
            assert TSK.bwd_smem_bytes(n, elt) <= 227 * 1024
    with pytest.raises(ValueError, match="state size 8"):
        TSK.bwd_smem_bytes(8, 4)
    with pytest.raises(ValueError, match="state size 8"):
        TSK.ssm_bwd_plan(1, 64, 32, 8, torch.float32)


@pytest.mark.parametrize("B,S,I,N", [(1, 2048, 8192, 16), (2, 300, 520, 4),
                                     (1, 2000, 8192, 16), (2, 129, 518, 16)])
def test_scan_backward_plan_grid_and_partials(B, S, I, N):
    """The forward's block (32 channels x 8 segments): one block per 32
    channels and batch row, and dB / dC partials of one row of (N, S) per
    block, I / 32 of them (half of the earlier I / 16)."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = TSK.ssm_bwd_plan(B, S, I, N, dtype)
        blocks = -(-I // 32)
        assert plan.grid == (blocks, B) and plan.threads == 256
        assert plan.partials == (blocks, B, N, S)
        assert plan.smem_bytes == TSK.bwd_smem_bytes(N, dtype.itemsize)


def _segmented_scan_bwd(dt, a, bm, cm, x, hc, dy, dhT, P=8, R=8):
    """The backward kernel's order, written out in torch (fp32): per 64-step
    chunk, last first, the runs of R steps of the P segments rebuild their
    states (cumulative pairs, the checkpoint carried through the segments,
    h = A h_in + B), fold the reverse recurrence into (prod a, Q) pairs, take
    their G_in from the segment on the right (the chunk's carry into the
    last), and sweep back; the a_t of the rebuild serve both passes."""
    B, S, I = dt.shape
    N = a.shape[1]
    L = P * R
    Sp = -(-S // L) * L
    pad = lambda t: torch.cat(  # noqa: E731
        [t, t.new_zeros((t.shape[0], Sp - S) + tuple(t.shape[2:]))], 1)
    dtp, xp, bp, cp, dyp = (pad(t) for t in (dt, x, bm, cm, dy))
    e_all = torch.exp2(dtp[..., None] * (a * 1.4426950408889634))
    u_all = dtp * xp
    ddt = torch.zeros((B, Sp, I)); dxo = torch.zeros((B, Sp, I))
    dbm = torch.zeros((B, Sp, N)); dcm = torch.zeros((B, Sp, N))
    da = torch.zeros((I, N))
    g = dhT.clone()
    for k in reversed(range(Sp // L)):
        sl = slice(k * L, (k + 1) * L)
        e = e_all[:, sl].reshape(B, P, R, I, N)
        ub = (u_all[:, sl, :, None] * bp[:, sl, None, :]).reshape(B, P, R, I, N)
        c = (dyp[:, sl, :, None] * cp[:, sl, None, :]).reshape(B, P, R, I, N)
        ca, cb = e.clone(), ub.clone()
        for r in range(1, R):
            ca[:, :, r] = ca[:, :, r - 1] * e[:, :, r]
            cb[:, :, r] = e[:, :, r] * cb[:, :, r - 1] + ub[:, :, r]
        hin = [hc[:, k]]
        for s in range(1, P):
            hin.append(ca[:, s - 1, R - 1] * hin[-1] + cb[:, s - 1, R - 1])
        hin = torch.stack(hin, 1)                        # (B, P, I, N)
        h = ca * hin[:, :, None] + cb
        q = c[:, :, R - 1]
        for r in range(R - 2, -1, -1):
            q = e[:, :, r + 1] * q + c[:, :, r]
        pa, pb = ca[:, :, R - 1], e[:, :, 0] * q         # G_in -> a_0 G_0
        gin = [None] * P
        gin[P - 1] = g
        for s in range(P - 2, -1, -1):
            gin[s] = pa[:, s + 1] * gin[s + 1] + pb[:, s + 1]
        g = pa[:, 0] * gin[0] + pb[:, 0]
        dt_c = dtp[:, sl].reshape(B, P, R, I)
        x_c = xp[:, sl].reshape(B, P, R, I)
        b_c = bp[:, sl].reshape(B, P, R, N)
        dy_c = dyp[:, sl].reshape(B, P, R, I)
        gv = torch.stack(gin, 1)                         # (B, P, I, N)
        du = torch.zeros((B, P, R, I)); dtt = torch.zeros((B, P, R, I))
        vb = torch.zeros((B, P, R, N)); vc = torch.zeros((B, P, R, N))
        for r in range(R - 1, -1, -1):
            gv = gv + c[:, :, r]
            hp = h[:, :, r - 1] if r else hin
            gda = gv * hp * e[:, :, r]
            da += (gda * dt_c[:, :, r, :, None]).sum((0, 1))
            du[:, :, r] = (gv * b_c[:, :, r, None, :]).sum(-1)
            dtt[:, :, r] = (gda * a).sum(-1)
            vb[:, :, r] = (gv * (dt_c[:, :, r] * x_c[:, :, r])[..., None]).sum(2)
            vc[:, :, r] = (dy_c[:, :, r, :, None] * h[:, :, r]).sum(2)
            gv = gv * e[:, :, r]
        ddt[:, sl] = (du * x_c + dtt).reshape(B, L, I)
        dxo[:, sl] = (du * dt_c).reshape(B, L, I)
        dbm[:, sl] = vb.reshape(B, L, N)
        dcm[:, sl] = vc.reshape(B, L, N)
    return ddt[:, :S], da, dbm[:, :S], dcm[:, :S], dxo[:, :S], g


@pytest.mark.parametrize("S", [5, 64, 129, 200])
def test_segmented_scan_bwd_order_matches_plain_backward(S):
    """The backward kernel's segmented reverse scan (one a_t per state and
    step for both passes, G_in from the right) against the plain backward,
    fp32, at GRAD_TOL of each gradient's largest magnitude."""
    args, dy, dh = _scan_inputs(2, S, 6, 4, 31 + S, True)
    targs = [torch.from_numpy(a) for a in args]
    _, _, hc = TSR.ssm_scan_ref(*targs, chunk_states=True)
    dt, a, bm, cm, x, _ = targs
    want = TSR.ssm_scan_bwd_ref(dt, a, bm, cm, x, hc, torch.from_numpy(dy),
                                torch.from_numpy(dh))
    got = _segmented_scan_bwd(dt, a, bm, cm, x, hc, torch.from_numpy(dy),
                              torch.from_numpy(dh))
    for name, gt, wt in zip(("ddt", "da", "dbm", "dcm", "dx", "dh0"), got,
                            want):
        _rel_close(gt.numpy(), wt.numpy(), GRAD_TOL, name)


def test_refuse_grad_raises_only_when_autograd_needs_a_backward():
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="env_step kernel has no backward"):
        refuse_grad("env_step", torch.zeros(2), w)
    refuse_grad("env_step", torch.zeros(2), w.detach())
    with torch.no_grad():
        refuse_grad("env_step", w)
