"""Attention in plain PyTorch (port of `repro/models/attention.py`). Layout
(B, S, H, hd) for queries and (B, T, KV, hd) for keys and values, as in the
reference; GQA query head h reads KV head h // (H / KV).

* :func:`flash_attention` — the reference's `flash_attention_jnp`: a
  blocked online softmax (query blocks outer, KV blocks inner, running
  max, sum and accumulator in f32) with its blocked backward (KV blocks
  outer, query blocks inner: the reference's custom VJP `flash_bwd`), a
  `torch.autograd.Function` that saves q, k, v, the output and each row's
  log-sum-exp and nothing of size S x T. It is the plain attention of the
  port: `kernels.flash_attention.ops.attention` takes it for `impl="ref"`
  and for every CPU tensor; on the card `impl="auto"` launches the
  hand-written kernels instead.
* :func:`decode_attention` — one query token against a (possibly rolling)
  KV cache. The reference computes it outside any Pallas kernel, and so
  does the port. On DTensor caches split on T under an activation
  sharding it runs on each device's T slice (`decode_partial`) and
  combines the slices' softmax by all-reduces (`merge_partials`,
  `sharding.context.on_seq_shards`), as the reference's compile does.
* :func:`simple_attention` — naive O(S^2) oracle, used only to check.

The block loops run through `sharding.loops.scan`, so the dry-run counts
two blocks of each loop and scales them. Inside a block the query heads
stay flat, (B, qb, H, hd), and each K / V block is expanded to the query
heads (`repeat_interleave` over the head dim, as an `index_select`); the
backward sums the expanded blocks' gradients back onto the KV heads
(`index_add_`). On DTensors under an activation sharding the blocks run on
each device's shards, the query heads split over `model`
(`sharding.context.on_head_shards`), where the reference's compile splits
(KV, G).
"""
from __future__ import annotations

import math

import torch

from repro_torch.sharding.context import (on_head_shards, on_seq_shards,
                                          seq_sharded)
from repro_torch.sharding.loops import scan

NEG_INF = -1e30


def _gqa_split(q, num_kv: int):
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def _mask(qpos, kpos, causal: bool, window: int):
    msk = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                     device=qpos.device)
    if causal:
        msk = msk & (kpos[None, :] <= qpos[:, None])
    if window:
        msk = msk & (kpos[None, :] > (qpos[:, None] - window))
    return msk


def simple_attention(q, k, v, *, causal: bool, window: int = 0,
                     q_offset: int = 0):
    """Naive attention oracle. q: (B,S,H,hd) k/v: (B,T,KV,hd)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = _gqa_split(q, kv)                                    # (B,S,KV,G,hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    dev = q.device
    msk = _mask(torch.arange(s, device=dev) + q_offset,
                torch.arange(t, device=dev), causal, window)
    scores = torch.where(msk, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(b, s, h, hd)


# ---------------------------------------------------------------- blocked
def _pad(x, n: int):
    """`x` (B, L, ...) zero-padded along L to `n` (no op when it is)."""
    if x.shape[1] == n:
        return x
    return torch.nn.functional.pad(
        x, (0, 0) * (x.ndim - 2) + (0, n - x.shape[1]))


def _kv_heads(h: int, kv: int, g: int, h0: int, device):
    """The KV head each of the h query heads reads, of kv: query head i
    reads KV head (h0 + i) // g (with h0 = 0 and h = kv g,
    `repeat_interleave` over the head dim); None where that is every KV
    head once."""
    if g == 1 and h0 == 0 and h == kv:
        return None
    return torch.div(h0 + torch.arange(h, device=device), g,
                     rounding_mode="floor")


def _expand(x, idx):
    """A K / V block (B, kb, KV, hd) -> (B, kb, H, hd) on the query heads'
    KV heads `idx`."""
    return x if idx is None else x.index_select(2, idx)


def _fold(x, idx, kv: int):
    """The gradient of `_expand`: (B, kb, H, hd) summed onto the KV heads
    each query head read."""
    if idx is None:
        return x
    out = torch.zeros(x.shape[:2] + (kv, x.shape[3]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(2, idx, x)


def _block_mask(qpos, kpos, t: int, causal: bool, window: int):
    """(qb, kb): the reference's `_mask_block`, padded keys (>= t) out."""
    return _mask(qpos, kpos, causal, window) & (kpos < t)[None, :]


def _fwd(q, k, v, t: int, *, causal, window, q_block, k_block, q_offset,
         g, h0):
    """The blocked forward on inputs padded to the blocks (t: the keys
    before padding; query head i reads KV head (h0 + i) // g): the f32
    output (B, S', H, hd) and each row's lse (B, S', H), the reference's
    `_flash_fwd_scan`."""
    b, sp, h, hd = q.shape
    idx = _kv_heads(h, k.shape[2], g, h0, q.device)
    nq, nk = sp // q_block, k.shape[1] // k_block
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    def kv_step(carry, xs, j):
        m, l, acc = carry
        qblk, qpos = xs
        kpos = j * k_block + torch.arange(k_block, device=dev)
        kblk = _expand(k[:, j * k_block:(j + 1) * k_block], idx)
        vblk = _expand(v[:, j * k_block:(j + 1) * k_block], idx)
        sc = torch.einsum("bqhd,bchd->bhqc", qblk, kblk).to(
            torch.float32) * scale
        sc = torch.where(_block_mask(qpos, kpos, t, causal, window), sc,
                         NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p.to(vblk.dtype), vblk).to(torch.float32)
        return (m_new, l, acc), None

    def q_step(carry, xs, i):
        qblk = q[:, i * q_block:(i + 1) * q_block]            # (B,qb,H,hd)
        qpos = i * q_block + torch.arange(q_block, device=dev) + q_offset
        m0 = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32,
                        device=dev)
        l0 = torch.zeros((b, h, q_block), dtype=torch.float32, device=dev)
        a0 = torch.zeros((b, h, q_block, hd), dtype=torch.float32,
                         device=dev)
        _, (m, l, acc) = scan("models/attention.py:_fwd_q_block", kv_step,
                              (m0, l0, a0), (qblk, qpos), nk)
        out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,H,qb,hd)
        lse = m + torch.log(torch.clamp(l, min=1e-30))        # (B,H,qb)
        return carry, (out.transpose(1, 2), lse.transpose(1, 2))

    (out, lse), _ = scan("models/attention.py:_fwd", q_step, (), (), nq)
    return out.reshape(b, sp, h, hd), lse.reshape(b, sp, h)


def _bwd(q, k, v, out, lse, do, t: int, *, causal, window, q_block,
         k_block, q_offset, g, h0):
    """(dq, dk, dv) in f32 from inputs padded to the blocks (out and dO
    zero in the padded rows): the reference's `flash_bwd`, KV blocks outer
    and query blocks inner. D = rowsum(dO O), P = exp(scale S - lse), dV
    += P^T dO, dP = dO V^T, dS = P (dP - D) scale, dQ += dS K, dK += dS^T
    Q; dK and dV are kept per query head through the query loop and folded
    onto the KV heads once per KV block."""
    b, sp, h, hd = q.shape
    tp, kv = k.shape[1], k.shape[2]
    idx = _kv_heads(h, kv, g, h0, q.device)
    nq, nk = sp // q_block, tp // k_block
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    f32 = torch.float32
    d = (do.to(f32) * out.to(f32)).sum(dim=-1)                # (B,S',H)

    def q_step(carry, xs, i):
        dk_j, dv_j = carry
        kblk, vblk, kpos = xs
        rows = slice(i * q_block, (i + 1) * q_block)
        qblk, do_b = q[:, rows].to(f32), do[:, rows].to(f32)  # (B,qb,H,hd)
        lse_b = lse[:, rows].transpose(1, 2)                  # (B,H,qb)
        d_b = d[:, rows].transpose(1, 2)
        qpos = i * q_block + torch.arange(q_block, device=dev) + q_offset
        sc = torch.einsum("bqhd,bchd->bhqc", qblk, kblk) * scale
        sc = torch.where(_block_mask(qpos, kpos, t, causal, window), sc,
                         NEG_INF)
        p = torch.exp(sc - lse_b[..., None])                  # (B,H,qb,kb)
        dv_j = dv_j + torch.einsum("bhqc,bqhd->bchd", p, do_b)
        dp = torch.einsum("bqhd,bchd->bhqc", do_b, vblk)
        ds = p * (dp - d_b[..., None]) * scale
        dq_b = torch.einsum("bhqc,bchd->bqhd", ds, kblk)
        dk_j = dk_j + torch.einsum("bhqc,bqhd->bchd", ds, qblk)
        return (dk_j, dv_j), dq_b

    def kv_step(carry, xs, j):
        (dq,) = carry
        cols = slice(j * k_block, (j + 1) * k_block)
        kblk = _expand(k[:, cols].to(f32), idx)               # (B,kb,H,hd)
        vblk = _expand(v[:, cols].to(f32), idx)
        kpos = j * k_block + torch.arange(k_block, device=dev)
        z = torch.zeros((b, k_block, h, hd), dtype=f32, device=dev)
        dq_blocks, (dk_j, dv_j) = scan(
            "models/attention.py:_bwd_kv_block", q_step, (z, z),
            (kblk, vblk, kpos), nq)
        dq = dq + dq_blocks.reshape(b, sp, h, hd)
        return (dq,), (_fold(dk_j, idx, kv), _fold(dv_j, idx, kv))

    dq0 = torch.zeros((b, sp, h, hd), dtype=f32, device=dev)
    (dk, dv), (dq,) = scan("models/attention.py:_bwd", kv_step, (dq0,), (),
                           nk)
    return dq, dk.reshape(b, tp, kv, hd), dv.reshape(b, tp, kv, hd)


class BlockedAttention(torch.autograd.Function):
    """The blocked attention with the blocked backward: (q, k, v, out,
    lse) saved. Outputs the output in q's dtype and the lse (B, S, H) f32
    (not differentiable)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, k_block, q_offset,
                g, h0):
        s, t = q.shape[1], k.shape[1]
        nq, nk = -(-s // q_block), -(-t // k_block)
        kw = dict(causal=causal, window=window, q_block=q_block,
                  k_block=k_block, q_offset=q_offset, g=g, h0=h0)
        out, lse = _fwd(_pad(q, nq * q_block), _pad(k, nk * k_block),
                        _pad(v, nk * k_block), t, **kw)
        out, lse = out[:, :s].to(q.dtype), lse[:, :s]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        kw = ctx.kw
        s, t = q.shape[1], k.shape[1]
        sp = -(-s // kw["q_block"]) * kw["q_block"]
        tp = -(-t // kw["k_block"]) * kw["k_block"]
        dq, dk, dv = _bwd(_pad(q, sp), _pad(k, tp), _pad(v, tp),
                          _pad(out, sp), _pad(lse, sp), _pad(do, sp), t,
                          **kw)
        return (dq[:, :s].to(q.dtype), dk[:, :t].to(k.dtype),
                dv[:, :t].to(v.dtype)) + (None,) * 7


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_block: int = 512, k_block: int = 1024,
                    q_offset: int = 0):
    """Blocked online-softmax attention with the blocked backward
    (`flash_attention_jnp`).

    q: (B, S, H, hd); k, v: (B, T, KV, hd); H % KV == 0. Returns (B, S, H,
    hd) in q's dtype. The blocks are capped at S and T; S and T are padded
    to them here and the padded keys masked, as the reference does.
    Differentiable in q, k and v, with no (S, T) tensor kept or made."""
    q_block, k_block = min(q_block, q.shape[1]), min(k_block, k.shape[1])

    def attend(q, k, v, g, h0):
        return BlockedAttention.apply(q, k, v, causal, int(window), q_block,
                                      k_block, q_offset, g, h0)
    return on_head_shards(attend, q, k, v)[0]


def _decode_scores(q, k):
    """(B, 1, H, hd) queries against (B, T, KV, hd) keys: the (B, KV, G, T)
    fp32 scores over sqrt(hd)."""
    qg = _gqa_split(q, k.shape[2])[:, 0]                      # (B, KV, G, hd)
    # a cache in another dtype than q: the scores in the promoted dtype, as
    # jnp.einsum computes them
    dt = torch.promote_types(q.dtype, k.dtype)
    sc = torch.einsum("bkgh,btkh->bkgt", qg.to(dt),
                      k.to(dt)).to(torch.float32)
    return sc / math.sqrt(q.shape[-1])


def _decode_valid(pos, t: int, cache_len, window: int, ring: bool):
    """Which cache slots at global positions `pos` a decode reads, in a
    cache of t slots: (B or 1, len(pos))."""
    if isinstance(cache_len, torch.Tensor):
        clen = cache_len.reshape(-1, 1)                        # (B or 1, 1)
        hi = torch.clamp(clen, max=t) if ring else clen
    else:            # a Python int: no host-to-device copy per decode step
        clen = int(cache_len)
        hi = min(clen, t) if ring else clen
    valid = pos[None, :] < hi
    if window and not ring:
        valid = valid & (pos[None, :] >= clen - window)
    return valid


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     ring: bool = False):
    """Single-step decode attention against a KV cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, T, KV, hd); cache_len: an int or
    a (B,) tensor, the number of valid cache entries (the current token's
    KV, already written, included). With ``ring`` the cache is a rolling
    buffer of size ``window`` (positions wrap) and validity is
    min(cache_len, window).

    Where the caches are DTensors split on T under an armed activation
    sharding (`sharding.context.seq_sharded`; cache_len an int), each
    device runs the softmax on its T slice (`decode_partial`) and the
    slices are combined by all-reduces (`merge_partials`), as the
    reference's compile splits it; not bit-equal to the one-slice path."""
    b, _, h, hd = q.shape
    t = k_cache.shape[1]
    if seq_sharded(k_cache):
        def on_slice(q, k, v, t0, reduce):
            return merge_partials(*decode_partial(
                q, k, v, cache_len, t0, t, window=window, ring=ring), reduce)
        out = on_seq_shards(on_slice, q, k_cache, v_cache)
        return out.to(v_cache.dtype).reshape(b, 1, h, hd).to(q.dtype)
    sc = _decode_scores(q, k_cache)
    valid = _decode_valid(torch.arange(t, device=q.device), t, cache_len,
                          window, ring)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh",
                       (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype),
                       v_cache)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_partial(q, k, v, cache_len, t0: int, t: int, *, window: int = 0,
                   ring: bool = False):
    """The split softmax's part of one slice of a t-slot cache: k, v
    (B, n, KV, hd) hold its entries at global positions [t0, t0 + n); the
    rest as `decode_attention`'s. Returns the slice's max m and sum l,
    (B, KV, G, 1), and the unnormalised o = p @ v, (B, KV, G, hd), all fp32
    (p cast to v's dtype for the product, as the one-slice path casts its
    weights). A slice with no valid slot has m = NEG_INF: its weight in
    `merge_partials` is exactly 0 beside any slice that has one."""
    sc = _decode_scores(q, k)
    valid = _decode_valid(torch.arange(t0, t0 + k.shape[1], device=q.device),
                          t, cache_len, window, ring)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    o = torch.einsum("bkgt,btkh->bkgh", p.to(v.dtype), v)
    return m, p.sum(dim=-1, keepdim=True), o.to(torch.float32)


def merge_partials(m, l, o, reduce):
    """Combine the slices' `decode_partial` (m, l, o) into the normalised
    fp32 output (B, KV, G, hd): `reduce(x, op)` takes x over the slices
    with op "max" or "sum" (all-reduces over the cache's T split)."""
    mg = reduce(m, "max")
    w = torch.exp(m - mg)
    return reduce(o * w, "sum") / torch.clamp(reduce(l * w, "sum"),
                                              min=1e-30)
