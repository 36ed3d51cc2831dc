"""Attention in plain PyTorch (port of `repro/models/attention.py`, forward
only). Layout (B, S, H, hd) for queries and (B, T, KV, hd) for keys and
values, as in the reference; GQA query head h reads KV head h // (H / KV).

* :func:`flash_attention` — the blocked online-softmax forward of the
  reference's `flash_attention_jnp` (query blocks outer, KV blocks inner,
  running max / sum / accumulator in f32). It is a plain version; the
  model's prefill goes through `kernels.flash_attention.ops.attention`,
  which launches the hand-written kernel on the card.
* :func:`decode_attention` — one query token against a (possibly rolling)
  KV cache. The reference computes it outside any Pallas kernel, and so
  does the port.
* :func:`simple_attention` — naive O(S^2) oracle.
"""
from __future__ import annotations

import math

import torch

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_block: int = 512, k_block: int = 1024,
                    q_offset: int = 0):
    """Blocked online-softmax attention, forward (`flash_attention_jnp`).

    q: (B, S, H, hd); k, v: (B, T, KV, hd); H % KV == 0. Returns
    (B, S, H, hd) in q's dtype. S and T are padded to the blocks here and
    the padded keys masked, as the reference does."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_block, k_block = min(q_block, s), min(k_block, t)
    nq, nk = -(-s // q_block), -(-t // k_block)
    dev = q.device
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * q_block - s))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * k_block - t))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * k_block - t))
    qg = _gqa_split(qp, kv)                                   # (B,S',KV,G,hd)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi * q_block:(qi + 1) * q_block]         # (B,qb,KV,G,hd)
        qpos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
        m = torch.full((b, kv, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, q_block, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk = kp[:, ki * k_block:(ki + 1) * k_block]     # (B,kb,KV,hd)
            vblk = vp[:, ki * k_block:(ki + 1) * k_block]
            kpos = ki * k_block + torch.arange(k_block, device=dev)
            sc = torch.einsum("bqkgh,bckh->bkgqc", qblk, kblk).to(
                torch.float32) * scale
            msk = _mask(qpos, kpos, causal, window) & (kpos < t)[None, :]
            sc = torch.where(msk, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckh->bkgqh", p.to(vblk.dtype), vblk).to(torch.float32)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=3)                            # (B,KV,G,nq,qb,hd)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(b, nq * q_block, h, hd)
    return out[:, :s].to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     ring: bool = False):
    """Single-step decode attention against a KV cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, T, KV, hd); cache_len: an int or
    a (B,) tensor, the number of valid cache entries (the current token's
    KV, already written, included). With ``ring`` the cache is a rolling
    buffer of size ``window`` (positions wrap) and validity is
    min(cache_len, window)."""
    b, _, h, hd = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    qg = _gqa_split(q, kv)[:, 0]                              # (B, KV, G, hd)
    # a cache in another dtype than q: the scores in the promoted dtype, as
    # jnp.einsum computes them
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    sc = torch.einsum("bkgh,btkh->bkgt", qg.to(dt),
                      k_cache.to(dt)).to(torch.float32)
    sc = sc / math.sqrt(hd)
    pos = torch.arange(t, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        clen = cache_len.reshape(-1, 1)                        # (B or 1, 1)
        hi = torch.clamp(clen, max=t) if ring else clen
    else:            # a Python int: no host-to-device copy per decode step
        clen = int(cache_len)
        hi = min(clen, t) if ring else clen
    valid = pos[None, :] < hi
    if window and not ring:
        valid = valid & (pos[None, :] >= clen - window)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh",
                       (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype),
                       v_cache)
    return out.reshape(b, 1, h, hd).to(q.dtype)
