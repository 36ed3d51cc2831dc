"""Plain PyTorch oracles of the flash attention kernels, in the kernels'
head-major layout (port of `repro/kernels/flash_attention/ref.py`, and the
reference's `flash_bwd` written plainly). They are the path the wrappers
take for CPU tensors and what `chip_smoke.py` holds the kernels to on the
card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, _mask, simple_attention


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, S, hd); k/v: (B, KV, T, hd) — kernel layout (head-major)."""
    o = simple_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def _scores(q, k, causal: bool, window: int):
    """fp32 scaled scores (B, KV, G, S, T) of head-major q and k, and the
    (S, T) mask."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, KV, H // KV, S, hd)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(torch.float32))
    msk = _mask(torch.arange(S, device=q.device),
                torch.arange(T, device=q.device), causal, window)
    return s * hd ** -0.5, msk


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0):
    """Each row's log-sum-exp of the scaled, masked scores, (B, H, S) fp32:
    what the forward kernel writes for the backward (masked scores at
    -1e30, as the reference's)."""
    s, msk = _scores(q, k, causal, window)
    lse = torch.logsumexp(torch.where(msk, s, NEG_INF), dim=-1)
    return lse.reshape(q.shape[0], q.shape[1], q.shape[2])


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0):
    """(dq, dk, dv) of attention from (q, k, v, o, lse, dO), head-major as
    the forward's (q, o, dO: (B, H, S, hd); k, v: (B, KV, T, hd); lse:
    (B, H, S)), in fp32 and returned in the inputs' dtype: the reference's
    `flash_bwd` (repro/models/attention.py) written plainly. D = rowsum(dO
    O), P = exp(scale S - lse) (0 where masked), dV = P^T dO, dP = dO V^T,
    dS = P (dP - D) scale, dQ = dS K, dK = dS^T Q; dK and dV are summed
    over the G query heads of each KV head."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    f32 = torch.float32
    s, msk = _scores(q, k, causal, window)
    lse_g = lse.to(f32).reshape(B, KV, H // KV, S, 1)
    p = torch.where(msk, torch.exp(s - lse_g), 0.0)
    dog = do.to(f32).reshape(B, KV, H // KV, S, hd)
    d = (dog * o.to(f32).reshape(B, KV, H // KV, S, hd)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, v.to(f32))
    ds = p * (dp - d) * hd ** -0.5
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.to(f32)).reshape(B, H, S, hd)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds,
                      q.to(f32).reshape(B, KV, H // KV, S, hd))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
