"""The attention block with train, prefill and decode paths (port of
`repro/models/blocks.py`, the attention block only; cross-attention, MoE,
Mamba, mLSTM and sLSTM are ROADMAP Queue 1 item 13).

    init_attn(generator, cfg)                 -> params subtree
    attn_train(p, cfg, x)                     -> y            (full sequence)
    attn_prefill(p, cfg, x, cache)            -> y, cache'    (fill the cache)
    attn_decode(p, cfg, x, cache, pos)        -> y, cache'    (one token)

``x`` is (B, S, d_model); the block is residual-free (the LM adds residuals
and norms). Full-sequence attention goes through
`kernels.flash_attention.ops.attention`: on the card every prefill and
every training forward launches the hand-written kernel. Caches are dicts
of (B, T, KV, hd) tensors, written in place (the reference returns updated
copies; the port saves the copy of a whole cache per layer and token).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_rope, init_linear, linear


def init_attn(generator, cfg: ArchConfig, *, lead=(), device=None):
    """wq, wk, wv, wo; `lead` prepends the LM's stacked-period axis."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    return {
        "wq": init_linear(generator, d, cfg.num_heads * hd,
                          bias=cfg.qkv_bias, **kw),
        "wk": init_linear(generator, d, cfg.num_kv_heads * hd,
                          bias=cfg.qkv_bias, **kw),
        "wv": init_linear(generator, d, cfg.num_kv_heads * hd,
                          bias=cfg.qkv_bias, **kw),
        "wo": init_linear(generator, cfg.num_heads * hd, d,
                          stddev=0.02 / math.sqrt(2 * cfg.num_layers), **kw),
    }


def _qkv(p, cfg: ArchConfig, x, positions, rope: bool = True):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def attn_train(p, cfg: ArchConfig, x, *, causal: bool = True, window: int = 0,
               impl: str = "auto"):
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, _positions(b, s, x.device))
    o = FA.attention(q, k, v, causal=causal, window=window, impl=impl)
    return linear(p["wo"], o.reshape(b, s, -1))


def init_attn_cache(cfg: ArchConfig, batch: int, cache_len: int,
                    dtype=torch.bfloat16, *, lead=(), device=None):
    shp = tuple(lead) + (batch, cache_len, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def attn_prefill(p, cfg: ArchConfig, x, cache: Dict, *, window: int = 0,
                 impl: str = "auto"):
    """Run full-sequence attention and write the KV cache.

    The cache length may exceed S (room for decode); with a ring cache
    (window > 0 and cache_len == window) the tail of the sequence is kept,
    the entry for absolute position p at p % window."""
    b, s, _ = x.shape
    t = cache["k"].shape[1]
    q, k, v = _qkv(p, cfg, x, _positions(b, s, x.device))
    o = FA.attention(q, k, v, causal=True, window=window, impl=impl)
    if window and t == window and s > t:
        idx = torch.arange(s - t, s, device=x.device) % t
        cache["k"][:, idx] = k[:, -t:].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, -t:].to(cache["v"].dtype)
    else:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
    return linear(p["wo"], o.reshape(b, s, -1)), cache


def attn_decode(p, cfg: ArchConfig, x, cache: Dict, pos: int, *,
                window: int = 0):
    """x: (B, 1, d); pos: the absolute position of this token (an int)."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    ring = bool(window) and t == window
    widx = pos % t if ring else pos
    cache["k"][:, widx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, widx] = v[:, 0].to(cache["v"].dtype)
    o = attn_lib.decode_attention(q, cache["k"], cache["v"], pos + 1,
                                  window=window, ring=ring)
    return linear(p["wo"], o.reshape(b, 1, -1)), cache
