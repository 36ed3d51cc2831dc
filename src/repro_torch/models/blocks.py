"""Transformer / SSM / MoE building blocks with train, prefill and decode
paths (port of `repro/models/blocks.py`: attention, cross-attention, the
MoE FFN, Mamba, mLSTM and sLSTM).

    init_<blk>(generator, cfg, ...)           -> params subtree
    <blk>_train(p, cfg, x, ...)               -> y            (full sequence)
    <blk>_prefill(p, cfg, x, cache, ...)      -> y, cache'    (fill the cache)
    <blk>_decode(p, cfg, x, cache, ...)       -> y, cache'    (one token)

``x`` is (B, S, d_model); blocks are residual-free (the LM adds residuals
and norms). Full-sequence attention goes through
`kernels.flash_attention.ops.attention` and the Mamba scan through
`kernels.ssm_scan.ops.selective_scan`: on the card every prefill and every
training forward launches the hand-written kernels. Caches are dicts of
tensors, written in place (the reference returns updated copies; the port
saves the copy of a whole cache per layer and token).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

import torch.nn.functional as F

from repro_torch.common.config import ArchConfig, MoEConfig, SSMConfig
from repro_torch.common.pytree import normal_init
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.ssm_scan import ops as SS
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_rope, init_linear, linear,
                                       log_sigmoid, softplus)
from repro_torch.sharding.context import (constrain_moe, scatter_along,
                                          write_slot)
from repro_torch.sharding.loops import scan


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
    """x: (B, 1, d); pos: the absolute position of this token (an int).

    A write at or past the end of a cache that is not a ring raises a
    ValueError. The reference does not: `dynamic_update_slice_in_dim`
    clamps the start, so it overwrites the last slot and then attends with
    length pos + 1. That is a documented difference (ROADMAP Queue 3); the
    serving executor and `launch.steps` size every cache so that no served
    or launched decode reaches it."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    ring = bool(window) and t == window
    if not ring and pos >= t:
        raise ValueError(
            f"attn_decode: a KV write at position {pos} into a cache of "
            f"{t} slots (the reference clamps it into slot {t - 1})")
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    widx = pos % t if ring else pos
    write_slot(cache["k"], widx, k[:, 0])
    write_slot(cache["v"], widx, v[:, 0])
    o = attn_lib.decode_attention(q, cache["k"], cache["v"], pos + 1,
                                  window=window, ring=ring)
    return linear(p["wo"], o.reshape(b, 1, -1)), cache


# cross attention (whisper decoder): KV from the encoder output, computed once
def init_cross_attn(generator, cfg: ArchConfig, *, lead=(), device=None):
    return init_attn(generator, cfg, lead=lead, device=device)


def cross_attn_kv(p, cfg: ArchConfig, enc_out):
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = linear(p["wk"], enc_out).reshape(b, t, cfg.num_kv_heads, hd)
    v = linear(p["wv"], enc_out).reshape(b, t, cfg.num_kv_heads, hd)
    return {"k": k, "v": v}


def cross_attn_apply(p, cfg: ArchConfig, x, kv: Dict, *, impl: str = "auto"):
    """Every query against every encoder position (no mask, no RoPE)."""
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    o = FA.attention(q, kv["k"].to(x.dtype), kv["v"].to(x.dtype),
                     causal=False, impl=impl)
    return linear(p["wo"], o.reshape(b, s, -1))


# ======================================================================
# mixture-of-experts FFN (top-k routing, the routed experts only)
def init_moe(generator, cfg: ArchConfig, mcfg: MoEConfig, *, lead=(),
             device=None):
    """router (d, E), gate and up (E, d, f), down (E, f, d), with the
    reference's stddevs, drawn in its order."""
    lead = tuple(lead)
    d, e, f = cfg.d_model, mcfg.num_experts, mcfg.expert_d_ff
    router = init_linear(generator, d, e, stddev=0.02, lead=lead,
                         device=device)
    gate = normal_init(generator, lead + (e, d, f), stddev=1 / math.sqrt(d),
                       device=device)
    up = normal_init(generator, lead + (e, d, f), stddev=1 / math.sqrt(d),
                     device=device)
    down = normal_init(generator, lead + (e, f, d),
                       stddev=1 / math.sqrt(f) / math.sqrt(2 * cfg.num_layers),
                       device=device)
    return {"router": router, "gate": gate, "up": up, "down": down}


def moe_apply(p, cfg: ArchConfig, mcfg: MoEConfig, x,
              capacity_factor: float = 1.25,
              dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss), the reference's function.

    Routing as the reference: router logits in fp32, softmax, top-k,
    weights renormalised by max(sum, 1e-9), the Switch aux loss over all
    tokens. Each batch row is a routing group: an assignment's slot in its
    expert is its rank among the row's (S·k) token-major assignments to
    that expert, and capacity dispatch (cap = ceil(S·k/E·cf), at most S)
    drops the assignments whose slot is at or past cap; `dropless` sets
    cap = S, which drops none. Where the reference fills an (E, cap, d)
    buffer per row and multiplies every slot, the port sorts the
    assignments by expert and multiplies each expert's rows only (its
    empty slots add nothing to the reference's combine), so an expert no
    token chose is never read. The k-combine is the reference's: (S, k, d)
    times the kept weights, summed over k. One device-to-host copy per
    call (the experts' row counts).

    A tensor whose values cannot be read (a meta tensor: the dry-run's
    trace, `launch.steps.lower_case`) takes the reference's fixed-shape
    dispatch instead (`_moe_buffers`), which reads nothing on the host."""
    b, s, d = x.shape
    e, k = mcfg.num_experts, mcfg.experts_per_token
    cap = s if dropless else max(1, min(s, int(math.ceil(
        s * k / e * capacity_factor))))
    logits = linear(p["router"], x).to(torch.float32)           # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)                   # (B, S, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch-style, over all tokens)
    me = probs.mean(dim=(0, 1))
    if x.is_meta:
        ce = F.one_hot(topi, e).to(torch.float32).mean(dim=(0, 1, 2))
        aux = e * torch.sum(me * ce) * mcfg.aux_loss_coef
        return _moe_buffers(p, x, topi, topw, e, cap), aux
    ce = torch.bincount(topi.reshape(-1), minlength=e).to(torch.float32) / (
        b * s * k)
    aux = e * torch.sum(me * ce) * mcfg.aux_loss_coef

    n = b * s * k
    row = torch.arange(b, device=x.device).repeat_interleave(s * k)
    flat_e = topi.reshape(-1)                                   # row, token, k
    group = flat_e * b + row                                    # expert, row
    order = torch.argsort(group, stable=True)
    counts = torch.bincount(group, minlength=e * b)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(group)
    slot[order] = torch.arange(n, device=x.device) - starts[group[order]]
    w = topw.reshape(-1) * (slot < cap)                         # kept weights
    xs = x.reshape(b * s, d)[(order // (s * k)) * s + (order % (s * k)) // k]
    ys = torch.empty_like(xs)
    hi = 0
    for ei, cnt in enumerate(counts.reshape(e, b).sum(1).tolist()):
        lo, hi = hi, hi + cnt
        if cnt:
            h = xs[lo:hi]
            g = F.silu(h @ p["gate"][ei].to(x.dtype)) * (
                h @ p["up"][ei].to(x.dtype))
            ys[lo:hi] = g @ p["down"][ei].to(x.dtype)
    out = torch.empty_like(ys)
    out[order] = ys
    y = (out.reshape(b, s, k, d) * w.to(x.dtype).reshape(b, s, k, 1)).sum(2)
    return y, aux


def _moe_buffers(p, x, topi, topw, e: int, cap: int):
    """The reference's capacity dispatch at fixed shapes: each row's (S·k)
    assignments set into an (E, cap, d) buffer at their rank within their
    expert (those at or past cap into a spare slot that is dropped), every
    slot through its expert's FFN, each assignment's slot gathered back and
    the k weighted and summed. The buffer is pinned by `constrain_moe`, as
    the reference's is. It computes `moe_apply`'s function with no host
    read, at the cost of multiplying the empty slots."""
    b, s, d = x.shape
    k = topi.shape[-1]
    flat_e = topi.reshape(b, s * k)                             # (B, S*k)
    onehot = F.one_hot(flat_e, e)                               # (B, S*k, E)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(
        2, flat_e[..., None])[..., 0]                           # rank
    keep = pos < cap
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    dest = torch.where(keep, slot, e * cap)[..., None].expand(b, s * k, d)
    # zeros placed as x (a DTensor's `new_zeros` is replicated: the whole
    # global batch's buffer on every device)
    buf = scatter_along(torch.zeros_like(x[:, :1]).expand(b, e * cap + 1, d),
                        1, dest, x[:, tok])
    buf = constrain_moe(buf[:, :e * cap].reshape(b, e, cap, d))
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["gate"].to(x.dtype))) * \
        torch.einsum("becd,edf->becf", buf, p["up"].to(x.dtype))
    out_e = constrain_moe(torch.einsum("becf,efd->becd", h,
                                       p["down"].to(x.dtype)))
    got = out_e.reshape(b, e * cap, d).gather(
        1, slot[..., None].expand(b, s * k, d))                 # (B, S*k, d)
    w = (topw.reshape(b, s * k) * keep).to(x.dtype)
    return (got * w[..., None]).reshape(b, s, k, d).sum(2)


# ======================================================================
# Mamba selective-SSM block
def _dt_rank(cfg: ArchConfig, scfg: SSMConfig) -> int:
    return scfg.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def init_mamba(generator, cfg: ArchConfig, scfg: SSMConfig, *, lead=(),
               device=None):
    """The reference's tree, shapes and initialisers: S4D-real A_log, the
    inverse-softplus dt bias of a log-uniform draw in [1e-3, 1e-1], conv_w
    with std 0.3, out_proj with std 0.02 / sqrt(2 L), D ones; drawn in the
    reference's order. `lead` prepends the LM's stacked-period axis."""
    lead = tuple(lead)
    d = cfg.d_model
    inner = scfg.expand * d
    dt_rank = _dt_rank(cfg, scfg)
    n = scfg.state_dim
    kw = dict(lead=lead, device=device)
    f32 = torch.float32
    in_proj = init_linear(generator, d, 2 * inner, **kw)
    conv_w = normal_init(generator, lead + (scfg.conv_width, inner),
                         stddev=0.3, device=device)
    x_proj = init_linear(generator, inner, dt_rank + 2 * n, **kw)
    dt_w = normal_init(generator, lead + (dt_rank, inner),
                       stddev=dt_rank ** -0.5, device=device)
    u = torch.empty(lead + (inner,), dtype=f32, device=device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)
    a = torch.arange(1, n + 1, dtype=f32, device=device).expand(
        lead + (inner, n))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (inner,), dtype=f32, device=device),
        "x_proj": x_proj,
        "dt_proj": {"w": dt_w,
                    "b": torch.log(torch.exp(torch.exp(u)) - 1.0 + 1e-9)},
        "A_log": torch.log(a),
        "D": torch.ones(lead + (inner,), dtype=f32, device=device),
        "out_proj": init_linear(generator, inner, d,
                                stddev=0.02 / math.sqrt(2 * cfg.num_layers),
                                **kw),
    }


def _mamba_conv(p, xi):
    """Causal depthwise conv over time, as the reference writes it: a loop
    of shifted multiply-adds (not `F.conv1d`, which cuDNN runs in TF32 by
    default). xi: (B, S, inner)."""
    w = p["conv_w"].to(xi.dtype)                               # (W, inner)
    width = w.shape[0]
    xp = F.pad(xi, (0, 0, width - 1, 0))
    out = torch.zeros_like(xi)
    for i in range(width):
        out = out + xp[:, i:i + xi.shape[1]] * w[i]
    return out + p["conv_b"].to(xi.dtype)


def _mamba_inner(p, xi_conv, dt_rank: int, n: int):
    """The post-conv computation -> (x, dt, A, B, C) of the scan:
    x = silu(xi_conv), dt softplus'd, A = -exp(A_log) in fp32, B and C the
    x_proj splits (views)."""
    xi = F.silu(xi_conv)
    proj = linear(p["x_proj"], xi)                            # (B,S,dtr+2n)
    dt, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = softplus(dt @ p["dt_proj"]["w"].to(xi.dtype)
                  + p["dt_proj"]["b"].to(xi.dtype))           # (B,S,inner)
    a = -torch.exp(p["A_log"].to(torch.float32))              # (inner, n)
    return xi, dt, a, bmat, cmat


def _mamba_full(p, cfg: ArchConfig, scfg: SSMConfig, x, h0, impl: str):
    """Shared full-sequence path: one `selective_scan` (one kernel launch on
    the card). Returns (out, final state, conv tail)."""
    xz = linear(p["in_proj"], x)
    xi_raw, z = torch.chunk(xz, 2, dim=-1)
    xi_conv = _mamba_conv(p, xi_raw)
    xi, dt, a, bmat, cmat = _mamba_inner(p, xi_conv, _dt_rank(cfg, scfg),
                                         scfg.state_dim)
    y, h_last = SS.selective_scan(dt, a, bmat, cmat, xi, h0, impl=impl)
    y = y.to(x.dtype) + xi * p["D"].to(x.dtype)
    y = y * F.silu(z)
    w = scfg.conv_width
    # the last w - 1 raw inputs, zeros in front when S < w - 1
    conv_tail = F.pad(xi_raw, (0, 0, w - 1, 0))[:, -(w - 1):]
    return linear(p["out_proj"], y), h_last, conv_tail


def mamba_train(p, cfg: ArchConfig, scfg: SSMConfig, x, *,
                impl: str = "auto"):
    """x: (B, S, d) -> (B, S, d), from a zero state."""
    out, _, _ = _mamba_full(p, cfg, scfg, x, None, impl)
    return out


def init_mamba_cache(cfg: ArchConfig, scfg: SSMConfig, batch: int,
                     dtype=torch.float32, *, lead=(), device=None):
    """conv: the last conv_width - 1 raw inputs in `dtype`; ssm: the fp32
    state."""
    inner = scfg.expand * cfg.d_model
    lead = tuple(lead)
    return {"conv": torch.zeros(lead + (batch, scfg.conv_width - 1, inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, inner, scfg.state_dim),
                               dtype=torch.float32, device=device)}


def mamba_prefill(p, cfg: ArchConfig, scfg: SSMConfig, x, cache: Dict, *,
                  impl: str = "auto"):
    """Full-sequence pass from the cache's ssm state that leaves the final
    state and the conv tail in the cache (as the reference, the conv starts
    from zeros). `impl` picks the scan: "auto" (the kernel on the card, the
    plain version on the CPU) or "ref"."""
    out, h_last, conv_tail = _mamba_full(p, cfg, scfg, x, cache["ssm"], impl)
    cache["conv"].copy_(conv_tail)
    cache["ssm"].copy_(h_last)
    return out, cache


def mamba_decode(p, cfg: ArchConfig, scfg: SSMConfig, x, cache: Dict):
    """x: (B, 1, d). One step of the recurrent form, plain PyTorch."""
    xz = linear(p["in_proj"], x)
    xi_raw, z = torch.chunk(xz, 2, dim=-1)                    # (B,1,inner)
    conv_buf = torch.cat([cache["conv"].to(x.dtype), xi_raw], dim=1)
    w = p["conv_w"].to(x.dtype)
    xi = (torch.einsum("bwi,wi->bi", conv_buf, w)[:, None]
          + p["conv_b"].to(x.dtype))
    xi, dt, a, bmat, cmat = _mamba_inner(p, xi, _dt_rank(cfg, scfg),
                                         scfg.state_dim)
    f32 = torch.float32
    da = torch.exp(dt[:, 0, :, None].to(f32) * a)             # (B, inner, n)
    dbx = (dt[:, 0] * xi[:, 0])[..., None].to(f32) * bmat[:, 0, None, :].to(f32)
    h = da * cache["ssm"] + dbx
    y = torch.einsum("bin,bn->bi", h, cmat[:, 0].to(f32))[:, None].to(x.dtype)
    y = y + xi * p["D"].to(x.dtype)
    y = y * F.silu(z)
    cache["conv"].copy_(conv_buf[:, 1:])
    cache["ssm"].copy_(h)
    return linear(p["out_proj"], y), cache


# ======================================================================
# xLSTM blocks (mLSTM: matrix memory; sLSTM: scalar memory w/ recurrence)
def _xlstm_dims(cfg: ArchConfig, scfg: SSMConfig):
    inner = scfg.expand * cfg.d_model
    return inner, scfg.mlstm_heads, inner // scfg.mlstm_heads


def init_mlstm(generator, cfg: ArchConfig, scfg: SSMConfig, *, lead=(),
               device=None):
    d = cfg.d_model
    inner, nh, _ = _xlstm_dims(cfg, scfg)
    kw = dict(lead=lead, device=device)
    return {
        "up": init_linear(generator, d, 2 * inner, **kw),
        "wq": init_linear(generator, inner, inner, **kw),
        "wk": init_linear(generator, inner, inner, **kw),
        "wv": init_linear(generator, inner, inner, **kw),
        "w_if": init_linear(generator, inner, 2 * nh, bias=True, **kw),
        "down": init_linear(generator, inner, d,
                            stddev=0.02 / math.sqrt(2 * cfg.num_layers), **kw),
    }


def init_mlstm_cache(cfg: ArchConfig, scfg: SSMConfig, batch: int, *,
                     lead=(), device=None):
    """C (B, nh, dh, dh), n (B, nh, dh) zeros and the stabiliser m at
    -1e30, all fp32 (the reference's initial state)."""
    _, nh, dh = _xlstm_dims(cfg, scfg)
    lead, f32 = tuple(lead) + (batch, nh), torch.float32
    return {"C": torch.zeros(lead + (dh, dh), dtype=f32, device=device),
            "n": torch.zeros(lead + (dh,), dtype=f32, device=device),
            "m": torch.full(lead, -1e30, dtype=f32, device=device)}


def _mlstm_qkvif(p, scfg: SSMConfig, x):
    b, s, _ = x.shape
    nh = scfg.mlstm_heads
    f32 = torch.float32
    xi, z = torch.chunk(linear(p["up"], x), 2, dim=-1)
    dh = xi.shape[-1] // nh
    q = linear(p["wq"], xi).reshape(b, s, nh, dh).to(f32) / math.sqrt(dh)
    k = linear(p["wk"], xi).reshape(b, s, nh, dh).to(f32)
    v = linear(p["wv"], xi).reshape(b, s, nh, dh).to(f32)
    igate, fgate = torch.chunk(linear(p["w_if"], xi).to(f32), 2, dim=-1)
    return (q, k, v, igate, log_sigmoid(fgate)), z


def _mlstm_step(carry, qkvif, t: int):
    """Step t of the stabilised mLSTM recurrence: ((C, n, m), h_t)."""
    C, nvec, m = carry
    q, k, v, igate, fgate = qkvif
    qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], igate[:, t], fgate[:, t]
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        vt[..., :, None] * kt[..., None, :])                   # (B,nh,dh,dh)
    nvec = f_p[..., None] * nvec + i_p[..., None] * kt
    num = torch.einsum("bhij,bhj->bhi", C, qt)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", nvec, qt)),
                      min=1.0)
    return (C, nvec, m_new), num / den[..., None]


def _mlstm_scan(qkvif, state: Dict):
    """The stabilised mLSTM recurrence, one step per position, from
    `state`'s C, n and m (`sharding.loops.scan`). The reference pads S to
    64-step chunks whose padded steps leave the state as it is, so a plain
    loop over the S real steps reaches the same state. Returns (h (B, S,
    nh, dh), the final {"C", "n", "m"}); `state` is not written (autograd
    may still need it)."""
    hs, (C, nvec, m) = scan("models/blocks.py:_mlstm_scan", _mlstm_step,
                            (state["C"], state["n"], state["m"]), qkvif,
                            qkvif[0].shape[1])
    return hs, {"C": C, "n": nvec, "m": m}


def _mlstm_apply(p, scfg: SSMConfig, x, state: Dict):
    """(block output, final state) from `state`."""
    qkvif, z = _mlstm_qkvif(p, scfg, x)
    hs, final = _mlstm_scan(qkvif, state)                      # (B,S,nh,dh)
    b, s = x.shape[:2]
    y = hs.reshape(b, s, -1).to(x.dtype) * F.silu(z)
    return linear(p["down"], y), final


def mlstm_prefill(p, cfg: ArchConfig, scfg: SSMConfig, x, cache: Dict):
    """Full-sequence pass from the cache's state that leaves the final
    state in the cache."""
    y, final = _mlstm_apply(p, scfg, x, cache)
    for key, val in final.items():
        cache[key].copy_(val)
    return y, cache


def mlstm_train(p, cfg: ArchConfig, scfg: SSMConfig, x):
    state = init_mlstm_cache(cfg, scfg, x.shape[0], device=x.device)
    return _mlstm_apply(p, scfg, x, state)[0]


def mlstm_decode(p, cfg: ArchConfig, scfg: SSMConfig, x, cache: Dict):
    return mlstm_prefill(p, cfg, scfg, x, cache)


def init_slstm(generator, cfg: ArchConfig, scfg: SSMConfig, *, lead=(),
               device=None):
    d = cfg.d_model
    inner, nh, dh = _xlstm_dims(cfg, scfg)
    kw = dict(lead=lead, device=device)
    up = init_linear(generator, d, inner, **kw)
    w_gates = init_linear(generator, inner, 4 * inner, bias=True, **kw)
    r_gates = normal_init(generator, tuple(lead) + (nh, dh, 4 * dh),
                          stddev=1 / math.sqrt(dh), device=device)
    return {"up": up, "w_gates": w_gates, "r_gates": r_gates,
            "down": init_linear(generator, inner, d,
                                stddev=0.02 / math.sqrt(2 * cfg.num_layers),
                                **kw)}


def init_slstm_cache(cfg: ArchConfig, scfg: SSMConfig, batch: int, *,
                     lead=(), device=None):
    """c, n, h zeros and the stabiliser m at -1e30, (B, nh, dh) fp32."""
    _, nh, dh = _xlstm_dims(cfg, scfg)
    shp, f32 = tuple(lead) + (batch, nh, dh), torch.float32
    return {"c": torch.zeros(shp, dtype=f32, device=device),
            "n": torch.zeros(shp, dtype=f32, device=device),
            "h": torch.zeros(shp, dtype=f32, device=device),
            "m": torch.full(shp, -1e30, dtype=f32, device=device)}


def _slstm_step(carry, xs, t: int):
    """Step t of the sLSTM recurrence: ((c, n, h, m), h_t)."""
    c, n, h, m = carry
    wx, rk = xs
    rec = torch.einsum("bhj,hjk->bhk", h, rk)                  # (B,nh,4dh)
    zt, it, ft, ot = torch.chunk(wx[:, t] + rec, 4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    ft = log_sigmoid(ft)
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h = ot * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


def _slstm_apply(p, cfg: ArchConfig, scfg: SSMConfig, x, state: Dict):
    """The sLSTM recurrence, one step per position, from `state`'s c, n, h
    and m (`sharding.loops.scan`): (block output, the final {"c", "n", "h",
    "m"}); `state` is not written (autograd may still need it)."""
    b, s, _ = x.shape
    inner, nh, dh = _xlstm_dims(cfg, scfg)
    xi = linear(p["up"], x)
    wx = linear(p["w_gates"], xi).reshape(b, s, nh, 4 * dh).to(torch.float32)
    rk = p["r_gates"].to(torch.float32)
    hs, (c, n, h, m) = scan("models/blocks.py:_slstm_apply", _slstm_step,
                            (state["c"], state["n"], state["h"], state["m"]),
                            (wx, rk), s)
    y = hs.reshape(b, s, inner).to(x.dtype)
    return linear(p["down"], y), {"c": c, "n": n, "h": h, "m": m}


def slstm_prefill(p, cfg: ArchConfig, scfg: SSMConfig, x, cache: Dict):
    """Full-sequence pass from the cache's state that leaves the final
    state in the cache."""
    y, final = _slstm_apply(p, cfg, scfg, x, cache)
    for key, val in final.items():
        cache[key].copy_(val)
    return y, cache


def slstm_train(p, cfg: ArchConfig, scfg: SSMConfig, x):
    state = init_slstm_cache(cfg, scfg, x.shape[0], device=x.device)
    return _slstm_apply(p, cfg, scfg, x, state)[0]


def slstm_decode(p, cfg: ArchConfig, scfg: SSMConfig, x, cache: Dict):
    return slstm_prefill(p, cfg, scfg, x, cache)
