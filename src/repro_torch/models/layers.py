"""Core layers: norms, rotary embeddings, linear/embedding init+apply, FFNs
and the Mish activation (port of `repro/models/layers.py`).

Everything is functional: ``init_*`` builds a params subtree of tensors
drawn from a `torch.Generator` with the reference's shapes and stddevs
(a dense weight is stored (d_in, d_out)); the apply functions are plain
tensor code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import normal_init
from repro_torch.sharding.context import gather_last, logsumexp_last, \
    lookup_rows


# ----------------------------------------------------------------------
# norms
def init_rmsnorm(d: int, *, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(dt)


def init_layernorm(d: int, *, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


# ----------------------------------------------------------------------
# linear / embedding
def init_linear(generator, d_in: int, d_out: int, bias: bool = False,
                stddev: Optional[float] = None, *, lead=(), device=None):
    """`lead` prepends axes to every leaf (the LM's stacked periods)."""
    std = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal_init(generator, tuple(lead) + (d_in, d_out), stddev=std,
                          device=device)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=torch.float32,
                             device=device)
    return p


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_embedding(generator, vocab: int, d: int, *, device=None):
    return {"table": normal_init(generator, (vocab, d), stddev=0.02,
                                 device=device)}


def embed(p, tokens, dtype=torch.float32):
    return lookup_rows(p["table"].to(dtype), tokens)


def next_token_nll(logits, labels):
    """Mean cross entropy of fp32 `logits` (B, S, V) at `labels` (B, S),
    labels < 0 ignored (the reference's -100): (loss, number of labelled
    tokens as fp32)."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logz = logsumexp_last(logits)
    gold = gather_last(logits, safe)
    ntok = valid.sum()
    loss = ((logz - gold) * valid).sum() / torch.clamp(ntok, min=1)
    return loss, ntok.to(torch.float32)


# ----------------------------------------------------------------------
# rotary position embeddings
def rope_freqs(head_dim: int, theta: float, *, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)       # (hd/2,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# activations / FFN
def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) written as logaddexp(x, 0), as `jax.nn.softplus` is
    (`F.softplus` switches to x above a threshold of 20, which the
    reference does not)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x)) = -softplus(-x), as `jax.nn.log_sigmoid` is."""
    return -softplus(-x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x))."""
    return x * torch.tanh(softplus(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACT = {"silu": F.silu, "gelu": gelu, "geglu": gelu, "mish": mish,
        "relu": torch.relu, "tanh": torch.tanh}


def init_ffn(generator, d_model: int, d_ff: int, activation: str = "silu",
             bias: bool = False, *, lead=(), device=None):
    """Gated FFN (llama silu-gate / gemma geglu) or plain 2-layer (gelu).
    Draws up, down, then gate, in the reference's order."""
    gated = activation in ("silu", "geglu")
    kw = dict(bias=bias, lead=lead, device=device)
    p = {"up": init_linear(generator, d_model, d_ff, **kw),
         "down": init_linear(generator, d_ff, d_model, **kw)}
    if gated:
        p["gate"] = init_linear(generator, d_model, d_ff, **kw)
    return p


def ffn(p, x, activation: str = "silu"):
    act = _ACT[activation]
    if "gate" in p:
        h = act(linear(p["gate"], x)) * linear(p["up"], x)
    else:
        h = act(linear(p["up"], x))
    return linear(p["down"], h)
