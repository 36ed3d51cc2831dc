"""Entry point of the flash attention kernels, in the (B, S, H, hd) contract
of `models.attention.flash_attention` (the reference's
`flash_attention_jnp`): q (B, S, H, hd), k and v (B, T, KV, hd) ->
(B, S, H, hd).

`impl="auto"` dispatches by the tensors' device: a CUDA tensor launches the
hand-written kernels (they launch or raise; there is no fallback). When
autograd will need the gradient (grad mode on and an input that requires
it), that call is a `torch.autograd.Function`: its forward is the forward
kernel, which then also writes each row's log-sum-exp, and its backward the
backward kernel (`flash_attention_bwd`), the counterpart of the reference's
custom VJP; no (S, T) matrix is kept or made. Otherwise (every serving
prefill) the forward kernel runs alone, without the lse. The head-major
views the kernels read are transposes, not copies.

`impl="ref"` on any device, and every CPU tensor, take the plain attention,
the reference's blocked `flash_attention_jnp` with its blocked backward
(`models.attention.flash_attention`), with or without grad. The kernels'
oracles in `ref.py` stay what the tests and `chip_smoke.py` hold the
kernels to.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        flash_attention_bwd)
from repro_torch.models.attention import flash_attention as blocked_attention


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: (q, k, v, o, lse) saved, the
    gradients from `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        o, lse = flash_attention(qh, kh, vh, causal=causal, window=window,
                                 with_lse=True)
        ctx.save_for_backward(qh, kh, vh, o, lse)
        ctx.causal, ctx.window = causal, window
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, o, lse = ctx.saved_tensors
        # autograd may hand over an expanded or strided dO
        doh = do.contiguous().transpose(1, 2)
        dq, dk, dv = flash_attention_bwd(qh, kh, vh, o, lse, doh,
                                         causal=ctx.causal, window=ctx.window)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), \
            None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto"):
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be auto|ref, got {impl!r}")
    if impl == "ref" or q.device.type == "cpu":
        return blocked_attention(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, int(window))
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)
