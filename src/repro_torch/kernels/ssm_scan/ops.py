"""Entry point of the selective-scan kernels (port of
`repro/kernels/ssm_scan/ops.py`).

`impl="auto"` dispatches by the tensors' device: a CUDA tensor launches the
hand-written kernels (they launch or raise; there is no fallback), a CPU
tensor takes the plain versions. When autograd will need the gradient (grad
mode on and an input that requires it), the call is a
`torch.autograd.Function`: its forward is the forward kernel, which then
also writes the state at every 64-step chunk's start, and its backward the
backward kernel (`ssm_scan_bwd`), which rebuilds the states one chunk at a
time from those checkpoints, as the reference's `jax.checkpoint`-ed chunks
do; no (B, S, I, N) tensor is kept or made. Otherwise (every serving
prefill) the forward kernel runs alone. `impl="ref"` takes the plain version
on any device and differentiates it with plain autograd. The reference pads
S and I to its block sizes; the kernels take the true S and I and mask the
ragged edge themselves, so nothing is padded here. A and the state are
fp32 whatever the inputs' dtype, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan.kernel import ssm_scan, ssm_scan_bwd
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


class SelectiveScan(torch.autograd.Function):
    """The scan with its chunk-checkpointed backward: (dt, A, B, C, x) and
    the chunk states saved, the gradients from `ssm_scan_bwd`."""

    @staticmethod
    def forward(ctx, dt, a, bm, cm, x, h0):
        y, hT, hc = ssm_scan(dt, a, bm, cm, x, h0, with_chunks=True)
        ctx.save_for_backward(dt, a, bm, cm, x, hc)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, a, bm, cm, x, hc = ctx.saved_tensors
        return ssm_scan_bwd(dt, a, bm, cm, x, hc, dy.contiguous(),
                            dhT.contiguous())


def selective_scan(dt, a, bm, cm, x, h0=None, *, impl: str = "auto"):
    """dt, x: (B, S, I); a: (I, N); bm, cm: (B, S, N); h0: (B, I, N) or
    None for zeros. Returns (y (B, S, I) in dt's dtype, hT (B, I, N) fp32)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be auto|ref, got {impl!r}")
    if h0 is None:
        B, _, I = dt.shape
        h0 = torch.zeros((B, I, a.shape[1]), dtype=torch.float32,
                         device=dt.device)
    a = a.float()
    if impl == "ref":
        return ssm_scan_ref(dt, a, bm, cm, x, h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, a, bm, cm, x, h0)):
        return SelectiveScan.apply(dt, a, bm, cm, x, h0)
    return ssm_scan(dt, a, bm, cm, x, h0)
