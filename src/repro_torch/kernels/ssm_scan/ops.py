"""Entry point of the selective-scan kernel (port of
`repro/kernels/ssm_scan/ops.py`).

`impl="auto"` dispatches by the tensors' device: a CUDA tensor launches the
hand-written kernel (it launches or raises; there is no fallback), a CPU
tensor takes the plain version. `impl="ref"` takes the plain version on any
device. The reference pads S and I to its block sizes; the kernel takes the
true S and I and masks the ragged edge itself, so nothing is padded here.
A and the state are fp32 whatever the inputs' dtype, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan.kernel import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def selective_scan(dt, a, bm, cm, x, h0=None, *, impl: str = "auto"):
    """dt, x: (B, S, I); a: (I, N); bm, cm: (B, S, N); h0: (B, I, N) or
    None for zeros. Returns (y (B, S, I) in dt's dtype, hT (B, I, N) fp32)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be auto|ref, got {impl!r}")
    if h0 is None:
        B, _, I = dt.shape
        h0 = torch.zeros((B, I, a.shape[1]), dtype=torch.float32,
                         device=dt.device)
    fn = ssm_scan if impl == "auto" else ssm_scan_ref
    return fn(dt, a.float(), bm, cm, x, h0)
