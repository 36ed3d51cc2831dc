"""Plain PyTorch oracle of the selective-scan kernel: the reference's
sequential recurrence (port of `repro/kernels/ssm_scan/ref.py`), a Python
loop over S on the fp32 state. It is the path the kernel's wrapper takes for
CPU tensors and what `chip_smoke.py` holds the kernel to on the card."""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, a, bm, cm, x, h0):
    """dt, x: (B, S, I); a: (I, N); bm, cm: (B, S, N); h0: (B, I, N).
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = C_t . h_t; returns
    (y (B, S, I) in dt's dtype, hT (B, I, N) fp32). As in the reference,
    dt_t * x_t is formed in the inputs' dtype."""
    f32 = torch.float32
    a32 = a.to(f32)
    h = h0.to(f32)
    ys = []
    for t in range(dt.shape[1]):
        da = torch.exp(dt[:, t, :, None].to(f32) * a32)
        h = da * h + (dt[:, t] * x[:, t])[..., None].to(f32) \
            * bm[:, t, None, :].to(f32)
        ys.append(torch.einsum("bin,bn->bi", h, cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(dt.dtype), h
