"""Plain PyTorch oracles of the selective-scan kernels: the reference's
sequential recurrence (port of `repro/kernels/ssm_scan/ref.py`), a Python
loop over S on the fp32 state, and its gradient from the chunk states. They
are the path the wrappers take for CPU tensors and what `chip_smoke.py`
holds the kernels to on the card."""
from __future__ import annotations

import torch

from repro_torch.sharding.loops import scan

#: steps per checkpointed chunk: the reference's `_mamba_scan_chunked` and
#: the kernels' chunk
CHUNK = 64


def _scan_step(carry, xs, t: int):
    """Step t of the recurrence on the fp32 state: ((h,), y_t fp32)."""
    (h,) = carry
    dt, bm, cm, x, a32 = xs
    f32 = torch.float32
    da = torch.exp(dt[:, t, :, None].to(f32) * a32)
    h = da * h + (dt[:, t] * x[:, t])[..., None].to(f32) \
        * bm[:, t, None, :].to(f32)
    return (h,), torch.einsum("bin,bn->bi", h, cm[:, t].to(f32))


def ssm_scan_ref(dt, a, bm, cm, x, h0, *, chunk_states: bool = False):
    """dt, x: (B, S, I); a: (I, N); bm, cm: (B, S, N); h0: (B, I, N).
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = C_t . h_t; returns
    (y (B, S, I) in dt's dtype, hT (B, I, N) fp32), and with `chunk_states`
    also the fp32 state at the start of every 64-step chunk, (B,
    ceil(S / 64), I, N). As in the reference, dt_t * x_t is formed in the
    inputs' dtype. Without chunk states the loop is `sharding.loops.scan`'s,
    which the dry-run scales."""
    f32 = torch.float32
    xs = (dt, bm, cm, x, a.to(f32))
    h = h0.to(f32)
    if not chunk_states:
        y, (h,) = scan("kernels/ssm_scan/ref.py:ssm_scan_ref", _scan_step,
                       (h,), xs, dt.shape[1])
        return y.to(dt.dtype), h
    ys, starts = [], []
    for t in range(dt.shape[1]):
        if t % CHUNK == 0:
            starts.append(h)
        (h,), y = _scan_step((h,), xs, t)
        ys.append(y)
    return torch.stack(ys, dim=1).to(dt.dtype), h, torch.stack(starts, dim=1)


def ssm_scan_bwd_ref(dt, a, bm, cm, x, hc, dy, dhT):
    """The scan's gradient from its chunk states `hc` (B, ceil(S / 64), I,
    N): (ddt, da, dbm, dcm, dx, dh0), ddt, dbm, dcm and dx in the inputs'
    dtypes, da (I, N) and dh0 (B, I, N) fp32. Chunk by chunk, last first:
    the chunk's states are rebuilt from its checkpoint (at most 64 (B, I,
    N) states at a time), then the reverse recurrence G_t = dy_t C_t +
    a_{t+1} G_{t+1} from G = dhT runs through it. dt * x is the inputs'
    dtype product, as in the forward, and its gradient flows to dt and x in
    fp32."""
    f32 = torch.float32
    B, S, I = dt.shape
    a32 = a.to(f32)
    u = (dt * x).to(f32)
    dtf, xf, bf, cf, dyf = (t.to(f32) for t in (dt, x, bm, cm, dy))
    ddt = torch.empty((B, S, I), dtype=f32, device=dt.device)
    dx = torch.empty_like(ddt)
    dbm = torch.empty((B, S, bm.shape[-1]), dtype=f32, device=dt.device)
    dcm = torch.empty_like(dbm)
    da = torch.zeros_like(a32)
    g = dhT.to(f32)
    for k in reversed(range(hc.shape[1])):
        s0, s1 = k * CHUNK, min(S, (k + 1) * CHUNK)
        h, hs = hc[:, k].to(f32), []
        for t in range(s0, s1):
            h = torch.exp(dtf[:, t, :, None] * a32) * h \
                + u[:, t, :, None] * bf[:, t, None, :]
            hs.append(h)
        states = torch.stack(hs, dim=1)             # (B, <= 64, I, N)
        for j in reversed(range(s1 - s0)):
            t = s0 + j
            e = torch.exp(dtf[:, t, :, None] * a32)
            g = g + dyf[:, t, :, None] * cf[:, t, None, :]
            gda = g * (states[:, j - 1] if j else hc[:, k].to(f32)) * e
            da += (gda * dtf[:, t, :, None]).sum(0)
            du = (g * bf[:, t, None, :]).sum(-1)
            ddt[:, t] = du * xf[:, t] + (gda * a32).sum(-1)
            dx[:, t] = du * dtf[:, t]
            dcm[:, t] = torch.einsum("bi,bin->bn", dyf[:, t], states[:, j])
            dbm[:, t] = torch.einsum("bin,bi->bn", g, u[:, t])
            g = g * e
    return (ddt.to(dt.dtype), da, dbm.to(bm.dtype), dcm.to(cm.dtype),
            dx.to(x.dtype), g)
