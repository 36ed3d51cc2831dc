"""Wrapper of the CUDA selective-scan kernel (`csrc/ssm_scan.cu`).

Replaces the TPU kernel `repro/kernels/ssm_scan/kernel.py::ssm_scan`
(`_ssm_kernel`). What bounds it on an H100: the S·I·N exponentials on the
special-function units, with the bytes of dt, x and y close behind (64 and
61 µs at Jamba's prefill, S = 2048, I = 8192, N = 16). The TPU kernel
carries the state across a sequential grid axis; here each CUDA block walks
the whole sequence for 64 channels with the state in registers, a channel's
N states spread over N / 4 lanes, and tiles of dt, x, B and C staged in
shared memory (the source note has the design).

For CPU tensors the wrapper takes the plain version (`ref.ssm_scan_ref`);
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

#: state sizes the kernel is instantiated for (Jamba and Mamba use 16)
STATE_DIMS = (4, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = KB.load("ssm_scan")
    lib.ssm_scan_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


def ssm_scan(dt, a, bm, cm, x, h0):
    """dt, x: (B, S, I); a: (I, N) fp32; bm, cm: (B, S, N); h0: (B, I, N)
    fp32. Returns (y (B, S, I) in dt's dtype, hT (B, I, N) fp32). dt, x,
    bm and cm share a dtype and may have any batch and sequence strides
    with a unit last stride; a and h0 are contiguous."""
    if dt.device.type == "cpu":
        return ssm_scan_ref(dt, a, bm, cm, x, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {dt.device}")
    B, S, I = dt.shape
    N = a.shape[-1]
    if dt.dtype not in _DTYPES:
        raise ValueError(f"ssm_scan kernel: float32 or bfloat16 inputs, not "
                         f"{dt.dtype}")
    for name, t, shape, dtype in (
            ("a", a, (I, N), torch.float32), ("bm", bm, (B, S, N), dt.dtype),
            ("cm", cm, (B, S, N), dt.dtype), ("x", x, (B, S, I), dt.dtype),
            ("h0", h0, (B, I, N), torch.float32)):
        if t.device != dt.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"ssm_scan kernel: {name} must be {dtype} of shape {shape} on "
                f"{dt.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan kernel: state size {N} not in "
                         f"{STATE_DIMS}")
    if min(B, S, I) == 0:
        raise ValueError("ssm_scan kernel: empty input")
    for name, t in (("dt", dt), ("x", x), ("bm", bm), ("cm", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan kernel: {name} needs a unit stride "
                             f"along its last axis")
    for name, t in (("a", a), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan kernel: {name} must be contiguous")
    y = torch.empty((B, S, I), dtype=dt.dtype, device=dt.device)
    hT = torch.empty((B, I, N), dtype=torch.float32, device=dt.device)
    strides = [s for t in (dt, x, bm, cm) for s in t.stride()[:2]]
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    err = _lib().ssm_scan_launch(
        dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        x.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), *strides,
        B, S, I, N, _DTYPES[dt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    ssm_scan.launches += 1
    return y, hT


ssm_scan.launches = 0
