"""Wrapper of the CUDA selective-scan kernel (`csrc/ssm_scan.cu`).

Replaces the TPU kernel `repro/kernels/ssm_scan/kernel.py::ssm_scan`
(`_ssm_kernel`). What bounds it on an H100: the S·I·N exponentials on the
special-function units, with the bytes of dt, x and y close behind (64 and
61 µs at Jamba's prefill, S = 2048, I = 8192, N = 16). The TPU kernel
carries the state across a sequential grid axis; here the sequence is split
across the threads of a block: a block holds 32 channels x 8 time segments,
walks S in chunks of 64 steps (each segment a run of 8), folds each run to
its cumulative (prod a, h) pairs in registers, scans a channel's 8 pairs by
warp shuffles with the previous chunk's carry first (the reference's
`_ssm_comb`), and sweeps the run again from its start state. Each
exponential is taken once (`ex2.approx` of dt·A·log2 e); tiles of dt, x, B
and C come through a two-stage cp.async ring and y leaves through a tile
of each stage, one barrier a chunk (the source note has the design and
what holds it above its bound). `ssm_plan` gives the launch's shape and
shared memory.

For CPU tensors the wrapper takes the plain version (`ref.ssm_scan_ref`);
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.denoiser.kernel import SMEM_LIMIT
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

#: state sizes the kernel is instantiated for (Jamba and Mamba use 16)
STATE_DIMS = (4, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel's block, fixed in csrc/ssm_scan.cu: channels, time segments
#: per chunk (a channel's lanes) and steps per segment
SSM_CHANNELS = 32
SSM_SEGMENTS = 8
SSM_RUN = 8
SSM_THREADS = SSM_CHANNELS * SSM_SEGMENTS
#: bytes after each segment's rows in a staged tile (bank spread)
_PAD = 16
#: an H100 SM: its shared memory and per-block reservation, threads and
#: 32-bit registers
SM_SMEM = 233472
SM_SMEM_RESERVED = 1024
SM_THREADS = 2048
SM_REGISTERS = 65536
#: `__launch_bounds__(256, 2)` caps a thread at 128 registers
MAX_REGISTERS = 128


class SSMPlan(NamedTuple):
    """How the scan kernel covers a call: a grid of (I / channels, B)
    blocks of `threads`; each walks `chunks` chunks of `chunk` steps, a
    chunk being `segments` runs of `run` steps; `smem_bytes` per block;
    `blocks_per_sm` resident at once."""
    chunk: int
    run: int
    segments: int
    channels: int
    threads: int
    chunks: int
    grid: tuple
    smem_bytes: int
    blocks_per_sm: int


def ssm_smem_bytes(N: int, elt: int) -> int:
    """Shared memory of one block, bytes, for state size N and element
    size `elt` (4 for fp32 inputs, 2 for bf16): `smem_bytes` in
    csrc/ssm_scan.cu. Per stage a dt, an x and a y tile (segments of `run`
    rows of 32 elements) and a B and a C tile (rows of N), each segment
    padded; two stages; A' and the carry as 32 rows of N + 4 floats."""
    x_seg = SSM_RUN * SSM_CHANNELS * elt + _PAD
    bc_seg = SSM_RUN * N * elt + _PAD
    stage = SSM_SEGMENTS * (3 * x_seg + 2 * bc_seg)
    return 2 * stage + 2 * SSM_CHANNELS * (N + 4) * 4


def ssm_plan(B: int, S: int, I: int, N: int, dtype) -> SSMPlan:
    """The launch of the scan over dt, x (B, S, I) with state size N in
    `dtype` (float32 or bfloat16). Raises ValueError for a state size or
    dtype the kernel is not built for, an empty shape, or shared memory
    past a block's limit."""
    if dtype not in _DTYPES:
        raise ValueError(f"ssm_scan kernel: float32 or bfloat16 inputs, not "
                         f"{dtype}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan kernel: state size {N} not in "
                         f"{STATE_DIMS}")
    if min(B, S, I) < 1:
        raise ValueError(f"ssm_scan kernel: empty input B={B} S={S} I={I}")
    smem = ssm_smem_bytes(N, 4 if dtype == torch.float32 else 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssm_scan kernel: {smem} bytes of shared memory "
                         f"per block, over {SMEM_LIMIT}")
    chunk = SSM_SEGMENTS * SSM_RUN
    resident = min(SM_SMEM // (smem + SM_SMEM_RESERVED),
                   SM_THREADS // SSM_THREADS,
                   SM_REGISTERS // (SSM_THREADS * MAX_REGISTERS))
    return SSMPlan(chunk=chunk, run=SSM_RUN, segments=SSM_SEGMENTS,
                   channels=SSM_CHANNELS, threads=SSM_THREADS,
                   chunks=-(-S // chunk), grid=(-(-I // SSM_CHANNELS), B),
                   smem_bytes=smem, blocks_per_sm=resident)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = KB.load("ssm_scan")
    lib.ssm_scan_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssm_scan_launch.restype = ctypes.c_int
    lib.ssm_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssm_scan_smem_bytes.restype = ctypes.c_int
    for N in STATE_DIMS:
        for dtype, code in _DTYPES.items():
            if lib.ssm_scan_smem_bytes(N, code) != \
                    ssm_smem_bytes(N, dtype.itemsize):
                raise RuntimeError("csrc/ssm_scan.cu and ssm_smem_bytes "
                                   "disagree on the shared-memory layout")
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
    ssm_plan(B, S, I, N, dt.dtype)
    for name, t, shape, dtype in (
            ("a", a, (I, N), torch.float32), ("bm", bm, (B, S, N), dt.dtype),
            ("cm", cm, (B, S, N), dt.dtype), ("x", x, (B, S, I), dt.dtype),
            ("h0", h0, (B, I, N), torch.float32)):
        if t.device != dt.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"ssm_scan kernel: {name} must be {dtype} of shape {shape} on "
                f"{dt.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
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
