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

`ssm_scan(..., with_chunks=True)` also returns the fp32 state at the start
of every 64-step chunk, the checkpoints `ssm_scan_bwd` (`csrc/
ssm_scan_bwd.cu`, the gradient of the scan) rebuilds the states from, one
chunk at a time, as the reference's `jax.checkpoint`-ed chunks do. The
backward has the forward's block (32 channels x 8 segments of 8 steps):
per chunk it rebuilds the states with the forward's fold, scan and sweep,
then runs the reverse recurrence for G the same way from the right with the
same a_t (one exponential per state and step); dB and dC leave as one
partial per block of 32 channels, summed over the blocks by a second launch
in a fixed order. `ssm_bwd_plan` gives its launch and shared memory.

For CPU tensors the wrappers take the plain versions (`ref.ssm_scan_ref`,
`ref.ssm_scan_bwd_ref`); for CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.denoiser.kernel import SMEM_LIMIT
from repro_torch.kernels.ssm_scan.ref import (CHUNK, ssm_scan_bwd_ref,
                                              ssm_scan_ref)

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
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
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


def _check(dt, a, bm, cm, x, **fp32):
    """The kernels' shared checks: shapes, dtypes, devices and strides of
    the inputs, and of the fp32 tensors `fp32` ((B, I, N) unless named
    hc)."""
    B, S, I = dt.shape
    N = a.shape[-1]
    ssm_plan(B, S, I, N, dt.dtype)
    want = {"hc": (B, -(-S // CHUNK), I, N)}
    for name, t, shape, dtype in (
            ("a", a, (I, N), torch.float32), ("bm", bm, (B, S, N), dt.dtype),
            ("cm", cm, (B, S, N), dt.dtype), ("x", x, (B, S, I), dt.dtype),
            *((k, t, want.get(k, (B, I, N)), torch.float32)
              for k, t in fp32.items())):
        if t.device != dt.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"ssm_scan kernel: {name} must be {dtype} of shape {shape} on "
                f"{dt.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("dt", dt), ("x", x), ("bm", bm), ("cm", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan kernel: {name} needs a unit stride "
                             f"along its last axis")
    for name, t in (("a", a), *fp32.items()):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan kernel: {name} must be contiguous")
    return B, S, I, N


def ssm_scan(dt, a, bm, cm, x, h0, *, with_chunks: bool = False):
    """dt, x: (B, S, I); a: (I, N) fp32; bm, cm: (B, S, N); h0: (B, I, N)
    fp32. Returns (y (B, S, I) in dt's dtype, hT (B, I, N) fp32), and with
    `with_chunks` also the state at each 64-step chunk's start, (B,
    ceil(S / 64), I, N) fp32. dt, x, bm and cm share a dtype and may have
    any batch and sequence strides with a unit last stride; a and h0 are
    contiguous."""
    if dt.device.type == "cpu":
        return ssm_scan_ref(dt, a, bm, cm, x, h0, chunk_states=with_chunks)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {dt.device}")
    B, S, I, N = _check(dt, a, bm, cm, x, h0=h0)
    y = torch.empty((B, S, I), dtype=dt.dtype, device=dt.device)
    hT = torch.empty((B, I, N), dtype=torch.float32, device=dt.device)
    hc = (torch.empty((B, -(-S // CHUNK), I, N), dtype=torch.float32,
                      device=dt.device) if with_chunks else None)
    strides = [s for t in (dt, x, bm, cm) for s in t.stride()[:2]]
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    err = _lib().ssm_scan_launch(
        dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        x.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), *strides,
        B, S, I, N, _DTYPES[dt.dtype], stream,
        None if hc is None else hc.data_ptr())
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    ssm_scan.launches += 1
    return (y, hT, hc) if with_chunks else (y, hT)


ssm_scan.launches = 0

class SSMBwdPlan(NamedTuple):
    """How the backward covers a call: a grid of (I / channels, B) blocks
    of `threads`, one resident per SM, `smem_bytes` each; `partials` is the
    shape of the fp32 dB and dC partials the blocks write, (blocks, B, N,
    S), which the second launch sums over the blocks."""
    grid: tuple
    threads: int
    smem_bytes: int
    partials: tuple


def bwd_smem_bytes(N: int, elt: int) -> int:
    """Shared memory of one block of the backward kernel, bytes, for state
    size N and element size `elt`: `bwd_smem_bytes` in
    csrc/ssm_scan_bwd.cu. Per stage a dt, an x and a dy tile and a B and a
    C tile (segments as the forward's) and the chunk's checkpoints (32 rows
    of N + 4 floats); two stages; the ddt and dx tiles; A', A and the G
    carry (32 rows of N + 4 floats each); dA's per-thread partials (N x 256
    floats); the cross-warp dB and dC sums (8 warps x 2 x N x 64 floats)."""
    if N not in STATE_DIMS:
        raise ValueError(f"ssm_scan_bwd kernel: state size {N} not in "
                         f"{STATE_DIMS}")
    x_seg = SSM_RUN * SSM_CHANNELS * elt + _PAD
    bc_seg = SSM_RUN * N * elt + _PAD
    rows = SSM_CHANNELS * (N + 4) * 4
    stage = SSM_SEGMENTS * (3 * x_seg + 2 * bc_seg) + rows
    return (2 * stage + 2 * SSM_SEGMENTS * x_seg + 3 * rows
            + N * SSM_THREADS * 4 + SSM_THREADS // 32 * 2 * N * CHUNK * 4)


def ssm_bwd_plan(B: int, S: int, I: int, N: int, dtype) -> SSMBwdPlan:
    """The backward's launch over dt, x (B, S, I) with state size N in
    `dtype`; raises ValueError where `ssm_plan` does or where the shared
    memory does not fit."""
    ssm_plan(B, S, I, N, dtype)
    smem = bwd_smem_bytes(N, 4 if dtype == torch.float32 else 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssm_scan_bwd kernel: {smem} bytes of shared "
                         f"memory per block, over {SMEM_LIMIT}")
    blocks = -(-I // SSM_CHANNELS)
    return SSMBwdPlan(grid=(blocks, B), threads=SSM_THREADS, smem_bytes=smem,
                      partials=(blocks, B, N, S))


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = KB.load("ssm_scan_bwd")
    lib.ssm_scan_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int
    lib.ssm_scan_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssm_scan_bwd_smem_bytes.restype = ctypes.c_int
    for N in STATE_DIMS:
        for dtype, code in _DTYPES.items():
            if lib.ssm_scan_bwd_smem_bytes(N, code) != \
                    bwd_smem_bytes(N, dtype.itemsize):
                raise RuntimeError("csrc/ssm_scan_bwd.cu and bwd_smem_bytes "
                                   "disagree on the shared-memory layout")
    return lib


def ssm_scan_bwd(dt, a, bm, cm, x, hc, dy, dhT):
    """The scan's gradient from the forward's chunk states `hc` (B,
    ceil(S / 64), I, N), the output's gradient `dy` (B, S, I) and the final
    state's `dhT` (B, I, N): returns (ddt, da, dbm, dcm, dx, dh0), ddt, dbm,
    dcm and dx contiguous in dt's dtype, da (I, N) and dh0 (B, I, N) fp32.
    dt, x, bm and cm as `ssm_scan` takes them; dy is made contiguous. On the
    card the kernel writes dB and dC as one partial per block of 32
    channels and dA as one per batch row, and its second launch sums them
    in a fixed order (deterministic)."""
    if dt.device.type == "cpu":
        return ssm_scan_bwd_ref(dt, a, bm, cm, x, hc, dy, dhT)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd runs on cpu or cuda, not {dt.device}")
    dy = dy.contiguous()
    B, S, I, N = _check(dt, a, bm, cm, x, hc=hc, dhT=dhT)
    if dy.dtype != dt.dtype or tuple(dy.shape) != (B, S, I):
        raise ValueError(f"ssm_scan_bwd kernel: dy must be {dt.dtype} of "
                         f"shape {(B, S, I)}; got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    plan = ssm_bwd_plan(B, S, I, N, dt.dtype)
    dev, f32 = dt.device, torch.float32
    ddt = torch.empty((B, S, I), dtype=dt.dtype, device=dev)
    dx = torch.empty_like(ddt)
    dbm = torch.empty((B, S, N), dtype=dt.dtype, device=dev)
    dcm = torch.empty_like(dbm)
    da = torch.empty((I, N), dtype=f32, device=dev)
    dh0 = torch.empty((B, I, N), dtype=f32, device=dev)
    pdb = torch.empty(plan.partials, dtype=f32, device=dev)
    pdc = torch.empty_like(pdb)
    pda = torch.empty((B, I, N), dtype=f32, device=dev)
    strides = [s for t in (dt, x, bm, cm) for s in t.stride()[:2]]
    err = _bwd_lib().ssm_scan_bwd_launch(
        dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        x.data_ptr(), hc.data_ptr(), dy.data_ptr(), dhT.data_ptr(),
        ddt.data_ptr(), dx.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
        da.data_ptr(), dh0.data_ptr(), pdb.data_ptr(), pdc.data_ptr(),
        pda.data_ptr(), *strides, B, S, I, N, _DTYPES[dt.dtype],
        KB.raw_stream(dt.get_device()))
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    ssm_scan_bwd.launches += 1
    return ddt, da, dbm, dcm, dx, dh0


ssm_scan_bwd.launches = 0
