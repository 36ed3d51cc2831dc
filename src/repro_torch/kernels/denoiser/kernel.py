"""Wrappers of the CUDA denoiser kernels: the whole reverse chain
(`csrc/denoiser_chain.cu`) and one eps-MLP forward (`csrc/denoiser_step.cu`),
both built on the cluster pieces of `csrc/mlp_common.cuh`.

`denoiser_chain` replaces the TPU kernel
`repro/kernels/denoiser/kernel.py::denoiser_chain` (`_chain_kernel`). What
bounds it on an H100: operations, ~160 kFLOP per batch row and step at the
paper's widths, against ~317 KB of weights. The kernel runs on a thread-block
cluster of 8 CTAs that split the hidden width (256, fixed at compile time):
each keeps its slices of W1, W2 and W3 resident in shared memory for all K
steps (loaded with cp.async), runs fc1 and fc2 on the tensor cores in
3xTF32 (fp32 accuracy; `torch.backends.cuda.matmul.allow_tf32` plays no
part) and exchanges fc2's and fc3's partial sums with bulk copies into the
other CTAs' shared memory, counted on mbarriers. `chain_plan` gives the
cluster size C, the row tile R and the shared memory from the shapes, or
raises naming what does not fit; it is pure Python, so the CPU tests reach
it. There is no cuBLAS or torch.matmul inside the chain. A call checks its
13 tensors against shapes computed once per call shape
(`_chain_launch_plan`).

`denoiser_step` replaces `repro/kernels/denoiser/kernel.py::denoiser_step`
(`_denoiser_kernel`), the distilled sampler's one call per decision. It is
one step of the chain's design: the same cluster, resident weight slices,
3xTF32 `mma.sync` and bulk-copy exchanges, with fc1 over the whole input
and tanh(eps) stored where the chain would update x. It reads x, the
timestep embedding (one row per batch row, or one row for all) and f_s
where they lie, so a call launches the kernel and nothing else. At the
main path's shape (B = 256) its 40 MFLOP take 0.245 µs as 3×TF32, far under
a launch: latency bounds it. `step_plan` is its `chain_plan`, with the same
refusals (H = 256 and C = 8 only).

For CPU tensors each wrapper takes its plain version (`ref.py`); for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.denoiser.ref import denoiser_chain_ref, denoiser_ref

#: shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 232448


#: the chain and step kernels' row tile (one m16 tile of mma.sync), threads
#: per CTA, cluster size and hidden width, all fixed in csrc/mlp_common.cuh
CHAIN_ROWS = 16
CHAIN_THREADS = 256
CHAIN_C = 8
CHAIN_H = 256


class ChainPlan(NamedTuple):
    """How the chain (or step) kernel covers a call: clusters of `C` CTAs, each CTA
    owning H / C hidden columns; a cluster walks row tiles of `R` rows;
    `tiles` = ceil(B / R); `smem_bytes` per CTA."""
    C: int
    R: int
    tiles: int
    smem_bytes: int


def chain_smem_bytes(A: int, F: int, t_dim: int) -> int:
    """Shared memory of one CTA of the chain kernel, bytes: `make_layout`
    in csrc/denoiser_chain.cu, region for region."""
    def r4(n):
        return (n + 3) // 4 * 4

    def pad16_4(n):                 # the least m >= n with m = 4 mod 16
        return (n + 11) // 16 * 16 + 4
    R, C, H = CHAIN_ROWS, CHAIN_C, CHAIN_H
    ncol = H // C
    blk = R * (ncol + 4)          # R x ncol, padded
    floats = (r4(max(16, A + t_dim + F) * (ncol + 8)) + r4(ncol * (H + 8))
              + r4(ncol * A) + 4 * r4(ncol) + r4(A) + 2 * R * pad16_4(16)
              + 2 * R * pad16_4(ncol) + (2 * C + 2) * blk
              + 2 * r4(R * A + t_dim + 3) + r4(C * R * A) + 16 * ncol + 4)
    return 4 * floats


def chain_plan(B: int, A: int, F: int, t_dim: int, H: int) -> ChainPlan:
    """The (C, R) plan of the chain kernel for x (B, A), f_s (B, F), tembs
    (K, t_dim) and hidden width H.

    A cluster of C = 8 CTAs owns R = 16 rows; CTA r owns hidden columns
    [32 r, 32 (r+1)), and its slices of W1, W2 and W3 must fit in
    SMEM_LIMIT bytes. The kernel is compiled for the paper's H = 256 only.
    One thread per (row, action dim) and per (row, embedding dim) of a tile
    bounds A and t_dim by 256 / R = 16. A B = 1 decision runs on 8 SMs and
    B = 256 (16 tiles) on 128. Raises ValueError naming the constraint
    where no plan fits."""
    if min(B, A, F, t_dim, H) < 1:
        raise ValueError(f"denoiser_chain kernel: B, A, F, t_dim and H must "
                         f"be >= 1; got B={B} A={A} F={F} t_dim={t_dim} "
                         f"H={H}")
    if H != CHAIN_H:
        raise ValueError(f"denoiser_chain kernel: H={H}; the kernel is "
                         f"compiled for H={CHAIN_H} only")
    if max(A, t_dim) * CHAIN_ROWS > CHAIN_THREADS:
        raise ValueError(f"denoiser_chain kernel: A={A} and t_dim={t_dim} "
                         f"must each be <= {CHAIN_THREADS // CHAIN_ROWS}")
    smem = chain_smem_bytes(A, F, t_dim)
    if smem > SMEM_LIMIT:
        raise ValueError(f"denoiser_chain kernel: {smem} bytes of shared "
                         f"memory per CTA at A={A} F={F} t_dim={t_dim}, "
                         f"over {SMEM_LIMIT}")
    return ChainPlan(C=CHAIN_C, R=CHAIN_ROWS, tiles=-(-B // CHAIN_ROWS),
                     smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _chain_lib():
    lib = KB.load("denoiser_chain")
    lib.denoiser_chain_launch.argtypes = ([ctypes.c_void_p] * 14
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
    lib.denoiser_chain_launch.restype = ctypes.c_int
    lib.denoiser_chain_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.denoiser_chain_smem_bytes.restype = ctypes.c_int
    lib.denoiser_chain_max_clusters.argtypes = ([ctypes.c_int] * 3
                                                + [ctypes.c_void_p])
    lib.denoiser_chain_max_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _chain_launch_plan(device_index: int, B: int, A: int, F: int, TD: int,
                       H: int, K: int):
    """(plan, clusters in the grid, expected shapes in argument order) for
    one call shape on one card, computed once."""
    plan = chain_plan(B, A, F, TD, H)
    lib = _chain_lib()
    smem = lib.denoiser_chain_smem_bytes(A, F, TD)
    if smem != plan.smem_bytes:
        raise RuntimeError("csrc/denoiser_chain.cu and chain_plan disagree on "
                           f"the shared memory: {smem} != {plan.smem_bytes}")
    resident = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.denoiser_chain_max_clusters(A, F, TD,
                                              ctypes.byref(resident))
    if err != 0:
        raise RuntimeError(f"denoiser_chain occupancy query failed: CUDA "
                           f"error {err}")
    if resident.value < 1:
        raise ValueError(f"denoiser_chain kernel: a cluster of {plan.C} CTAs "
                         f"with {smem} bytes each cannot be resident")
    D = A + TD + F
    shapes = tuple(torch.Size(s) for s in (
        (B, A), (K, B, A), (B, F), (K, TD), (K,), (K,), (K,), (D, H), (H,),
        (H, H), (H,), (H, A), (A,)))
    return plan, min(plan.tiles, resident.value), shapes


_CHAIN_ARGS = ("x", "noises", "f_s", "tembs", "coef_x", "coef_e", "coef_n",
               "w1", "b1", "w2", "b2", "w3", "b3")


def denoiser_chain(x, noises, f_s, tembs, coef_x, coef_e, coef_n,
                   w1, b1, w2, b2, w3, b3):
    """tanh(x_0) (B, A) after K affine steps; x (B, A), noises (K, B, A),
    f_s (B, F), tembs (K, t_dim), coef_* (K,), w1 (A+t_dim+F, H), w2 (H, H),
    w3 (H, A), biases (H,), (H,), (A,)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return denoiser_chain_ref(x, noises, f_s, tembs, coef_x, coef_e,
                                      coef_n, w1, b1, w2, b2, w3, b3)
        raise ValueError(f"denoiser_chain runs on cpu or cuda, not {x.device}")
    refuse_grad("denoiser_chain", x, noises, f_s, tembs, coef_x, coef_e,
                coef_n, w1, b1, w2, b2, w3, b3)
    dev = x.get_device()
    B, A = x.shape
    K, TD = tembs.shape
    plan, clusters, shapes = _chain_launch_plan(
        dev, B, A, f_s.shape[-1], TD, w1.shape[-1], K)
    args = (x, noises, f_s, tembs, coef_x, coef_e, coef_n, w1, b1, w2, b2,
            w3, b3)
    f32 = torch.float32
    for i, (t, shape) in enumerate(zip(args, shapes)):
        if t.dtype is not f32 or t.get_device() != dev or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"denoiser_chain kernel: {_CHAIN_ARGS[i]} must be a "
                f"contiguous float32 tensor of shape {tuple(shape)} on "
                f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    ptrs = [t.data_ptr() for t in args]
    for i in range(7, 12):              # w1, b1, w2, b2, w3: cp.async 16 B
        if ptrs[i] % 16:
            raise ValueError(f"denoiser_chain kernel: {_CHAIN_ARGS[i]} must "
                             f"start on 16 bytes")
    out = torch.empty((B, A), dtype=f32, device=x.device)
    err = _chain_lib().denoiser_chain_launch(
        *ptrs, out.data_ptr(), B, A, shapes[2][1], TD, K, clusters,
        KB.raw_stream(dev))
    if err != 0:
        raise RuntimeError(
            f"denoiser_chain kernel launch failed: CUDA error {err}")
    denoiser_chain.launches += 1
    return out


denoiser_chain.launches = 0


def step_smem_bytes(A: int, F: int, t_dim: int) -> int:
    """Shared memory of one CTA of the step kernel, bytes: `make_layout`
    in csrc/denoiser_step.cu, region for region."""
    def r4(n):
        return (n + 3) // 4 * 4

    def pad16_4(n):                 # the least m >= n with m = 4 mod 16
        return (n + 11) // 16 * 16 + 4
    R, C, H = CHAIN_ROWS, CHAIN_C, CHAIN_H
    ncol = H // C
    blk = R * (ncol + 4)
    xk = -(-(A + t_dim + F) // 16) * 16
    floats = (r4(xk * (ncol + 8)) + r4(ncol * (H + 8)) + r4(ncol * A)
              + 2 * r4(ncol) + r4(A) + 2 * R * pad16_4(xk)
              + 2 * R * pad16_4(ncol) + (2 * C + 1) * blk + r4(C * R * A)
              + 16 * ncol + 4)
    return 4 * floats


def step_plan(B: int, A: int, F: int, t_dim: int, H: int) -> ChainPlan:
    """The (C, R) plan of the step kernel for x (B, A), an embedding of
    t_dim, f_s (B, F) and hidden width H: the chain kernel's cluster (C = 8
    CTAs of 32 hidden columns, R = 16 rows a tile), compiled for H = 256
    only; one thread per (row, action dim) of a tile bounds A by 16. Raises
    ValueError naming the constraint where no plan fits."""
    if min(B, A, F, t_dim, H) < 1:
        raise ValueError(f"denoiser_step kernel: B, A, F, t_dim and H must "
                         f"be >= 1; got B={B} A={A} F={F} t_dim={t_dim} "
                         f"H={H}")
    if H != CHAIN_H:
        raise ValueError(f"denoiser_step kernel: H={H}; the kernel is "
                         f"compiled for H={CHAIN_H} only")
    if A * CHAIN_ROWS > CHAIN_THREADS:
        raise ValueError(f"denoiser_step kernel: A={A} must be <= "
                         f"{CHAIN_THREADS // CHAIN_ROWS}")
    smem = step_smem_bytes(A, F, t_dim)
    if smem > SMEM_LIMIT:
        raise ValueError(f"denoiser_step kernel: {smem} bytes of shared "
                         f"memory per CTA at A={A} F={F} t_dim={t_dim}, "
                         f"over {SMEM_LIMIT}")
    return ChainPlan(C=CHAIN_C, R=CHAIN_ROWS, tiles=-(-B // CHAIN_ROWS),
                     smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _step_lib():
    lib = KB.load("denoiser_step")
    lib.denoiser_step_launch.argtypes = ([ctypes.c_void_p] * 10
                                         + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
    lib.denoiser_step_launch.restype = ctypes.c_int
    lib.denoiser_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.denoiser_step_smem_bytes.restype = ctypes.c_int
    lib.denoiser_step_max_clusters.argtypes = ([ctypes.c_int] * 3
                                               + [ctypes.c_void_p])
    lib.denoiser_step_max_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _step_launch_plan(device_index: int, B: int, A: int, F: int, TD: int,
                      H: int, per_row: bool):
    """(plan, clusters in the grid, expected shapes in argument order) for
    one call shape on one card, computed once."""
    plan = step_plan(B, A, F, TD, H)
    lib = _step_lib()
    smem = lib.denoiser_step_smem_bytes(A, F, TD)
    if smem != plan.smem_bytes:
        raise RuntimeError("csrc/denoiser_step.cu and step_plan disagree on "
                           f"the shared memory: {smem} != {plan.smem_bytes}")
    resident = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.denoiser_step_max_clusters(A, F, TD, ctypes.byref(resident))
    if err != 0:
        raise RuntimeError(f"denoiser_step occupancy query failed: CUDA "
                           f"error {err}")
    if resident.value < 1:
        raise ValueError(f"denoiser_step kernel: a cluster of {plan.C} CTAs "
                         f"with {smem} bytes each cannot be resident")
    D = A + TD + F
    shapes = tuple(torch.Size(s) for s in (
        (B, A), (B, TD) if per_row else (TD,), (B, F), (D, H), (H,), (H, H),
        (H,), (H, A), (A,)))
    return plan, min(plan.tiles, resident.value), shapes


_STEP_ARGS = ("x", "temb", "f_s", "w1", "b1", "w2", "b2", "w3", "b3")


def denoiser_step(x, temb, f_s, w1, b1, w2, b2, w3, b3):
    """tanh(mish(mish([x, temb, f_s] w1 + b1) w2 + b2) w3 + b3), (B, A);
    x (B, A), temb (B, t_dim) one row per batch row or (t_dim,) one row for
    all, f_s (B, F), w1 (A+t_dim+F, H), w2 (H, H), w3 (H, A), biases (H,),
    (H,), (A,)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            inp = torch.cat([x, temb.expand(x.shape[0], temb.shape[-1]), f_s],
                            dim=-1)
            return denoiser_ref(inp, w1, b1, w2, b2, w3, b3)
        raise ValueError(f"denoiser_step runs on cpu or cuda, not {x.device}")
    refuse_grad("denoiser_step", x, temb, f_s, w1, b1, w2, b2, w3, b3)
    dev = x.get_device()
    B, A = x.shape
    TD = temb.shape[-1]
    per_row = temb.dim() == 2
    plan, clusters, shapes = _step_launch_plan(
        dev, B, A, f_s.shape[-1], TD, w1.shape[-1], per_row)
    args = (x, temb, f_s, w1, b1, w2, b2, w3, b3)
    f32 = torch.float32
    for i, (t, shape) in enumerate(zip(args, shapes)):
        if t.dtype is not f32 or t.get_device() != dev or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"denoiser_step kernel: {_STEP_ARGS[i]} must be a "
                f"contiguous float32 tensor of shape {tuple(shape)} on "
                f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    ptrs = [t.data_ptr() for t in args]
    for i in range(3, 8):               # w1, b1, w2, b2, w3: cp.async 16 B
        if ptrs[i] % 16:
            raise ValueError(f"denoiser_step kernel: {_STEP_ARGS[i]} must "
                             f"start on 16 bytes")
    out = torch.empty((B, A), dtype=f32, device=x.device)
    err = _step_lib().denoiser_step_launch(
        *ptrs, out.data_ptr(), TD if per_row else 0, B, A, shapes[2][1], TD,
        clusters, KB.raw_stream(dev))
    if err != 0:
        raise RuntimeError(
            f"denoiser_step kernel launch failed: CUDA error {err}")
    denoiser_step.launches += 1
    return out


denoiser_step.launches = 0
