"""Wrapper of the CUDA flash attention kernel (`csrc/flash_attention.cu`).

Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
flash_attention` (`_attn_kernel`). What bounds it on an H100: operations,
4·B·H·S·T·hd FLOPs times the unmasked fraction against a few MB of q, k, v
and o; at tinyllama's 2048-token prefill 0.104 ms in fp32 (3×TF32 on the
tensor cores, 494.7 TFLOP/s) and 0.0174 ms in bf16 (989 TFLOP/s).

The kernel runs on the tensor cores: a producer warp brings the K and V
tiles by TMA into a two-stage ring counted on mbarriers, and one or two
consumer warpgroups of 64 query rows run S = Q K^T and O += P V as `wgmma`
with Q and P the A operands from registers. fp32 inputs take 3×TF32 (each
operand split into a TF32 hi and lo part, three products), which keeps
fp32 accuracy; V and K's lo part are written split (V transposed, since
TF32 `wgmma` reads B K-major only) into shared memory before the products.
bf16 inputs take native bf16 `wgmma` with fp32 accumulation. `flash_plan`
gives each (head dim, dtype)'s tiles and shared memory from the same
arithmetic as the source, in pure Python, so the CPU tests reach it.

The tensor maps read the tensors through their strides, so the model's
(B, S, H, hd) activations are passed as head-major views without a copy;
TMA needs 16-byte-aligned base addresses and strides, which the wrapper
checks (it raises, it does not copy). Keys at or past T are masked by the
kernel: the caller pads nothing.

`flash_attention(..., with_lse=True)` also returns each row's
log-sum-exp, which `flash_attention_bwd` (`csrc/flash_attention_bwd.cu`,
the counterpart of the reference's `flash_bwd`) recomputes P from. The
backward runs on the tensor cores too, in two launches on one body: a dQ
kernel (rows are queries, K and V tiles streamed by TMA; it also writes D)
and a dK / dV kernel (rows are keys, Q and dO tiles streamed, one CTA per
query head); fp32 is 3×TF32 and bf16 native, as the forward. With GQA the
dK / dV CTAs write per-head fp32 partials that the last CTA of each key
block sums in head order (no float atomics: deterministic).
`flash_bwd_plan` mirrors each (head dim, dtype, kernel)'s tiles and shared
memory.

For CPU tensors the wrappers take the plain versions (`ref.attention_ref`,
`ref.attention_lse_ref`, `ref.attention_bwd_ref`); for CUDA tensors they
launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.denoiser.kernel import SMEM_LIMIT
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

#: head dims the kernel is instantiated for (tinyllama 64; qwen2, llama3.2
#: and Jamba 128; gemma 256)
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class FlashPlan(NamedTuple):
    """One (head dim, dtype)'s tiles: `BQ` query rows per CTA (64 per
    consumer warpgroup), `BK` keys per K/V tile, `stages` in the TMA ring,
    `q_in_smem` whether the query block is copied into shared memory,
    `threads` per CTA, `smem_bytes` per CTA."""
    BQ: int
    BK: int
    stages: int
    q_in_smem: bool
    threads: int
    smem_bytes: int


# (BQ, BK, stages, q_in_smem) by (dtype, head dim): `Plan` in the source
_PLANS = {
    (torch.float32, 64): (128, 64, 2, True),
    (torch.float32, 128): (128, 32, 2, True),
    (torch.float32, 256): (64, 32, 2, False),
    (torch.bfloat16, 64): (128, 64, 2, True),
    (torch.bfloat16, 128): (128, 64, 2, True),
    (torch.bfloat16, 256): (64, 64, 2, True),
}


def flash_plan(hd: int, dtype) -> FlashPlan:
    """The kernel's plan at head dim `hd` in `dtype`: `Layout` in
    csrc/flash_attention.cu, region for region. Each region starts on 1024
    bytes: the query block (padded rows, when copied), `stages` K and V
    tiles, and for fp32 K's lo part and V's transposed hi and lo parts;
    then two mbarriers per stage and 1024 bytes to align the base. Raises
    ValueError naming what the kernel does not take or what does not fit."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: float32 or bfloat16 "
                         f"inputs, not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    BQ, BK, stages, q_smem = _PLANS[(dtype, hd)]
    es = 4 if dtype == torch.float32 else 2

    def align1k(n):
        return -(-n // 1024) * 1024
    tile = BK * hd * es
    q_bytes = align1k(BQ * (hd + 16 // es) * es) if q_smem else 0
    split = 3 * tile if es == 4 else 0
    smem = q_bytes + 2 * stages * tile + split + 16 * stages + 1024
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention kernel: {smem} bytes of shared "
                         f"memory at head_dim {hd} in {dtype}, over "
                         f"{SMEM_LIMIT}")
    return FlashPlan(BQ=BQ, BK=BK, stages=stages, q_in_smem=q_smem,
                     threads=BQ // 64 * 128 + 32, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = KB.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_void_p] * 2)
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _checked_plan(hd: int, dtype) -> FlashPlan:
    """The plan, once checked against the compiled layout (`flash_plan`
    raises before the library is built)."""
    plan = flash_plan(hd, dtype)
    smem = _lib().flash_attention_smem_bytes(hd, _DTYPES[dtype])
    if smem != plan.smem_bytes:
        raise RuntimeError("csrc/flash_attention.cu and flash_plan disagree "
                           f"on the shared memory: {smem} != "
                           f"{plan.smem_bytes}")
    return plan


def _strides(name, t, es):
    """(batch, head, seq) element strides of a (B, heads, L, hd) operand for
    TMA: a size-1 dimension's stride is never used and is replaced by a
    valid one; any other must be a multiple of 16 bytes, as the base
    address."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel: {name} must start on 16 "
                         f"bytes for TMA")
    unit = 16 // es
    span = -(-max(n * st for n, st in zip(t.shape, t.stride())) // unit) * unit
    out = []
    for size, st in zip(t.shape[:3], t.stride()[:3]):
        if size == 1:
            st = span
        elif (st * es) % 16:
            raise ValueError(f"flash_attention kernel: {name}'s strides "
                             f"{tuple(t.stride())} must be multiples of 16 "
                             f"bytes for TMA")
        out.append(st)
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """q: (B, H, S, hd); k, v: (B, KV, T, hd), H % KV == 0; returns
    (B, H, S, hd) in q's dtype, and with `with_lse` also each row's
    log-sum-exp of the scaled scores, (B, H, S) fp32. Any strides with a
    unit stride along hd (multiples of 16 bytes on the card). On the card
    the output is a head-major view of a contiguous (B, S, H, hd) tensor."""
    if q.device.type == "cpu":
        o = attention_ref(q, k, v, causal=causal, window=window)
        if with_lse:
            return o, attention_lse_ref(q, k, causal=causal, window=window)
        return o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    _checked_plan(hd, q.dtype)         # raises on what the kernel does not take
    for name, t, shape in (("k", k, (B, KV, T, hd)), ("v", v, (B, KV, T, hd))):
        if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"flash_attention kernel: {name} must be {q.dtype} of shape "
                f"{shape} on {q.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if H % KV:
        raise ValueError(f"flash_attention kernel: {H} query heads do not "
                         f"split into {KV} KV heads")
    if min(B, S, T) == 0:
        raise ValueError("flash_attention kernel: empty input")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name} needs a unit "
                             f"stride along head_dim")
    es = q.element_size()
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _strides(name, t, es)]
    o = torch.empty((B, S, H, hd), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides += list(o.stride()[:3])
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *strides,
        B, H, KV, S, T, hd, _DTYPES[q.dtype], int(causal), int(window),
        float(hd) ** -0.5, KB.raw_stream(q.get_device()),
        None if lse is None else lse.data_ptr())
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: error {err} (a CUDA "
            f"error; 10000: libcuda offers no cuTensorMapEncodeTiled; "
            f"10001 + n: it refused a map with CUresult n)")
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


flash_attention.launches = 0


class FlashBwdPlan(NamedTuple):
    """One backward kernel's plan at a (head dim, dtype): `rows` per CTA
    (64 per consumer warpgroup: queries for dQ, keys for dK / dV), `BN`
    rows of each streamed tile (K and V for dQ, Q and dO for dK / dV),
    `stages` in the TMA ring, `rows_in_smem` whether the resident rows are
    copied into shared memory, `splits` CTAs over the output columns,
    `threads` (the consumer warpgroups and a producer warp, or with two
    consumer warpgroups a producer warpgroup that hands its registers to
    them) and `smem_bytes` per CTA."""
    rows: int
    BN: int
    stages: int
    rows_in_smem: bool
    splits: int
    threads: int
    smem_bytes: int


#: (rows, BN, stages, rows_in_smem, splits) by (dtype, head dim, kernel:
#: 0 = dQ, 1 = dK / dV): `Plan` in csrc/flash_attention_bwd.cu
_BWD_PLANS = {
    (torch.float32, 64, 0): (128, 64, 2, True, 1),
    (torch.float32, 128, 0): (128, 32, 2, False, 1),
    (torch.float32, 256, 0): (64, 32, 1, False, 2),
    (torch.bfloat16, 64, 0): (128, 64, 2, True, 1),
    (torch.bfloat16, 128, 0): (128, 64, 2, True, 1),
    (torch.bfloat16, 256, 0): (64, 64, 2, True, 2),
    (torch.float32, 64, 1): (128, 32, 2, True, 1),
    (torch.float32, 128, 1): (128, 32, 2, False, 1),
    (torch.float32, 256, 1): (64, 32, 1, False, 2),
    (torch.bfloat16, 64, 1): (128, 64, 2, True, 1),
    (torch.bfloat16, 128, 1): (128, 32, 2, True, 1),
    (torch.bfloat16, 256, 1): (64, 32, 2, True, 2),
}


def flash_bwd_plan(hd: int, dtype, which: int) -> FlashBwdPlan:
    """The dQ (`which` 0) or dK / dV (1) kernel's plan: `Layout` in
    csrc/flash_attention_bwd.cu, region for region, each on 1024 bytes:
    the two resident row blocks (padded rows, when copied), `stages` pairs
    of streamed tiles, for dK / dV each stage's lse and D, for fp32 the two
    tiles' lo parts and the transposed hi and lo parts of the tiles the
    second products read (one for dQ, two for dK / dV, the CTA's output
    columns only); then two mbarriers per stage, a flag and 1024 bytes to
    align the base. Raises ValueError naming what the kernels do not take
    or what does not fit."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bwd kernel: float32 or bfloat16 "
                         f"inputs, not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    rows, bn, stages, in_smem, splits = _BWD_PLANS[(dtype, hd, which)]
    es = 4 if dtype == torch.float32 else 2

    def align1k(n):
        return -(-n // 1024) * 1024
    tile = bn * hd * es
    ttile = hd // splits * bn * 4
    smem = 2 * (align1k(rows * (hd + 16 // es) * es) if in_smem else 0)
    smem += 2 * stages * tile
    if which == 1:
        smem += align1k(2 * stages * bn * 4)
    if es == 4:
        smem += 2 * tile + (4 if which == 1 else 2) * ttile
    smem += 16 * stages + 16 + 1024
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention_bwd kernel: {smem} bytes of "
                         f"shared memory at head_dim {hd} in {dtype}, over "
                         f"{SMEM_LIMIT}")
    # two consumer warpgroups come with a producer warpgroup, one with a
    # producer warp
    threads = rows // 64 * 128 + (128 if rows == 128 else 32)
    return FlashBwdPlan(rows=rows, BN=bn, stages=stages, rows_in_smem=in_smem,
                        splits=splits, threads=threads, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = KB.load("flash_attention_bwd")
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 15
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_plan.argtypes = [ctypes.c_int] * 4
    lib.flash_attention_bwd_plan.restype = ctypes.c_int
    for (dtype, hd, which) in _BWD_PLANS:
        plan = flash_bwd_plan(hd, dtype, which)
        got = [lib.flash_attention_bwd_plan(hd, _DTYPES[dtype], which, f)
               for f in range(6)]
        want = [plan.rows, plan.BN, plan.stages, int(plan.rows_in_smem),
                plan.splits, plan.smem_bytes]
        if got != want:
            raise RuntimeError("csrc/flash_attention_bwd.cu and "
                               f"flash_bwd_plan disagree at {dtype}, hd {hd}, "
                               f"kernel {which}: {got} != {want}")
    return lib


def bwd_scratch(B: int, H: int, KV: int, T: int, hd: int, dtype):
    """The dK / dV kernel's scratch with G = H / KV > 1 query heads per KV
    head: (the shape of each of its fp32 dK and dV partials, (B, T, H, hd),
    the number of its zeroed last-CTA counters, one per (batch row, KV
    head, key block, column split)); None with G = 1, where each CTA writes
    dK and dV itself."""
    if H == KV:
        return None
    plan = flash_bwd_plan(hd, dtype, 1)
    return (B, T, H, hd), B * KV * -(-T // plan.rows) * plan.splits


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of `flash_attention` from its inputs, its output `o`,
    its `lse` and the output's gradient `do`, head-major as the forward's
    (q, o, do: (B, H, S, hd); k, v: (B, KV, T, hd); lse: (B, H, S) fp32).
    Returns the gradients in q's dtype, head-major views of contiguous
    (B, S, H, hd) and (B, T, KV, hd) tensors on the card. q, k, v, o and do
    may have any strides with a unit stride along hd (on the card, q, k, v
    and do start on 16 bytes with strides of multiples of 16 bytes, as TMA
    reads them)."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    flash_bwd_plan(hd, q.dtype, 1)     # raises on what it does not take
    for name, t, shape, dtype in (
            ("k", k, (B, KV, T, hd), q.dtype), ("v", v, (B, KV, T, hd), q.dtype),
            ("o", o, (B, H, S, hd), q.dtype), ("do", do, (B, H, S, hd), q.dtype),
            ("lse", lse, (B, H, S), torch.float32)):
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"flash_attention_bwd kernel: {name} must be {dtype} of shape "
                f"{shape} on {q.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if H % KV or min(B, S, T) == 0:
        raise ValueError(f"flash_attention_bwd kernel: H={H} KV={KV} B={B} "
                         f"S={S} T={T}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd kernel: {name} needs a "
                             f"unit stride along head_dim")
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd kernel: lse must be contiguous")
    dev, es = q.device, q.element_size()
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((B, T, KV, hd), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    pdk = pdv = counters = None
    scratch = bwd_scratch(B, H, KV, T, hd, q.dtype)
    if scratch is not None:
        pdk = torch.empty(scratch[0], dtype=torch.float32, device=dev)
        pdv = torch.empty_like(pdk)
        counters = torch.zeros(scratch[1], dtype=torch.int32, device=dev)
    tma = {name: _strides(name, t, es)     # read by TMA
           for name, t in (("q", q), ("k", k), ("v", v), ("do", do))}
    strides = [*tma["q"], *tma["k"], *tma["v"], *o.stride()[:3], *tma["do"]]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _bwd_lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ptr(pdk), ptr(pdv), ptr(counters), *strides, B, H, KV,
        S, T, hd, _DTYPES[q.dtype], int(causal), int(window),
        float(hd) ** -0.5, KB.raw_stream(q.get_device()))
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: error {err} (a CUDA "
            f"error; 10000: libcuda offers no cuTensorMapEncodeTiled; "
            f"10001 + n: it refused a map with CUresult n)")
    flash_attention_bwd.launches += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


flash_attention_bwd.launches = 0
