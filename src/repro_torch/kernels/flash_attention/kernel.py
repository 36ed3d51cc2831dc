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
backward is a first, simple kernel: fp32 FMAs on the CUDA cores, two
launches (dQ and D, then dK and dV), no atomics; `bwd_smem_bytes` gives
its shared memory.

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


def bwd_smem_bytes(hd: int):
    """(dQ kernel, dK / dV kernel) shared memory per CTA in bytes at head
    dim `hd`: `Smem` in csrc/flash_attention_bwd.cu. Tiles of BQ query rows
    and BK keys (64 and 64; 32 and 32 at hd 256), every operand staged as
    fp32 rows of hd + 1 floats: Q, dO, K and V tiles, dS (and for dK / dV
    also P) as rows of BK + 1, and lse and D per query row."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    bq = bk = 32 if hd == 256 else 64
    rows = (2 * bq + 2 * bk) * (hd + 1)
    return (4 * (rows + bq * (bk + 1) + 2 * bq),
            4 * (rows + 2 * bq * (bk + 1) + 2 * bq))


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = KB.load("flash_attention_bwd")
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 15
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
    for hd in HEAD_DIMS:
        got = tuple(lib.flash_attention_bwd_smem_bytes(hd, w) for w in (0, 1))
        if got != bwd_smem_bytes(hd):
            raise RuntimeError("csrc/flash_attention_bwd.cu and "
                               "bwd_smem_bytes disagree on the shared memory: "
                               f"{got} != {bwd_smem_bytes(hd)}")
    return lib


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of `flash_attention` from its inputs, its output `o`,
    its `lse` and the output's gradient `do`, head-major as the forward's
    (q, o, do: (B, H, S, hd); k, v: (B, KV, T, hd); lse: (B, H, S) fp32).
    Returns the gradients in q's dtype, head-major views of contiguous
    (B, S, H, hd) and (B, T, KV, hd) tensors on the card. q, k, v, o and do
    may have any strides with a unit stride along hd."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bwd kernel: float32 or bfloat16 "
                         f"inputs, not {q.dtype}")
    bwd_smem_bytes(hd)                 # raises on a head dim it does not take
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
    dev = q.device
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((B, T, KV, hd), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    err = _bwd_lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *strides, B, H, KV, S, T, hd, _DTYPES[q.dtype],
        int(causal), int(window), float(hd) ** -0.5,
        KB.raw_stream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


flash_attention_bwd.launches = 0
