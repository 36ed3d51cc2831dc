"""Wrapper of the CUDA flash attention kernel (`csrc/flash_attention.cu`).

Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
flash_attention` (`_attn_kernel`). What bounds it on an H100: operations,
4·B·H·S·T·hd FLOPs times the unmasked fraction against a few MB of q, k, v
and o. This first kernel runs plain fp32 FMAs out of shared memory (one
CTA per 64-row query block and head, 64-key K/V tiles, the online-softmax
state in registers); `wgmma`, TMA and a bf16 tensor-core path are later
work. The kernel reads the tensors through their strides, so the model's
(B, S, H, hd) activations are passed as head-major views without a copy,
and masks the keys at or past T itself: the caller pads nothing.

For CPU tensors the wrapper takes the plain version (`ref.attention_ref`);
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.denoiser.kernel import SMEM_LIMIT
from repro_torch.kernels.flash_attention.ref import attention_ref

#: head dims the kernel is instantiated for (tinyllama 64; qwen2 and
#: llama3.2 128; gemma 256)
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = KB.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, S, hd); k, v: (B, KV, T, hd), H % KV == 0; returns
    (B, H, S, hd) in q's dtype. Any strides with a unit stride along hd.
    On the card the output is a head-major view of a contiguous
    (B, S, H, hd) tensor."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: float32 or bfloat16 "
                         f"inputs, not {q.dtype}")
    for name, t, shape in (("k", k, (B, KV, T, hd)), ("v", v, (B, KV, T, hd))):
        if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"flash_attention kernel: {name} must be {q.dtype} of shape "
                f"{shape} on {q.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"flash_attention kernel: {H} query heads do not "
                         f"split into {KV} KV heads")
    if min(B, S, T) == 0:
        raise ValueError("flash_attention kernel: empty input")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name} needs a unit "
                             f"stride along head_dim")
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_attention kernel needs {smem} bytes of "
                         f"shared memory at head_dim {hd}; a block has "
                         f"{SMEM_LIMIT}")
    o = torch.empty((B, S, H, hd), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *strides,
        B, H, KV, S, T, hd, _DTYPES[q.dtype], int(causal), int(window),
        float(hd) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
