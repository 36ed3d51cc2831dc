"""Wrappers of the CUDA denoiser kernels: the whole reverse chain
(`csrc/denoiser_chain.cu`) and one eps-MLP forward (`csrc/denoiser_step.cu`).

`denoiser_chain` replaces the TPU kernel
`repro/kernels/denoiser/kernel.py::denoiser_chain` (`_chain_kernel`). What
bounds it on an H100: fp32 operations, ~160 kFLOP per batch row and step at
the paper's widths, against ~317 KB of weights read once. The kernel keeps a
block's rows, their activations, W1, W3 and the biases in shared memory for
all K steps and streams W2 from L2; there is no cuBLAS or torch.matmul
inside the chain.

`denoiser_step` replaces `repro/kernels/denoiser/kernel.py::denoiser_step`
(`_denoiser_kernel`), the distilled sampler's one call per decision. At the
main path's shape (B = 256) its 40 MFLOP and 0.37 MB both take less than a
launch, so latency bounds it; the kernel reads the weights from L2 and
keeps a block's rows and activations in shared memory.

For CPU tensors each wrapper takes its plain version (`ref.py`); for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.denoiser.ref import denoiser_chain_ref, denoiser_ref

#: shared memory one block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 232448


def _check(kernel: str, shapes, device):
    """Each tensor of {name: (tensor, shape)} must be contiguous float32 of
    that shape on `device`; raises naming the first that is not."""
    for name, (t, shape) in shapes.items():
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


@functools.lru_cache(maxsize=None)
def _chain_lib():
    lib = KB.load("denoiser_chain")
    lib.denoiser_chain_launch.argtypes = ([ctypes.c_void_p] * 14
                                          + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
    lib.denoiser_chain_launch.restype = ctypes.c_int
    lib.denoiser_chain_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.denoiser_chain_smem_bytes.restype = ctypes.c_int
    return lib


def denoiser_chain(x, noises, f_s, tembs, coef_x, coef_e, coef_n,
                   w1, b1, w2, b2, w3, b3):
    """tanh(x_0) (B, A) after K affine steps; x (B, A), noises (K, B, A),
    f_s (B, F), tembs (K, t_dim), coef_* (K,), w1 (A+t_dim+F, H), w2 (H, H),
    w3 (H, A), biases (H,), (H,), (A,)."""
    if x.device.type == "cpu":
        return denoiser_chain_ref(x, noises, f_s, tembs, coef_x, coef_e,
                                  coef_n, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"denoiser_chain runs on cpu or cuda, not {x.device}")
    B, A = x.shape
    K, TD = tembs.shape
    F = f_s.shape[1]
    H = w1.shape[1]
    shapes = {"x": (x, (B, A)), "noises": (noises, (K, B, A)),
              "f_s": (f_s, (B, F)), "tembs": (tembs, (K, TD)),
              "coef_x": (coef_x, (K,)), "coef_e": (coef_e, (K,)),
              "coef_n": (coef_n, (K,)), "w1": (w1, (A + TD + F, H)),
              "b1": (b1, (H,)), "w2": (w2, (H, H)), "b2": (b2, (H,)),
              "w3": (w3, (H, A)), "b3": (b3, (A,))}
    _check("denoiser_chain", shapes, x.device)
    lib = _chain_lib()
    smem = lib.denoiser_chain_smem_bytes(A, F, TD, H)
    if smem > SMEM_LIMIT:
        raise ValueError(f"denoiser_chain kernel needs {smem} bytes of shared "
                         f"memory at A={A} F={F} H={H}; a block has "
                         f"{SMEM_LIMIT}")
    out = torch.empty((B, A), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t, _ in shapes.values()] + [out.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.denoiser_chain_launch(*ptrs, B, A, F, TD, H, K, stream)
    if err != 0:
        raise RuntimeError(
            f"denoiser_chain kernel launch failed: CUDA error {err}")
    denoiser_chain.launches += 1
    return out


denoiser_chain.launches = 0


@functools.lru_cache(maxsize=None)
def _step_lib():
    lib = KB.load("denoiser_step")
    lib.denoiser_step_launch.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
    lib.denoiser_step_launch.restype = ctypes.c_int
    lib.denoiser_step_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.denoiser_step_smem_bytes.restype = ctypes.c_int
    return lib


def denoiser_step(inp, w1, b1, w2, b2, w3, b3):
    """tanh(mish(mish(inp w1 + b1) w2 + b2) w3 + b3), (B, A); inp (B, D),
    w1 (D, H), w2 (H, H), w3 (H, A), biases (H,), (H,), (A,)."""
    if inp.device.type == "cpu":
        return denoiser_ref(inp, w1, b1, w2, b2, w3, b3)
    if inp.device.type != "cuda":
        raise ValueError(f"denoiser_step runs on cpu or cuda, not {inp.device}")
    B, D = inp.shape
    H = w1.shape[1]
    A = w3.shape[1]
    shapes = {"inp": (inp, (B, D)), "w1": (w1, (D, H)), "b1": (b1, (H,)),
              "w2": (w2, (H, H)), "b2": (b2, (H,)), "w3": (w3, (H, A)),
              "b3": (b3, (A,))}
    _check("denoiser_step", shapes, inp.device)
    if B == 0:
        raise ValueError("denoiser_step kernel: empty batch")
    lib = _step_lib()
    smem = lib.denoiser_step_smem_bytes(D, H)
    if smem > SMEM_LIMIT:
        raise ValueError(f"denoiser_step kernel needs {smem} bytes of shared "
                         f"memory at D={D} H={H}; a block has {SMEM_LIMIT}")
    out = torch.empty((B, A), dtype=torch.float32, device=inp.device)
    ptrs = [t.data_ptr() for t, _ in shapes.values()] + [out.data_ptr()]
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    err = lib.denoiser_step_launch(*ptrs, B, D, H, A, stream)
    if err != 0:
        raise RuntimeError(
            f"denoiser_step kernel launch failed: CUDA error {err}")
    denoiser_step.launches += 1
    return out


denoiser_step.launches = 0
