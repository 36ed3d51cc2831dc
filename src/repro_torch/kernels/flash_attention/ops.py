"""Entry point of the flash attention kernel, in the (B, S, H, hd) contract
of `models.attention.flash_attention` (the reference's
`flash_attention_jnp`): q (B, S, H, hd), k and v (B, T, KV, hd) ->
(B, S, H, hd).

`impl="auto"` dispatches by the tensors' device: a CUDA tensor launches the
hand-written kernel (it launches or raises; there is no fallback), a CPU
tensor takes the plain version. `impl="ref"` takes the plain version on any
device. The head-major views the kernel reads are transposes, not copies.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: str = "auto"):
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be auto|ref, got {impl!r}")
    fn = flash_attention if impl == "auto" else attention_ref
    o = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
           causal=causal, window=window)
    return o.transpose(1, 2)
