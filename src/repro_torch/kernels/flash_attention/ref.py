"""Plain PyTorch oracle of the flash attention kernel, in the kernel's
head-major layout (port of `repro/kernels/flash_attention/ref.py`). It is
the path the kernel's wrapper takes for CPU tensors and what `chip_smoke.py`
holds the kernel to on the card."""
from __future__ import annotations

from repro_torch.models.attention import simple_attention


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, S, hd); k/v: (B, KV, T, hd) — kernel layout (head-major)."""
    o = simple_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)
