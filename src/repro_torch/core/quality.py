"""CLIP-score quality proxy q_k = h(s_k, g_k) (paper Eq. 2; port of
`repro/core/quality.py`).

q(s) = Q_MAX (1 - exp(-s / TAU)) + per-task noise. The reference writes
`s / TAU` as a multiply by the reciprocal (rounded to f32 once) and pins the
product before the noise is added; eager PyTorch rounds every operation on
its own, so the same operation order gives the same rounding.
"""
from __future__ import annotations

import torch

Q_MAX = 0.285
TAU = 10.0


def quality_of(steps: torch.Tensor, noise=0.0) -> torch.Tensor:
    s = steps.to(torch.float32)
    return Q_MAX * (1.0 - torch.exp(-s * (1.0 / TAU))) + noise


def quality_penalty(q: torch.Tensor, q_min: float, p_quality: float):
    """Eq. 3: I_k = p_quality if q < q_min else 0."""
    return torch.where(q < q_min, p_quality, 0.0)
