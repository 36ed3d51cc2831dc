"""Activation shared by the actor networks (port of `repro/models/layers.py`,
`mish` only)."""
from __future__ import annotations

import torch


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), softplus written as logaddexp(x, 0) as
    `jax.nn.softplus` is (`F.softplus` switches to x above a threshold of
    20, which the reference does not)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))
