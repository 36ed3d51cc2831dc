"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise for a kernel without a backward when autograd would need one:
    grad mode on and an input that requires grad. The kernel's output would
    carry no `grad_fn`, so the gradient would be silently lost."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} kernel has no backward: call it under torch.no_grad() "
            f"or on inputs that do not require grad (its plain version, "
            f"impl='ref', is differentiable)")
