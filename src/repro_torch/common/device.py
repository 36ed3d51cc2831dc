"""Where the port runs: the CUDA device unless the caller names another."""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map


def resolve_device(device=None) -> torch.device:
    """`None` means `torch.device("cuda")`, and raises when CUDA is missing.

    The port never drops to the CPU on its own: a caller that wants the plain
    PyTorch path on the CPU asks for it with `device="cpu"`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_device(tree, device: torch.device):
    """Move every tensor of a nested dict / list / tuple tree to `device`
    (a tensor already there is kept, not copied)."""
    return tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)
