"""Read parameter checkpoints written by the reference package.

The reference saves a params tree as `<dir>/<step>/arrays.npz`, one array
per path key ("denoiser/layers/0/w"; list indices are digits). Loading
rebuilds the nested dicts and lists with numpy alone, and the tensors keep
the reference's layout (a dense weight is (in, out)), so a policy trained by
the reference runs in the port unchanged.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None


def _unflatten(flat: dict) -> Any:
    """{'a/0/w': x} -> {'a': [{'w': x}]}; digit keys become list slots."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def params_from_jax(tree: Any, *, device=None) -> Any:
    """A reference params tree of numpy arrays (nested dicts / lists /
    tuples) as the same tree of tensors on `device`."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=dev) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dev)


def load_params(npz_dir: str, step: Optional[int] = None, *,
                device=None) -> Any:
    """Params saved by `repro.common.checkpoint.save_checkpoint` under
    `npz_dir` (the latest step when `step` is None)."""
    if step is None:
        step = latest_step(npz_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {npz_dir}")
    with np.load(os.path.join(npz_dir, str(step), "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_jax(_unflatten(flat), device=device)
