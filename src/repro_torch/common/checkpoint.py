"""Parameter checkpoints in the reference package's format.

The reference saves a params tree as `<dir>/<step>/arrays.npz`, one array
per path key ("denoiser/layers/0/w"; list indices are digits), beside a
`treedef.json`. `load_params` rebuilds the nested dicts and lists with
numpy alone and `restore_checkpoint` fills a target tree of the same
shape; the tensors keep the reference's layout (a dense weight is (in,
out)), so a policy trained by the reference runs in the port unchanged.
`save_checkpoint` writes the same layout, so
`repro.common.checkpoint.restore_checkpoint` reads what the port trained.
`train_state_from_jax` carries a whole reference SAC `TrainState` over.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (tree_map, tree_paths,
                                       tree_unflatten)


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


def restore_checkpoint(directory: str, target: Any,
                       step: Optional[int] = None) -> Any:
    """Restore `<directory>/<step>/arrays.npz` (the latest step when `step`
    is None) into the structure of `target`: every tensor leaf of `target`
    is replaced by the checkpoint's array under its path key, on that
    leaf's device and in its dtype. Raises FileNotFoundError when there is
    no step, KeyError on a missing key and ValueError on a shape that
    differs from the target's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with np.load(os.path.join(directory, str(step), "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    leaves = []
    for key, like in tree_paths(target).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing key {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"checkpoint key {key} has shape "
                             f"{tuple(arr.shape)}, the target "
                             f"{tuple(np.shape(like))}")
        leaves.append(torch.from_numpy(np.array(arr)).to(
            device=like.device, dtype=like.dtype)
            if isinstance(like, torch.Tensor) else arr)
    return tree_unflatten(target, leaves)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write `tree` (nested dicts / lists of tensors) as
    `<directory>/<step>/arrays.npz` with the reference's path keys, plus a
    `treedef.json`; the step directory is replaced whole (written under a
    temporary name, then renamed). Returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree_paths(tree).items()}
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "treedef.json"), "w") as f:
            json.dump({"step": step,
                       "treedef": tree_map(lambda x: list(np.shape(x)), tree),
                       "keys": sorted(flat)}, f)
        final = os.path.join(directory, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def train_state_from_jax(ts: Any, *, device=None):
    """A reference `repro.core.sac.TrainState` (leaves numpy or jax
    arrays) as the port's `core.sac.TrainState` on `device`, its three
    `AdamState`s and its step included. `params_from_jax` would turn the
    NamedTuples into lists, so they are rebuilt field by field here."""
    from repro_torch.core.sac import TrainState
    from repro_torch.training.optimizer import AdamState
    dev = resolve_device(device)

    def tensor(x):
        return torch.from_numpy(np.array(x)).to(dev)

    def adam(st):
        return AdamState(step=tensor(st.step),
                         mu=params_from_jax(st.mu, device=dev),
                         nu=params_from_jax(st.nu, device=dev))

    return TrainState(
        actor=params_from_jax(ts.actor, device=dev),
        critic1=params_from_jax(ts.critic1, device=dev),
        critic2=params_from_jax(ts.critic2, device=dev),
        target1=params_from_jax(ts.target1, device=dev),
        target2=params_from_jax(ts.target2, device=dev),
        opt_actor=adam(ts.opt_actor), opt_critic1=adam(ts.opt_critic1),
        opt_critic2=adam(ts.opt_critic2), step=tensor(ts.step))
