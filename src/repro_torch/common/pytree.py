"""Helpers over parameter trees: nested dicts and lists of tensors (port of
`repro/common/pytree.py`, the parts the trainers and the model zoo need).

Leaves are visited in the reference's order: dict keys sorted, list and
tuple slots in order. A NamedTuple is a node too, so a `TrainState` maps
field by field.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def tree_leaves(tree: Any) -> List[Any]:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (which share its structure)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, k, *(o[i] for o in others))
                           for i, k in enumerate(kids)])


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The structure of `like` with `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_paths(tree: Any) -> Dict[str, Any]:
    """{'a/0/w': leaf}, the path keys of the reference's npz checkpoints."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            out["/".join(prefix)] = node
    walk(tree, [])
    return out


def normal_init(generator: torch.Generator, shape, *, stddev: float = 0.02,
                device=None, dtype=torch.float32) -> torch.Tensor:
    """N(0, stddev^2) of `shape`, drawn in place from `generator` on
    `device` (the reference's `normal_init`; one pass, no scaled copy)."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, stddev, generator=generator)


def param_count(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
