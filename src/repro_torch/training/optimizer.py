"""Adam with decoupled weight decay, global-norm clipping and a cosine
schedule, functional on parameter trees (port of
`repro/training/optimizer.py`).

`adam_update(grads, state, params, lr) -> (updates, state)`, then
`apply_updates(params, updates)`, as the reference does; `value_and_grad`
takes the grads of a params tree with autograd. This is not
`torch.optim.Adam`: the reference adds the weight decay after the Adam
normalisation (`u + wd * p`, scaled by `-lr`), where `Adam(weight_decay=)`
adds it to the gradient, and it computes `sqrt(v / bc2) + eps` where torch
computes `sqrt(v) / sqrt(bc2) + eps`. The bias corrections are f32 powers,
as `jnp.power` takes them.

`clip_by_global_norm_` and `adam_apply_` are the same arithmetic done in
place, leaf by leaf, on grads, params and the Adam moments (as a jitted
step that donates its buffers would): a training step at full width then
holds one copy of each, not the two that the functional update needs
while it builds the new trees.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.common.pytree import tree_leaves, tree_map, tree_unflatten


class AdamState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any
    nu: Any


def value_and_grad(loss_fn: Callable, params):
    """(loss, aux, grads) of `loss_fn(params) -> (loss, aux)`, the grads
    from `torch.autograd.grad` over the leaves of `params`, in its
    structure (zeros for a leaf the loss does not reach, as JAX gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def adam_init(params) -> AdamState:
    leaf = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=leaf.device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32)))
         for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """`clip_by_global_norm` in place on `grads`; returns the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return norm


def adam_update(grads, state: AdamState, params, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> Tuple[Any, AdamState]:
    step = state.step + 1
    t = step.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), t)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        return ((-lr) * u).to(p.dtype), m, v

    outs = tree_map(lambda *a: upd(*a), grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda _, o: o[i], grads, outs)  # noqa: E731
    return pick(0), AdamState(step=step, mu=pick(1), nu=pick(2))


def adam_apply_(grads, state: AdamState, params, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> AdamState:
    """`adam_update` then `apply_updates`, in place: each leaf's moments and
    param are updated with the same operations in the same order, one leaf
    at a time. Returns the state (its `mu` and `nu` the updated tensors, its
    step advanced)."""
    step = state.step + 1
    t = step.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), t)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        p.add_(((-lr) * u).to(p.dtype))
    return AdamState(step=step, mu=state.mu, nu=state.nu)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
