"""Activation-sharding constraint context (port of
`repro/sharding/context.py`).

In the reference, GSPMD left to itself may all-gather the batch and shard
d_model instead; pinning the token activations to P(dp, None, None) at
period boundaries forces the FSDP-style solution. The launch layer
(`launch.steps.build_case`) arms this context around a step, and the
models call `constrain` where the reference does.

In the port a plain tensor passes through unchanged. A
`torch.distributed.tensor.DTensor` is redistributed on its own
`DeviceMesh` to the placements of the armed spec
(`sharding.specs.to_placements`). The armed shardings live in context
variables, so a thread or task sees only what it armed.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch

from repro_torch.sharding.specs import NamedSharding, to_placements

# for rank-3 (B, S, D) token activations
_ACT_SHARDING: ContextVar[Optional[NamedSharding]] = ContextVar(
    "act_sharding", default=None)
# for rank-4 (B, E, C, D) expert buffers
_MOE_SHARDING: ContextVar[Optional[NamedSharding]] = ContextVar(
    "moe_sharding", default=None)


@contextmanager
def activation_sharding(sharding: Optional[NamedSharding],
                        moe_sharding: Optional[NamedSharding] = None):
    tok = _ACT_SHARDING.set(sharding)
    tok_m = _MOE_SHARDING.set(moe_sharding)
    try:
        yield
    finally:
        _MOE_SHARDING.reset(tok_m)
        _ACT_SHARDING.reset(tok)


def _redistribute(x: torch.Tensor, sharding: NamedSharding):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, to_placements(sharding.spec,
                                              mesh.mesh_dim_names))


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Apply the ambient activation constraint to a (B, S, D) tensor."""
    sharding = _ACT_SHARDING.get()
    if sharding is None or x.ndim != 3:
        return x
    return _redistribute(x, sharding)


def constrain_moe(x: torch.Tensor) -> torch.Tensor:
    """Pin a (B, E, C, D) expert-parallel dispatch buffer."""
    sharding = _MOE_SHARDING.get()
    if sharding is None or x.ndim != 4:
        return x
    return _redistribute(x, sharding)
