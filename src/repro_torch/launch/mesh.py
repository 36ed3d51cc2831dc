"""Device meshes (port of `repro/launch/mesh.py`; the TPU v5e constants and
`make_production_mesh` come with the dry-run analysis, ROADMAP item 15's
second part).

The reference's `make_data_mesh` is a one-axis jax mesh that `shard_map`
drives from one process. The port's counterpart is single-controller too:
a `Mesh` names its axes over a tuple of `torch.device`s, and one process
enqueues every shard's work on its shard's device. It is not a
`torch.distributed` world: the sharded rollout needs no collective (the
params are replicated, the batch is split and gathered), and a process
group is needed only once LM weights are placed across ranks.

A device may appear in the tuple more than once: several shards then run
on one card, or on the host. That is the port's counterpart of jax's
`--xla_force_host_platform_device_count`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple, Union

import torch

from repro_torch.common.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Named axes over `devices` (row-major over the axes). Hashable.

    `shape` maps each axis name to its size, as a jax mesh's does; that
    is all the partition rules (`sharding.specs`) read."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def local_devices(n: int, device=None) -> Tuple[torch.device, ...]:
    """`n` devices of `device`'s type (None: CUDA): the first `n` CUDA
    devices, raising when fewer exist, or the host `n` times."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (dev,) * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(
            f"a mesh of {n} devices asked for, but only {count} CUDA devices "
            "exist; pass the devices themselves (repeats allowed) to put "
            "several shards on one")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence = None, *, device=None) -> Mesh:
    """A mesh of `shape` named `axes` over `devices` (None: `local_devices`
    of `device`'s type)."""
    n = math.prod(shape)
    devs = (local_devices(n, device) if devices is None
            else tuple(torch.device(d) for d in devices))
    return Mesh(devs, tuple(axes), tuple(int(s) for s in shape))


def make_debug_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """The `(data, model)` mesh the step builders and partition rules
    read, for tests (on the host the one device repeats)."""
    return make_mesh((data, model), ("data", "model"), device=device)


def make_data_mesh(devices: Union[int, Sequence] = 0, axis: str = "data", *,
                   device=None) -> Mesh:
    """1-D data-parallel mesh: the mesh the `repro_torch.api` sharded
    execution backend splits the rollout batch / stream axis over
    (`api/backends.py`). `devices` is a count (0: every CUDA device, or
    one host device) or the devices themselves, repeats allowed."""
    if not isinstance(devices, int):
        devs = tuple(torch.device(d) for d in devices)
        return Mesh(devs, (axis,), (len(devs),))
    dev = resolve_device(device)
    n = int(devices) or (torch.cuda.device_count() if dev.type == "cuda"
                         else 1)
    return make_mesh((n,), (axis,), device=dev)
