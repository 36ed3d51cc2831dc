"""Device meshes and the roofline's hardware constants (port of
`repro/launch/mesh.py`).

TARGET: NVIDIA H100 SXM (HGX) in place of the reference's TPU v5e pods:
the production meshes keep the reference's shapes, 16 x 16 = 256 devices
("data", "model") and 2 x 16 x 16 = 512 ("pod", "data", "model"). A
256-device mesh spans 32 HGX nodes of 8 GPUs: only 8 devices share
NVLink, so the outer axis and most of `model`'s 16 cross InfiniBand at
about 50 GB/s a GPU (one 400 Gb/s NIC each). The collective term, taken at
NVLink's rate, is therefore a lower bound.

`make_production_mesh` is a FUNCTION (not a module constant) so importing
this module never touches process-group state. It returns a
`torch.distributed` `DeviceMesh` on "cpu" over a fake process group of
256 or 512 ranks (`torch.testing._internal.distributed.fake_pg`: every
collective returns at once, no data moves): the dry-run's world
(`launch.dryrun`), a host analysis, not a fallback from the card.

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

# NVIDIA H100 SXM constants (per device) for the roofline model
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
HBM_BW = 3.35e12                # bytes/s
HBM_PER_DEVICE = 80e9           # bytes
LINK_BW = 25e9                  # bytes/s per NVLink 4 link, each way
NUM_LINKS = 18                  # 18 links: 450 GB/s each way in aggregate


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


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with `multi_pod`, as a `DeviceMesh` on "cpu" over a
    fake process group of 256 or 512 ranks. The group is initialised here
    (rank 0) when none exists; a group of another size raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", world_size=n, rank=0,
                                store=FakeStore())
    elif dist.get_world_size() != n:
        raise ValueError(
            f"a process group of {dist.get_world_size()} ranks exists; the "
            f"{'multi' if multi_pod else 'single'}-pod mesh needs {n} "
            "(destroy it first)")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)
