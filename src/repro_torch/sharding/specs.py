"""Partition rules: param/cache path -> spec, divisibility-aware (port of
`repro/sharding/specs.py`).

Weights shard FSDP-style: the d_model-like dim over the ``data`` axis and the
wide (d_ff / heads*head_dim / vocab / experts) dim over the ``model`` axis.
Any rule whose sharded dim does not divide the mesh axis size degrades to
replication on that dim (this keeps one rule-set valid across all ten
architectures). On the multi-pod mesh, weights are replicated over ``pod``
(classic cross-pod data parallelism) while the batch shards over
``("pod", "data")``.

A spec is a plain tuple with one entry per leading dim: an axis name, a
tuple of axis names, or None (replicated); trailing replicated dims are
dropped. It is the counterpart of a `PartitionSpec`, and
`to_placements` turns it into the `Shard(d)` / `Replicate()` list of a
`torch.distributed` `DeviceMesh`. The rules read only axis names and
sizes, so `mesh` is a `launch.mesh.Mesh`, a `DeviceMesh` or a plain
mapping from axis name to size: a rule set is checked on a 16 x 16 or a
2 x 16 x 16 shape without a world of 512 ranks.
"""
from __future__ import annotations

import math
import re
from collections.abc import Mapping
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.common.pytree import map_with_paths

Spec = Tuple[Any, ...]

# (regex over 'a/b/c' path, spec entries aligned to the LAST ndim dims)
# None entries mean replicate. Leading dims (e.g. the stacked period axis)
# are implicitly replicated.
PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # embeddings / heads
    (r"embed/table$", ("model", "data")),
    (r"lm_head/w$", ("data", "model")),
    (r"frontend_proj/w$", ("data", "model")),
    # attention
    (r"(attn|self_attn|cross_attn)/w[qkv]/w$", ("data", "model")),
    (r"(attn|self_attn|cross_attn)/w[qkv]/b$", ("model",)),
    (r"(attn|self_attn|cross_attn)/wo/w$", ("model", "data")),
    (r"(attn|self_attn|cross_attn)/wo/b$", (None,)),
    # dense FFN
    (r"ffn/(gate|up)/w$", ("data", "model")),
    (r"ffn/(gate|up)/b$", ("model",)),
    (r"ffn/down/w$", ("model", "data")),
    (r"ffn/down/b$", (None,)),
    # MoE (expert-parallel over `model`)
    (r"moe/router/w$", ("data", None)),
    (r"moe/(gate|up)$", ("model", "data", None)),
    (r"moe/down$", ("model", None, "data")),
    # Mamba
    (r"mamba/in_proj/w$", ("data", "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/x_proj/w$", ("model", None)),
    (r"mamba/dt_proj/w$", (None, "model")),
    (r"mamba/dt_proj/b$", ("model",)),
    (r"mamba/A_log$", ("model", None)),
    (r"mamba/D$", ("model",)),
    (r"mamba/out_proj/w$", ("model", "data")),
    # xLSTM
    (r"(mlstm|slstm)/up/w$", ("data", "model")),
    (r"mlstm/w[qkv]/w$", ("data", "model")),
    (r"mlstm/w_if/w$", ("model", None)),
    (r"mlstm/w_if/b$", (None,)),
    (r"slstm/w_gates/w$", ("data", "model")),
    (r"slstm/w_gates/b$", ("model",)),
    (r"slstm/r_gates$", (None, None, None)),
    (r"(mlstm|slstm)/down/w$", ("model", "data")),
    # norms and everything else: replicate
    (r".*", ()),
]



class NamedSharding(NamedTuple):
    """A spec on a mesh: the port's `jax.sharding.NamedSharding`."""
    mesh: Any
    spec: Spec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a `launch.mesh.Mesh`, a `DeviceMesh` or a
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axis_size(shape: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def spec_for(path: str, shape: Sequence[int], mesh,
             rules=PARAM_RULES) -> Spec:
    sizes = mesh_shape(mesh)
    for pat, entries in rules:
        if re.search(pat, path):
            nd = len(shape)
            ne = len(entries)
            full = [None] * (nd - ne) + list(entries) if ne <= nd else list(entries[-nd:])
            out = []
            for dim, ax in zip(shape, full):
                if ax is not None and dim % _axis_size(sizes, ax) == 0 and dim > 0:
                    out.append(ax)
                else:
                    out.append(None)
            # trim trailing Nones
            while out and out[-1] is None:
                out.pop()
            return tuple(out)
    return ()


def tree_shardings(tree: Any, mesh, rules=PARAM_RULES):
    """Map a tree (tensors, meta tensors included) to NamedShardings; a
    leaf without a shape (the caches' int `pos`) counts as a scalar."""
    def fn(path, leaf):
        return NamedSharding(mesh, spec_for(path, tuple(getattr(
            leaf, "shape", ())), mesh, rules))
    return map_with_paths(fn, tree)


# ----------------------------------------------------------------------
# cache rules: attention KV caches shard (batch over dp_axes, seq over `seq_ax`)
def cache_rules(dp_axes, seq_ax) -> List[Tuple[str, Tuple[Optional[str], ...]]]:
    """Caches are stacked (periods/L, B, T, KV, hd) for attention KV;
    (B, T-1/W, inner) conv; (B, inner, N) ssm; mlstm/slstm small states."""
    return [
        (r"(attn|self|cross)/[kv]$", (dp_axes, seq_ax, None, None)),
        (r"mamba/conv$", (dp_axes, None, "model")),
        (r"mamba/ssm$", (dp_axes, "model", None)),
        # mLSTM matrix memory: shard the k-contraction dim over `model`,
        # matching wk/wq output sharding — keeps the (B,nh,dh,dh) state
        # resident-sharded across decode steps (§Perf iteration: removes a
        # 212 MB/step state all-gather; the contraction against q becomes a
        # small (B,nh,dh) all-reduce instead).
        (r"mlstm/C$", (dp_axes, None, None, "model")),
        (r"mlstm/n$", (dp_axes, None, "model")),
        (r"mlstm/m$", (dp_axes, None)),
        (r"slstm/[cnhm]$", (dp_axes, None, None)),
        (r"pos$", ()),
        (r".*", ()),
    ]


def batch_spec(mesh, batch: int):
    """Shard the global batch over every data-parallel axis that divides."""
    sizes = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    dp = tuple(axes)
    if batch % _axis_size(sizes, dp) != 0:
        # degrade: drop pod, then drop data
        for cand in (("data",), ()):
            cand = tuple(a for a in cand if a in sizes)
            if not cand or batch % _axis_size(sizes, cand) == 0:
                dp = cand
                break
    return dp


def to_placements(spec: Spec, mesh_dim_names: Sequence[str]) -> List:
    """The `torch.distributed.tensor` placements of `spec` on a DeviceMesh
    whose dims are named `mesh_dim_names`: `Shard(d)` on each mesh dim that
    tensor dim d is split over, `Replicate()` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, (tuple, list))
                     else (entry,)):
            if name is None:
                continue
            if name in dim_of:
                raise ValueError(f"mesh axis {name!r} splits two dims of "
                                 f"spec {spec}")
            if name not in mesh_dim_names:
                raise ValueError(f"spec {spec} names axis {name!r}, not one "
                                 f"of the mesh's {tuple(mesh_dim_names)}")
            dim_of[name] = d
    return [Shard(dim_of[n]) if n in dim_of else Replicate()
            for n in mesh_dim_names]
