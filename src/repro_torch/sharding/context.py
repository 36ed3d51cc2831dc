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

`constrain_heads` places the attention's queries: their heads over `model`
where the token activations are armed, as the reference's compile splits
the attention's (KV, G) heads. Where the query's head view was refused
(heads * head_dim split over `model` at a width that is no multiple of
head_dim) it puts the heads on an uneven `Shard`: a local slice, no
collective. `on_head_shards` then runs the blocked attention on each
device's shards. Every (batch, head) pair is independent there, and
DTensor would gather the flattened (batch, heads) dim of each block's
matmul (a `_StridedShard` its `bmm` rule does not take), and refuses any op
on a dim split into more shards than it has entries (12 heads over 16).

A decode step's KV cache is split on T (`launch.steps.build_case`), and
DTensor gathers a device's whole cache for a write at one T index and for
an einsum whose other operand keeps a head split. `write_slot` writes the
new token into each device's own T shard (GSPMD's masked
dynamic-update-slice) and `on_seq_shards` runs decode attention on each
device's T slice, its softmax combined by all-reduces.

DTensor's index rule gathers the embedding table's vocab split on every
device. Where that moves more bytes than the rows looked up (a decode
step's few tokens), `lookup_rows` looks each id up on the device's own
vocab rows and all-reduces the masked rows over the split.
"""
from __future__ import annotations

import math
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


def constrain_heads(q: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) queries with the heads split over `model` under the
    ambient activation sharding (the batch as the tokens'), unevenly where
    `model` does not divide H; the identity elsewhere."""
    sharding = _ACT_SHARDING.get()
    if sharding is None or q.ndim != 4:
        return q
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return q
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    if "model" not in names:
        return q
    spec = (sharding.spec[0], None, "model", None)
    want = to_placements(spec, names)
    if list(q.placements) == want:
        return q
    return q.redistribute(mesh, want)


def on_head_shards(attend, q, k, v):
    """`attend(q, k, v, g, h0)` on each device's shards of (B, S, H, hd)
    queries and (B, T, KV, hd) keys and values, where query head i of the
    shard reads KV head (h0 + i) // g of the shard's keys (g = H / KV).
    The outputs, shaped as q and q[..., 0], come back as DTensors placed as
    q. Only under an armed activation sharding and with q a DTensor; else
    `attend(q, k, v, H / KV, 0)` on the tensors as given.

    q's heads go over `model` (`constrain_heads`); k and v take q's batch
    split and keep a split of their heads over `model` that matches q's,
    else are replicated there. Their gradients are then partial sums over
    `model` (each device's query heads add theirs)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    g = q.shape[2] // k.shape[2]
    if _ACT_SHARDING.get() is None or not isinstance(q, DTensor):
        return attend(q, k, v, g, 0)
    q = constrain_heads(q)
    mesh = q.device_mesh
    model = mesh.mesh_dim_names.index("model") \
        if "model" in mesh.mesh_dim_names else -1
    heads_split = model >= 0 and q.placements[model] == Shard(2)
    kv_split = heads_split and k.shape[2] % mesh.size(model) == 0
    pl = [Shard(0) if p == Shard(0) else
          Shard(2) if i == model and kv_split else Replicate()
          for i, p in enumerate(q.placements)]
    grad_pl = [Partial() if i == model and heads_split and not kv_split
               else p for i, p in enumerate(pl)]
    k, v = (x.redistribute(mesh, pl) for x in (k, v))
    hq0, hk0 = _shard_start(q, 2), _shard_start(k, 2)
    outs = attend(q.to_local(grad_placements=q.placements),
                  k.to_local(grad_placements=grad_pl),
                  v.to_local(grad_placements=grad_pl), g, hq0 - hk0 * g)
    return tuple(_from_local(x, mesh, q.placements, q.shape[:x.ndim])
                 for x in outs)


def _shard_start(x, dim: int) -> int:
    """The global index of DTensor x's first entry along `dim` in this
    device's shard."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_shape
    return local_shape(x.shape, x.device_mesh, x.placements)[1][dim]


def seq_sharded(x) -> bool:
    """Whether decode runs on the T shards of (B, T, ...) cache x: under an
    armed activation sharding, with x a DTensor split on dim 1."""
    if _ACT_SHARDING.get() is None:
        return False
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(x, DTensor) and Shard(1) in x.placements


def _batch_only(placements):
    """A cache's placements with its batch split kept and every other mesh
    dim replicated (the T split's dims among them)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if p == Shard(0) else Replicate() for p in placements]


def write_local_slot(local: torch.Tensor, index: int, new: torch.Tensor,
                     start: int) -> None:
    """The part of `cache[:, index] = new` that falls in `local`, the
    cache's entries [start, start + local.shape[1]) along dim 1: GSPMD's
    masked dynamic-update-slice. The slot index is clamped into the slice
    and the write masked by whether `index` lies in it, so every slice runs
    the same fixed-shape ops."""
    n = local.shape[1]
    inside = torch.tensor(start <= index < start + n, device=local.device)
    slot = local[:, min(max(index - start, 0), n - 1)]
    slot.copy_(torch.where(inside, new.to(local.dtype), slot))


def write_slot(cache: torch.Tensor, index: int, new: torch.Tensor) -> None:
    """`cache[:, index] = new` in place (cache (B, T, ...), new (B, ...)).
    Where decode runs on the cache's T shards (`seq_sharded`) each device
    writes into its own shard (`write_local_slot`), new placed with the
    cache's batch split: DTensor has no local rule for a write at one T
    index and gathers the cache's T. Elsewhere the indexed assignment."""
    if not seq_sharded(cache):
        cache[:, index] = new.to(cache.dtype)
        return
    new = new.redistribute(cache.device_mesh, _batch_only(cache.placements))
    write_local_slot(cache.to_local(), index, new.to_local(),
                     _shard_start(cache, 1))


def on_seq_shards(decode, q, k, v):
    """`decode(q, k, v, t0, reduce)` on each device's T slice of
    (B, T, KV, hd) DTensor caches k and v (`seq_sharded`), which holds the
    cache's entries from global position t0; q (B, 1, H, hd) comes
    replicated over the mesh dims that split T and split as the cache's
    batch. `reduce(x, op)` all-reduces an fp32 tensor of a device's
    batch rows over the T split's mesh dims, op "max" or "sum", as
    DTensor `Partial` placements redistributed (so the dry-run's counter
    sees all-reduces). decode's (B, ...) output comes back as a DTensor
    placed as the query here."""
    from torch.distributed.tensor import Partial, Shard
    mesh = k.device_mesh
    pl = _batch_only(k.placements)
    batch = q.shape[0]
    q, v = q.redistribute(mesh, pl), v.redistribute(mesh, k.placements)

    def reduce(x, op):
        part = [Partial(op) if p == Shard(1) else r
                for p, r in zip(k.placements, pl)]
        return _from_local(x, mesh, part, (batch,) + x.shape[1:]) \
            .redistribute(mesh, pl).to_local()
    out = decode(q.to_local(), k.to_local(), v.to_local(),
                 _shard_start(k, 1), reduce)
    return _from_local(out, mesh, pl, (batch,) + out.shape[1:])


def _from_local(x, mesh, placements, shape):
    """A contiguous DTensor of global `shape` from each device's shard."""
    from torch.distributed.tensor import DTensor
    stride = [1]
    for n in reversed(shape[1:]):
        stride.insert(0, stride[0] * n)
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def scatter_along(x: torch.Tensor, dim: int, index: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """`x.scatter(dim, index, src)`. Under an armed activation sharding, on
    DTensors, it runs on each device's shards with index and src placed as
    x (exact where x is not split along `dim`): torch 2.11's DTensor has
    no scatter rule that keeps a split and gathers all three whole (the
    MoE dispatch's int64 index, broadcast over d_model)."""
    from torch.distributed.tensor import DTensor
    if _ACT_SHARDING.get() is None or not all(
            isinstance(t, DTensor) for t in (x, index, src)) or any(
            p.is_shard(dim % x.ndim) for p in x.placements):
        return x.scatter(dim, index, src)
    mesh, pl = x.device_mesh, x.placements
    index, src = (t.redistribute(mesh, pl) for t in (index, src))
    out = x.to_local().scatter(dim, index.to_local(),
                               src.to_local(grad_placements=pl))
    return _from_local(out, mesh, pl, x.shape)


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over x's last dim (the loss's log-partition). Under an
    armed activation sharding, on a DTensor, the max and the sum of
    exponentials are reduced over the split dim (vocab-parallel):
    DTensor's own logsumexp gathers the whole dim on every device."""
    from torch.distributed.tensor import DTensor
    if _ACT_SHARDING.get() is None or not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    m = x.detach().amax(dim=-1, keepdim=True)
    return _summed(x, (x - m).exp().sum(dim=-1)).log() + m[..., 0]


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along x's last dim (idx: x's shape without it; the
    loss's gold logits). Under an armed activation sharding, on a
    DTensor, a masked sum over the last dim, which keeps x's splits:
    DTensor runs `torch.gather`'s backward as a zero tensor of x's global
    shape replicated on every device (its `new_zeros`), the logits of a
    whole global batch."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    if _ACT_SHARDING.get() is None or not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    # the vocab ids split as x's last dim, so the mask and its gradient
    # keep x's split (replicated ids would make them whole on each device)
    last = Shard(x.ndim - 1)
    ids = distribute_tensor(
        torch.arange(x.shape[-1], device=x.to_local().device),
        x.device_mesh, [Shard(0) if p == last else Replicate()
                        for p in x.placements])
    return _summed(x, torch.where(ids == idx[..., None], x, 0.0).sum(dim=-1))


def _summed(x, y):
    """`y`, a sum over DTensor x's last dim, all-reduced over the mesh dims
    that split it (left to DTensor, the partial sum is reduce-scattered
    onto the batch dim, and its gradient then meets x's split there)."""
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(x.ndim - 1)
    return y.redistribute(y.device_mesh, [
        Replicate() if p == last else q
        for p, q in zip(x.placements, y.placements)])


def lookup_local_rows(local: torch.Tensor, ids: torch.Tensor,
                      start: int) -> torch.Tensor:
    """The rows of `ids` that fall in `local`, a table's rows [start, start
    + local.shape[0]), and zeros for the others: each device's part of a
    vocab-parallel lookup, which sums over the row slices to
    `table[ids]`. The ids outside the slice are clamped to its first row and
    masked, so every slice runs the same fixed-shape ops."""
    inside = (ids >= start) & (ids < start + local.shape[0])
    rows = local[torch.where(inside, ids - start, 0)]
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def masked_lookup_cheaper(table_shape, table_pl, ids_shape, ids_pl, sizes,
                          itemsize: int) -> bool:
    """Whether `lookup_rows` looks up on each device's rows of a (V, d)
    table placed as `table_pl` (ids (...) placed as `ids_pl`, a mesh of
    `sizes`), from nothing but those: where it sends fewer bytes a device
    than DTensor's index rule, which gathers the table's vocab split (a
    ring of n devices sends n - 1 shards). The masked lookup all-reduces
    its output over that split instead (2 (n - 1) / n of it, a device's
    ids times its d shard). Both gather the ids over the mesh dims that
    split the table."""
    vocab = math.prod(k for p, k in zip(table_pl, sizes) if p.is_shard(0))
    if vocab == 1:
        return False
    table = math.prod(table_shape) * itemsize / math.prod(
        k for p, k in zip(table_pl, sizes) if p.is_shard())
    ids = math.prod(ids_shape) / math.prod(
        k for p, q, k in zip(ids_pl, table_pl, sizes)
        if p.is_shard() and q.is_replicate())
    out = ids * table_shape[-1] * itemsize / math.prod(
        k for p, k in zip(table_pl, sizes) if p.is_shard(1))
    return 2 * out * (vocab - 1) / vocab < table * (vocab - 1)


def lookup_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`table[tokens]` (the embedding lookup of a (V, d) table). Under an
    armed activation sharding, on DTensors, where `masked_lookup_cheaper`:
    each device looks the ids up on its own vocab rows of the table
    (`lookup_local_rows`), its d shard as it is, and the partial sums are
    all-reduced over the vocab split, as `_summed` does for the loss: the
    ids are gathered over the mesh dims that split the table (ints, a
    device's batch), never the table. The rows come back placed as the
    token activations (`constrain`), where every model pins them or its
    first layer reads them. DTensor's index rule gathers the table's vocab
    split on every device. Elsewhere the indexed lookup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if _ACT_SHARDING.get() is None or not all(
            isinstance(t, DTensor) for t in (table, tokens)) or \
            not masked_lookup_cheaper(
                table.shape, table.placements, tokens.shape,
                tokens.placements, table.device_mesh.shape,
                table.element_size()):
        return table[tokens]
    mesh, tpl = table.device_mesh, table.placements
    ids = tokens.redistribute(mesh, [
        Replicate() if not q.is_replicate() else p
        for p, q in zip(tokens.placements, tpl)])
    # the ids' own shard, not a view of it: a view would put an argument's
    # storage among the step's temporaries in the dry-run's memory count
    rows = lookup_local_rows(table.to_local(), ids._local_tensor,
                             _first_row(table))
    part = [Partial() if q.is_shard(0) else
            Shard(ids.ndim) if q.is_shard(1) else p
            for p, q in zip(ids.placements, tpl)]
    out = _from_local(rows, mesh, part, tuple(ids.shape) + table.shape[1:])
    out = out.redistribute(mesh, [Replicate() if q.is_shard(0) else p
                                  for p, q in zip(part, tpl)])
    return constrain(out)


def _first_row(x) -> int:
    """The global index of DTensor x's first row on this device, x's dim 0
    split by `Shard(0)`s in mesh-dim order (`torch.chunk`'s rows a shard),
    from the mesh coordinate: `_shard_start` makes an index tensor of the
    shard's rows on the host."""
    start, size = 0, x.shape[0]
    for p, c, n in zip(x.placements, x.device_mesh.get_coordinate(),
                       x.device_mesh.shape):
        if p.is_shard(0):
            chunk = -(-size // n)
            start += min(c * chunk, size)
            size = max(0, min(chunk, size - c * chunk))
    return start


def constrain_moe(x: torch.Tensor) -> torch.Tensor:
    """Pin a (B, E, C, D) expert-parallel dispatch buffer."""
    sharding = _MOE_SHARDING.get()
    if sharding is None or x.ndim != 4:
        return x
    return _redistribute(x, sharding)
