"""The dry-run's reshard policy: what the port does where the reference
leaves the choice to GSPMD.

`launch.steps.lower_case` traces a step on DTensors (meta local shards over
a fake process group). GSPMD, in the reference's compile, reshards
whatever an op needs on its own. DTensor does not: where its sharding
propagation has no strategy for an op's input placements, the op raises.
And where it has several, it takes the one that moves the fewest bytes
now, which at decode gives up the batch's `data` sharding of a matmul in
favour of a partial sum over `data` (weight-stationary) for the rest of
the step. Both decide the dry-run's numbers, so this mode fixes them, and
counts what it does:

* **Matmuls keep the left operand's free-dim shards** (the tokens of
  every `x @ w`, the port's only matmul layout). Where the right operand
  is split or a partial sum over a mesh dim the left one's free dim is
  split over, the policy prices two partitions by the bytes a device
  sends (`matmul_partition`) and takes the cheaper, as GSPMD does:
  (a) the right operand gathered or reduced over that dim first, FSDP's
  weight gather (`policy.matmul_right_replicated`, op -> count); or (b)
  weight-stationary: the right operand keeps its split, the left one's
  free dim is gathered over that dim (its contraction dim cut locally
  where the right one is split there), and the product is
  reduce-scattered, or moved by an all-to-all, back onto the left one's
  free-dim split (`policy.matmul_weight_stationary`). (a) is the cheaper
  where a device holds many tokens (train and prefill: 65,536 tokens a
  device against a weight shard tens to hundreds of times smaller), (b)
  at decode (8 tokens a device). Both do the same FLOPs a device and
  leave the product placed alike. A left operand that is a partial sum
  over a mesh dim the right one is split over is reduced first, so the
  product stays split (`policy.matmul_left_reduced`); DTensor would
  gather the right one and multiply it whole. All three are the ideal
  partition's collectives, not departures from it.
* **A masked partial** (DTensor's vocab-parallel gather of the loss) is
  reduced as soon as an op returns it: `policy.masked_partials_reduced`.
* **Plain tensors meeting DTensors** (positions, rope tables, masks, the
  optimizer's bias corrections, all created inside the step) become
  replicated DTensors: `policy.plain_tensors_replicated`.
* **An op that DTensor refuses** is retried with the fewest of its
  operands' shards replicated: one (operand, mesh dim) at a time, mesh
  dims outside the batch's first, so the batch keeps its data-parallel
  sharding where anything does. Counted in `reshards` under the op.
* **An op with no sharding rule** runs on the local shard of operands
  that are all replicated, its outputs replicated:
  `reshards["<op> [local, replicated operands]"]`.
* **An op no narrow retry fixes** gets every operand replicated:
  `reshards["<op> [all operands replicated]"]`.

DTensor can also give up a split on its own, with no refusal: a matmul
whose output is replicated over a mesh dim that an operand was split over
repeats its FLOPs there. Those are counted in `shards_dropped` (op ->
count): the second place where the numbers depart from the ideal
partition.

The collectives each reshard implies are counted like any other (this
mode sits above `hlo_analysis.CollectiveCounter`). A reshard found for an op and its input
shapes and placements is remembered, so each layer's copy of an op costs
one dispatch.

`greedy_redistribute_plans` is the trace's other choice. DTensor plans a
redistribution that involves a `_StridedShard` (the attention's flattened
(batch, heads) dim: batch over ("pod", "data"), heads over `model`) by a
graph search over placements, once per tensor shape. On a 3-D mesh that
search dominates the trace: 0.24 s a plan on a (2, 2, 2) mesh, minutes
for some of gemma-7b's on (2, 16, 16). Inside it DTensor takes its greedy
planner (its default for plain shards) and falls back to the search where
greedy raises while planning; where a greedy plan raises while it runs
(whisper-small's train step on 2 x 16 x 16), the op or the reshard is
run once more under the search (`_searching`). On the reduced LMs tested
(prefill on (2, 2, 2)) both planners give the same FLOPs and collectives.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import time
import traceback
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

aten = torch.ops.aten

# op -> (left operand's index, its free dims, right operand's index, its
# batch dims: shards there are compatible with the left's)
_MATMULS = {
    aten.mm.default: (0, (0,), 1, ()),
    aten.addmm.default: (1, (0,), 2, ()),
    aten.bmm.default: (0, (0, 1), 1, (0,)),
    aten.baddbmm.default: (1, (0, 1), 2, (0,)),
}


# the matmuls that may run weight-stationary (no bias to add to a partial
# product)
_STATIONARY = (aten.mm.default, aten.bmm.default)


def _local_bytes(shape, placements, sizes, itemsize) -> float:
    """A shard's bytes of a tensor of global `shape`, split as `placements`
    over a mesh of `sizes` (evenly: a price, not an allocation)."""
    n = math.prod(shape) * itemsize
    for p, k in zip(placements, sizes):
        if p.is_shard():
            n /= k
    return n


class Partition(NamedTuple):
    """`matmul_partition`'s choice: mesh dims where the right operand is
    gathered or reduced first (a), where the product is weight-stationary
    (b), where the left operand is reduced first; and the left operand's
    placements for (b) (None without it)."""
    gather: List[int]
    stationary: List[int]
    reduce: List[int]
    left: Optional[List]


def matmul_partition(func, left_shape, left_pl, right_shape, right_pl,
                     sizes, left_itemsize: int, right_itemsize: int,
                     batch_dims: Sequence[int], held=()) -> Partition:
    """How `ReshardPolicy` partitions matmul `func` (a key of `_MATMULS`)
    on operands of these global shapes and placements over a mesh of
    `sizes` whose dims `batch_dims` split the batch, from nothing but
    those. Where a mesh dim splits the left operand's free dim and the
    right operand is split or partial there, (a) gathers the right one
    there (on a batch dim, FSDP's weight gather), and on a batch dim (b)
    keeps it: the left operand is reduced where it is a partial sum and
    cut locally where the right one's contraction or batch dim is split,
    then over that mesh dim its free dim's split moves to its contraction
    dim (an all-to-all; the product a partial sum, reduce-scattered back)
    where the right one's contraction dim is split, or it is gathered
    (the product's split then moved back by an all-to-all) where the right
    one's free dim is. (b) is taken where it sends fewer bytes a device,
    priced as GSPMD prices a ring over the mesh dim's n devices: n - 1
    shards for a gather or a reduce-scatter, (n - 1) / n of a shard for an
    all-to-all; the left operand's move is free where its placements for
    (b) are among `held` (an earlier product's, kept). The CPU fake group
    runs an all-to-all as a gather and a chunk (ROADMAP Queue 3), so the
    dry-run counts (b)'s all-to-alls as gathers. (b) needs an `mm` or
    `bmm` (no bias to add to a partial sum), plain `Shard`s and a right
    operand split there, not a partial sum."""
    _, free, _, batch = _MATMULS[func]
    contract_l, contract_r = len(left_shape) - 1, len(right_shape) - 2

    def split_r(p):
        return p.is_shard() and p.dim not in batch
    pairs = list(enumerate(zip(left_pl, right_pl)))
    both = [i for i, (pl, pr) in pairs
            if pl.is_shard() and pl.dim in free
            and (pr.is_partial() or split_r(pr))]
    reduce = [i for i, (pl, pr) in pairs if pl.is_partial() and split_r(pr)]
    # (b)'s left operand: reduced, then cut where the right one's
    # contraction or batch dim is split and it is whole
    cut = []
    for i, (pl, pr) in pairs:
        pl = Replicate() if i in reduce else pl
        if pl.is_replicate() and type(pr) is Shard and (
                pr.dim == contract_r or pr.dim in batch):
            pl = Shard(contract_l if pr.dim == contract_r else pr.dim)
        cut.append(pl)
    open_ = [i for i in both if func in _STATIONARY and i in batch_dims
             and type(left_pl[i]) is Shard and type(right_pl[i]) is Shard]
    # where the right operand's contraction dim is split the left one's
    # free-dim split moves to its contraction dim; else it is gathered
    moves = {i: right_pl[i].dim == contract_r for i in open_}
    placed = [Shard(contract_l) if moves.get(i) else
              Replicate() if i in moves else p for i, p in enumerate(cut)]
    left = 0 if tuple(placed) in held else _local_bytes(
        left_shape, cut, sizes, left_itemsize)
    weight = _local_bytes(right_shape, right_pl, sizes, right_itemsize)
    out_shape = tuple(left_shape[:-1]) + tuple(right_shape[-1:])
    # the product's splits (only whether a mesh dim splits it counts)
    out = _local_bytes(out_shape, [
        Shard(0) if (pl.is_shard() and pl.dim in free) or (
            pr.is_shard() and pr.dim != contract_r) else Replicate()
        for pl, pr in zip(left_pl, right_pl)], sizes, left_itemsize)
    stationary = [i for i in open_ if (
        left / sizes[i] + out if moves[i] else left + out / sizes[i])
        < weight]
    # a mesh dim that keeps (a) keeps the left operand's split there
    placed = [p if i in stationary or i not in moves else cut[i]
              for i, p in enumerate(placed)]
    gather = [i for i in both if i not in stationary]
    return Partition(gather, stationary, reduce,
                     placed if stationary else None)


def _keeps_placed(func) -> bool:
    """Whether a weight-stationary product's placed left operand is kept
    across DTensor op `func`: a matmul (the next may read it), a view, a
    cast or a pointwise op, the ops between consecutive projections of one
    activation (the next weight's cast, the operand's view, an activation
    of the previous product)."""
    return (func in _MATMULS or not func._schema.is_mutable and (
        func.is_view or func in (aten._to_copy.default,
                                 aten._unsafe_view.default)
        or torch.Tag.pointwise in func.tags))


class TraceBudgetExceeded(RuntimeError):
    """The trace ran past its budget (a per-token loop at a long S)."""


def _where() -> str:
    """The innermost model frame on the stack, as file:line."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and "/launch/" not in f.filename]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.filename.split('src/')[-1]}:{f.lineno}"


@contextlib.contextmanager
def greedy_redistribute_plans():
    """DTensor's redistributions planned greedily first (see the module's
    docstring); a torch without the two planner functions is left as it
    is."""
    from torch.distributed.tensor import _redistribute as R
    search = getattr(R, "_gen_transform_infos_non_cached", None)
    if search is None or not hasattr(R, "get_redistribute_planner"):
        yield
        return

    def plan(src, dst, *args, **kwargs):
        try:
            return R.get_redistribute_planner(
                src.device_mesh, src.tensor_meta
            ).generate_greedy_transform_infos(src, dst)
        except Exception:  # noqa: BLE001 - the search handles the rest
            return search(src, dst, *args, **kwargs)
    R._gen_transform_infos_non_cached = plan
    _SEARCH.append(search)
    try:
        yield
    finally:
        _SEARCH.pop()
        R._gen_transform_infos_non_cached = search


_SEARCH: list = []      # DTensor's graph search, while the greedy plans run


@contextlib.contextmanager
def _searching():
    """Plan with DTensor's graph search again, its cached plans dropped:
    a greedy plan that raised when it ran (a `_StridedShard` it gets
    wrong) is not taken twice."""
    if not _SEARCH:
        yield
        return
    from torch.distributed.tensor import _redistribute as R
    greedy = R._gen_transform_infos_non_cached
    R._gen_transform_infos.cache_clear()
    R._gen_transform_infos_non_cached = _SEARCH[-1]
    try:
        yield
    finally:
        R._gen_transform_infos_non_cached = greedy


def _label(func, fix) -> str:
    return {"dims": str(func), "local": f"{func} [local, replicated operands]",
            "all": f"{func} [all operands replicated]"}[fix[0]]


def _replicated(placements, dims: Sequence[int]):
    """`placements` with those on mesh dims `dims` replicated."""
    return [Replicate() if i in dims else p for i, p in enumerate(placements)]


def _replicate_dims(x, dims: Sequence[int]):
    """`x` (a DTensor) with its placements on mesh dims `dims` replicated
    (an all-gather for a shard, an all-reduce for a partial sum)."""
    return _redistribute(x, _replicated(x.placements, dims))


def _redistribute(x, placements):
    """`x` (a DTensor) redistributed to `placements`. `x` is detached
    first: the mode runs below autograd, which has recorded the op
    already, and `redistribute`'s autograd Function would otherwise
    `detach_` an output that requires grad in place (an op that torch
    2.11's DTensor has no rule for)."""
    try:
        return x.detach().redistribute(x.device_mesh, placements)
    except RuntimeError:
        with _searching():
            return x.detach().redistribute(x.device_mesh, placements)


def _identity(x) -> Tuple:
    """DTensor x's local tensor as storage, version and view, and its
    placements: equal for two views of one tensor in one layout (matmul's
    reshapes of one activation)."""
    loc = x._local_tensor
    return (loc.untyped_storage()._cdata, loc._version, tuple(loc.shape),
            loc.stride(), loc.storage_offset(), tuple(x.placements))


def _own_storage(x):
    """DTensor `x` with a local tensor that owns no more storage than it
    spans. The CPU fake group runs an all-to-all as a gather and a chunk
    (ROADMAP Queue 3), whose shard is a view that keeps the whole gather
    alive for as long as the shard lives; an all-to-all's output holds its
    shard only."""
    loc = x._local_tensor
    if loc.untyped_storage().nbytes() <= loc.numel() * loc.element_size():
        return x
    return DTensor.from_local(loc.clone(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


class ReshardPolicy(TorchDispatchMode):
    """Enter it above `hlo_analysis`'s `CollectiveCounter` and
    `LocalCounter` (last, so it sees each op first). `dp_dims` are the mesh dims the batch is split
    over; they are given up last. `counters` (below it, each with
    `snapshot()` and `restore()`) have what they saw of a refused attempt
    taken back out. Past `budget_s` seconds from its creation, the next op
    raises `TraceBudgetExceeded`, naming itself and the model's line."""

    def __init__(self, dp_dims: Sequence[int] = (), counters=(),
                 budget_s: float = float("inf")):
        super().__init__()
        self.dp_dims = tuple(dp_dims)
        self.deadline = time.monotonic() + budget_s
        self.budget_s = budget_s
        self.counters = tuple(counters)
        self.reshards: Counter = Counter()
        self.gathers: Counter = Counter()
        self.stationary: Counter = Counter()
        self.reduces: Counter = Counter()
        self.dropped: Counter = Counter()
        self.masked: Counter = Counter()
        self.wrapped = 0
        self._placed: Dict[Tuple, Tuple] = {}
        self._fixes: Dict[Tuple, object] = {}

    def record(self) -> Dict:
        """`reshards` (the departures from the ideal partition) and what
        the policy did that the ideal partition does too."""
        return {"reshards": dict(sorted(self.reshards.items())),
                "shards_dropped": dict(sorted(self.dropped.items())),
                "policy": {"matmul_right_replicated": dict(
                               sorted(self.gathers.items())),
                           "matmul_weight_stationary": dict(
                               sorted(self.stationary.items())),
                           "matmul_left_reduced": dict(
                               sorted(self.reduces.items())),
                           "masked_partials_reduced": dict(
                               sorted(self.masked.items())),
                           "plain_tensors_replicated": self.wrapped}}

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if time.monotonic() > self.deadline:
            raise TraceBudgetExceeded(
                f"the trace passed its budget of {self.budget_s:g} s at "
                f"{func} ({_where()})")
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if not _keeps_placed(func):
            self._placed.clear()
        flat, _ = tree_flatten((args, kwargs))
        mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
        args, kwargs = tree_map(lambda x: self._wrap(x, mesh), (args, kwargs))
        post = None
        if func in _MATMULS:
            args, post = self._keep_left(func, args)
        key = (func,) + tuple(
            (tuple(a.shape), tuple(a.placements)) if isinstance(a, DTensor)
            else None for a in tree_flatten((args, kwargs))[0])
        fix = self._fixes.get(key)
        if fix is None:
            snap = self._snapshot()
            try:
                out = func(*args, **kwargs)
            except Exception:  # noqa: BLE001 - a greedy plan, or refused
                self._restore(snap)
                try:
                    with _searching():
                        out = func(*args, **kwargs)
                except Exception as err:  # noqa: BLE001 - refused
                    self._restore(snap)
                    fix, out = self._find_fix(func, args, kwargs, err)
                    self._fixes[key] = fix
        else:
            out = self._apply(func, args, kwargs, fix)
        if fix is not None:
            self.reshards[_label(func, fix)] += 1
        if post is not None:
            out = post(out)
        if func in _MATMULS:
            self._note_dropped(func, args, out)
        return self._reduce_masked(func, out)

    def _note_dropped(self, func, args, out):
        """Count a matmul whose output DTensor left replicated a mesh dim
        that an operand was split over: its FLOPs are repeated on that
        dim (DTensor's own choice, no refusal)."""
        li, _, ri, _ = _MATMULS[func]
        split = {i for a in (args[li], args[ri])
                 for i, p in enumerate(getattr(a, "placements", ()))
                 if not (p.is_replicate() or p.is_partial())}
        if any(out.placements[i].is_replicate() for i in split):
            self.dropped[str(func)] += 1

    def snapshot(self):
        """The policy's own counts (`sharding.loops` scales them)."""
        return (Counter(self.reshards), Counter(self.gathers),
                Counter(self.stationary), Counter(self.reduces),
                Counter(self.dropped), Counter(self.masked), self.wrapped)

    def restore(self, snap):
        (self.reshards, self.gathers, self.stationary, self.reduces,
         self.dropped, self.masked) = (Counter(c) for c in snap[:6])
        self.wrapped = snap[6]

    def _snapshot(self):
        return [c.snapshot() for c in self.counters]

    def _restore(self, snap):
        """Forget what the counters saw of a refused attempt."""
        for c, s in zip(self.counters, snap):
            c.restore(s)

    def _reduce_masked(self, func, out):
        """Reduce an output in DTensor's masked-partial state (its
        vocab-parallel gather) at once: one all-reduce, as GSPMD's
        masked gather does. Left as it is, a later view of it keeps a
        mask of the old shape and its reduction raises."""
        if not (isinstance(out, DTensor) and any(
                hasattr(p, "mask_buffer") for p in out.placements)):
            return out
        self.masked[str(func)] += 1
        return _replicate_dims(out, [i for i, p in enumerate(out.placements)
                                     if hasattr(p, "mask_buffer")])

    def _wrap(self, x, mesh):
        if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
            self.wrapped += 1
            return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        return x

    def _keep_left(self, func, args):
        """`args` with the operands placed by `matmul_partition`, and the
        function that places the product (None where nothing does)."""
        li, _, ri, _ = _MATMULS[func]
        left, right = args[li], args[ri]
        if not (isinstance(left, DTensor) and isinstance(right, DTensor)):
            return args, None
        ident = _identity(left)
        part = matmul_partition(
            func, left.shape, left.placements, right.shape, right.placements,
            left.device_mesh.shape, left.element_size(),
            right.element_size(), self.dp_dims,
            held=[steps[-1] for key, steps in self._placed
                  if key == ident])
        args, post = list(args), None
        # a redistribution DTensor cannot run (an uneven `_StridedShard`)
        # leaves the choice to DTensor
        with contextlib.suppress(RuntimeError):
            steps = ([_replicated(left.placements, part.reduce)]
                     if part.reduce else []) + (
                [part.left] if part.stationary else [])
            if steps:
                args[li] = self._place_left(left, ident, steps,
                                            bool(part.stationary))
            if part.reduce:
                self.reduces[str(func)] += 1
            if part.stationary:
                back = {i: left.placements[i] for i in part.stationary}

                def post(out):
                    return _own_storage(_redistribute(out, [
                        back.get(i, p) for i, p in enumerate(out.placements)]))
                self.stationary[str(func)] += 1
            if part.gather:
                args[ri] = _replicate_dims(right, part.gather)
                self.gathers[str(func)] += 1
        return tuple(args), post

    def _place_left(self, left, ident, steps, share: bool):
        """`left` (of `_identity` `ident`) redistributed to each of
        `steps` (placement lists) in turn. For a weight-stationary product
        (`share`) the result is kept for the next matmul that reads the
        same tensor in the same layout (q, k and v read one x, gate and up
        one h): it is moved once, as XLA's common-subexpression pass moves
        it once for every dot. It is dropped at the first op that
        `_keeps_placed` does not keep it across, so it lives no longer
        than those products do."""
        from torch.multiprocessing.reductions import StorageWeakRef
        # an entry lives while its source's storage does (so its address
        # is not reused while the key lives)
        self._placed = {k: v for k, v in self._placed.items()
                        if not v[0].expired()}
        source = StorageWeakRef(left._local_tensor.untyped_storage())
        key = (ident, tuple(tuple(pl) for pl in steps))
        if share and key in self._placed:
            return self._placed[key][1]
        placed = left
        for pl in steps:
            placed = _redistribute(placed, pl)
        if share:
            placed = _own_storage(placed)
            self._placed[key] = (source, placed)
        return placed

    # ------------------------------------------------------------------
    def _apply(self, func, args, kwargs, fix):
        """Run `func` under `fix`: ("dims", ((operand, mesh dim), ...)),
        ("all",) or ("local",)."""
        flat, spec = tree_flatten((args, kwargs))
        if fix[0] == "dims":
            for j, i in fix[1]:
                flat[j] = _replicate_dims(flat[j], (i,))
        else:
            flat = [_replicate_dims(a, range(a.device_mesh.ndim))
                    if isinstance(a, DTensor) else a for a in flat]
        a2, k2 = tree_unflatten(flat, spec)
        if fix[0] != "local":
            return func(*a2, **k2)
        mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
        a3, k3 = tree_map(lambda x: x.to_local() if isinstance(x, DTensor)
                          else x, (a2, k2))
        out = func(*a3, **k3)
        return tree_map(
            lambda y: DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
            if isinstance(y, torch.Tensor) else y, out)

    def _find_fix(self, func, args, kwargs, err):
        flat = tree_flatten((args, kwargs))[0]
        # (operand, mesh dim) pairs that are split, outside the batch's
        # dims first
        cands = sorted(((j, i) for j, a in enumerate(flat)
                        if isinstance(a, DTensor)
                        for i, p in enumerate(a.placements)
                        if not p.is_replicate()),
                       key=lambda c: (c[1] in self.dp_dims, c))
        outer = [c for c in cands if c[1] not in self.dp_dims]
        tries = [("dims", (c,)) for c in cands]
        if len(outer) > 1:
            tries.append(("dims", tuple(outer)))
        tries += [("dims", pair) for pair in itertools.combinations(cands, 2)
                  if ("dims", pair) not in tries][:8]
        # refused on replicated operands: no sharding rule at all
        tries += [("all",)] * bool(cands) + [("local",)]
        for fix in tries:
            snap = self._snapshot()
            try:
                return fix, self._apply(func, args, kwargs, fix)
            except Exception:  # noqa: BLE001 - try the next
                self._restore(snap)
        raise err
