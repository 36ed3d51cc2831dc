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
  is split or a partial sum over the same mesh dim, it is gathered or
  reduced over that dim first: GSPMD's FSDP choice under the reference's
  activation constraints (`policy.matmul_right_replicated`, op -> count).
  A left operand that is a partial sum over a mesh dim the right one is
  split over is reduced first, so the product stays split
  (`policy.matmul_left_reduced`); DTensor would gather the right one and
  multiply it whole. Both are the ideal partition's collectives, not
  departures from it.
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
import time
import traceback
from collections import Counter
from typing import Dict, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
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


def _replicate_dims(x, dims: Sequence[int]):
    """`x` (a DTensor) with its placements on mesh dims `dims` replicated
    (an all-gather for a shard, an all-reduce for a partial sum). `x` is
    detached first: the mode runs below autograd, which has recorded the
    op already, and `redistribute`'s autograd Function would otherwise
    `detach_` an output that requires grad in place (an op that torch
    2.11's DTensor has no rule for)."""
    pl = list(x.placements)
    for i in dims:
        pl[i] = Replicate()
    try:
        return x.detach().redistribute(x.device_mesh, pl)
    except RuntimeError:
        with _searching():
            return x.detach().redistribute(x.device_mesh, pl)


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
        self.reduces: Counter = Counter()
        self.dropped: Counter = Counter()
        self.masked: Counter = Counter()
        self.wrapped = 0
        self._fixes: Dict[Tuple, object] = {}

    def record(self) -> Dict:
        """`reshards` (the departures from the ideal partition) and what
        the policy did that the ideal partition does too."""
        return {"reshards": dict(sorted(self.reshards.items())),
                "shards_dropped": dict(sorted(self.dropped.items())),
                "policy": {"matmul_right_replicated": dict(
                               sorted(self.gathers.items())),
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
        flat, _ = tree_flatten((args, kwargs))
        mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
        args, kwargs = tree_map(lambda x: self._wrap(x, mesh), (args, kwargs))
        if func in _MATMULS:
            args = self._keep_left(func, args)
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
        li, free, ri, batch = _MATMULS[func]
        left, right = args[li], args[ri]
        if not (isinstance(left, DTensor) and isinstance(right, DTensor)):
            return args
        pairs = list(enumerate(zip(left.placements, right.placements)))
        split_r = lambda pr: pr.is_shard() and pr.dim not in batch  # noqa
        gather = [i for i, (pl, pr) in pairs
                  if pl.is_shard() and pl.dim in free
                  and (pr.is_partial() or split_r(pr))]
        reduce = [i for i, (pl, pr) in pairs
                  if pl.is_partial() and split_r(pr)]
        args = list(args)
        # a redistribution DTensor cannot run (an uneven `_StridedShard`)
        # leaves the choice to DTensor
        with contextlib.suppress(RuntimeError):
            if gather:
                args[ri] = _replicate_dims(right, gather)
                self.gathers[str(func)] += 1
            if reduce:
                args[li] = _replicate_dims(left, reduce)
                self.reduces[str(func)] += 1
        return tuple(args)

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
