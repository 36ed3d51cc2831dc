"""Per-step recurrences that the dry-run traces as two counted steps (the
seam between the models' loops and `launch.steps.Lowered.analyze`, as
`sharding.context` is for the activation constraints).

    scan(site, step, carry, xs, n) -> (ys, carry)

runs `carry, y_t = step(carry, xs, t)` for t in range(n) and returns the
y_t stacked along dim 1 with the last carry: the Mamba scan's plain version
(`kernels/ssm_scan/ref.py`), the mLSTM and the sLSTM recurrences
(`models/blocks.py`), the blocked attention's query and KV block loops
(`models/attention.py`). `step` slices step t of the whole sequences in `xs`
itself. A step's y_t is a tensor, a tuple of tensors (each stacked) or None
(a loop that only carries). Unarmed (everywhere but the dry-run) `scan` is
that loop and nothing else.

The dry-run arms a `LoopScaler` around a step (`scaled_loops`) with its
counters: objects with `snapshot()` and `restore(snapshot)`, whose
snapshots are numbers, dicts of numbers and tuples of those. The reference
lowers each recurrence as a `lax.scan` whose body XLA counts once; the port
traces eagerly, and a loop of 4k or 32k DTensor steps a layer does not end
in the trace's budget. An armed scan of n > 2 steps therefore runs

* step 0 as itself: it starts from the initial state (a plain tensor the
  reshard policy replicates, no gradient to it), unlike the others;
* step 1 once, standing for steps 1 .. n - 1: what the counters saw of it,
  `after - before`, is added n - 2 more times (`LoopScaler.repeated`);

and builds the (B, n, ...) output from the two steps' outputs with one
`torch.cat` (step 1's expanded), which writes the bytes the loop's
`torch.stack` writes. The carry it returns is step 1's, of the loop's
shapes (a prefill copies it into the cache); the values are not the
loop's. Where autograd records, step 1 is a `torch.autograd.Function`
(`_StandIn`) whose backward runs step 1's backward under the same scale and
adds, n - 2 times, the out-of-place sum by which the autograd engine
accumulates each step's gradient of a whole sequence (its select's
backward, a full-length tensor) or of a weight every step reads. The graph
of step 1 that its backward needs is rebuilt there uncounted (the eager
loop keeps every step's graph), and so is the gradient its carry gets from
the next step: the one step 1 gives its own input carry, placed as the
loop's are. `LoopScaler.record()` names each scaled loop's site with its
count of loops and its trip count. A scan inside an armed step (the
attention's KV loop inside its query loop) is scaled inside the outer
repeat, so its counts, and its count of loops, multiply.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

Ys = Union[torch.Tensor, Tuple[torch.Tensor, ...], None]

Step = Callable[[Tuple, Tuple, int], Tuple[Tuple, Ys]]


def _extrapolate(before, after, k: int):
    """`after` plus (after - before) x k, through dicts and tuples; a key
    new since `before` that comes to 0 is dropped."""
    if isinstance(after, dict):
        out = ((key, _extrapolate(before.get(key, 0), v, k))
               for key, v in after.items())
        return type(after)({key: v for key, v in out
                            if v != 0 or key in before})
    if isinstance(after, (tuple, list)):
        return type(after)(_extrapolate(b, a, k)
                           for b, a in zip(before, after))
    return after + (after - before) * k


class LoopScaler:
    """The armed state: the counters to scale and the loops scaled so far
    ((site, trip count) -> loops)."""

    def __init__(self, counters: Sequence):
        self.counters = tuple(counters)
        self.loops: Counter = Counter()

    @contextmanager
    def repeated(self, k: int):
        """What the counters see inside counts 1 + k times (k = -1: not at
        all)."""
        before = [c.snapshot() for c in self.counters]
        loops = Counter(self.loops)
        yield
        for c, b in zip(self.counters, before):
            c.restore(_extrapolate(b, c.snapshot(), k))
        self.loops = _extrapolate(loops, self.loops, k)

    def record(self) -> Dict:
        """site -> {"loops", "trip_count"}; a site scaled at two trip
        counts is keyed "site@n" for each."""
        sites = Counter(site for site, _ in self.loops)
        return {(site if sites[site] == 1 else f"{site}@{n}"):
                {"loops": count, "trip_count": n}
                for (site, n), count in sorted(self.loops.items())}

    def scan(self, site: str, step: Step, carry: Tuple, xs: Tuple, n: int):
        self.loops[site, n] += 1
        carry, y0 = step(carry, xs, 0)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in carry + tuple(xs)):
            outs = _StandIn.apply(self, n - 2, step, len(carry), *carry, *xs)
            carry, y1 = outs[:len(carry)], _unflat(outs[len(carry):], y0)
        else:
            with self.repeated(n - 2):
                carry, y1 = step(carry, xs, 1)

        def cat(a, b):
            rest = b.unsqueeze(1).expand(
                (b.shape[0], n - 1) + tuple(b.shape[1:]))
            return torch.cat([a.unsqueeze(1), rest], dim=1)
        return _map(cat, y0, y1), carry


def _flat(y: Ys) -> Tuple:
    return () if y is None else tuple(y) if isinstance(y, tuple) else (y,)


def _unflat(flat: Sequence, like: Ys) -> Ys:
    """`flat` in the structure of `like` (a tensor, a tuple or None)."""
    return (None if like is None else tuple(flat) if isinstance(like, tuple)
            else flat[0])


def _map(fn, *ys: Ys) -> Ys:
    """`fn` over the tensors of step outputs of one structure."""
    return _unflat([fn(*t) for t in zip(*map(_flat, ys))], ys[0])


class _StandIn(torch.autograd.Function):
    """Step 1 of an armed scan, standing for steps 1 .. n - 1 (k = n - 2
    more): forward and backward counted 1 + k times. Outputs: the carry,
    then the step's outputs (a clone of one that is a carry tensor, the
    sLSTM's h)."""

    @staticmethod
    def forward(ctx, scaler, k, step, n_carry, *tensors):
        with scaler.repeated(k):
            carry, y = step(tensors[:n_carry], tensors[n_carry:], 1)
        ctx.save_for_backward(*tensors)
        ctx.args = (scaler, k, step, n_carry)
        ctx.set_materialize_grads(False)
        return (*carry, *(t.clone() if any(t is c for c in carry) else t
                          for t in _flat(y)))

    @staticmethod
    def backward(ctx, *grads):
        # unpacked first: a remat's recomputation of the period runs here,
        # counted as the forward it is
        saved = ctx.saved_tensors
        scaler, k, step, n_carry = ctx.args
        need = ctx.needs_input_grad[4:]
        grads = list(grads)
        with torch.enable_grad():
            with scaler.repeated(-1):
                ins = [x.detach().requires_grad_(w)
                       for x, w in zip(saved, need)]
                carry, y = step(tuple(ins[:n_carry]), tuple(ins[n_carry:]), 1)
                outs = (*carry, *_flat(y))
                # a step's carry has the next step's gradient: the one
                # this step gives its own carry, placed as the loop's are
                missing = [i for i in range(n_carry) if grads[i] is None]
                if missing:
                    seed = [torch.zeros_like(o) if i in missing else g
                            for i, (o, g) in enumerate(zip(outs, grads))]
                    back = _grad(outs, seed, ins[:n_carry], retain_graph=True)
                    for i in missing:
                        grads[i] = seed[i] if back[i] is None else back[i]
            with scaler.repeated(k):
                got = _grad(outs, grads, ins)
            with scaler.repeated(k - 1):
                for g in got[n_carry:]:
                    if g is not None:
                        g + g   # noqa: B018 - counted, not used
        return (None,) * 4 + tuple(got)


def _grad(outs, grads, wrt, **kw):
    """`torch.autograd.grad` of the outputs that have a gradient, None for
    an input that does not require one."""
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    got = iter(torch.autograd.grad(
        [o for o, _ in pairs], [x for x in wrt if x.requires_grad],
        [g for _, g in pairs], allow_unused=True, **kw))
    return [next(got) if x.requires_grad else None for x in wrt]


_SCALER: ContextVar[Optional[LoopScaler]] = ContextVar("loop_scaler",
                                                       default=None)


@contextmanager
def scaled_loops(counters: Sequence):
    """Arm a `LoopScaler` over `counters` for the scans run inside."""
    scaler = LoopScaler(counters)
    tok = _SCALER.set(scaler)
    try:
        yield scaler
    finally:
        _SCALER.reset(tok)


def scan(site: str, step: Step, carry: Tuple, xs: Tuple, n: int):
    """(the n steps' outputs stacked along dim 1, the last carry)."""
    scaler = _SCALER.get()
    if scaler is not None and n > 2:
        return scaler.scan(site, step, tuple(carry), tuple(xs), n)
    ys = []
    for t in range(n):
        carry, y = step(carry, xs, t)
        ys.append(y)
    return _map(lambda *y: torch.stack(y, dim=1), *ys), carry
