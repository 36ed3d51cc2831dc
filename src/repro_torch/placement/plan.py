"""Gang-layout planner: demand weights -> a concrete pre-warmed layout (port
of `repro/placement/plan.py`, a copy).

`plan_stream` turns one stream's (M, NC) demand weights into new
`(server_model, server_gang, server_gang_size)` arrays over that stream's
idle servers, honouring the env's reuse contract exactly: the fast
scheduler (`env._select_servers`) reuses a gang iff a COMPLETE idle gang
with matching model and exact size exists, so pre-warming must form whole
synthetic gangs — writing `server_model` alone warms nothing.

Greedy credit-halving: repeatedly pick the highest-credit (model, c) cell,
place one gang of that shape, halve the cell's credit (so a cell with 2x
the demand ends up with ~2x the gangs), and stop when idle capacity or
credit runs out. Placed gangs then bind to servers in three passes:

1. *keep*: an existing complete idle gang already matching (model, c) is
   consumed as-is — zero churn, zero counters;
2. *bind*: remaining gangs pick idle servers cheapest-first — a server
   already holding the model costs nothing (no prefetch), an empty server
   costs a prefetch, a server holding another model costs an eviction plus
   a prefetch;
3. leftovers keep whatever they held (placement never evicts a model it
   does not need the server for — an un-planned warm server can still get
   lucky).

Gang labels follow the seam convention (`traffic.stream._window_seam`):
`K + min(member index)` in [K, K+E), collision-free against next-window
task ids [0, K) and against carried busy gangs (their leaders are busy;
placed leaders are idle — disjoint index sets).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np


class StreamPlacement(NamedTuple):
    """One stream's planned layout + what changed (serving prefetch/evict
    consume the masks; the sim just writes the arrays into the carry)."""
    model: np.ndarray        # (E,) i32 target resident model per server
    gang: np.ndarray         # (E,) i32 gang label (seam convention)
    gang_size: np.ndarray    # (E,) i32
    prefetch: np.ndarray     # (E,) bool — resident model changed
    evict: np.ndarray        # (E,) bool — a previously-resident model left
    counters: Dict[str, int]


def _intact_idle_gangs(idle: np.ndarray, model: np.ndarray,
                       gang: np.ndarray, gang_size: np.ndarray):
    """{label: (member indices, model)} of COMPLETE idle gangs — every
    server sharing the label is idle and the count matches the recorded
    size (the env's reuse test, host-side)."""
    out = {}
    for g in np.unique(gang[idle & (gang >= 0)]):
        members = np.flatnonzero(gang == g)
        size = gang_size[members[0]]
        if size > 0 and len(members) == size and idle[members].all() \
                and (gang_size[members] == size).all() \
                and (model[members] == model[members[0]]).all():
            out[int(g)] = (members, int(model[members[0]]))
    return out


def plan_gangs(weights: np.ndarray, capacity: int,
               c_support: Tuple[int, ...],
               max_gangs_per_cell: int = 0) -> list:
    """Demand weights -> ordered [(model, c), ...] gang shapes fitting in
    `capacity` idle servers, by greedy credit-halving (ties break to the
    lowest model then smallest c — np.argmax on the flat array)."""
    credit = np.asarray(weights, np.float64).copy()
    M, NC = credit.shape
    placed = np.zeros((M, NC), np.int64)
    out = []
    remaining = int(capacity)
    while remaining > 0 and credit.max() > 0.0:
        flat = int(np.argmax(credit))
        m, j = divmod(flat, NC)
        c = int(c_support[j])
        full = max_gangs_per_cell > 0 and placed[m, j] >= max_gangs_per_cell
        if c > remaining or full:
            credit[m, j] = 0.0
            continue
        out.append((m, c))
        placed[m, j] += 1
        remaining -= c
        credit[m, j] *= 0.5
    return out


def plan_stream(weights: np.ndarray, idle: np.ndarray, model: np.ndarray,
                gang: np.ndarray, gang_size: np.ndarray,
                c_support: Tuple[int, ...], K: int,
                max_gangs_per_cell: int = 0) -> StreamPlacement:
    """One stream's placement: see the module docstring for the algorithm.

    `idle` is the (E,) idle mask; `model`/`gang`/`gang_size` are the
    carried arrays. Busy servers are never touched.
    """
    idle = np.asarray(idle, bool)
    new_model = np.asarray(model, np.int32).copy()
    new_gang = np.asarray(gang, np.int32).copy()
    new_size = np.asarray(gang_size, np.int32).copy()
    prefetch = np.zeros(new_model.shape, bool)
    evict = np.zeros(new_model.shape, bool)

    targets = plan_gangs(weights, int(idle.sum()), c_support,
                         max_gangs_per_cell)

    # pass 1: consume existing matching complete idle gangs (zero churn)
    free = idle.copy()
    existing = _intact_idle_gangs(idle, new_model, new_gang, new_size)
    kept = 0
    unbound = []
    for m, c in targets:
        hit = next((g for g, (mem, gm) in sorted(existing.items())
                    if gm == m and len(mem) == c), None)
        if hit is not None:
            free[existing.pop(hit)[0]] = False
            kept += 1
        else:
            unbound.append((m, c))

    # pass 2: bind the rest cheapest-first (model hit < empty < evict)
    for m, c in unbound:
        cand = np.flatnonzero(free)
        if len(cand) < c:       # defensive: plan_gangs bounded total servers
            continue            # by idle capacity, so this cannot fire
        cost = np.where(new_model[cand] == m, 0,
                        np.where(new_model[cand] < 0, 1, 2))
        members = cand[np.lexsort((cand, cost))][:c]
        free[members] = False
        changed = new_model[members] != m
        prefetch[members] |= changed
        evict[members] |= changed & (new_model[members] >= 0)
        new_model[members] = m
        new_gang[members] = K + int(members.min())
        new_size[members] = c

    counters = {"gangs_planned": len(targets), "gangs_kept": kept,
                "gangs_bound": len(unbound),
                "prefetches": int(prefetch.sum()),
                "evictions": int(evict.sum())}
    return StreamPlacement(model=new_model, gang=new_gang,
                           gang_size=new_size, prefetch=prefetch,
                           evict=evict, counters=counters)
