"""`PlacementManager` — the slow timescale's stateful controller (port of
`repro/placement/manager.py`).

One instance per `StreamRunner` (constructed only when the spec is
active). The runner feeds it two host-side touchpoints per window:

    observe_window(w, cols)   after `_build_window`: fold the window's
                              (B, K) model/c columns into `DemandStats`
    apply(carry, w)           after `_window_seam`: plan a layout from
                              windows <= w and write it into the carried
                              `EnvState` for window w+1

The carry's server tensors are read to the host once per planning seam and
the new layout is written back as new tensors on the carry's device. `apply`
replaces ONLY those carried tensors between windows — never a trace
column, never a decision program — so `placement=None` (no manager at all)
runs byte-for-byte the programs and results it always did.

Fault interaction needs no code here: the decision step's cold-restart
wipe (`env.decision_step`) erases any placed cache whose server has
crashed, idempotently, before every selection — a stale placement can
never outlive a cold restart.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import env as EV
from repro_torch.placement.plan import StreamPlacement, plan_stream
from repro_torch.placement.policies import get_placement_policy
from repro_torch.placement.spec import PlacementSpec
from repro_torch.placement.stats import DEFAULT_C_SUPPORT, DemandStats
from repro_torch.telemetry.trace import NULL_TRACER


class PlacementDecision(NamedTuple):
    """One seam's applied placement: per-stream layouts + this decision's
    counter deltas. Execution backends with real weights implement
    `apply_placement(decision)` (serving prefetches/evicts off the timed
    path); the simulated backends need nothing beyond the carry write."""
    window: int
    streams: List[StreamPlacement]
    counters: Dict[str, int]


class PlacementManager:
    def __init__(self, spec: PlacementSpec, ecfg: EV.EnvConfig,
                 num_streams: int = 1, tracer=None):
        if not spec.active:
            raise ValueError("PlacementManager needs an active spec; gate "
                             "construction on placement_active(spec)")
        self.spec = spec
        self.ecfg = ecfg
        self.B = int(num_streams)
        self.tracer = NULL_TRACER if tracer is None else tracer
        # gang sizes larger than the cluster can never be placed
        support = tuple(c for c in DEFAULT_C_SUPPORT
                        if c <= ecfg.num_servers) or (1,)
        self.stats = DemandStats(self.B, ecfg.num_models, support)
        self._policy = get_placement_policy(spec.policy)
        self._counters = {"decisions": 0, "gangs_planned": 0,
                          "gangs_kept": 0, "gangs_bound": 0,
                          "prefetches": 0, "evictions": 0}

    # ------------------------------------------------------------------
    def observe_window(self, window: int, cols: Dict[str, np.ndarray]
                       ) -> None:
        """Fold one built window's demand (host numpy columns)."""
        self.stats.observe(cols["model"], cols["c"])

    def apply(self, carry: EV.EnvState, window: int
              ) -> "tuple[EV.EnvState, Optional[PlacementDecision]]":
        """Plan + write the layout into the carried state at the seam after
        `window`; returns the (possibly unchanged) carry and the decision
        (None on off-interval seams)."""
        if (window + 1) % self.spec.interval != 0:
            return carry, None
        K = self.ecfg.max_tasks
        with self.tracer.span("placement_decide", cat="placement",
                              window=window, policy=self.spec.policy):
            host = {f: getattr(carry, f).cpu().numpy() for f in
                    ("server_free_at", "server_model", "server_gang",
                     "server_gang_size")}
            streams: List[StreamPlacement] = []
            for b in range(self.B):
                weights = self._policy(self.spec, self.stats, b)
                streams.append(plan_stream(
                    weights, host["server_free_at"][b] <= 0.0,
                    host["server_model"][b], host["server_gang"][b],
                    host["server_gang_size"][b], self.stats.c_support, K,
                    self.spec.max_gangs_per_cell))
            deltas = {k: sum(s.counters[k] for s in streams)
                      for k in streams[0].counters}
            deltas["decisions"] = 1
            for k, v in deltas.items():
                self._counters[k] += v
            dev = carry.server_model.device

            def stacked(field):
                return torch.from_numpy(np.stack(
                    [getattr(s, field) for s in streams])).to(dev)
            carry = carry._replace(server_model=stacked("model"),
                                   server_gang=stacked("gang"),
                                   server_gang_size=stacked("gang_size"))
        return carry, PlacementDecision(window=window, streams=streams,
                                        counters=deltas)

    # ------------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        """Cumulative host ledger (`eat_placement_*` in the registry)."""
        return {f"placement_{k}": int(v) for k, v in self._counters.items()}
