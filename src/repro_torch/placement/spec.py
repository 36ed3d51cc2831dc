"""`PlacementSpec` — the frozen, hashable description of the slow timescale
(port of `repro/placement/spec.py`, a copy).

The paper's fast scheduler decides *which task runs where* every event; the
two-timescale extension ("Two-Timescale Model Caching and Resource
Allocation for Edge-Enabled AI-Generated Content Services", PAPERS.md) adds
a slow decision — *which models stay resident where* — taken once per
stream-window seam. This spec names the placement policy and its knobs:

* ``policy="none"``: no slow timescale. Nothing is attached anywhere, so
  every decision program — and therefore every result — is bitwise-identical
  to a run without the spec (the `faults=None` static-presence pattern).
* ``policy="static"``: pin a fixed layout from prior popularity
  (`model_probs` x `c_probs`), independent of observed demand.
* ``policy="lfu"``: demand-weighted from the *trailing window's* per-model
  arrival counts (least-frequently-used models lose their servers first).
* ``policy="forecast"``: EWMA predictor over the per-window arrival history
  with a trend boost (`trend_gain`) that reacts to rising demand faster
  than the EWMA alone — the flash-crowd-on-a-cold-model case — plus an
  optional seasonal average over a known `period` (in windows).

New policies (e.g. a learned placement actor) register through
`repro_torch.placement.policies.register_placement`; the spec validates its
`policy` name against that registry, so a registered name is a valid spec.

The spec rides on ``StreamConfig(placement=...)``; it is frozen and
hashable so it can key program caches (it never reaches one: placement runs
on the host between windows).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PlacementSpec:
    policy: str = "none"
    # -- cadence ---------------------------------------------------------
    interval: int = 1              # decide every N window seams
    # -- forecast predictor ---------------------------------------------
    ewma_alpha: float = 0.5        # EWMA smoothing of per-window demand
    trend_gain: float = 1.5        # boost for (last - ewma) demand rises
    period: int = 0                # seasonal period in windows; 0 = off
    # -- static prior (also the lfu/forecast cold-start prior) -----------
    model_probs: Tuple[float, ...] = ()   # per-model popularity; () = uniform
    c_probs: Tuple[float, ...] = ()       # gang-size prior over (1, 2, 4, 8);
    #                                       () = the paper's task mix
    # -- planner ---------------------------------------------------------
    max_gangs_per_cell: int = 0    # cap per (model, c) demand cell; 0 = none

    def __post_init__(self):
        from repro_torch.placement.policies import known_policies
        if self.policy not in known_policies():
            raise ValueError(
                f"placement policy must be one of {known_policies()}, "
                f"got {self.policy!r}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if self.trend_gain < 0.0:
            raise ValueError(
                f"trend_gain must be >= 0, got {self.trend_gain}")
        if self.period < 0:
            raise ValueError(f"period must be >= 0, got {self.period}")
        if self.max_gangs_per_cell < 0:
            raise ValueError("max_gangs_per_cell must be >= 0")
        for name, probs in (("model_probs", self.model_probs),
                            ("c_probs", self.c_probs)):
            if probs and (min(probs) < 0.0 or sum(probs) <= 0.0):
                raise ValueError(f"{name} must be non-negative with a "
                                 f"positive sum, got {probs}")

    # ------------------------------------------------------------------
    @property
    def active(self) -> bool:
        """True when this spec places anything at all. An inactive spec
        (``PlacementSpec.none()``) touches no state: the carried stream
        state, the decision programs, and every result are bitwise-identical
        to running with ``placement=None``."""
        return self.policy != "none"

    @classmethod
    def none(cls) -> "PlacementSpec":
        """The explicit no-placement spec."""
        return cls()


def placement_active(spec) -> bool:
    """None-tolerant activity test used by every plumbing layer."""
    return spec is not None and spec.active
