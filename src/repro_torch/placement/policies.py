"""Placement-policy registry: demand weights for the slow timescale (port
of `repro/placement/policies.py`, a copy).

A placement policy is a pure function

    fn(spec: PlacementSpec, stats: DemandStats, stream: int) -> (M, NC) f64

returning non-negative *demand weights* over (model, gang-size) cells —
how much the next window is expected to want each cell. The planner
(`placement.plan`) turns weights into a concrete gang layout; policies
never touch servers. Registering a name makes it a valid
`PlacementSpec(policy=...)` — the hook for a learned placement actor later
is exactly `@register_placement("learned")` around a params-closing
callable.

Built-ins (the two-timescale caching paper, PAPERS.md):

    none      zero weights — never called in practice (an inactive spec is
              short-circuited before planning), registered so the name
              validates.
    static    a fixed prior: outer(model_probs, c_probs), demand-blind.
    lfu       the trailing window's observed counts (least-frequently-used
              models lose their servers first); falls back to the static
              prior before any window has been observed.
    forecast  EWMA over the window history plus a trend boost
              `trend_gain * (last - ewma)` clamped at zero — a flash crowd
              on a cold model shows up as a large positive trend one window
              after it starts — blended 50/50 with the seasonal mean when
              `spec.period` is set (diurnal cells).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.placement.stats import DemandStats

#: the paper's D_c marginal (workload.TraceConfig.c_probs) — the default
#: gang-size prior when a spec does not pin its own
DEFAULT_C_PRIOR: Tuple[float, ...] = (0.35, 0.35, 0.2, 0.1)

PlacementPolicy = Callable[["PlacementSpec", DemandStats, int], np.ndarray]

_REGISTRY: Dict[str, PlacementPolicy] = {}


def register_placement(name: str):
    """Decorator: register a placement policy under `name` (also makes the
    name a valid `PlacementSpec.policy`)."""
    def deco(fn: PlacementPolicy) -> PlacementPolicy:
        _REGISTRY[str(name)] = fn
        return fn
    return deco


def known_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_placement_policy(name: str) -> PlacementPolicy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r}; known: "
                       f"{known_policies()}") from None


# ----------------------------------------------------------------------
def _normalised(probs: Tuple[float, ...], n: int,
                fallback: Tuple[float, ...]) -> np.ndarray:
    """Spec probs -> length-n simplex vector: () takes the fallback,
    short vectors pad with zero, long ones truncate, then renormalise."""
    src = probs if probs else fallback
    v = np.zeros(n, np.float64)
    v[:min(len(src), n)] = np.asarray(src[:n], np.float64)
    s = v.sum()
    return v / s if s > 0 else np.full(n, 1.0 / n)


def prior_weights(spec, M: int, c_support: Tuple[int, ...]) -> np.ndarray:
    """The static (M, NC) prior: outer(model popularity, gang-size mix)."""
    mp = _normalised(spec.model_probs, M, tuple([1.0] * M))
    cp = _normalised(spec.c_probs, len(c_support), DEFAULT_C_PRIOR)
    return np.outer(mp, cp)


# ----------------------------------------------------------------------
@register_placement("none")
def _none(spec, stats: DemandStats, b: int) -> np.ndarray:
    return np.zeros((stats.M, stats.NC), np.float64)


@register_placement("static")
def _static(spec, stats: DemandStats, b: int) -> np.ndarray:
    return prior_weights(spec, stats.M, stats.c_support)


@register_placement("lfu")
def _lfu(spec, stats: DemandStats, b: int) -> np.ndarray:
    last = stats.last(b)
    if last.sum() <= 0:
        return prior_weights(spec, stats.M, stats.c_support)
    return last.copy()


@register_placement("forecast")
def _forecast(spec, stats: DemandStats, b: int) -> np.ndarray:
    if stats.windows == 0:
        return prior_weights(spec, stats.M, stats.c_support)
    last = stats.last(b)
    ew = stats.ewma(b, spec.ewma_alpha)
    w = np.maximum(ew + spec.trend_gain * (last - ew), 0.0)
    if spec.period > 1 and stats.windows >= spec.period:
        # the window being planned has absolute index stats.windows
        seas = stats.seasonal(b, spec.period, stats.windows % spec.period)
        w = 0.5 * w + 0.5 * seas
    return w
