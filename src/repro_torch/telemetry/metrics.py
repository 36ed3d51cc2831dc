"""Latency histogram (port of `repro/telemetry/metrics.py`,
`DEFAULT_EDGES` and `LatencyHistogram` only; the metrics registry and its
Prometheus / JSONL export are ROADMAP Queue 1 item 11). Pure numpy."""
from __future__ import annotations

from typing import Optional

import numpy as np

# 60 log-spaced bins across 0.1 s .. 1e5 s, plus underflow/overflow slots —
# the QoS response-latency range this simulator spans (re-exported by
# `traffic.metrics`, its historical home).
DEFAULT_EDGES = np.geomspace(1e-1, 1e5, 61).astype(np.float32)


class LatencyHistogram:
    """Fixed-bin streaming histogram with percentile estimation.

    Slot semantics (matching `np.searchsorted(edges, v)` /
    `traffic.metrics.bucketize_counts`): slot 0 is the underflow,
    holding values in (-inf, edges[0]]; slot i >= 1 holds
    (edges[i-1], edges[i]]; the last slot is the overflow
    (> edges[-1]).

    Percentiles interpolate linearly inside the resolved slot.
    Sub-range resolution at the extremes is bounded by the edges:

    * the underflow slot interpolates over [0, edges[0]] — values below
      edges[0] are reported no finer than that sub-range (callers whose
      data can sit far below edges[0] should pick tighter edges, e.g.
      `telemetry.profile.DECISION_EDGES` for decision latencies);
    * the overflow slot clamps to edges[-1] (the histogram cannot know
      how far past the top edge the mass sits — pair with an exact
      running max, as `StreamAggregator` does);
    * q == 0 resolves to the lower edge of the first *occupied* slot
      (it used to report 0.0 regardless of where the data sat).
    """

    def __init__(self, edges: Optional[np.ndarray] = None):
        self.edges = np.asarray(DEFAULT_EDGES if edges is None else edges,
                                np.float64)
        self.counts = np.zeros(len(self.edges) + 1, np.int64)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def add_counts(self, counts) -> None:
        self.counts += np.asarray(counts, np.int64)

    def add_values(self, values) -> None:
        idx = np.searchsorted(self.edges, np.asarray(values, np.float64))
        np.add.at(self.counts, idx, 1)

    def percentile(self, q: float) -> float:
        """q in [0, 1]; linear interpolation inside the resolved slot
        (see the class docstring for the underflow/overflow sub-range
        behaviour at the extremes)."""
        total = self.total
        if total == 0:
            return float("nan")
        target = q * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if self.counts[i] == 0:
            # only reachable at target == 0 (q == 0) with empty leading
            # slots: resolve to the first occupied slot's lower edge
            # instead of interpolating from an empty one
            i = int(np.argmax(self.counts > 0))
            return float(self.edges[i - 1] if i >= 1 else 0.0)
        lo = self.edges[i - 1] if i >= 1 else 0.0
        hi = self.edges[i] if i < len(self.edges) else self.edges[-1]
        prev = cum[i - 1] if i >= 1 else 0
        frac = (target - prev) / max(int(self.counts[i]), 1)
        return float(lo + np.clip(frac, 0.0, 1.0) * (hi - lo))
