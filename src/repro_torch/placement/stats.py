"""Per-window demand statistics the placement policies consume (port of
`repro/placement/stats.py`, a copy).

`DemandStats` counts, per stream and per window, how many arriving tasks
fell into each (model, gang-size) cell. The counts come straight from the
built window's host-side task columns — the same tasks the fast scheduler
is about to see — so the slow timescale observes exactly the demand the
fast one serves, on one continuous clock. Placement for window w+1 is
planned *after* window w's seam from windows <= w: the policy never peeks
at arrivals it has not yet been shown.

History is bounded (`history` windows, default 64): the EWMA, trend and
seasonal accessors below only ever look that far back, so a million-window
stream holds O(history * B * M * NC) floats.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

#: the paper's collaboration-requirement support (workload.TraceConfig)
DEFAULT_C_SUPPORT: Tuple[int, ...] = (1, 2, 4, 8)


class DemandStats:
    """Rolling (stream, model, gang-size-bin) demand counts.

    `observe(model, c)` folds one window's (B, K) task columns; accessors
    return (M, NC) float arrays for one stream. `windows` is the number of
    windows observed so far — the window about to be planned has index
    `windows` (0-based), which is what the seasonal accessor phases on.
    """

    def __init__(self, num_streams: int, num_models: int,
                 c_support: Tuple[int, ...] = DEFAULT_C_SUPPORT,
                 history: int = 64):
        if num_models < 1:
            raise ValueError(f"num_models must be >= 1, got {num_models}")
        if not c_support or list(c_support) != sorted(set(c_support)):
            raise ValueError(f"c_support must be sorted unique gang sizes, "
                             f"got {c_support}")
        self.B = int(num_streams)
        self.M = int(num_models)
        self.c_support = tuple(int(c) for c in c_support)
        self.NC = len(self.c_support)
        self._hist: deque = deque(maxlen=int(history))   # (B, M, NC) arrays
        self.windows = 0
        self.total = np.zeros((self.B, self.M, self.NC), np.float64)

    # ------------------------------------------------------------------
    def observe(self, model: np.ndarray, c: np.ndarray) -> None:
        """Fold one window's task columns: `model` and `c` are (B, K) int
        arrays (the built window, leftovers included — backlog is demand
        too). Gang sizes between support points bin to the next size DOWN
        (a placed gang of the smaller size still serves part of the load);
        models outside [0, M) are ignored."""
        model = np.asarray(model)
        c = np.asarray(c)
        if model.shape != c.shape or model.ndim != 2 \
                or model.shape[0] != self.B:
            raise ValueError(f"expected (B={self.B}, K) model/c columns, got "
                             f"{model.shape} / {c.shape}")
        sup = np.asarray(self.c_support)
        cbin = np.clip(np.searchsorted(sup, c, side="right") - 1, 0,
                       self.NC - 1)
        counts = np.zeros((self.B, self.M, self.NC), np.float64)
        ok = (model >= 0) & (model < self.M)
        flat = model.clip(0, self.M - 1) * self.NC + cbin
        for b in range(self.B):
            counts[b] = np.bincount(
                flat[b][ok[b]], minlength=self.M * self.NC
            ).reshape(self.M, self.NC)
        self._hist.append(counts)
        self.total += counts
        self.windows += 1

    # -- accessors (one stream, (M, NC) each) ---------------------------
    def last(self, b: int) -> np.ndarray:
        if not self._hist:
            return np.zeros((self.M, self.NC), np.float64)
        return self._hist[-1][b]

    def history(self, b: int) -> List[np.ndarray]:
        return [h[b] for h in self._hist]

    def ewma(self, b: int, alpha: float) -> np.ndarray:
        """EWMA over the retained history (oldest first): recomputed per
        call so the value is a pure function of the retained windows —
        deterministic regardless of when it is asked for."""
        out = np.zeros((self.M, self.NC), np.float64)
        first = True
        for h in self._hist:
            out = h[b].copy() if first else alpha * h[b] + (1 - alpha) * out
            first = False
        return out

    def seasonal(self, b: int, period: int, phase: int) -> np.ndarray:
        """Mean demand over retained windows sharing `phase` modulo
        `period` (window i in the retained deque has absolute index
        `windows - len(hist) + i`)."""
        if period <= 1:
            return self.last(b)
        base = self.windows - len(self._hist)
        picks = [h[b] for i, h in enumerate(self._hist)
                 if (base + i) % period == phase % period]
        if not picks:
            return np.zeros((self.M, self.NC), np.float64)
        return np.mean(picks, axis=0)
