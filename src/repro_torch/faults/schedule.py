"""Deterministic host-side fault schedules (port of
`repro/faults/schedule.py`, a copy: numpy `SeedSequence` draws, so the
port's arrays are byte-identical to the reference's).

`FaultTimeline` materialises a `FaultSpec` into concrete per-server
crash/recovery intervals and per-window straggler factors, then slices them
into the fixed-shape device arrays the fused decision step consumes:

    f_down_start  (B, E, F) f32  window-local down-interval starts
    f_down_end    (B, E, F) f32  window-local down-interval ends
    f_slow        (B, E)    f32  execution-time multiplier (>= 1)
    f_cold        (B, 1)    f32  1.0 when crashes wipe the model cache

Crash intervals are an alternating Exp(mtbf)/Exp(mttr) renewal process per
(stream, server) on the ABSOLUTE stream clock, drawn lazily from a
counter-seeded numpy generator — the timeline is a pure function of
(spec.seed, stream, server), independent of window boundaries, batch order,
or execution backend. Window `w` sees the intervals overlapping
[t0, t0 + horizon) rebased to the window-local clock (starts may be
negative for a window that opens mid-outage); unused slots pad at INF so
every device-side test (`start <= t < end`) is vacuously false.

Everything here is numpy on the host; the arrays ride inside the rollout's
`traces` dict beside the task columns, and the decision step's fault mode
reads them (on the card, the fault instantiation of `csrc/env_step.cu`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.faults.spec import FaultSpec

INF = np.float32(1e30)

#: trace keys the fused decision step consumes (presence = faults enabled)
FAULT_COLS = ("f_down_start", "f_down_end", "f_slow", "f_cold")
#: per-task retry-count column threaded through the window for the seam
RETRY_COL = "f_retries"


def _rng(*tokens: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(t) & 0xFFFFFFFF for t in tokens]))


class FaultTimeline:
    """Lazily-extended absolute crash timeline + per-window array slicer.

    One instance per run (the StreamRunner / Simulator owns it); windows
    must be requested with non-decreasing `t0` per stream (the stream clock
    only moves forward), which lets the timeline prune spent intervals.
    """

    def __init__(self, spec: FaultSpec, num_servers: int,
                 num_streams: int = 1):
        self.spec = spec
        self.E = int(num_servers)
        self.B = int(num_streams)
        # per (stream, server): absolute (start, end) down intervals
        self._events = [[[] for _ in range(self.E)] for _ in range(self.B)]
        self._rngs = [[_rng(spec.seed, 0xC7A5, b, e) for e in range(self.E)]
                      for b in range(self.B)]
        self._gen_until = np.zeros((self.B, self.E), np.float64)
        self.down_events = 0            # intervals materialised so far
        self.overflow_events = 0        # intervals beyond max_down_events

    # ------------------------------------------------------------------
    def _extend(self, b: int, e: int, until: float) -> None:
        """Grow (b, e)'s renewal process to cover [0, until)."""
        if self.spec.mtbf <= 0.0:
            self._gen_until[b, e] = max(self._gen_until[b, e], until)
            return
        rng = self._rngs[b][e]
        t = self._gen_until[b, e]
        while t < until:
            up = rng.exponential(self.spec.mtbf)
            down = rng.exponential(self.spec.mttr)
            start = t + up
            self._events[b][e].append((start, start + down))
            self.down_events += 1
            t = start + down
        self._gen_until[b, e] = t

    def window_arrays(self, window: int, t0: np.ndarray,
                      horizon: float) -> Dict[str, np.ndarray]:
        """Fixed-shape fault arrays for one window.

        `t0` is the (B,) absolute epoch of each stream's window start;
        `horizon` bounds how far past t0 crash intervals are materialised —
        it must cover the window's decision span (`ecfg.time_limit`) plus
        the longest possible in-flight execution, so a crash landing inside
        any schedulable gang's run is visible at schedule time.
        """
        B, E, F = self.B, self.E, int(self.spec.max_down_events)
        t0 = np.asarray(t0, np.float64)
        if t0.shape != (B,):
            raise ValueError(f"t0 must be shape ({B},), got {t0.shape}")
        ds = np.full((B, E, F), INF, np.float32)
        de = np.full((B, E, F), INF, np.float32)
        for b in range(B):
            for e in range(E):
                self._extend(b, e, float(t0[b]) + float(horizon))
                # prune intervals fully behind this window (the stream
                # clock is monotonic, so they can never be needed again)
                evs = [ev for ev in self._events[b][e] if ev[1] > t0[b]]
                self._events[b][e] = evs
                if len(evs) > F:
                    self.overflow_events += len(evs) - F
                    evs = evs[:F]
                for i, (s, t_end) in enumerate(evs):
                    ds[b, e, i] = np.float32(s - t0[b])
                    de[b, e, i] = np.float32(t_end - t0[b])
        slow = np.ones((B, E), np.float32)
        if self.spec.straggler_prob > 0.0:
            for b in range(B):
                r = _rng(self.spec.seed, 0x57A6, window, b)
                hit = r.random(E) < self.spec.straggler_prob
                slow[b] = np.where(hit, self.spec.straggler_factor,
                                   1.0).astype(np.float32)
        cold = np.full((B, 1), 1.0 if self.spec.cold_restart else 0.0,
                       np.float32)
        return {"f_down_start": ds, "f_down_end": de, "f_slow": slow,
                "f_cold": cold}

    # ------------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return {"down_events": int(self.down_events),
                "down_events_truncated": int(self.overflow_events)}


def fault_horizon(time_limit: float, spec: Optional[FaultSpec] = None
                  ) -> float:
    """Crash-visibility horizon past a window's t0: the decision span plus a
    generous bound on in-flight execution (Table-VI init ~36 s + 50 steps
    at the slowest per-step cost, times the worst straggler factor)."""
    overhang = 36.0 + 0.53 * 50.0
    if spec is not None and spec.straggler_prob > 0.0:
        overhang *= float(spec.straggler_factor)
    return float(time_limit) + overhang


def retry_backoff(spec: FaultSpec, retries: int) -> float:
    """Capped exponential backoff before re-admission attempt `retries`
    (1-indexed: the first retry waits `backoff_base`)."""
    return float(min(spec.backoff_base * (2.0 ** max(retries - 1, 0)),
                     spec.backoff_cap))
