"""Streaming QoS telemetry: O(bins) latency percentiles and run aggregates
(port of `repro/traffic/metrics.py`).

`StreamAggregator` folds per-window stats records on the host so a long run
keeps O(bins) state instead of O(tasks) samples. Latency percentiles come
from a fixed log-spaced histogram (`LatencyHistogram`) with linear
interpolation inside the resolved bin.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.telemetry.metrics import DEFAULT_EDGES, LatencyHistogram  # noqa: F401


def bucketize_counts(values: torch.Tensor, mask: torch.Tensor, edges):
    """Device-side helper (tensors in, tensor out): per-bin counts of
    values[mask] along the last axis, leading axes kept (the stream seam
    bins its (B, K) latencies per stream).

    Returns (..., len(edges)+1) int32 counts: slot 0 is the underflow
    (< edges[0]), slot i covers (edges[i-1], edges[i]], the last slot is
    overflow. `edges` is an array or a tensor."""
    e = torch.as_tensor(edges, device=values.device)
    idx = torch.searchsorted(e, values.to(e.dtype))
    counts = torch.zeros(values.shape[:-1] + (len(edges) + 1,),
                         dtype=torch.int32, device=values.device)
    return counts.scatter_add_(-1, idx, mask.to(torch.int32))


# ----------------------------------------------------------------------
# Keys the engine emits per window as (B,) arrays (summed here), plus
# "hist" as (B, bins) counts and "elapsed" as per-stream window span. The
# fault-mode keys (n_failed / n_failed_dropped / n_retried / n_readmitted)
# are optional — absent records fold in as zero.
_SUM_KEYS = ("n_injected", "n_sched", "n_done", "n_dropped", "n_reload",
             "n_viol", "n_viol_q", "n_viol_t", "sum_resp", "sum_quality",
             "sum_steps", "busy_time", "elapsed",
             "n_failed", "n_failed_dropped", "n_retried", "n_readmitted")


class StreamAggregator:
    """Folds per-window stats records into run-level QoS telemetry.

    Conventions: a *scheduled* task has a deterministic recorded finish time
    (no preemption), so scheduled counts as served for goodput; `elapsed`
    accumulates per-stream simulated seconds (stream-seconds), so rates are
    per single-cluster second averaged over the parallel streams.
    """

    def __init__(self, num_servers: int, q_min: float, resp_sla: float,
                 edges: Optional[np.ndarray] = None):
        self.num_servers = int(num_servers)
        self.q_min = float(q_min)
        self.resp_sla = float(resp_sla)
        self.hist = LatencyHistogram(edges)
        self.totals = {k: 0.0 for k in _SUM_KEYS}
        self.max_resp = 0.0
        self.num_windows = 0

    def update(self, stats: Dict[str, np.ndarray]) -> None:
        for k in _SUM_KEYS:
            if k in stats:
                self.totals[k] += float(np.sum(stats[k]))
        self.hist.add_counts(np.sum(np.asarray(stats["hist"]), axis=0))
        self.max_resp = max(self.max_resp, float(np.max(stats["max_resp"])))
        self.num_windows += 1

    # -- derived telemetry ------------------------------------------------
    def summary(self) -> Dict[str, float]:
        t = self.totals
        sched = max(t["n_sched"], 1.0)
        secs = max(t["elapsed"], 1e-9)       # stream-seconds
        good = t["n_sched"] - t["n_viol"]
        # a *resolved* task left the system: scheduled, shed by max_carry
        # backlog shedding, or dropped after exhausting its fault-retry
        # budget. Drops are QoS failures (the task was offered and never
        # served), so the headline violation/goodput rates count them — a
        # policy cannot shed its way to a better QoS score. The *_scheduled
        # variants keep the drop-exclusive (conditional on service) view.
        # Crash-then-retried tasks are still in flight (not resolved); they
        # resolve at their eventual success, shed, or retry exhaustion.
        drops = t["n_dropped"] + t["n_failed_dropped"]
        resolved = max(t["n_sched"] + drops, 1.0)
        # histogram percentiles interpolate inside a log bin, which can
        # overshoot the true maximum — clamp to the exact running max
        def pct(q):
            p = self.hist.percentile(q)
            return float(min(p, self.max_resp)) if np.isfinite(p) else p
        return {
            "num_windows": self.num_windows,
            "tasks_injected": int(t["n_injected"]),
            "tasks_scheduled": int(t["n_sched"]),
            "tasks_completed_in_window": int(t["n_done"]),
            "tasks_dropped": int(drops),
            "tasks_dropped_shed": int(t["n_dropped"]),
            "tasks_dropped_retry_exhausted": int(t["n_failed_dropped"]),
            "tasks_failed": int(t["n_failed"]),
            "tasks_retried": int(t["n_retried"]),
            "tasks_resolved": int(t["n_sched"] + drops),
            "sim_seconds": float(secs),
            "latency_p50": pct(0.50),
            "latency_p95": pct(0.95),
            "latency_p99": pct(0.99),
            "latency_mean": float(t["sum_resp"] / sched),
            "latency_max": float(self.max_resp),
            "drop_rate": float(drops / resolved),
            "qos_violation_rate": float((t["n_viol"] + drops) / resolved),
            "qos_violation_rate_quality": float(t["n_viol_q"] / resolved),
            "qos_violation_rate_latency": float((t["n_viol_t"] + drops)
                                                / resolved),
            "qos_violation_rate_scheduled": float(t["n_viol"] / sched),
            "avg_quality": float(t["sum_quality"] / sched),
            "avg_steps": float(t["sum_steps"] / sched),
            "cold_start_rate": float(t["n_reload"] / sched),
            "reuse_rate": float(1.0 - t["n_reload"] / sched),
            "utilization": float(t["busy_time"]
                                 / (self.num_servers * secs)),
            "throughput_per_s": float(t["n_sched"] / secs),
            "goodput_per_s": float(max(good, 0.0) / secs),
            "goodput_rate": float(max(good, 0.0) / resolved),
            "q_min": self.q_min,
            "resp_sla": self.resp_sla,
        }

    # -- unified metrics registry -----------------------------------------
    def publish(self, labels: Optional[Dict[str, str]] = None,
                registry=None) -> None:
        """Publish this aggregator's summary (gauges ``eat_stream_<key>``)
        and its raw latency histogram (``eat_stream_latency_seconds``
        buckets) into the unified telemetry registry
        (`repro_torch.telemetry.metrics`; None = the process default)."""
        from repro_torch.telemetry import metrics as TM
        TM.publish_summary(self.summary(), prefix="eat_stream",
                           labels=labels, registry=registry)
        reg = registry or TM.default_registry()
        reg.histogram("eat_stream_latency_seconds",
                      "scheduled-task response latency",
                      edges=self.hist.edges).observe_counts(
            self.hist.counts, approx_sum=self.totals["sum_resp"],
            labels=labels)
