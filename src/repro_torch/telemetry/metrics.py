"""Unified metrics registry: counters / gauges / histograms with labels
(port of `repro/telemetry/metrics.py`, a copy: pure numpy, so the
Prometheus text is the reference's for the same updates).

Every layer that already computes run statistics — the streaming QoS
aggregator (`traffic.metrics.StreamAggregator`), the serving pool ledger
(`ServerPool.counters()`), the streaming trainers' per-round history rows —
publishes into ONE registry under a common naming scheme, and the registry
exports two ways:

* Prometheus text exposition format (``to_prometheus()`` /
  ``write_prometheus(path)``) — scrape-ready, histogram buckets in the
  standard ``_bucket{le=...}`` / ``_sum`` / ``_count`` convention;
* JSONL snapshots (``write_jsonl(path)``) — one metric sample per line,
  machine-diffable across PRs.

Naming scheme (see docs/telemetry_schema.md): ``eat_<layer>_<quantity>``
with layers ``stream`` (QoS aggregates), ``serving`` (pool/executor),
``train`` (per-round trainer telemetry), ``decision`` (policy-inference
latency). Labels carry the low-cardinality dimensions (policy, backend,
cell, algo); values are plain floats.

Publishing is pure host-side dict arithmetic — it never touches a
decision program, so metrics are byte-identical whether tracing is on or
off.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

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


LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Optional[Mapping[str, str]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(ls: LabelSet, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = ls + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class Counter:
    """Monotone accumulator per label set."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: Dict[LabelSet, float] = {}

    def inc(self, value: float = 1.0,
            labels: Optional[Mapping[str, str]] = None) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        ls = _labelset(labels)
        self.values[ls] = self.values.get(ls, 0.0) + float(value)


class Gauge:
    """Last-value metric per label set."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: Dict[LabelSet, float] = {}

    def set(self, value: float,
            labels: Optional[Mapping[str, str]] = None) -> None:
        self.values[_labelset(labels)] = float(value)


class Histogram:
    """Fixed-bin histogram per label set (`LatencyHistogram` underneath),
    exported in the Prometheus cumulative-bucket convention."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 edges: Optional[np.ndarray] = None):
        self.name, self.help = name, help
        self.edges = np.asarray(DEFAULT_EDGES if edges is None else edges,
                                np.float64)
        self.values: Dict[LabelSet, LatencyHistogram] = {}
        self.sums: Dict[LabelSet, float] = {}

    def _hist(self, ls: LabelSet) -> LatencyHistogram:
        h = self.values.get(ls)
        if h is None:
            h = self.values[ls] = LatencyHistogram(self.edges)
            self.sums[ls] = 0.0
        return h

    def observe(self, value: float,
                labels: Optional[Mapping[str, str]] = None) -> None:
        ls = _labelset(labels)
        self._hist(ls).add_values([value])
        self.sums[ls] += float(value)

    def observe_counts(self, counts, approx_sum: float = 0.0,
                       labels: Optional[Mapping[str, str]] = None) -> None:
        """Fold pre-binned device-side counts (e.g. a window's latency
        histogram row); `approx_sum` keeps the `_sum` series meaningful."""
        ls = _labelset(labels)
        self._hist(ls).add_counts(counts)
        self.sums[ls] += float(approx_sum)

    def percentile(self, q: float,
                   labels: Optional[Mapping[str, str]] = None) -> float:
        ls = _labelset(labels)
        return self._hist(ls).percentile(q) if ls in self.values \
            else float("nan")


class MetricsRegistry:
    """Name -> metric, with typed creation and full-registry export."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  edges: Optional[np.ndarray] = None) -> Histogram:
        return self._get(Histogram, name, help, edges=edges)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """{name: {"kind", "help", "samples": {label-string: value}}} —
        histograms expand into bucket/sum/count sample series."""
        out: Dict[str, Dict] = {}
        for name, m in sorted(self._metrics.items()):
            samples: Dict[str, float] = {}
            if isinstance(m, Histogram):
                for ls, h in m.values.items():
                    # slot i of LatencyHistogram covers (edges[i-1],
                    # edges[i]] with slot 0 the underflow, so the
                    # cumulative prometheus bucket le=edges[i] is
                    # sum(counts[:i+1]); the overflow slot only shows in
                    # le="+Inf" (= total), per the exposition convention.
                    cum = 0
                    for i, edge in enumerate(h.edges):
                        cum += int(h.counts[i])
                        samples[f"{name}_bucket" + _fmt_labels(
                            ls, (("le", repr(float(edge))),))] = float(cum)
                    samples[f"{name}_bucket"
                            + _fmt_labels(ls, (("le", "+Inf"),))] = \
                        float(h.total)
                    samples[f"{name}_sum" + _fmt_labels(ls)] = m.sums[ls]
                    samples[f"{name}_count" + _fmt_labels(ls)] = \
                        float(h.total)
            else:
                for ls, v in m.values.items():
                    samples[name + _fmt_labels(ls)] = v
            out[name] = {"kind": m.kind, "help": m.help, "samples": samples}
        return out

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for name, rec in self.snapshot().items():
            if rec["help"]:
                lines.append(f"# HELP {name} {rec['help']}")
            lines.append(f"# TYPE {name} {rec['kind']}")
            for series, v in rec["samples"].items():
                lines.append(f"{series} {v:.17g}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return path

    def write_jsonl(self, path: str) -> str:
        ts = time.time()
        with open(path, "w") as f:
            for name, rec in self.snapshot().items():
                for series, v in rec["samples"].items():
                    f.write(json.dumps({"ts": ts, "metric": name,
                                        "series": series, "kind": rec["kind"],
                                        "value": v}) + "\n")
        return path


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+(?P<value>[^\s]+)$")


def parse_prometheus(text: str) -> Dict[str, float]:
    """Prometheus text -> {series-string: value}. Round-trips
    `to_prometheus()` output exactly (label order is canonical there)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable prometheus sample: {line!r}")
        out[m.group("name") + (m.group("labels") or "")] = \
            float(m.group("value"))
    return out


# ----------------------------------------------------------------------
# the process-wide default registry (consumers may still build their own)
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


# -- publishers ---------------------------------------------------------
def publish_summary(summary: Mapping[str, object], *, prefix: str,
                    labels: Optional[Mapping[str, str]] = None,
                    registry: Optional[MetricsRegistry] = None) -> None:
    """Flat scalar summary dict -> gauges `<prefix>_<key>{labels}`.
    Non-numeric values are skipped (they belong in labels, not samples)."""
    reg = registry or default_registry()
    for k, v in summary.items():
        if isinstance(v, bool) or not isinstance(v, (int, float, np.number)):
            continue
        if not math.isfinite(float(v)):
            continue
        reg.gauge(f"{prefix}_{k}").set(float(v), labels=labels)


def publish_counters(counters: Mapping[str, object], *, prefix: str,
                     labels: Optional[Mapping[str, str]] = None,
                     registry: Optional[MetricsRegistry] = None) -> None:
    """Monotone ledger dict (e.g. `ServerPool.counters()`) -> gauges with
    the counter naming suffix `_total` (the source resets per run, so the
    registry records the latest run total rather than accumulating)."""
    reg = registry or default_registry()
    for k, v in counters.items():
        if isinstance(v, (int, float, np.number)) and not isinstance(v, bool):
            reg.gauge(f"{prefix}_{k}_total").set(float(v), labels=labels)
