"""Span-based structured tracing for the whole stack (port of
`repro/telemetry/trace.py`).

One `Tracer` per run collects host-side *spans* — named wall-clock
intervals opened around device programs (window seam, policy decision,
env advance, model load, prefill, decode, replay push, gradient update) —
and writes them as Chrome trace-event JSON (loadable in perfetto /
chrome://tracing) plus a line-per-event JSONL sidecar. Spans are recorded
strictly OUTSIDE the decision programs: the tracer is never called inside
a CUDA graph capture, so enabling it cannot perturb a single program, and
with `TraceConfig(enabled=False)` (the default) every call site hits the
shared `NULL_TRACER` no-op — zero allocations, zero behavioural change.
Where a span wraps work the card runs asynchronously, the caller
synchronises the stream it ran on before closing it (`StreamRunner` does,
with a recording tracer only), so the span times the work.

`StreamRunner`, `PlacementManager`, the serving executor and
`training.distill` take a tracer; `tracer_for(TraceConfig(...))` resolves
the SAME config to the SAME `Tracer` (live tracers are cached per config),
so one run emits one trace file no matter how many layers touch it.

    with tracer.span("window", window=w):
        ...host work wrapping one window's rollout...
    tracer.write()          # idempotent full rewrite; safe to call often

Span names and their argument keys are documented in
`docs/telemetry_schema.md`; `telemetry.schema.validate_trace` checks an
emitted file against the machine-readable schema.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

#: schema version stamped into every trace file (bump on breaking changes)
TRACE_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class TraceConfig:
    """Declarative tracing knobs, hashable so it keys the live-tracer cache
    (`tracer_for`) and can ride on an execution spec.

    * ``enabled`` — master switch; False (default) resolves to the no-op
      `NULL_TRACER` everywhere.
    * ``path`` — Chrome trace JSON output (default ``trace.json``); the
      JSONL sidecar lands next to it as ``<path>.jsonl``.
    * ``jsonl`` — also write the JSONL sidecar (one event per line).
    * ``metrics_path`` — when set, consumers snapshot the unified metrics
      registry here (Prometheus text; ``<path>.jsonl`` gets the JSONL
      snapshot) at run end.
    * ``profile_decisions`` — time per-decision policy inference after a
      `Simulator.run` (`telemetry.profile.profile_policy`, the host clock
      around the synchronised decision) and surface p50/p95/p99 in the
      result summary and sweep rows.
    * ``profile_iters`` — decisions timed by the profiler probe.
    * ``profiler_dir`` — opt-in `torch.profiler` capture directory
      (device-side profile alongside the host-span trace; the reference's
      ``jax_profiler_dir``).
    """
    enabled: bool = False
    path: str = "trace.json"
    jsonl: bool = True
    metrics_path: Optional[str] = None
    profile_decisions: bool = False
    profile_iters: int = 50
    profiler_dir: Optional[str] = None


class _NullSpan:
    """No-op context manager shared by every disabled call site."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a constant-time no-op."""
    enabled = False
    config: Optional[TraceConfig] = None

    def span(self, name: str, cat: str = "phase", **args):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "phase", **args) -> None:
        pass

    def counter(self, name: str, value: float, **args) -> None:
        pass

    def write(self) -> Optional[str]:
        return None


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self.tracer, self.name, self.cat, self.args = tracer, name, cat, args

    def __enter__(self):
        self.depth = self.tracer._enter()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        self.tracer._exit(self.name, self.cat, self.t0, dur, self.depth,
                          self.args)
        return False


class Tracer:
    """Collects spans/instants/counters; writes Chrome JSON + JSONL.

    Events are buffered on the host (a 10^5-span run is a few MB) and the
    output files are fully rewritten on every `write()` — callers flush at
    natural boundaries (run end, round end) and a crash mid-run still
    leaves the last consistent file behind.
    """

    enabled = True

    def __init__(self, config: TraceConfig):
        self.config = config
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._epoch = time.time()
        self._depth = 0
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- recording -----------------------------------------------------
    def span(self, name: str, cat: str = "phase", **args) -> _Span:
        """Context manager: one complete ("X") event on exit."""
        return _Span(self, name, cat, args)

    def _enter(self) -> int:
        with self._lock:
            d = self._depth
            self._depth += 1
        return d

    def _exit(self, name, cat, t0, dur, depth, args) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0 - self._t0) * 1e6, "dur": dur * 1e6,
              "pid": self._pid, "tid": 0, "args": dict(args, depth=depth)}
        with self._lock:
            self._depth -= 1
            self.events.append(ev)

    def instant(self, name: str, cat: str = "phase", **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": self._pid, "tid": 0, "args": args}
        with self._lock:
            self.events.append(ev)

    def counter(self, name: str, value: float, **args) -> None:
        ev = {"name": name, "cat": "counter", "ph": "C",
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": self._pid, "tid": 0,
              "args": dict(args, value=float(value))}
        with self._lock:
            self.events.append(ev)

    # -- output --------------------------------------------------------
    def _ordered(self) -> List[Dict[str, Any]]:
        # completion order == append order; presentation order is by start
        # time so nesting reads top-down in the file and in `trace_summary`
        return sorted(self.events, key=lambda e: e["ts"])

    def write(self) -> str:
        """(Re)write the trace files; returns the Chrome JSON path."""
        path = self.config.path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        events = self._ordered()
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema_version": TRACE_SCHEMA_VERSION,
                "epoch_unix_s": self._epoch,
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        if self.config.jsonl:
            with open(path + ".jsonl", "w") as f:
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
        return path


# ----------------------------------------------------------------------
# one live tracer per TraceConfig: every layer that threads the same
# config (StreamRunner, trainers, serving executor) shares one
# event buffer, hence one trace file per run.
_LIVE: Dict[TraceConfig, Tracer] = {}
_LIVE_LOCK = threading.Lock()


def tracer_for(config: Optional[TraceConfig]):
    """Resolve a TraceConfig to a tracer (NULL_TRACER when disabled)."""
    if config is None or not config.enabled:
        return NULL_TRACER
    with _LIVE_LOCK:
        t = _LIVE.get(config)
        if t is None:
            t = _LIVE[config] = Tracer(config)
        return t


def reset_tracers() -> None:
    """Drop every cached live tracer (tests; fresh files per scenario)."""
    with _LIVE_LOCK:
        _LIVE.clear()


# ----------------------------------------------------------------------
class torch_profile:
    """Opt-in device-side capture, the counterpart of the reference's
    `repro.telemetry.trace.jax_profile` (its `TraceConfig.jax_profiler_dir`
    is `profiler_dir` here): wraps a region in `torch.profiler.profile`
    (CPU activity, and CUDA when a card is present) when
    `TraceConfig.profiler_dir` is set and tracing is enabled, and writes
    the capture there as a Chrome trace (`torch_profile_<pid>.json`) on
    exit; a no-op otherwise. `self.path` names the file written."""

    def __init__(self, config: Optional[TraceConfig]):
        self._dir = (config.profiler_dir
                     if config is not None and config.enabled else None)
        self._prof = None
        self.path: Optional[str] = None

    def __enter__(self):
        if self._dir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self._dir, exist_ok=True)
            self.path = os.path.join(self._dir,
                                     f"torch_profile_{os.getpid()}.json")
            self._prof.export_chrome_trace(self.path)
            self._prof = None
        return False
