"""repro_torch.telemetry — structured tracing, unified metrics, decision
profiling (port of `repro/telemetry`).

* `trace` — span-based tracer emitting Chrome trace-event JSON
  (perfetto-loadable) + JSONL, recorded only around device programs; zero
  overhead when disabled. `torch_profile` adds an opt-in `torch.profiler`
  capture.
* `metrics` — one labelled counters/gauges/histograms registry that the
  stream aggregator publishes into; Prometheus text + JSONL snapshot
  export.
* `profile` — per-decision policy-inference latency (the diffusion
  actor's K-denoise-step cost vs greedy/fifo), CUDA events on the card.
* `schema` — the machine-readable trace schema + dependency-free
  validator every emitted file is gated with.
"""
from repro_torch.telemetry.metrics import (DEFAULT_EDGES, Counter, Gauge,
                                           Histogram, LatencyHistogram,
                                           MetricsRegistry, default_registry,
                                           parse_prometheus, publish_counters,
                                           publish_summary)
from repro_torch.telemetry.profile import (DECISION_EDGES, DecisionProfile,
                                           profile_policy)
from repro_torch.telemetry.schema import (KNOWN_SPANS, TRACE_SCHEMA,
                                          assert_valid_trace, span_durations,
                                          validate_events, validate_trace)
from repro_torch.telemetry.trace import (NULL_TRACER, TraceConfig, Tracer,
                                         reset_tracers, torch_profile,
                                         tracer_for)

__all__ = [
    "TraceConfig", "Tracer", "NULL_TRACER", "tracer_for", "reset_tracers",
    "torch_profile",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "LatencyHistogram",
    "DEFAULT_EDGES", "default_registry",
    "parse_prometheus", "publish_summary", "publish_counters",
    "DecisionProfile", "profile_policy", "DECISION_EDGES",
    "KNOWN_SPANS", "TRACE_SCHEMA", "validate_events", "validate_trace",
    "assert_valid_trace", "span_durations",
]
