"""Machine-readable schema for emitted traces, plus a built-in validator
(port of `repro/telemetry/schema.py`, a copy: the port emits the same span
names, so one schema and one validator read both packages' traces).

`TRACE_SCHEMA` is a JSON-Schema (draft-07 subset) document describing the
Chrome trace-event files the tracer writes; `validate_trace` enforces it
without external dependencies (no `jsonschema` is needed), so
`tests/test_torch_telemetry.py` and `chip_smoke.py` can gate every emitted
file. `KNOWN_SPANS` is the contract documented in
`docs/telemetry_schema.md`: every span name the stack emits, one place.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

#: every span name the stack emits -> (category, emitting layer)
KNOWN_SPANS: Dict[str, Tuple[str, str]] = {
    # Simulator (repro.api.simulator)
    "run":              ("run",      "api.Simulator"),
    "resolve_policy":   ("run",      "api.Simulator"),
    "episodic_rollout": ("rollout",  "api.Simulator"),
    "profile_decisions": ("profile", "api.Simulator"),
    # streaming engine (repro.traffic.stream.StreamRunner)
    "window":           ("stream",   "traffic.StreamRunner"),
    "build_window":     ("stream",   "traffic.StreamRunner"),
    "window_rollout":   ("rollout",  "traffic.StreamRunner"),
    "window_seam":      ("stream",   "traffic.StreamRunner"),
    "fault_requeue":    ("stream",   "traffic.StreamRunner"),
    # streaming trainers (repro.training.stream_train)
    "train_round":      ("train",    "training.stream_train"),
    "replay_push":      ("train",    "training.stream_train"),
    "gae_pool":         ("train",    "training.stream_train"),
    "gradient_update":  ("train",    "training.stream_train"),
    # serving backend (repro.serving.backend / executor)
    "decision":         ("serving",  "serving.ServingRollout"),
    "env_advance":      ("serving",  "serving.ServingRollout"),
    "wall_patch":       ("serving",  "serving.ServingRollout"),
    "execute_task":     ("serving",  "serving.ServingRollout"),
    "model_load":       ("serving",  "serving.ServingRollout"),
    "executor_warmup":  ("serving",  "serving.ServingRollout"),
    "prefill":          ("serving",  "serving.ModelExecutor"),
    "decode":           ("serving",  "serving.ModelExecutor"),
    # serving fault tolerance (repro.serving.backend)
    "executor_retry":   ("serving",  "serving.ServingRollout"),
    "executor_degrade": ("serving",  "serving.ServingRollout"),
    # slow-timescale placement (repro.placement / serving.backend)
    "placement_decide": ("placement", "placement.PlacementManager"),
    "prefetch":         ("placement", "serving.ServingRollout"),
    "evict":            ("placement", "serving.ServingRollout"),
}

_EVENT_SCHEMA = {
    "type": "object",
    "required": ["name", "cat", "ph", "ts", "pid", "tid"],
    "properties": {
        "name": {"type": "string", "minLength": 1},
        "cat": {"type": "string", "minLength": 1},
        "ph": {"enum": ["X", "i", "C"]},
        "ts": {"type": "number", "minimum": 0},
        "dur": {"type": "number", "minimum": 0},
        "pid": {"type": "integer"},
        "tid": {"type": "integer"},
        "args": {"type": "object"},
        "s": {"enum": ["t", "p", "g"]},
    },
}

TRACE_SCHEMA = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "repro telemetry trace (Chrome trace-event JSON)",
    "type": "object",
    "required": ["traceEvents", "otherData"],
    "properties": {
        "traceEvents": {"type": "array", "items": _EVENT_SCHEMA},
        "displayTimeUnit": {"type": "string"},
        "otherData": {
            "type": "object",
            "required": ["schema_version"],
            "properties": {
                "schema_version": {"type": "integer", "minimum": 1},
                "epoch_unix_s": {"type": "number"},
            },
        },
    },
}

_TYPES = {"object": dict, "array": list, "string": str, "integer": int,
          "number": (int, float), "boolean": bool}


def _check(doc, schema, path: str, errors: List[str]) -> None:
    """Minimal draft-07 checker for exactly the constructs TRACE_SCHEMA
    uses: type, enum, required, properties, items, minimum, minLength."""
    if "enum" in schema:
        if doc not in schema["enum"]:
            errors.append(f"{path}: {doc!r} not in {schema['enum']}")
        return
    t = schema.get("type")
    if t:
        py = _TYPES[t]
        ok = isinstance(doc, py) and not (t in ("integer", "number")
                                          and isinstance(doc, bool))
        if not ok:
            errors.append(f"{path}: expected {t}, got {type(doc).__name__}")
            return
    if t == "object":
        for req in schema.get("required", ()):
            if req not in doc:
                errors.append(f"{path}: missing required key {req!r}")
        for k, sub in schema.get("properties", {}).items():
            if k in doc:
                _check(doc[k], sub, f"{path}.{k}", errors)
    elif t == "array":
        items = schema.get("items")
        if items:
            for i, el in enumerate(doc):
                _check(el, items, f"{path}[{i}]", errors)
    elif t == "string":
        if len(doc) < schema.get("minLength", 0):
            errors.append(f"{path}: string shorter than "
                          f"{schema['minLength']}")
    elif t in ("integer", "number"):
        if "minimum" in schema and doc < schema["minimum"]:
            errors.append(f"{path}: {doc} < minimum {schema['minimum']}")


def validate_events(doc: dict, *, strict_names: bool = False) -> List[str]:
    """Validate a loaded trace document; returns a list of problems
    (empty = valid). `strict_names=True` additionally requires every span
    name to appear in `KNOWN_SPANS` — the repo's own emitters must pass
    it; third-party spans need not."""
    errors: List[str] = []
    _check(doc, TRACE_SCHEMA, "$", errors)
    if strict_names and not errors:
        for i, ev in enumerate(doc["traceEvents"]):
            if ev["ph"] == "C":
                continue                      # counters are free-form
            if ev["name"] not in KNOWN_SPANS:
                errors.append(f"$.traceEvents[{i}]: unknown span name "
                              f"{ev['name']!r} (add it to KNOWN_SPANS + "
                              "docs/telemetry_schema.md)")
    return errors


def validate_trace(path: str, *, strict_names: bool = False) -> List[str]:
    """Validate a trace file (Chrome JSON or JSONL sidecar)."""
    if path.endswith(".jsonl"):
        with open(path) as f:
            events = [json.loads(line) for line in f if line.strip()]
        doc = {"traceEvents": events, "otherData": {"schema_version": 1}}
    else:
        with open(path) as f:
            doc = json.load(f)
    return validate_events(doc, strict_names=strict_names)


def assert_valid_trace(path: str, *, strict_names: bool = False) -> None:
    errors = validate_trace(path, strict_names=strict_names)
    if errors:
        raise ValueError(f"invalid trace {path}:\n  " + "\n  ".join(errors))


def span_durations(events: Iterable[dict]) -> Dict[str, Dict[str, float]]:
    """Aggregate complete-span events -> {name: {count, total_s, mean_s,
    self_total_s}}. `self_total_s` subtracts the time spent in directly
    nested spans (depth + containment), so a per-phase breakdown sums to
    ~the root span instead of double-counting parents."""
    spans = [e for e in events if e.get("ph") == "X"]
    out: Dict[str, Dict[str, float]] = {}
    for e in spans:
        rec = out.setdefault(e["name"], {"count": 0, "total_s": 0.0,
                                         "self_total_s": 0.0})
        rec["count"] += 1
        rec["total_s"] += e["dur"] / 1e6
        child = 0.0
        d = e.get("args", {}).get("depth")
        if d is not None:
            for c in spans:
                if (c is not e and c.get("args", {}).get("depth") == d + 1
                        and c["ts"] >= e["ts"]
                        and c["ts"] + c.get("dur", 0.0)
                        <= e["ts"] + e["dur"]):
                    child += c["dur"] / 1e6
        rec["self_total_s"] += max(e["dur"] / 1e6 - child, 0.0)
    for rec in out.values():
        rec["mean_s"] = rec["total_s"] / max(rec["count"], 1)
    return out
