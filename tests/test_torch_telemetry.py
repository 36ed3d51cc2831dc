"""The port's telemetry (`repro_torch.telemetry`) against the reference on
the CPU: the recording tracer's events (the same calls give the same
names, categories and args, and the reference's validator accepts the
port's files), the trace schema, the metrics registry's Prometheus text
(identical for the same updates) and its parser, `DecisionProfile`'s
summary, `profile_policy` on the CPU's host clock, and a port stream's
trace under the strict span-name check."""
import json

import numpy as np
import pytest
import torch

from repro import telemetry as JTEL
from repro.telemetry import metrics as JM
from repro.telemetry import profile as JPR
from repro.telemetry import schema as JS
from repro.telemetry import trace as JT
from repro_torch import telemetry as TEL
from repro_torch.core import env as TEV
from repro_torch.core import rollout as TRO
from repro_torch.core.workload import TraceConfig
from repro_torch.faults import FaultSpec
from repro_torch.placement import PlacementSpec
from repro_torch.telemetry import metrics as TM
from repro_torch.telemetry import profile as TPR
from repro_torch.telemetry import schema as TSC
from repro_torch.telemetry import trace as TT
from repro_torch.traffic import metrics as TMX
from repro_torch.traffic import stream as TS
from repro_torch.traffic.arrivals import PoissonArrivals


@pytest.fixture(autouse=True)
def _fresh():
    TT.reset_tracers()
    TM.default_registry().clear()
    yield
    TT.reset_tracers()
    TM.default_registry().clear()


def _drive(mod, path):
    """The same span / instant / counter calls on one module's tracer."""
    tr = mod.Tracer(mod.TraceConfig(enabled=True, path=str(path)))
    with tr.span("window", cat="stream", window=0, backend="fused"):
        with tr.span("build_window", cat="stream", window=0):
            pass
        with tr.span("window_rollout", cat="rollout", window=0, streams=2,
                     steps=8):
            tr.instant("decision", cat="serving", task=3)
        tr.counter("backlog", 5, window=0)
    with tr.span("placement_decide", cat="placement", window=1,
                 policy="lfu"):
        pass
    return tr, tr.write()


def _shape(ev):
    return (ev["name"], ev["cat"], ev["ph"], ev.get("s"), ev["args"])


def test_tracer_events_match_the_reference(tmp_path):
    jt, jpath = _drive(JT, tmp_path / "j" / "trace.json")
    tt, tpath = _drive(TT, tmp_path / "t" / "trace.json")
    jdoc, tdoc = json.load(open(jpath)), json.load(open(tpath))
    assert sorted(map(str, map(_shape, jdoc["traceEvents"]))) == \
        sorted(map(str, map(_shape, tdoc["traceEvents"])))
    assert [e["name"] for e in jt.events] == [e["name"] for e in tt.events]
    assert tdoc["otherData"]["schema_version"] == TT.TRACE_SCHEMA_VERSION == \
        JT.TRACE_SCHEMA_VERSION
    for path in (tpath, tpath + ".jsonl"):
        assert JS.validate_trace(path, strict_names=True) == []
        assert TSC.validate_trace(path, strict_names=True) == []
    assert JS.span_durations(tdoc["traceEvents"]).keys() == \
        TSC.span_durations(tdoc["traceEvents"]).keys()
    # the same document gives the same breakdown in both
    assert JS.span_durations(jdoc["traceEvents"]) == \
        TSC.span_durations(jdoc["traceEvents"])


def test_schema_is_the_reference_schema(tmp_path):
    assert TSC.KNOWN_SPANS == JS.KNOWN_SPANS
    # the package's names: the reference's, with torch_profile for
    # jax_profile, and validate_events exported too
    assert set(TEL.__all__) == (set(JTEL.__all__) - {"jax_profile"}) | {
        "torch_profile", "validate_events"}
    assert TSC.TRACE_SCHEMA == JS.TRACE_SCHEMA
    bad = {"traceEvents": [{"name": "", "cat": "x", "ph": "Q", "ts": -1,
                            "pid": 1, "tid": 0}, {"name": "mystery",
                                                  "cat": "x", "ph": "X",
                                                  "ts": 0, "pid": 1,
                                                  "tid": 0}],
           "otherData": {"schema_version": 1}}
    assert TSC.validate_events(bad) == JS.validate_events(bad) != []
    good = {"traceEvents": bad["traceEvents"][1:], "otherData":
            {"schema_version": 1}}
    assert TSC.validate_events(good, strict_names=True) == \
        JS.validate_events(good, strict_names=True) != []
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="invalid trace"):
        TSC.assert_valid_trace(str(path))


def test_tracer_for_caches_per_config(tmp_path):
    cfg = TT.TraceConfig(enabled=True, path=str(tmp_path / "a.json"))
    assert TT.tracer_for(cfg) is TT.tracer_for(cfg)
    assert TT.tracer_for(None) is TT.NULL_TRACER
    assert TT.tracer_for(TT.TraceConfig()) is TT.NULL_TRACER
    first = TT.tracer_for(cfg)
    TT.reset_tracers()
    assert TT.tracer_for(cfg) is not first
    assert TT.NULL_TRACER.write() is None
    with TT.NULL_TRACER.span("x", a=1) as s:
        assert s is not None


def test_torch_profile_writes_its_capture(tmp_path):
    off = TT.torch_profile(TT.TraceConfig(profiler_dir=str(tmp_path)))
    with off:
        pass
    assert off.path is None
    cfg = TT.TraceConfig(enabled=True, profiler_dir=str(tmp_path / "prof"))
    with TT.torch_profile(cfg) as prof:
        torch.ones(8).sum()
    assert prof.path and json.load(open(prof.path))["traceEvents"]


# ---------------------------------------------------------------- metrics
def _updates(mod, reg):
    c = reg.counter("eat_stream_tasks", "tasks")
    c.inc(3, labels={"policy": "fifo"})
    c.inc(labels={"policy": "greedy"})
    reg.gauge("eat_serving_pool_loads").set(7.5, labels={"cell": "a"})
    h = reg.histogram("eat_decision_latency_seconds", "lat",
                      edges=np.geomspace(1e-4, 1.0, 9))
    for v in (1e-5, 3e-4, 0.02, 0.02, 2.0):
        h.observe(v, labels={"sampler": "ddpm"})
    h.observe_counts(np.arange(10), approx_sum=1.5, labels={"sampler": "x"})
    mod.publish_summary({"a": 1, "b": 2.5, "skip": "s", "flag": True,
                         "inf": float("inf")}, prefix="eat_train",
                        labels={"algo": "sac"}, registry=reg)
    mod.publish_counters({"loads": 4, "reuses": 2.0, "no": None},
                         prefix="eat_serving", registry=reg)


def test_prometheus_text_identical_and_round_trips(tmp_path):
    j, t = JM.MetricsRegistry(), TM.MetricsRegistry()
    _updates(JM, j)
    _updates(TM, t)
    text = t.to_prometheus()
    assert text == j.to_prometheus()
    parsed = TM.parse_prometheus(text)
    assert parsed == JM.parse_prometheus(text)
    snap = t.snapshot()
    assert parsed == {s: v for rec in snap.values()
                      for s, v in rec["samples"].items()}
    assert t.histogram("eat_decision_latency_seconds").percentile(
        0.5, labels={"sampler": "ddpm"}) == j.histogram(
        "eat_decision_latency_seconds").percentile(
        0.5, labels={"sampler": "ddpm"})
    t.write_prometheus(str(tmp_path / "m.prom"))
    t.write_jsonl(str(tmp_path / "m.jsonl"))
    assert open(tmp_path / "m.prom").read() == text
    rows = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert {r["series"] for r in rows} == set(parsed)
    with pytest.raises(TypeError, match="already registered"):
        t.gauge("eat_stream_tasks")
    with pytest.raises(ValueError, match="invalid metric name"):
        t.counter("bad name")
    with pytest.raises(ValueError, match="cannot decrease"):
        t.counter("eat_stream_tasks").inc(-1)
    with pytest.raises(ValueError, match="unparseable"):
        TM.parse_prometheus("what is this")


def test_stream_aggregator_publishes_the_reference_text():
    from repro.traffic import metrics as JMX
    rng = np.random.default_rng(0)
    ja = JMX.StreamAggregator(8, 0.23, 120.0)
    ta = TMX.StreamAggregator(8, 0.23, 120.0)
    for _ in range(3):
        rec = {k: rng.integers(0, 20, 4).astype(np.int32)
               for k in ("n_injected", "n_sched", "n_done", "n_dropped",
                         "n_reload", "n_viol", "n_viol_q", "n_viol_t")}
        rec.update({k: rng.uniform(0, 300, 4).astype(np.float32)
                    for k in ("sum_resp", "sum_quality", "sum_steps",
                              "busy_time", "elapsed", "max_resp")})
        rec["hist"] = rng.integers(0, 4, (4, 62)).astype(np.int32)
        ja.update(rec)
        ta.update(rec)
    jr, tr = JM.MetricsRegistry(), TM.MetricsRegistry()
    ja.publish(labels={"policy": "fifo"}, registry=jr)
    ta.publish(labels={"policy": "fifo"}, registry=tr)
    assert tr.to_prometheus() == jr.to_prometheus()
    ta.publish()
    assert "eat_stream_latency_seconds" in \
        TM.default_registry().to_prometheus()


# ---------------------------------------------------------------- profile
def test_decision_profile_summary_identical():
    rng = np.random.default_rng(1)
    j, t = JPR.DecisionProfile(), TPR.DecisionProfile()
    for phase in ("policy", "env_advance", "executor"):
        for v in rng.lognormal(-6.0, 1.5, 40 if phase != "executor" else 0):
            j.observe(phase, float(v))
            t.observe(phase, float(v))
    assert t.summary() == j.summary()
    assert t.counts("policy") == 40 and "executor_latency_p50_s" not in \
        t.summary()
    np.testing.assert_array_equal(TPR.DECISION_EDGES, JPR.DECISION_EDGES)


@pytest.mark.parametrize("batch", [0, 4])
def test_profile_policy_on_the_cpu(batch):
    ecfg = TEV.EnvConfig(num_servers=4, max_tasks=8, queue_window=4)
    out = TPR.profile_policy(ecfg, TRO.fifo_policy(ecfg), {}, iters=5,
                             warmup=1, batch=batch, device="cpu")
    for k in ("p50", "p95", "p99", "mean"):
        assert 0.0 < out[f"decision_latency_{k}_s"] < 5.0, (k, out)
    assert out["decision_latency_n"] == 5.0
    assert ("decision_batch" in out) == (batch > 0)


# ---------------------------------------------------------------- stream
def test_stream_trace_validates_strictly(tmp_path):
    """A port stream with faults, placement and a recording tracer writes
    a trace both validators accept under the strict name check, with the
    stream's spans and counters; tracing changes no result."""
    ecfg = TEV.EnvConfig(num_servers=4, queue_window=4, max_tasks=12,
                         time_limit=600.0, max_steps=96)

    def run(tracer):
        src = TS.ProcessTaskSource(
            PoissonArrivals(rate=0.3), TraceConfig(num_tasks=12,
                                                   max_servers=4),
            torch.Generator().manual_seed(3), num_streams=2, device="cpu")
        return TS.run_stream(
            ecfg, TRO.fifo_policy(ecfg), None, src,
            torch.Generator().manual_seed(4),
            TS.StreamConfig(num_windows=3, num_streams=2,
                            faults=FaultSpec.chaos(2),
                            placement=PlacementSpec(policy="forecast",
                                                    interval=2)),
            tracer=tracer, device="cpu")
    cfg = TT.TraceConfig(enabled=True, path=str(tmp_path / "s.json"))
    tracer = TT.tracer_for(cfg)
    traced = run(tracer)
    path = tracer.write()
    assert JS.validate_trace(path, strict_names=True) == []
    TSC.assert_valid_trace(path, strict_names=True)
    events = json.load(open(path))["traceEvents"]
    dur = TSC.span_durations(events)
    for name in ("window", "build_window", "window_rollout", "window_seam",
                 "fault_requeue"):
        assert dur[name]["count"] == 3, name
    assert dur["placement_decide"]["count"] == 1
    counters = {e["name"] for e in events if e["ph"] == "C"}
    assert counters == {"backlog", "pending_retry"}
    plain = run(None)
    assert plain.summary == traced.summary
    assert plain.per_window == traced.per_window
