"""Telemetry: the disabled tracer and the latency histogram."""
