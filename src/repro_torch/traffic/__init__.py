"""Streaming QoS telemetry."""
