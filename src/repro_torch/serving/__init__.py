"""Serving-side telemetry: metrics registry and tracer."""
