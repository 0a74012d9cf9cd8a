"""Observability: the span tracer and the metrics registry."""
