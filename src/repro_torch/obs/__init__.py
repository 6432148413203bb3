"""Observability: span tracing and the metrics registry (copies of the
JAX package's ``obs/tracer.py`` and ``obs/metrics.py``, stdlib only).

The Perfetto export (``obs/export.py``) is not ported yet."""

from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    PeriodicMetricsLogger,
    metric_key,
    parse_metric_key,
)
from repro_torch.obs.tracer import NullTracer, SpanRecord, SpanTracer

__all__ = [
    "Counter",
    "DEFAULT_LATENCY_BUCKETS_S",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullTracer",
    "PeriodicMetricsLogger",
    "SpanRecord",
    "SpanTracer",
    "metric_key",
    "parse_metric_key",
]
