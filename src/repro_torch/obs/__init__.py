"""Observability: span tracing, the metrics registry and the Chrome-trace
(Perfetto) export (copies of the JAX package's ``obs/tracer.py``,
``obs/metrics.py`` and ``obs/export.py``, stdlib only)."""

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
from repro_torch.obs.export import (
    load_trace,
    stage_breakdown,
    to_trace_events,
    validate_trace,
    write_chrome_trace,
)

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
    "load_trace",
    "metric_key",
    "parse_metric_key",
    "stage_breakdown",
    "to_trace_events",
    "validate_trace",
    "write_chrome_trace",
]
