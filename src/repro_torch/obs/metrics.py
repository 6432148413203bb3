"""Metrics registry: counters, gauges, fixed-bucket histograms.

The registry is the single source of truth for serving counters —
``stream_report`` sections are *derived from* registry snapshots rather
than parallel hand-rolled dicts. Instruments are get-or-create by
``(name, labels)`` and individually locked, so concurrent emit from the
draft worker thread and the scheduler loop is safe; ``snapshot()`` takes
a consistent point-in-time copy for per-run deltas and periodic dumps.

Keys render Prometheus-style: ``name{k=v,k2=v2}`` with labels sorted.
Stdlib-only (no torch/numpy) so ``repro_torch.obs`` imports stay cheap.
A copy of the JAX package's ``obs/metrics.py``: the same counter names,
keys and report arithmetic, so the two packages' reports compare key
for key.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PeriodicMetricsLogger",
    "DEFAULT_LATENCY_BUCKETS_S",
    "metric_key",
    "parse_metric_key",
]

# Log-ish spacing covering sub-ms instants through multi-second refines.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def metric_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_metric_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`metric_key` (label values come back as strings)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class Counter:
    """Monotonic counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (last write wins)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: float = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with cumulative-style snapshot.

    ``buckets`` are upper-edge values; an observation lands in the first
    bucket whose edge is >= the value, else in the overflow slot.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S) -> None:
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be non-empty and sorted, got {buckets!r}")
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        idx = len(self.buckets)
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class MetricsRegistry:
    """Thread-safe get-or-create instrument registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        key = metric_key(name, labels)
        with self._lock:
            inst = self._counters.get(key)
            if inst is None:
                inst = self._counters[key] = Counter()
            return inst

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = metric_key(name, labels)
        with self._lock:
            inst = self._gauges.get(key)
            if inst is None:
                inst = self._gauges[key] = Gauge()
            return inst

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
        **labels: Any,
    ) -> Histogram:
        key = metric_key(name, labels)
        with self._lock:
            inst = self._histograms.get(key)
            if inst is None:
                inst = self._histograms[key] = Histogram(buckets)
            return inst

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Consistent point-in-time copy of every instrument."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            "histograms": {k: h.snapshot() for k, h in histograms.items()},
        }

    def counter_deltas(self, since: Optional[Dict[str, Any]] = None) -> Dict[str, int]:
        """Counter values minus a prior ``snapshot()`` (missing keys = 0)."""
        base = (since or {}).get("counters", {})
        now = self.snapshot()["counters"]
        out = {k: v - base.get(k, 0) for k, v in now.items()}
        return {k: v for k, v in out.items() if v != 0}

    def sum_counters(self, name: str, since: Optional[Dict[str, Any]] = None, **match: Any) -> int:
        """Sum counter deltas whose name matches and whose labels include ``match``."""
        total = 0
        want = {k: str(v) for k, v in match.items()}
        for key, v in self.counter_deltas(since).items():
            n, labels = parse_metric_key(key)
            if n == name and all(labels.get(k) == mv for k, mv in want.items()):
                total += v
        return total

    # -- dumps -------------------------------------------------------------

    def render_text(self) -> str:
        snap = self.snapshot()
        lines: List[str] = []
        for key in sorted(snap["counters"]):
            lines.append(f"{key} {snap['counters'][key]}")
        for key in sorted(snap["gauges"]):
            lines.append(f"{key} {snap['gauges'][key]:.6g}")
        for key in sorted(snap["histograms"]):
            h = snap["histograms"][key]
            mean = h["sum"] / h["count"] if h["count"] else 0.0
            lines.append(f"{key} count={h['count']} sum={h['sum']:.6g} mean={mean:.6g}")
        return "\n".join(lines)

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")


class PeriodicMetricsLogger:
    """Daemon thread emitting one snapshot line every ``interval_s``.

    Each line is ``[metrics t=<s>] k=v ...`` over the counters that
    changed since the previous tick, so a live serve can be watched
    without grepping the final report.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        interval_s: float,
        sink: Callable[[str], None] = print,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        self.registry = registry
        self.interval_s = float(interval_s)
        self.sink = sink
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._last = registry.snapshot()

    def _tick(self) -> None:
        deltas = self.registry.counter_deltas(self._last)
        self._last = self.registry.snapshot()
        elapsed = time.perf_counter() - self._t0
        body = " ".join(f"{k}={v}" for k, v in sorted(deltas.items())) or "(idle)"
        self.sink(f"[metrics t={elapsed:.1f}s] {body}")

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._tick()

    def start(self) -> "PeriodicMetricsLogger":
        self._t0 = time.perf_counter()
        self._last = self.registry.snapshot()
        self._thread = threading.Thread(target=self._run, name="metrics-logger", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_tick:
            self._tick()
