"""Low-overhead span tracer with a bounded ring buffer.

Spans are recorded on the monotonic clock (``time.perf_counter``) into a
fixed-capacity ring; when the ring is full the oldest record is evicted
and ``dropped`` is incremented, so a long serve never grows memory
unboundedly. The default everywhere is :class:`NullTracer`, whose methods
are no-ops, so instrumented hot paths pay ~zero when tracing is off.

This module is stdlib-only on purpose, so ``repro_torch.obs`` imports
stay cheap. A copy of the JAX package's ``obs/tracer.py``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["SpanRecord", "SpanTracer", "NullTracer"]


@dataclass
class SpanRecord:
    """One trace record.

    ``ts``/``dur`` are in seconds on the ``perf_counter`` clock. ``ph``
    follows the Chrome trace-event phase vocabulary: ``"X"`` for a
    complete span, ``"i"`` for an instant. ``flow_id``/``flow_ph`` bind
    the record into a flow arrow chain (``"s"`` start, ``"t"`` step,
    ``"f"`` finish) — used for per-request admission→terminal arrows.
    """

    name: str
    track: str
    ts: float
    dur: float = 0.0
    ph: str = "X"
    args: Dict[str, Any] = field(default_factory=dict)
    flow_id: Optional[int] = None
    flow_ph: Optional[str] = None


class SpanTracer:
    """Thread-safe bounded-ring span recorder."""

    enabled = True

    def __init__(self, capacity: int = 8192):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: List[Optional[SpanRecord]] = [None] * self.capacity
        self._head = 0  # next write slot
        self._size = 0
        self.emitted = 0  # total records offered (kept + dropped-by-eviction)
        self.dropped = 0  # records evicted to make room

    # -- recording ---------------------------------------------------------

    def _append(self, rec: SpanRecord) -> None:
        with self._lock:
            if self._size == self.capacity:
                self.dropped += 1  # overwrites the oldest slot
            else:
                self._size += 1
            self._ring[self._head] = rec
            self._head = (self._head + 1) % self.capacity
            self.emitted += 1

    def instant(
        self,
        name: str,
        track: str = "main",
        flow_id: Optional[int] = None,
        flow_ph: Optional[str] = None,
        **args: Any,
    ) -> None:
        """Record a zero-duration instant event."""
        self._append(
            SpanRecord(
                name=name,
                track=track,
                ts=time.perf_counter(),
                ph="i",
                args=args,
                flow_id=flow_id,
                flow_ph=flow_ph,
            )
        )

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        track: str = "main",
        flow_id: Optional[int] = None,
        flow_ph: Optional[str] = None,
        **args: Any,
    ) -> Iterator[Dict[str, Any]]:
        """Context manager recording a complete ``"X"`` span on exit.

        Yields the mutable ``args`` dict so callers can attach results
        discovered mid-span (e.g. jit-cache hit/miss, rows packed).
        Nestable: inner spans simply record their own (shorter) windows.
        """
        start = time.perf_counter()
        try:
            yield args
        finally:
            self._append(
                SpanRecord(
                    name=name,
                    track=track,
                    ts=start,
                    dur=time.perf_counter() - start,
                    ph="X",
                    args=args,
                    flow_id=flow_id,
                    flow_ph=flow_ph,
                )
            )

    # -- reading -----------------------------------------------------------

    def records(self) -> List[SpanRecord]:
        """Retained records, oldest first."""
        with self._lock:
            if self._size < self.capacity:
                out = self._ring[: self._size]
            else:
                out = self._ring[self._head :] + self._ring[: self._head]
            return [r for r in out if r is not None]

    def __len__(self) -> int:
        with self._lock:
            return self._size

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._head = 0
            self._size = 0


class NullTracer:
    """No-op tracer: the default for every instrumented component.

    Mirrors the :class:`SpanTracer` API; ``span`` yields a throwaway
    dict so call sites can unconditionally write result attributes.
    """

    enabled = False
    capacity = 0
    emitted = 0
    dropped = 0

    def instant(self, name: str, track: str = "main", **kw: Any) -> None:
        return None

    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", **kw: Any) -> Iterator[Dict[str, Any]]:
        yield {}

    def records(self) -> List[SpanRecord]:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        return None
