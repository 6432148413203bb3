"""Kernel launch counts, by kernel name.

``launches`` counts the launches of the port's hand-written kernels; each
wrapper calls :func:`count` where it launches, under a lock, since the
scheduler launches from its draft worker thread and its refine thread at
once. While a thread captures a CUDA graph (:mod:`repro_torch.graphs`),
its counts go to that graph's tally instead (:func:`counting_into`,
thread-local: another thread's launches still reach ``launches``), and
each replay adds the whole tally (:func:`add`).

Standard library only, so that every layer can import it.
"""

from __future__ import annotations

import collections
import contextlib
import threading

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_capture = threading.local()     # .tally: the Counter this thread counts into, if any


def count(name: str) -> None:
    """Add one launch of ``name`` to ``launches`` (thread-safe), or to the
    calling thread's tally while it captures a graph."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    with _lock:
        launches[name] += 1


def add(tally: collections.Counter) -> None:
    """Add a graph's tally to ``launches``: one replay of it."""
    with _lock:
        launches.update(tally)


@contextlib.contextmanager
def counting_into(tally: collections.Counter):
    """Send this thread's :func:`count` calls to ``tally`` for the block."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = prev
