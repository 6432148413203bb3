"""Kernel launch counts, by kernel name.

``launches`` counts the launches of the port's hand-written kernels; each
wrapper calls :func:`count` where it launches, under a lock, since the
scheduler launches from its draft worker thread and its refine thread at
once. While a thread captures a CUDA graph (:mod:`repro_torch.graphs`),
its counts go to that graph's tally instead (:func:`counting_into`,
thread-local: another thread's launches still reach ``launches``), and
each replay adds the whole tally (:func:`add`). A capture's work may also
launch from a thread of autograd's engine (a train step's backward, and a
checkpointed forward run again in it): a launch from a thread without a
tally of its own goes to the tally of the capture in progress when the
stream it launches on is the one being captured (``counting_into``'s
``capturing`` probe; captures run one at a time).

Standard library only, so that every layer can import it.
"""

from __future__ import annotations

import collections
import contextlib
import threading

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_capture = threading.local()     # .tally: the Counter this thread counts into, if any
# the capture in progress: its tally, and a probe of whether the calling
# thread's current stream is the one being captured
_active = None


def count(name: str) -> None:
    """Add one launch of ``name`` to ``launches`` (thread-safe), or to the
    calling thread's tally while it captures a graph."""
    tally = getattr(_capture, "tally", None)
    if tally is None and _active is not None and _active[1]():
        tally = _active[0]
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
def counting_into(tally: collections.Counter, capturing=None):
    """Send this thread's :func:`count` calls to ``tally`` for the block;
    with ``capturing`` (a callable: whether the calling thread's current
    stream is being captured), another thread's calls too while it
    launches onto the captured stream."""
    global _active
    prev, prev_active = getattr(_capture, "tally", None), _active
    _capture.tally = tally
    if capturing is not None:
        _active = (tally, capturing)
    try:
        yield tally
    finally:
        _capture.tally = prev
        _active = prev_active
