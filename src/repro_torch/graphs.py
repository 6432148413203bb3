"""One CUDA graph per compile key: the port's counterpart of the JAX
package's jitted dispatches (``jax.jit`` keeps one executable per key of
argument shapes and static values; here a loop of eager launches is
captured once per key and replayed on every later call with that key).

``GraphCache(what)(key, fn, *inputs)`` returns what ``fn(*inputs)`` (a
tensor or a tuple of tensors) returns. ``fn`` runs where ``inputs[0]``
lies: on the CPU it is simply called (eager launches, which a caller gets
by asking for the CPU); on the card the result comes from one replay:

* on a miss, ``inputs`` are copied into static buffers on the card, ``fn``
  runs once eagerly on a side stream (the warm-up: one-time kernel
  attributes, the kernel library's build and load and the cuBLAS
  workspace of that stream happen outside any capture), then ``fn`` is
  captured on the same stream with ``torch.cuda.graph(...,
  capture_error_mode="thread_local")`` into a private memory pool;
* every call copies ``inputs`` into the static buffers (a host tensor
  through pinned memory, without waiting for the stream), replays on the
  caller's current stream and clones the outputs, so the next replay does
  not overwrite what a caller holds.

``fn`` reads its inputs through its arguments, or through buffers the
caller keeps fixed for the cache's lifetime (the draft engine's KV
cache), and never synchronises with the host. A capture that fails
raises :class:`GraphCaptureError`, naming the statement that broke it,
after releasing what the capture held (the default CUDA generator's
capture state, the half-built graph); nothing falls back to eager
launches. Captures take a process-wide lock: one at a time, whichever
thread asks.

A stateful ``fn`` (``GraphCache(..., stateful=True)``: a train step,
which updates weights and moments in place) must run once a call. Its
warm-up is the capturing call's one step: the cache releases the blocks
the warm-up freed (``torch.cuda.empty_cache()``, so that the graph's pool
takes the step's memory without doubling the peak), captures, and returns
the warm-up's outputs with no replay; every later call is one replay. A
capture of a stateful ``fn`` that fails raises :class:`GraphCaptureError`
all the same, after its warm-up step was applied.

Launch counts (:mod:`repro_torch.counts`) count what ran: the warm-up's
launches reach ``launches`` as they happen; during the capture, which
launches nothing, the kernels' wrappers count into the graph's tally
(``counts.counting_into``; also from autograd's threads, which launch a
backward onto the captured stream), and each replay adds the tally to
``launches``. A call that captures thus counts the loop twice, a replay
once; a stateful call that captures counts its one step once, from the
warm-up. ``captures`` and ``replays`` are the jit cache's misses and hits;
``capture_s`` holds each key's warm-up and capture wall time, apart from
its replays; ``last_warmup`` holds the output of the latest capture's
warm-up, that key's eager launches on the inputs of its first call (the
yardstick a caller may hold the first replay against).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, Hashable, Tuple

import torch

from repro_torch import counts

_TORCH_DIR = os.path.dirname(torch.__file__)


def compile_key(arrays: Dict[str, torch.Tensor]) -> Tuple:
    """What ``jax.jit`` retraces on for a dict of arrays: its keys, each
    entry's shape and dtype."""
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in arrays.items())


class GraphCaptureError(RuntimeError):
    """``fn`` did something a CUDA graph cannot record (most often a
    synchronisation: ``.item()``, ``.tolist()``, a blocking copy between
    the host and the card)."""


@dataclasses.dataclass
class _Graph:
    graph: Any                       # torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    output: Any                      # a tensor or a tuple of tensors in the graph's pool
    tally: collections.Counter       # kernel launches of one replay


def _where(err: BaseException) -> str:
    """The innermost frame of ``err``'s traceback outside torch itself."""
    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if not f.filename.startswith(_TORCH_DIR)] or frames
    if not ours:
        return "an unknown statement"
    f = ours[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


_CAPTURE_LOCK = threading.Lock()


def _end_failed_capture(graph, pool, side, dev: torch.device) -> None:
    """Leave the card as a capture that never began would. A capture that
    ``fn`` invalidated ends without its epilogue: the default CUDA generator
    stays in capture mode (its next draw outside a graph raises "Offset
    increment outside graph capture") until its state is replaced by a copy,
    which keeps its seed and offset; and the caching allocator keeps routing
    to the graph's pool until that pool is ended (the allocator's own entry
    point, which raises when the capture's end already did it). Then the
    half-built graph is reset and the side stream drained."""
    gen = torch.cuda.default_generators[dev.index]
    gen.graphsafe_set_state(gen.clone_state())
    end_pool = (getattr(torch._C, "_cuda_endAllocateToPool", None)
                or getattr(torch._C, "_cuda_endAllocateCurrentStreamToPool", None))
    if end_pool is not None:
        try:
            end_pool(dev.index, pool)
        except RuntimeError:
            pass                    # the capture's end already ended the pool
    graph.reset()
    side.synchronize()


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(o.clone() for o in out)


def _fill(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src.device.type == "cpu":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class GraphCache:
    """CUDA graphs of one function family, keyed by compile key.

    Args:
      what: the name a failed capture reports.
      hint: appended to a failed capture's message (what to do instead).
      stateful: ``fn`` changes what it reads (a train step): a call that
        captures returns its warm-up's outputs and replays nothing.
    """

    def __init__(self, what: str, hint: str = "", stateful: bool = False):
        self.what = what
        self.hint = hint
        self.stateful = stateful
        self._graphs: Dict[Hashable, _Graph] = {}
        self._stream = None
        self.captures = 0
        self.replays = 0
        self.capture_s: Dict[Hashable, float] = {}
        self.last_warmup = None

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, key: Hashable, fn: Callable, *inputs: torch.Tensor):
        if inputs[0].device.type != "cuda":
            return fn(*inputs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, fn, inputs)
            self._graphs[key] = entry
            if self.stateful:
                return self.last_warmup
        for dst, src in zip(entry.inputs, inputs):
            _fill(dst, src)
        entry.graph.replay()
        self.replays += 1
        counts.add(entry.tally)
        return _clone(entry.output)

    def _capture(self, key, fn: Callable, inputs) -> _Graph:
        dev = torch.device("cuda", torch.cuda.current_device())
        t0 = time.perf_counter()
        with torch.inference_mode(False):    # buffers any later call may fill
            static = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs)
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = fn(*static)
        if self.stateful:
            # the caller's stream owns the step's outputs; the blocks the
            # step freed go back to the card for the graph's pool
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = _clone(warm)
            side.wait_stream(torch.cuda.current_stream(dev))
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()      # private to this graph
        tally: collections.Counter = collections.Counter()
        raised = []
        # one capture at a time in the process: the scheduler's draft worker
        # and its refine thread would otherwise capture at once
        capturing = torch.cuda.is_current_stream_capturing
        with _CAPTURE_LOCK:
            try:
                with counts.counting_into(tally, capturing), torch.cuda.graph(
                        graph, pool=pool, stream=side, capture_error_mode="thread_local"):
                    try:
                        out = fn(*static)
                    except Exception as err:
                        raised.append(err)
                        raise
            except Exception as err:
                _end_failed_capture(graph, pool, side, dev)
                cause = raised[0] if raised else err
                raise GraphCaptureError(
                    f"capturing {self.what} (key {key}) failed at {_where(cause)}: {cause}"
                    + ("; its warm-up step was applied" if self.stateful else "")
                    + (f"; {self.hint}" if self.hint else "")) from cause
        torch.cuda.current_stream(dev).wait_stream(side)
        self.last_warmup = warm
        self.captures += 1
        self.capture_s[key] = time.perf_counter() - t0
        return _Graph(graph, static, out, tally)

    def clear(self) -> None:
        """Drop every graph and its memory pool (the counters stay)."""
        self._graphs.clear()
        self.last_warmup = None

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays, "graphs": len(self._graphs),
                "capture_ms": {str(k): s * 1e3 for k, s in self.capture_s.items()}}
