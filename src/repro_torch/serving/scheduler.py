"""Continuous-batching warm-start serving engine (port of the JAX package's
``serving/scheduler.py``, guaranteed tier).

Request-level front end over the paper's two-stage pipeline:

    queue -> pow2 seq buckets -> padded micro-batches
          -> [draft stage | flow refine stage]  (overlapped)
          -> per-request slices + guarantee reports

The two stages use different models (a draft generator and the DFM flow
backbone), so while the flow model refines micro-batch k, a worker thread
derives keys and drafts micro-batch k+1. On the card the draft runs on its
own CUDA stream; its tokens pass to the refine stream with an event and
``record_stream``, and each stage synchronises its own stream before it
reads the clock (the JAX engine's ``block_until_ready``).

The refine of a micro-batch is one call of the shared masked per-row loop
(:func:`repro_torch.core.sampler.scan_refine_loop_rows`): eager launches,
one backbone evaluation and one ``ws_step`` per-row launch per step, or
one ``ws_fused`` launch per K steps with ``fused_block = K``. The loop
never writes the draft tokens in place, so a retried dispatch reuses them
as they are (the JAX engine donates the buffer and snapshots it first).
The compile-key accounting and its ``jit_cache.*`` counters keep the JAX
package's names, so the two reports compare key for key; the refine is
not captured per key yet (its draft is: the AR draft engine replays one
CUDA graph per ``(rows, prefix_len, bucket_len)``, captured on the worker
thread's stream).

Sampling is row-keyed: every sample row's PRNG stream is derived from its
request's seed and its index within the request, so a request's output
is invariant to micro-batch packing, and equals the JAX package's.

Not ported yet, each refused by the constructor: the ``t0_policy``
scoring pre-pass and bandit, ``speculative`` serving, the distilled tier,
``pair_buffer`` and ``mesh``. With them off, the reports carry the JAX
package's keys with the same ``None`` values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import guarantees
from repro_torch.core.paths import WarmStartPath
from repro_torch.core.sampler import (
    make_euler_one_step_rows, refine_schedule_rows, scan_refine_loop_rows,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.ws_fused import make_ws_fused_fn
from repro_torch.obs import MetricsRegistry, NullTracer, parse_metric_key
from repro_torch.serving.batcher import (
    ACCEPTED_DRAFT, CANCELLED, COMPLETED, DISTILLED, DISTILLED_TIER, DRAFT_STREAM, FAILED,
    FLOW_STREAM, GUARANTEED_TIER, PRIORITY_CLASSES, SHED, TIMED_OUT, CancelToken,
    FillingBucket, MicroBatch, ServeRequest, bucket_seq_len, pack_requests, pad_rows,
    priority_rank, split_request, usable_rows,
)
from repro_torch.serving.engine import DispatchFailure, DispatchRetryPolicy, PerNFECostModel




def _key_label(key: Any) -> str:
    """Compile key -> registry-label-safe string ((16, 4, 4) -> 16x4x4);
    metric labels may not contain commas or braces."""
    if isinstance(key, tuple):
        return "x".join(str(p) for p in key)
    return str(key)


def _key_from_label(label: str) -> str:
    """Inverse of :func:`_key_label` back to the report's str(tuple)."""
    parts = label.split("x")
    if len(parts) > 1:
        return f"({', '.join(parts)})"
    return label

# per-class SLO scaling for the streaming admission loop: a class's
# deadline is arrival + slo * factor; None disarms the deadline entirely
# (the class flushes only on full / idle / drain and is excluded from SLO
# attainment). This is the lever that trades best_effort p99 against
# premium attainment: premium deadlines are priced at face value while
# best_effort never forces a partial-bucket flush.
DEFAULT_CLASS_SLO_FACTOR: Dict[str, Optional[float]] = {
    "premium": 1.0,
    "standard": 1.0,
    "best_effort": None,
}


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Per-request output + the guarantee that was enforced for it.

    ``nfe`` is the request-level NFE bound ``warm_nfe(cold_nfe, t0)`` —
    with heterogeneous per-row t0 (``row_t0s`` non-empty) it is the
    WORST row's step count; deeper rows spent fewer. ``nfe == 0`` marks
    a speculatively ACCEPTED request: its draft cleared the acceptance
    probe and shipped with zero refine steps (``micro_batch == -1``,
    no guarantee machinery engaged — the guarantee holds vacuously)."""

    request_id: int
    tokens: np.ndarray              # (num_samples, seq_len) int32
    nfe: int
    t0: float
    bucket_len: int
    micro_batch: int
    row_t0s: Tuple[float, ...] = ()   # per-row t0 (per-row adaptive mode)


@dataclasses.dataclass(frozen=True)
class CompletedRequest(RequestResult):
    """A streamed result: the same payload as :class:`RequestResult`
    plus the request's admission/latency accounting. Yielded by
    :meth:`WarmStartScheduler.serve_stream` as each micro-batch
    finishes — the tokens are bit-identical to what the end-of-run batch
    path (:meth:`WarmStartScheduler.serve_requests`) returns for the
    same request.

    ``status`` is the request's terminal state
    (:data:`~repro_torch.serving.batcher.TERMINAL_STATUSES`): every admitted
    request is yielded exactly once, and only ``COMPLETED`` results
    carry tokens — cancelled / timed-out / shed / failed requests are
    surfaced with an empty ``(0, seq_len)`` token array instead of
    being silently dropped."""

    arrival_s: float = 0.0          # admission time (stream clock)
    finished_s: float = 0.0         # micro-batch completion time
    latency_s: float = 0.0          # finished - arrival (time-to-result)
    flush_reason: str = ""          # full | deadline | idle | drain
    deadline_s: Optional[float] = None   # arrival + SLO (None: no SLO)
    slo_met: Optional[bool] = None       # finished <= deadline
    chunks: int = 1                 # micro-batch chunks reassembled
    status: str = COMPLETED         # terminal status (batcher constants)
    priority: str = "standard"      # the request's priority class


class _MonotonicClock:
    """Default stream clock; tests inject a fake with the same shape."""

    @staticmethod
    def time() -> float:
        return time.monotonic()

    @staticmethod
    def sleep(dt: float) -> None:
        time.sleep(dt)


# chunk request_ids are minted from here — far above any sane user id
# space, so a chunk id can never collide with an admitted request's id
_CHUNK_ID_BASE = 1 << 40


class QueueClosed(ValueError):
    """Submission to a closed :class:`AdmissionQueue`.

    Raised instead of silently enqueueing a request that the serving
    loop may never drain (the loop stops once the queue is closed AND
    empty). A ``ValueError`` subclass so pre-existing callers that
    caught ``ValueError`` keep working.
    """


class QueueFull(RuntimeError):
    """A bounded :class:`AdmissionQueue` rejected a submission.

    Raised when the queue is at ``max_depth`` and the incoming request's
    priority class is not strictly higher than the lowest class already
    queued — there is nothing cheaper to shed in its favour. The
    rejection is counted in :meth:`AdmissionQueue.stats` (``rejected``),
    so offered-load accounting stays exact.
    """


class AdmissionQueue:
    """Thread-safe request intake for :meth:`WarmStartScheduler
    .serve_stream` — the arrival side of the admission loop.

    Producers (an RPC front end, a replay thread) call :meth:`submit` or
    :meth:`push` while the stream is being served; the serving loop
    drains it between dispatches and keeps serving until the queue is
    :meth:`close`-d AND empty. Arrival timestamps default to the
    queue's clock at submission.

    **Bounded admission (overload hardening).** With ``max_depth`` set,
    the queue never holds more than that many requests: a submission to
    a full queue either *sheds* the most recent request of the lowest
    priority class present — but only when the incoming request's class
    is strictly higher (shedding never touches premium to admit
    best_effort) — or is *rejected* with :class:`QueueFull`. Shed
    requests are handed to the serving loop via :meth:`take_shed` and
    surface as ``SHED`` terminal results; :meth:`stats` keeps the exact
    conservation ledger (``offered == accepted + rejected``, with every
    accepted request later shed or drained exactly once).

    **Cancellation.** Every :meth:`submit` mints a
    :class:`~repro_torch.serving.batcher.CancelToken` for its request
    (:meth:`push` attaches one if the request has none);
    :meth:`cancel` flips it by request_id at any point in the request's
    lifetime — still queued, waiting in a filling bucket, or already
    packed — and the serving loop resolves the request to a
    ``CANCELLED`` terminal status. Tokens are kept for the stream's
    lifetime so late cancels stay addressable.
    """

    _instances = itertools.count()

    def __init__(self, *, max_depth: Optional[int] = None, clock=None,
                 metrics: Optional[MetricsRegistry] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self._clock = clock if clock is not None else _MonotonicClock()
        self._lock = threading.Lock()
        self._items: deque = deque()
        self._closed = False
        self._next_id = 0
        self.max_depth = max_depth
        self._tokens: Dict[int, CancelToken] = {}
        self._shed: List[ServeRequest] = []
        # the admission ledger lives in the metrics registry (the queue
        # is its owner — see docs/ARCHITECTURE.md metric ownership). A
        # shared registry serves several queues over its lifetime, so
        # each queue's counters carry a distinct `queue=` label and
        # stats() stays exact per queue.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._queue_label = f"q{next(AdmissionQueue._instances)}"
        q = self._queue_label
        self._c_offered = self.metrics.counter("admission.offered", queue=q)
        self._c_accepted = self.metrics.counter("admission.accepted", queue=q)
        self._c_rejected = self.metrics.counter("admission.rejected", queue=q)
        self._c_shed = self.metrics.counter("admission.shed", queue=q)
        self._g_depth = self.metrics.gauge("admission.queue_depth", queue=q)
        self._shed_classes: set = set()

    def _admit_locked(self, req: ServeRequest) -> None:
        """Depth-bounded enqueue; caller holds the lock. Counts the
        offer, then either enqueues, sheds a lower-class victim to make
        room, or raises QueueFull."""
        self._c_offered.inc()
        if self.max_depth is not None and len(self._items) >= self.max_depth:
            rank_in = priority_rank(req.priority)
            worst = max(priority_rank(r.priority) for r in self._items)
            if worst <= rank_in:
                self._c_rejected.inc()
                raise QueueFull(
                    f"admission queue full (depth {self.max_depth}) and "
                    f"request {req.request_id} ({req.priority}) does not "
                    f"outrank any queued request")
            # shed the NEWEST request of the worst class present: it has
            # the least sunk queueing time, and the class ordering means
            # premium is never shed before best_effort
            for i in range(len(self._items) - 1, -1, -1):
                if priority_rank(self._items[i].priority) == worst:
                    victim = self._items[i]
                    del self._items[i]
                    self._shed.append(victim)
                    self._c_shed.inc()
                    self._shed_classes.add(victim.priority)
                    self.metrics.counter(
                        "admission.shed_by_class", queue=self._queue_label,
                        priority=victim.priority).inc()
                    break
        self._c_accepted.inc()
        self._items.append(req)
        self._g_depth.set(len(self._items))

    def submit(self, *, seq_len: int, num_samples: int = 1, seed: int = 0,
               t0: Optional[float] = None, priority: str = "standard",
               timeout_s: Optional[float] = None,
               arrival_s: Optional[float] = None,
               tier: str = GUARANTEED_TIER) -> int:
        """Enqueue one request; returns its request_id.

        Raises :class:`QueueClosed` after :meth:`close`, and
        :class:`QueueFull` when a bounded queue has nothing cheaper to
        shed (see the class docstring for the shed-vs-reject rule).
        """
        with self._lock:
            if self._closed:
                raise QueueClosed("admission queue is closed")
            rid = self._next_id
            self._next_id += 1
            token = CancelToken()
            self._tokens[rid] = token
            self._admit_locked(ServeRequest(
                request_id=rid, seq_len=seq_len, num_samples=num_samples,
                seed=seed, t0=t0, priority=priority, timeout_s=timeout_s,
                cancel_token=token, tier=tier,
                arrival_s=(self._clock.time() if arrival_s is None
                           else arrival_s)))
        return rid

    def push(self, req: ServeRequest) -> int:
        """Enqueue a pre-built request (its request_id must be unique
        across the stream; the submitter owns that contract)."""
        with self._lock:
            if self._closed:
                raise QueueClosed("admission queue is closed")
            self._next_id = max(self._next_id, req.request_id + 1)
            if req.arrival_s == 0.0:
                req = dataclasses.replace(req, arrival_s=self._clock.time())
            if req.cancel_token is None:
                req = dataclasses.replace(req, cancel_token=CancelToken())
            self._tokens[req.request_id] = req.cancel_token
            self._admit_locked(req)
        return req.request_id

    def cancel(self, request_id: int) -> bool:
        """Cancel a request by id; returns False for unknown ids.

        Safe at any point in the lifecycle — queued, filling, packed, or
        already finished (then a no-op): the serving loop masks the
        request out wherever it currently is and yields a ``CANCELLED``
        terminal result, leaving every sibling request's output
        bit-identical to a run where this request was never submitted.
        """
        with self._lock:
            token = self._tokens.get(request_id)
        if token is None:
            return False
        token.cancel()
        return True

    def close(self) -> None:
        """No further arrivals; the serving loop drains and terminates."""
        with self._lock:
            self._closed = True

    def drain(self) -> List[ServeRequest]:
        with self._lock:
            items = list(self._items)
            self._items.clear()
            self._g_depth.set(0)
        return items

    def take_shed(self) -> List[ServeRequest]:
        """Hand over requests shed since the last call (serving loop
        yields them as ``SHED`` terminal results)."""
        with self._lock:
            shed, self._shed = self._shed, []
        return shed

    def stats(self) -> dict:
        """Exact admission ledger: ``offered == accepted + rejected``;
        shed requests are the subset of accepted ones later evicted.
        Every value is read from this queue's registry counters — the
        registry IS the ledger."""
        with self._lock:
            return {
                "offered": self._c_offered.value,
                "accepted": self._c_accepted.value,
                "rejected": self._c_rejected.value,
                "shed": self._c_shed.value,
                "shed_by_class": {
                    c: self.metrics.counter(
                        "admission.shed_by_class", queue=self._queue_label,
                        priority=c).value
                    for c in sorted(self._shed_classes)},
                "max_depth": self.max_depth,
            }

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed and not self._items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


def _derive_row_keys(seeds, sample_idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """(draft_keys, flow_keys), each (B, 2) on the host: fold (seed, sample
    index) into two independent streams. Depends only on the request's own
    seed and the row's index within the request, never on batch position.
    Negative indices (padding rows) fold in as their uint32 bits, as JAX's
    ``fold_in`` takes them."""
    seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int64)
    idx = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64)
    keys = torch.stack([torch.zeros_like(seeds), seeds & prng.MASK], dim=-1)
    base = prng.fold_in(keys, idx)
    return prng.fold_in(base, DRAFT_STREAM), prng.fold_in(base, FLOW_STREAM)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({where}); the port's scheduler "
        f"serves the guaranteed tier")


class WarmStartScheduler:
    """Request scheduler over the draft/flow warm-start pipeline.

    Args:
      flow_model: DFM backbone holding its weights, with ``dfm_apply(tokens
        (B, N), t (B,)) -> logits (B, N, V)`` (``repro_torch.models.Model``),
        on ``device``.
      draft_fn: row-keyed draft generator ``(keys (B, 2), seq_len) -> (B,
        seq_len) int32`` on ``device`` (``repro_torch.serving.drafts``, or
        ``ARDraftEngine.as_draft_fn()``).
      cold_nfe: Euler steps of the cold-start baseline (step size 1/N).
      default_t0: warm-start time for requests without an override.
      temperature: softmax temperature of the refine step.
      fused_block: K > 1 refines in blocks of K draws per backbone
        evaluation through the ``ws_fused`` kernel (opt-in).
      max_rows / min_bucket / max_bucket / row_quantum: packing knobs
        (see :mod:`repro_torch.serving.batcher`).
      overlap: draft micro-batch k+1 on a worker thread while micro-batch k
        refines (off: strictly serial).
      t0_bin_width: grouping bin for per-request t0 values (see
        ``batcher.pack_requests``); 0 groups by exact t0.
      retry_policy: :class:`DispatchRetryPolicy` for refine-dispatch faults.
      class_slo_factor: per-priority-class SLO scaling for ``serve_stream``.
      tracer / metrics: ``repro_torch.obs`` span tracer (default no-op) and
        metrics registry (default a private one); report sections are
        derived from the registry, under the JAX package's counter names.
      device: where the refine runs: the card unless ``"cpu"`` is asked for.
      mesh / t0_policy / per_row_t0 / speculative / accept_score /
        distilled_model / distilled_params / distilled_nfe /
        distilled_accept_score / pair_buffer: not ported yet; each is taken
        at the JAX package's default, and any other value raises
        ``NotImplementedError`` naming the slice that will port it.
        (``flow_params`` is not taken: ``flow_model`` holds its weights.)
    """

    def __init__(
        self,
        *,
        flow_model: Any,
        draft_fn: Callable[[torch.Tensor, int], torch.Tensor],
        cold_nfe: int,
        default_t0: float,
        temperature: float = 1.0,
        fused_block: int = 1,
        max_rows: int = 32,
        min_bucket: int = 8,
        max_bucket: Optional[int] = None,
        row_quantum: int = 4,
        overlap: bool = True,
        t0_bin_width: Optional[float] = None,
        retry_policy: Optional[DispatchRetryPolicy] = None,
        class_slo_factor: Optional[Dict[str, Optional[float]]] = None,
        tracer: Optional[Any] = None,
        metrics: Optional[MetricsRegistry] = None,
        device: Any = "cuda",
        mesh: Optional[Any] = None,
        t0_policy: Optional[Any] = None,
        per_row_t0: bool = False,
        speculative: bool = False,
        accept_score: Optional[float] = None,
        distilled_model: Optional[Any] = None,
        distilled_params: Optional[Any] = None,
        distilled_nfe: int = 1,
        distilled_accept_score: Optional[float] = None,
        pair_buffer: Optional[Any] = None,
    ):
        if mesh is not None:
            raise _not_ported("mesh (sharded refine)", "the multi-card slice")
        if t0_policy is not None:
            raise _not_ported("t0_policy (scoring pre-pass, bandit)",
                              "the drafting-policies slice")
        if per_row_t0:
            raise _not_ported("per_row_t0 (per-row t0 from the policy)",
                              "the drafting-policies slice")
        if speculative:
            raise _not_ported("speculative serving", "the drafting-policies slice")
        if accept_score is not None:
            raise _not_ported("accept_score (speculative acceptance)",
                              "the drafting-policies slice")
        if distilled_model is not None:
            raise _not_ported("the distilled tier", "the distilled-tier slice")
        if distilled_params is not None:
            raise _not_ported("distilled_params", "the distilled-tier slice")
        if distilled_nfe != 1:
            raise _not_ported(f"distilled_nfe={distilled_nfe}", "the distilled-tier slice")
        if distilled_accept_score is not None:
            raise _not_ported("distilled_accept_score", "the distilled-tier slice")
        if pair_buffer is not None:
            raise _not_ported("pair_buffer (self-distillation harvest)",
                              "the distilled-tier slice")
        if cold_nfe < 1:
            raise ValueError(f"cold_nfe must be >= 1, got {cold_nfe}")
        if fused_block < 1:
            raise ValueError(f"fused_block must be >= 1, got {fused_block}")
        self.device = resolve_device(device)
        if flow_model.device.type != self.device.type:
            raise ValueError(f"flow_model lives on {flow_model.device}, "
                             f"scheduler on {self.device}")
        self.flow_model = flow_model
        self.draft_fn = draft_fn
        self.cold_nfe = cold_nfe
        self.default_t0 = default_t0
        self.temperature = temperature
        self.fused_block = fused_block
        self.max_rows = max_rows
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.row_quantum = row_quantum
        self.overlap = overlap
        self.t0_bin_width = float(t0_bin_width or 0.0)

        self.tracer = tracer if tracer is not None else NullTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_cache_hits = m.counter("jit_cache.hits")
        self._c_cache_misses = m.counter("jit_cache.misses")
        self._c_fused_blocks = m.counter("fused.blocks_dispatched")
        self._c_fused_steps = m.counter("fused.steps_fused")
        self._c_dispatch_retries = m.counter("dispatch.retries")
        self._c_dispatch_failures = m.counter("dispatch.failures")

        self._queue: List[ServeRequest] = []
        self._next_id = 0
        self._compiled: set = set()     # compile_key accounting
        # the streaming admission loop's latency oracle: per-NFE refine cost
        # EWMA per compile key, and the draft stage's cost EWMA beside it
        self.cost_model = PerNFECostModel(metrics=m)
        self._draft_cost_ewma: Optional[float] = None
        self._chunk_ids = itertools.count(_CHUNK_ID_BASE)
        self.stream_report: Optional[dict] = None
        self.retry_policy = (retry_policy if retry_policy is not None
                             else DispatchRetryPolicy())
        self.class_slo_factor = dict(DEFAULT_CLASS_SLO_FACTOR)
        if class_slo_factor:
            for cls, factor in class_slo_factor.items():
                priority_rank(cls)      # raises on unknown classes
                self.class_slo_factor[cls] = factor
        # test-only fault injection: when set, called as hook(mb, attempt)
        # immediately before every refine dispatch attempt; raising from it
        # makes that attempt fail exactly like a device fault would
        self._dispatch_fault_hook: Optional[Callable[[Any, int], None]] = None
        # the active stream's clock, so retry backoff sleeps on it
        self._stream_clock: Optional[Any] = None

        # velocity_scale does not depend on t0 for the linear path, so one
        # stepping function serves every per-request t0 (the t0 only moves
        # the per-row schedule)
        path = WarmStartPath(t0=0.0)
        self._one_step = make_euler_one_step_rows(path, temperature=temperature)
        self._fused_fn = (make_ws_fused_fn(path, temperature=temperature)
                          if fused_block > 1 else None)
        self._draft_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)

    def _refine_loop(self, flow_keys, x, ts, hs, active, key_idx) -> torch.Tensor:
        """The masked per-row refine of one micro-batch (eager launches)."""
        with torch.inference_mode():
            return scan_refine_loop_rows(
                self.flow_model.dfm_apply, self._one_step, x, flow_keys, ts, hs, active,
                key_idx, fused_block=self.fused_block, fused_fn=self._fused_fn)

    # ---- request intake --------------------------------------------------

    def submit(self, *, seq_len: int, num_samples: int = 1, seed: int = 0,
               t0: Optional[float] = None, tier: str = GUARANTEED_TIER) -> int:
        """Enqueue one request; returns its request_id. ``t0=None`` serves at
        ``default_t0``. Rejects unservable requests here (bucket overflow,
        too many samples, the unported distilled tier), so one bad request
        can never poison a queued batch."""
        bucket_seq_len(seq_len, min_bucket=self.min_bucket, max_bucket=self.max_bucket)
        padded = pad_rows(num_samples, self.row_quantum)
        if padded > self.max_rows:
            raise ValueError(f"num_samples {num_samples} pads to {padded} rows > max_rows "
                             f"{self.max_rows} (split the request)")
        if tier == DISTILLED_TIER:
            raise ValueError("tier='distilled' needs distilled_model/distilled_params "
                             "on the scheduler")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(ServeRequest(request_id=rid, seq_len=seq_len,
                                        num_samples=num_samples, seed=seed, t0=t0, tier=tier))
        return rid

    # ---- stages ----------------------------------------------------------

    def _mb_row_streams(self, mb: MicroBatch):
        """(seeds, idx) int32 arrays deriving the per-row key streams."""
        seeds = np.zeros((mb.padded_rows,), np.int32)
        idx = np.zeros((mb.padded_rows,), np.int32)
        for span in mb.spans:
            for r in range(span.rows):
                seeds[span.row_offset + r] = span.request.seed
                # oversize-split chunks keep their rows' ORIGINAL sample
                # indices, so a chunk row's stream is the unsplit request's
                idx[span.row_offset + r] = span.request.sample_offset + r
        # padding rows: a fixed dummy stream (seed 0, descending negative
        # sample indices cannot collide with real rows of seed 0)
        for r in range(mb.rows, mb.padded_rows):
            seeds[r], idx[r] = 0, -(r + 1)
        return seeds, idx

    def _stage_keys_and_draft(self, mb: MicroBatch):
        """Draft stage for one micro-batch (runs on the worker thread):
        derive per-row keys, draft at bucket length on the draft stream,
        wait for it. Returns ``(x, flow_keys, t_draft, ready)``: ``ready``
        is the event the refine stream waits on (None on the CPU)."""
        with self.tracer.span("draft", track="draft_worker", bucket=mb.bucket_len,
                              rows=mb.rows, predrafted=False):
            t0 = time.perf_counter()
            seeds, idx = self._mb_row_streams(mb)
            draft_keys, flow_keys = _derive_row_keys(seeds, idx)
            ready = None
            stream = self._draft_stream
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx, torch.no_grad():
                x = self.draft_fn(draft_keys, mb.bucket_len)
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
            if stream is not None:
                stream.synchronize()
            if x.device.type != self.device.type or x.shape != (mb.padded_rows, mb.bucket_len):
                raise ValueError(f"draft_fn returned {tuple(x.shape)} on {x.device}, expected "
                                 f"({mb.padded_rows}, {mb.bucket_len}) on {self.device}")
            t_draft = time.perf_counter() - t0
            self._draft_cost_ewma = (t_draft if self._draft_cost_ewma is None
                                     else 0.7 * self._draft_cost_ewma + 0.3 * t_draft)
            self.metrics.gauge("draft.cost_ewma_s").set(self._draft_cost_ewma)
        return x, flow_keys, t_draft, ready

    def _dispatch_refine(self, mb: MicroBatch, x, flow_keys, ts, hs, active, key_idx):
        """One refine dispatch with bounded-backoff retries
        (:class:`DispatchRetryPolicy`). The loop leaves ``x`` untouched, so
        every retry starts from the same drafts. Raises
        :class:`DispatchFailure` once the budget is spent; the streaming loop
        turns that into ``FAILED`` results for this micro-batch only, the
        batch path re-queues."""
        policy = self.retry_policy
        for attempt in range(policy.attempts):
            try:
                if self._dispatch_fault_hook is not None:
                    self._dispatch_fault_hook(mb, attempt)
                out = self._refine_loop(flow_keys, x, ts, hs, active, key_idx)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                return out
            except Exception as err:  # noqa: BLE001 — device faults vary
                if attempt >= policy.max_retries:
                    self._c_dispatch_failures.inc()
                    raise DispatchFailure(mb.compile_key, attempt + 1, err) from err
                self._c_dispatch_retries.inc()
                sleep = (self._stream_clock.sleep
                         if self._stream_clock is not None else time.sleep)
                sleep(policy.backoff_s(attempt))
        raise AssertionError("unreachable")  # pragma: no cover

    def _stage_refine(self, mb: MicroBatch, x, flow_keys, ready=None):
        """Flow stage for one micro-batch: the masked per-row refine on the
        calling thread's stream, after the draft's ``ready`` event."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            x.record_stream(stream)
        span = self.tracer.span("refine", track="refine_dispatch", bucket=mb.bucket_len,
                                rows=mb.rows, padded_rows=mb.padded_rows, tier=mb.tier,
                                key=str(mb.compile_key))
        with span as sp:
            t0 = time.perf_counter()
            key = mb.compile_key
            was_miss = key not in self._compiled
            if was_miss:
                self._compiled.add(key)
                self._c_cache_misses.inc()
            else:
                self._c_cache_hits.inc()
            self.metrics.counter("jit_cache.per_key", key=_key_label(key),
                                 kind="miss" if was_miss else "hit").inc()
            sp["cache"] = "miss" if was_miss else "hit"
            ts, hs, active, key_idx, _ = refine_schedule_rows(
                mb.row_t0s, 1.0 / self.cold_nfe, self.cold_nfe)
            sp["nfe"] = len(ts)
            if self.fused_block > 1:
                k = min(self.fused_block, len(ts))
                self._c_fused_blocks.inc(-(-len(ts) // k))
                self._c_fused_steps.inc(len(ts))
            x = self._dispatch_refine(mb, x, flow_keys, ts, hs, active, key_idx)
            # observed NFE = what the executed schedule spent: the loop length
            # for the batch (against warm_nfe(cold_nfe, min t0)) and, per row,
            # the active-step count against the row's own warm_nfe
            guarantees.require_bucket_guarantee(self.cold_nfe, mb.t0, len(ts),
                                                bucket_len=mb.bucket_len, rows=mb.rows)
            observed_rows = active.sum(axis=0)
            mask = mb.row_mask
            guarantees.require_row_guarantees(self.cold_nfe, mb.row_t0s[mask],
                                              observed_rows[mask], bucket_len=mb.bucket_len,
                                              rows=mb.rows)
            t_flow = time.perf_counter() - t0
            self.cost_model.observe(key, t_flow, len(ts), compiled=was_miss)
        return x, t_flow

    # ---- jit-cache / fused-dispatch reporting ----------------------------

    def _jit_cache_snapshot(self):
        """Registry snapshot, so each run/stream reports its own deltas."""
        return self.metrics.snapshot()

    def _jit_cache_delta(self, snap) -> dict:
        """The report's ``jit_cache`` section from registry counter deltas
        since ``snap``: aggregate and per-compile-key hit/miss counts and
        fused-block dispatch totals."""
        deltas = self.metrics.counter_deltas(snap)
        per_key: Dict[str, Dict[str, int]] = {}
        for mkey, v in deltas.items():
            name, labels = parse_metric_key(mkey)
            if name != "jit_cache.per_key":
                continue
            entry = per_key.setdefault(_key_from_label(labels["key"]), {"hits": 0, "misses": 0})
            entry["hits" if labels["kind"] == "hit" else "misses"] += v
        return {
            "hits": deltas.get("jit_cache.hits", 0),
            "misses": deltas.get("jit_cache.misses", 0),
            "per_key": dict(sorted(per_key.items())),
            "fused": {
                "fused_block": self.fused_block,
                "blocks_dispatched": deltas.get("fused.blocks_dispatched", 0),
                "steps_fused": deltas.get("fused.steps_fused", 0),
            },
        }

    # ---- the pipeline ----------------------------------------------------

    def run(self) -> Tuple[Dict[int, RequestResult], dict]:
        """Drain the queue through the overlapped two-stage pipeline;
        ``(results by request_id, report)``. On failure the unserved
        requests go back on the queue."""
        requests, self._queue = self._queue, []
        try:
            return self.serve_requests(requests)
        except Exception:
            self._queue = requests + self._queue
            raise

    def _pipeline(self, batches: Sequence[MicroBatch]) -> Iterator[tuple]:
        """``(k, mb, x, t_draft, t_flow)`` per micro-batch, in order: the
        draft of batch k+1 on the worker thread while batch k refines."""
        if not self.overlap or len(batches) <= 1:
            for k, mb in enumerate(batches):
                x, flow_keys, t_draft, ready = self._stage_keys_and_draft(mb)
                x, t_flow = self._stage_refine(mb, x, flow_keys, ready)
                yield k, mb, x, t_draft, t_flow
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._stage_keys_and_draft, batches[0])
            for k, mb in enumerate(batches):
                x, flow_keys, t_draft, ready = fut.result()
                if k + 1 < len(batches):
                    fut = pool.submit(self._stage_keys_and_draft, batches[k + 1])
                x, t_flow = self._stage_refine(mb, x, flow_keys, ready)
                yield k, mb, x, t_draft, t_flow

    def serve_requests(self, requests: Sequence[ServeRequest]
                       ) -> Tuple[Dict[int, RequestResult], dict]:
        wall0 = time.perf_counter()
        results: Dict[int, RequestResult] = {}
        batch_reports: List[dict] = []
        cache_snap = self._jit_cache_snapshot()
        draft_total = flow_total = 0.0
        for req in requests:
            if req.tier == DISTILLED_TIER:
                raise ValueError("tier='distilled' needs distilled_model/distilled_params "
                                 "on the scheduler")
        batches = pack_requests(
            requests, cold_nfe=self.cold_nfe, default_t0=self.default_t0,
            max_rows=self.max_rows, min_bucket=self.min_bucket, max_bucket=self.max_bucket,
            row_quantum=self.row_quantum, t0_bin_width=self.t0_bin_width)
        for k, mb, x, t_draft, t_flow in self._pipeline(batches):
            draft_total += t_draft
            flow_total += t_flow
            x_host = x.cpu().numpy()
            for span, span_t0, span_rows in zip(mb.spans, mb.t0_spans, mb.row_t0_spans):
                req = span.request
                results[req.request_id] = RequestResult(
                    request_id=req.request_id,
                    tokens=x_host[span.row_offset:span.row_offset + span.rows, :req.seq_len],
                    nfe=guarantees.warm_nfe(self.cold_nfe, span_t0), t0=span_t0,
                    bucket_len=mb.bucket_len, micro_batch=k, row_t0s=span_rows)
            batch_reports.append({
                "micro_batch": k, "bucket_len": mb.bucket_len, "rows": mb.rows,
                "padded_rows": mb.padded_rows, "t0": mb.t0, "t0_spans": list(mb.t0_spans),
                "nfe": mb.n_steps, "tier": mb.tier,
                "draft_time_s": t_draft, "flow_time_s": t_flow,
            })

        wall = time.perf_counter() - wall0
        overlapped = max(0.0, draft_total + flow_total - wall)
        denom = min(draft_total, flow_total)
        rows = sum(mb.rows for mb in batches)

        def req_mean_nfe(r: RequestResult) -> float:
            # heterogeneous rows: the request spent the mean of its rows'
            # own step counts (r.nfe stays the worst-row bound)
            if r.row_t0s:
                return float(np.mean([guarantees.warm_nfe(self.cold_nfe, t)
                                      for t in r.row_t0s]))
            return float(r.nfe)

        nfe_values = [req_mean_nfe(r) for r in results.values()]
        report = {
            "num_requests": len(requests),
            "num_micro_batches": len(batches),
            "rows": rows,
            "padded_rows": sum(mb.padded_rows for mb in batches),
            "draft_time_s": draft_total,
            "flow_time_s": flow_total,
            "wall_time_s": wall,
            "overlap": self.overlap,
            "overlap_efficiency": (overlapped / denom) if denom > 0 else 0.0,
            "requests_per_s": len(requests) / wall if wall > 0 else float("inf"),
            "samples_per_s": rows / wall if wall > 0 else float("inf"),
            "mean_request_nfe": float(np.mean(nfe_values)) if nfe_values else 0.0,
            "jit_cache": self._jit_cache_delta(cache_snap),
            "mesh": None,
            "adaptive_t0": False,
            "policy": None,
            "speculative": None,
            "bandit": None,
            "distilled": None,
            "batches": batch_reports,
        }
        return results, report

    # ---- streaming / SLO-aware admission ---------------------------------

    def _stream_est_latency_s(self, fb: FillingBucket, unit: int, backlog_s: float) -> float:
        """Estimated time from 'flush now' to 'results out' for a filling
        bucket: pipeline backlog + draft-stage EWMA + measured per-NFE
        refine cost x worst-case steps (a first-dispatch surcharge for a new
        compile key). Zero until the first measurement."""
        t0_lb = min(self.default_t0 if r.t0 is None else float(r.t0) for r in fb.requests)
        n_steps = guarantees.warm_nfe(self.cold_nfe, t0_lb)
        key = (fb.bucket_len, pad_rows(fb.rows, unit), n_steps)
        est = self.cost_model.estimate_s(key, n_steps, include_compile=True)
        return backlog_s + (self._draft_cost_ewma or 0.0) + (est or 0.0)

    def _mb_est_latency_s(self, mb: MicroBatch) -> float:
        est = self.cost_model.estimate_s(mb.compile_key, mb.n_steps, include_compile=True)
        return (self._draft_cost_ewma or 0.0) + (est or 0.0)

    def _flush_bucket(self, fb: FillingBucket, reason: str, now: float) -> List[dict]:
        """FillingBucket -> dispatched micro-batches (the state machine's
        edge to DISPATCHED)."""
        occupancy = fb.rows
        self.tracer.instant("bucket_flush", track="flush", reason=reason,
                            bucket=fb.bucket_len, rows=occupancy, requests=len(fb.requests))
        self.metrics.counter("serve.flush", reason=reason).inc()
        self.metrics.histogram("bucket.flush_rows", buckets=(1, 2, 4, 8, 16, 32, 64, 128),
                               bucket=fb.bucket_len).observe(occupancy)
        reqs = fb.flush()               # deadline order
        batches = pack_requests(
            reqs, cold_nfe=self.cold_nfe, default_t0=self.default_t0,
            max_rows=self.max_rows, min_bucket=self.min_bucket, max_bucket=self.max_bucket,
            row_quantum=self.row_quantum, t0_bin_width=self.t0_bin_width)
        for mb in batches:
            for span in mb.spans:
                self.tracer.instant("request_packed", track="flush",
                                    flow_id=span.request.root_id, flow_ph="t",
                                    request_id=span.request.root_id, bucket=mb.bucket_len,
                                    reason=reason)
        return [{"mb": mb, "reason": reason, "flushed_s": now} for mb in batches]

    def serve_stream(
        self,
        requests: Optional[Sequence[ServeRequest]] = None,
        *,
        source: Optional[AdmissionQueue] = None,
        slo_ms: Optional[float] = None,
        idle_timeout_s: float = 0.05,
        poll_interval_s: float = 0.002,
        clock=None,
    ) -> Iterator[CompletedRequest]:
        """Streaming, continuously admitting serve loop.

        Yields a :class:`CompletedRequest` per request as its micro-batch
        finishes (oversize requests are split across micro-batches and
        reassembled first). Tokens equal :meth:`serve_requests`' for the
        same request set: per-row PRNG streams, bucket choice and NFE
        schedules are functions of the request alone, and the same per-row
        guarantee gates run on every dispatch.

        Admission: ``requests`` (admitted at once) and/or ``source`` (an
        :class:`AdmissionQueue` that producers keep filling). Requests wait
        in per-(bucket, priority, tier) :class:`FillingBucket`\\ s and are
        dispatched when a bucket fills, when the oldest request's SLO
        budget would otherwise be blown (``slo_ms``, against the measured
        per-NFE cost model), when arrivals go quiet (``idle_timeout_s``),
        or when the source closes. The next micro-batch's draft overlaps
        the current refine, as in the batch path.

        Every admitted request resolves to exactly one terminal result:
        ``COMPLETED`` with tokens, or ``CANCELLED`` / ``TIMED_OUT`` /
        ``SHED`` / ``FAILED`` with an empty token array. A refine dispatch
        that still fails after the retry budget fails only its own
        micro-batch. Premium micro-batches dispatch ahead of best_effort
        ones; per-class deadlines scale by ``class_slo_factor``.

        Afterwards ``self.stream_report`` holds latency percentiles, SLO
        attainment, flush reasons, the admission / terminal ledgers with
        the conservation check, dispatch retries and per-micro-batch
        timings. ``clock`` has ``time()``/``sleep(dt)`` (default monotonic
        wall time; tests inject a fake one).
        """
        clock = clock if clock is not None else _MonotonicClock()
        slo_s = None if slo_ms is None else float(slo_ms) / 1e3
        unit = self.row_quantum
        if requests is None and source is None:
            raise ValueError("serve_stream needs `requests` and/or `source`")
        own_source = source is None
        if own_source:
            source = AdmissionQueue(clock=clock, metrics=self.metrics)
        if requests is not None:
            now0 = clock.time()
            with source._lock:
                for req in requests:
                    # arrival = stream start for a pre-known request set; it
                    # is counted in the admission ledger and its cancel token
                    # registered, like a producer's submission
                    if req.arrival_s == 0.0:
                        req = dataclasses.replace(req, arrival_s=now0)
                    if req.cancel_token is None:
                        req = dataclasses.replace(req, cancel_token=CancelToken())
                    source._tokens[req.request_id] = req.cancel_token
                    source._c_offered.inc()
                    source._c_accepted.inc()
                    source._items.append(req)
                    source._next_id = max(source._next_id, req.request_id + 1)
                source._g_depth.set(len(source._items))
        if own_source:
            source.close()

        # filling buckets keyed by (bucket_len, priority, tier): a class never
        # waits on (or pads into) another class's bucket
        filling: Dict[Tuple[int, str, str], FillingBucket] = {}
        ready: List[dict] = []          # flushed micro-batches -> pipeline
        partials: Dict[int, dict] = {}  # parent_id -> chunk reassembly
        mb_reports: List[dict] = []
        latencies: List[float] = []
        class_latencies: Dict[str, List[float]] = {c: [] for c in PRIORITY_CLASSES}
        draft_total = flow_total = 0.0
        t_first: Optional[float] = None
        first_arrival_s: Optional[float] = None
        # one registry snapshot anchors every report section
        m0 = self._jit_cache_snapshot()
        wall0 = clock.time()
        mb_index = itertools.count()
        # every admitted root request id lands in `resolved` exactly once
        resolved: set = set()
        m = self.metrics
        tracer = self.tracer

        def count_terminal(status: str, priority: str) -> None:
            m.counter("serve.terminal", status=status, priority=priority).inc()

        def class_deadline(req: ServeRequest) -> Optional[float]:
            """arrival + slo * class factor; None for classes whose factor is
            None (best_effort by default)."""
            if slo_s is None:
                return None
            factor = self.class_slo_factor.get(req.priority, 1.0)
            if factor is None:
                return None
            return req.arrival_s + slo_s * factor

        def terminal(req: ServeRequest, status: str, now: float) -> Optional[CompletedRequest]:
            """Resolve ``req``'s root request to a non-COMPLETED status; None
            when already resolved (chunks share their parent's fate)."""
            root = req.root_id
            if root in resolved:
                return None
            resolved.add(root)
            part = partials.pop(root, None)
            n_chunks = part["num_chunks"] if part is not None else 1
            count_terminal(status, req.priority)
            # shed / timed-out / failed requests count against their class's
            # SLO attainment; a caller's cancel does not
            if status != CANCELLED and class_deadline(req) is not None:
                m.counter("serve.slo_total", priority=req.priority, served=False).inc()
            tracer.instant("request_terminal", track="terminal", flow_id=root, flow_ph="f",
                           request_id=root, status=status, priority=req.priority,
                           latency_ms=(now - req.arrival_s) * 1e3)
            return CompletedRequest(
                request_id=root, tokens=np.zeros((0, req.seq_len), np.int32),
                nfe=0, t0=0.0, bucket_len=0, micro_batch=-1,
                arrival_s=req.arrival_s, finished_s=now, latency_s=now - req.arrival_s,
                flush_reason="", deadline_s=None, slo_met=None, chunks=n_chunks,
                status=status, priority=req.priority)

        def admit(req: ServeRequest, now: float):
            nonlocal first_arrival_s
            if req.parent_id is not None:
                raise ValueError(
                    f"request {req.request_id} carries chunk metadata "
                    f"(parent_id={req.parent_id}); submit the parent request whole — "
                    f"the admission loop splits it")
            m.counter("serve.admitted").inc()
            if req.tier == DISTILLED_TIER:
                raise ValueError("tier='distilled' request admitted but the scheduler "
                                 "has no distilled model")
            if first_arrival_s is None or req.arrival_s < first_arrival_s:
                first_arrival_s = req.arrival_s
            pieces = [req]
            if req.num_samples > usable_rows(self.max_rows, unit):
                pieces = split_request(req, max_rows=self.max_rows, unit=unit,
                                       alloc_id=lambda: next(self._chunk_ids))
                m.counter("serve.split_requests").inc()
                partials[req.request_id] = {
                    "tokens": None, "rows_done": 0, "chunks_done": 0,
                    "num_chunks": len(pieces), "arrival_s": req.arrival_s,
                    "seq_len": req.seq_len, "samples": req.num_samples,
                }
            for piece in pieces:
                blen = bucket_seq_len(piece.seq_len, min_bucket=self.min_bucket,
                                      max_bucket=self.max_bucket)
                fkey = (blen, piece.priority, piece.tier)
                fb = filling.get(fkey)
                if fb is not None and fb.would_overflow(piece.num_samples,
                                                        max_rows=self.max_rows, unit=unit):
                    ready.extend(self._flush_bucket(fb, "full", now))
                    fb = None
                if fb is None:
                    fb = FillingBucket(blen)
                    filling[fkey] = fb
                fb.add(piece, deadline_s=class_deadline(piece))

        def pop_ready() -> Optional[dict]:
            """Next micro-batch: best priority class first (FIFO within a
            class), dropping micro-batches whose every span already
            resolved (no compute spent on them)."""
            while ready:
                best = min(range(len(ready)), key=lambda i: (
                    min(priority_rank(s.request.priority) for s in ready[i]["mb"].spans), i))
                pending = ready.pop(best)
                if all(s.request.root_id in resolved for s in pending["mb"].spans):
                    m.counter("serve.dropped_micro_batches").inc()
                    continue
                return pending
            return None

        def complete(pending: dict, x, t_draft: float, t_flow: float):
            """One finished micro-batch -> CompletedRequests. Spans whose
            request was cancelled or timed out in flight are masked out; the
            sibling rows are untouched."""
            nonlocal draft_total, flow_total, t_first
            draft_total += t_draft
            flow_total += t_flow
            mb = pending["mb"]
            k = next(mb_index)
            finished_s = clock.time()
            m.histogram("serve.queue_wait_s").observe(finished_s - pending["flushed_s"])
            mb_reports.append({
                "micro_batch": k, "bucket_len": mb.bucket_len,
                "rows": mb.rows, "padded_rows": mb.padded_rows,
                "t0": mb.t0, "t0_spans": list(mb.t0_spans),
                "nfe": mb.n_steps, "tier": mb.tier,
                "flush_reason": pending["reason"],
                "queue_wait_s": finished_s - pending["flushed_s"],
                "draft_time_s": t_draft, "flow_time_s": t_flow,
            })
            x_host = x.cpu().numpy()
            out = []
            for span, span_t0, span_rows in zip(mb.spans, mb.t0_spans, mb.row_t0_spans):
                req = span.request
                if req.root_id in resolved:
                    continue    # already terminal (a sibling chunk's fate)
                if req.cancelled or req.expired(finished_s):
                    item = terminal(req, CANCELLED if req.cancelled else TIMED_OUT,
                                    finished_s)
                    if item is not None:
                        out.append(item)
                    continue
                nfe = guarantees.warm_nfe(self.cold_nfe, span_t0)
                toks = x_host[span.row_offset:span.row_offset + span.rows, :req.seq_len]
                if req.parent_id is not None:
                    part = partials[req.parent_id]
                    if part["tokens"] is None:
                        part["tokens"] = np.zeros((part["samples"], part["seq_len"]),
                                                  toks.dtype)
                    part["tokens"][req.sample_offset:
                                   req.sample_offset + req.num_samples] = toks
                    part["rows_done"] += req.num_samples
                    part["chunks_done"] += 1
                    if part["rows_done"] < part["samples"]:
                        continue
                    rid, tokens = req.parent_id, part["tokens"]
                    arrival, chunks = part["arrival_s"], part["num_chunks"]
                    del partials[req.parent_id]
                else:
                    rid, tokens = req.request_id, toks
                    arrival, chunks = req.arrival_s, 1
                resolved.add(rid)
                deadline = class_deadline(req)
                met = None if deadline is None else finished_s <= deadline
                latency = finished_s - arrival
                latencies.append(latency)
                class_latencies[req.priority].append(latency)
                count_terminal(COMPLETED, req.priority)
                m.histogram("serve.latency_s", priority=req.priority).observe(latency)
                if deadline is not None:
                    m.counter("serve.slo_total", priority=req.priority, served=True).inc()
                    if met:
                        m.counter("serve.slo_met", priority=req.priority).inc()
                tracer.instant("request_terminal", track="terminal", flow_id=rid,
                               flow_ph="f", request_id=rid, status=COMPLETED,
                               priority=req.priority, latency_ms=latency * 1e3)
                if t_first is None:
                    t_first = finished_s
                out.append(CompletedRequest(
                    request_id=rid, tokens=tokens, nfe=nfe, t0=span_t0,
                    bucket_len=mb.bucket_len, micro_batch=k,
                    row_t0s=span_rows if chunks == 1 else (),
                    arrival_s=arrival, finished_s=finished_s, latency_s=latency,
                    flush_reason=pending["reason"], deadline_s=deadline, slo_met=met,
                    chunks=chunks, status=COMPLETED, priority=req.priority))
            return out

        def admitted(req: ServeRequest) -> None:
            tracer.instant("request_admitted", track="admission", flow_id=req.root_id,
                           flow_ph="s", request_id=req.root_id, priority=req.priority,
                           seq_len=req.seq_len)

        draft_fut = None
        draft_pending = None
        # retry backoff inside _dispatch_refine sleeps on this stream's clock
        self._stream_clock = clock
        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                while True:
                    now = clock.time()
                    # requests the bounded queue evicted become SHED results
                    for req in source.take_shed():
                        admitted(req)
                        item = terminal(req, SHED, now)
                        if item is not None:
                            yield item
                    for req in source.drain():
                        admitted(req)
                        if req.cancelled or req.expired(now):
                            item = terminal(req, CANCELLED if req.cancelled else TIMED_OUT,
                                            now)
                            if item is not None:
                                yield item
                            continue
                        admit(req, now)
                    source_done = source.closed
                    # cancellation / timeout sweep: pruned requests free their
                    # rows before packing, so siblings pack as if they never came
                    for fkey in list(filling):
                        fb = filling[fkey]
                        for req, status in fb.prune(now):
                            item = terminal(req, status, now)
                            if item is not None:
                                yield item
                        if not fb.requests:
                            del filling[fkey]
                    # deadline / idle / drain flush sweep
                    backlog_s = sum(self._mb_est_latency_s(p["mb"]) for p in ready)
                    if draft_pending is not None:
                        backlog_s += self._mb_est_latency_s(draft_pending["mb"])
                    for fkey in list(filling):
                        fb = filling[fkey]
                        reason = ("drain" if source_done else fb.flush_decision(
                            now, est_latency_s=self._stream_est_latency_s(fb, unit, backlog_s),
                            idle_timeout_s=idle_timeout_s, max_rows=self.max_rows, unit=unit))
                        if reason:
                            ready.extend(self._flush_bucket(fb, reason, now))
                            del filling[fkey]
                    # pipeline: the NEXT micro-batch drafts while this one refines
                    if draft_fut is None and ready:
                        draft_pending = pop_ready()
                        if draft_pending is not None:
                            draft_fut = pool.submit(self._stage_keys_and_draft,
                                                    draft_pending["mb"])
                    if draft_fut is not None:
                        x, flow_keys, t_draft, ev = draft_fut.result()
                        current, draft_fut, draft_pending = draft_pending, None, None
                        if ready:
                            draft_pending = pop_ready()
                            if draft_pending is not None:
                                draft_fut = pool.submit(self._stage_keys_and_draft,
                                                        draft_pending["mb"])
                        try:
                            x, t_flow = self._stage_refine(current["mb"], x, flow_keys, ev)
                        except DispatchFailure:
                            # the retry budget is spent: fail ONLY this
                            # micro-batch's requests and keep serving
                            m.counter("serve.failed_micro_batches").inc()
                            draft_total += t_draft
                            fail_s = clock.time()
                            for span in current["mb"].spans:
                                item = terminal(span.request, FAILED, fail_s)
                                if item is not None:
                                    yield item
                            continue
                        for item in complete(current, x, t_draft, t_flow):
                            yield item
                        continue
                    if source_done and not filling and not ready and draft_fut is None:
                        break
                    clock.sleep(poll_interval_s)
        finally:
            self._stream_clock = None

        wall = clock.time() - wall0

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else 0.0

        # every counter-valued section is a registry delta against m0
        parsed = [(parse_metric_key(k), v) for k, v in self.metrics.counter_deltas(m0).items()]

        def dsum(name: str, **match) -> int:
            want = {k: str(v) for k, v in match.items()}
            return sum(v for (n, labels), v in parsed
                       if n == name and all(labels.get(mk) == mv for mk, mv in want.items()))

        admission = source.stats()
        statuses = (COMPLETED, ACCEPTED_DRAFT, DISTILLED, CANCELLED, TIMED_OUT, SHED, FAILED)
        terminal_counts = {s: dsum("serve.terminal", status=s) for s in statuses}
        resolved_total = sum(terminal_counts.values())
        flush_reasons = {labels["reason"]: v for (n, labels), v in parsed if n == "serve.flush"}
        slo_served = dsum("serve.slo_total", served=True)
        slo_met_n = dsum("serve.slo_met")
        by_class_report = {}
        for cname in PRIORITY_CLASSES:
            counts = {s: dsum("serve.terminal", status=s, priority=cname) for s in statuses}
            if not any(counts.values()):
                continue
            lat = class_latencies[cname]
            ctot = dsum("serve.slo_total", priority=cname)
            cmet = dsum("serve.slo_met", priority=cname)
            by_class_report[cname] = {
                "completed": counts[COMPLETED],
                "accepted_draft": counts[ACCEPTED_DRAFT],
                "distilled": counts[DISTILLED],
                "shed": counts[SHED],
                "cancelled": counts[CANCELLED],
                "timed_out": counts[TIMED_OUT],
                "failed": counts[FAILED],
                "slo_attainment": (cmet / ctot if ctot else None),
                "latency_ms": {"p50": pct(lat, 50) * 1e3, "p95": pct(lat, 95) * 1e3,
                               "p99": pct(lat, 99) * 1e3, "n": len(lat)},
            }
        self.stream_report = {
            "streaming": True,
            "num_requests": dsum("serve.admitted"),
            "completed": terminal_counts[COMPLETED],
            "accepted_draft": terminal_counts[ACCEPTED_DRAFT],
            "distilled_served": terminal_counts[DISTILLED],
            "num_micro_batches": len(mb_reports),
            "split_requests": dsum("serve.split_requests"),
            "flush_reasons": dict(sorted(flush_reasons.items())),
            "slo_ms": slo_ms,
            "slo_attainment": (slo_met_n / slo_served if slo_served else None),
            "latency_s": {
                "mean": float(np.mean(latencies)) if latencies else 0.0,
                "p50": pct(latencies, 50), "p95": pct(latencies, 95),
                "p99": pct(latencies, 99),
                "max": float(np.max(latencies)) if latencies else 0.0,
            },
            # from the first admission, not from generator start
            "time_to_first_result_s": (
                None if t_first is None
                else t_first - (first_arrival_s if first_arrival_s is not None else wall0)),
            "wall_time_s": wall,
            "draft_time_s": draft_total,
            "flow_time_s": flow_total,
            "jit_cache": self._jit_cache_delta(m0),
            "adaptive_t0": False,
            "policy": None,
            "speculative": None,
            "bandit": None,
            "distilled": None,
            "admission": admission,
            "terminal": dict(terminal_counts),
            "by_class": by_class_report,
            "conservation": {
                "offered": admission["offered"],
                "rejected": admission["rejected"],
                "resolved": resolved_total,
                "balanced": admission["offered"] == admission["rejected"] + resolved_total,
            },
            "dropped_micro_batches": dsum("serve.dropped_micro_batches"),
            "dispatch": {
                "retries": dsum("dispatch.retries"),
                "failed_micro_batches": dsum("serve.failed_micro_batches"),
                "failed_requests": terminal_counts[FAILED],
                "max_retries": self.retry_policy.max_retries,
                "backoff_base_s": self.retry_policy.backoff_base_s,
            },
            "batches": mb_reports,
        }
