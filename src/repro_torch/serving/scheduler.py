"""Continuous-batching warm-start serving engine (port of the JAX package's
``serving/scheduler.py``).

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

The refine of a micro-batch is the shared masked per-row loop
(:func:`repro_torch.core.sampler.rows_loop`: one backbone evaluation and
one ``ws_step`` per-row launch per step, or one ``ws_fused`` launch per K
steps with ``fused_block = K``), on the card one CUDA graph replay per
micro-batch, captured once per ``MicroBatch.compile_key`` (JAX's
``jax.jit(refine)``); the step keys, the schedule and the active mask are
the graph's inputs, so one graph serves every mix of row t0s of its key.
The graph reads the drafts from its own static copy, so a retried dispatch
reuses them as they are (the JAX engine donates the buffer and snapshots it
first). The ``jit_cache.*`` counters keep the JAX package's names, so the
two reports compare key for key: a miss is a capture, a hit a replay. The
AR draft engine replays one CUDA graph per ``(rows, prefix_len,
bucket_len)``, captured on the worker thread's stream.

With a ``t0_policy`` (:class:`repro_torch.drafting.AdaptiveT0Policy` or
:class:`repro_torch.drafting.BanditT0Policy`) a scoring pre-pass drafts
every request before packing (one ``draft_fn`` call per bucket, on the
draft stream), probes the drafts of requests without a t0 override and
gives them the policy's t0 (``per_row_t0``: one per row); ``speculative``
ships a request whose every row clears ``accept_score`` as its drafts
(``ACCEPTED_DRAFT``, no refine); a bandit learns from the probe re-run on
the refined rows. The draft stage then assembles the pre-pass drafts and
never drafts again.

The distilled tier (``distilled_model`` / ``distilled_params``): a
``tier="distilled"`` micro-batch runs K = ``distilled_nfe`` steps of the
distilled head through the same masked row loop, keyed on a third stream
(``DISTILL_STREAM``), on the card one CUDA graph replay per distilled
compile key with the head's weights copied in as graph inputs; the policy's
probe then scores the rows, and a request whose minimum row score misses
``distilled_accept_score`` is served again as a fresh guaranteed request,
bit-identical to one. With a ``pair_buffer`` every guaranteed refine adds
its ``(draft, refined, t0)`` rows to it (the head's training set).

Sampling is row-keyed: every sample row's PRNG stream is derived from its
request's seed and its index within the request, so a request's output
is invariant to micro-batch packing, and equals the JAX package's.

Not ported yet, refused by the constructor: ``mesh``. With it off, the
reports carry the JAX package's ``"mesh": None``.
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
    distill_schedule_rows, make_euler_one_step_rows, refine_schedule_rows, rows_loop,
    rows_loop_inputs,
)
from repro_torch.device import resolve_device
from repro_torch.drafting.quality import to_host
from repro_torch.graphs import GraphCache
from repro_torch.kernels.ws_fused import make_ws_fused_fn
from repro_torch.obs import MetricsRegistry, NullTracer, parse_metric_key
from repro_torch.serving.batcher import (
    ACCEPTED_DRAFT, CANCELLED, COMPLETED, DISTILL_STREAM, DISTILLED, DISTILLED_TIER,
    DRAFT_STREAM, FAILED,
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


def _row_base_keys(seeds, sample_idx) -> torch.Tensor:
    """(B, 2) ``fold_in(key(seed), sample index)`` on the host. Negative
    indices (padding rows) fold in as their uint32 bits, as JAX's
    ``fold_in`` takes them."""
    seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int64)
    idx = torch.as_tensor(np.asarray(sample_idx), dtype=torch.int64)
    keys = torch.stack([torch.zeros_like(seeds), seeds & prng.MASK], dim=-1)
    return prng.fold_in(keys, idx)


def _derive_row_keys(seeds, sample_idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """(draft_keys, flow_keys), each (B, 2) on the host: fold (seed, sample
    index) into two independent streams. Depends only on the request's own
    seed and the row's index within the request, never on batch position."""
    base = _row_base_keys(seeds, sample_idx)
    return prng.fold_in(base, DRAFT_STREAM), prng.fold_in(base, FLOW_STREAM)


def _derive_distill_keys(seeds, sample_idx) -> torch.Tensor:
    """(B, 2) keys on the host on the distilled tier's own stream
    (``fold_in(., DISTILL_STREAM)`` of the same base). Distilled sampling
    never consumes a key of the DRAFT/FLOW streams, so a fallback's
    guaranteed refine draws exactly what a fresh guaranteed request would."""
    return prng.fold_in(_row_base_keys(seeds, sample_idx), DISTILL_STREAM)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({where})")


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
      t0_policy: optional :class:`repro_torch.drafting.AdaptiveT0Policy` or
        :class:`repro_torch.drafting.BanditT0Policy` (the policy protocol:
        ``scores_and_t0`` / ``t0_for_drafts`` and the ``calibration`` /
        ``bin_width`` / ``t0_floor`` attributes). Requests submitted without
        a t0 override are drafted in a scoring pre-pass and get the
        policy's (binned) t0 from the measured draft quality; the pre-pass
        drafts are reused (never drafted twice). A bandit policy also learns
        from the probe re-run on each refined micro-batch, priced by the
        per-NFE cost model.
      t0_bin_width: grouping bin for per-request t0 values (see
        ``batcher.pack_requests``); defaults to ``t0_policy.bin_width`` with
        a policy, else 0 (exact-t0 grouping).
      per_row_t0: keep the pre-pass's per-row t0 vector: rows enter the
        masked refine at their own step; the request's bound stays
        ``warm_nfe(cold_nfe, min(row_t0s))``.
      speculative: draft-and-verify: a scored request whose every row's
        probe score clears ``accept_score`` ships its drafts with zero refine
        steps (``ACCEPTED_DRAFT``, ``nfe == 0``, ``micro_batch == -1``);
        rejected requests serve exactly as with speculation off. Explicit-t0
        requests are never accepted. Needs ``t0_policy``.
      accept_score: the acceptance threshold; ``None`` takes the policy's
        own (bandit) or its calibration's top anchor score.
      retry_policy: :class:`DispatchRetryPolicy` for refine-dispatch faults.
      class_slo_factor: per-priority-class SLO scaling for ``serve_stream``.
      tracer / metrics: ``repro_torch.obs`` span tracer (default no-op) and
        metrics registry (default a private one); report sections are
        derived from the registry, under the JAX package's counter names.
      distilled_model / distilled_params: a distilled few-step head
        (:class:`repro_torch.drafting.DistilledRefiner`, ``dfm_apply(params,
        tokens, t)``) and its params (a dict of tensors on ``device``),
        enabling ``tier="distilled"`` requests: K = ``distilled_nfe`` steps
        of the head instead of the guaranteed refine, behind the policy
        probe's quality floor. Needs ``t0_policy``.
      distilled_nfe: steps the distilled tier runs (1 or 2).
      distilled_accept_score: the tier's quality floor: a request whose
        minimum row probe score falls below it is served again on the
        guaranteed path. Defaults to ``accept_score``.
      pair_buffer: a :class:`repro_torch.drafting.PairBuffer`; every
        guaranteed refine adds its ``(draft, refined, t0)`` rows to it.
      device: where the refine runs: the card unless ``"cpu"`` is asked for.
      mesh: not ported yet; anything but None raises ``NotImplementedError``.
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
        self.t0_policy = t0_policy
        if t0_bin_width is None:
            t0_bin_width = (getattr(t0_policy, "bin_width", 0.0)
                            if t0_policy is not None else 0.0)
        self.t0_bin_width = float(t0_bin_width)
        self.per_row_t0 = bool(per_row_t0)
        self.speculative = bool(speculative)
        if self.speculative and t0_policy is None:
            raise ValueError("speculative serving needs a t0_policy: acceptance is decided by "
                             "the policy's quality probe")
        if accept_score is None and t0_policy is not None:
            accept_score = getattr(t0_policy, "accept_score", None)
            if accept_score is None:
                scores = getattr(getattr(t0_policy, "calibration", None), "scores", None)
                if scores:
                    accept_score = float(scores[-1])
        self.accept_score = None if accept_score is None else float(accept_score)
        if self.speculative and self.accept_score is None:
            raise ValueError("speculative serving needs an accept_score (none given and the "
                             "policy carries no calibration to derive one)")
        # the distilled tier: a self-distilled K-step head served as a cheap
        # SLO class behind a calibrated probe-score quality floor
        self.distilled_model = distilled_model
        self.distilled_params = distilled_params
        self.distilled_nfe = int(distilled_nfe)
        self.pair_buffer = pair_buffer
        if distilled_model is not None:
            if not 1 <= self.distilled_nfe <= 2:
                raise ValueError(f"distilled_nfe must be 1 or 2 (the tier's whole point is a "
                                 f"1-2 step refine), got {distilled_nfe}")
            if t0_policy is None:
                raise ValueError("the distilled tier needs a t0_policy: its quality floor is "
                                 "the policy's probe score")
            if distilled_accept_score is None:
                distilled_accept_score = self.accept_score
            if distilled_accept_score is None:
                raise ValueError("distilled tier needs a quality floor (distilled_accept_score, "
                                 "or a policy calibration to derive one)")
            if not distilled_params:
                raise ValueError("distilled_model needs its distilled_params")
            for name, leaf in distilled_params.items():
                if leaf.device.type != self.device.type:
                    raise ValueError(f"distilled_params[{name!r}] lives on {leaf.device}, "
                                     f"scheduler on {self.device}")
        self.distilled_accept_score = (None if distilled_accept_score is None
                                       else float(distilled_accept_score))
        # bandit mode: the policy learns online from refined outcomes
        self._bandit_mode = (t0_policy is not None and hasattr(t0_policy, "update")
                             and hasattr(t0_policy, "scorer"))
        # request_id -> (bucket_len, per-row draft probe scores): the context
        # each in-flight row's arm was selected under (bandit mode only)
        self._row_scores: Dict[int, Tuple[int, np.ndarray]] = {}

        self.tracer = tracer if tracer is not None else NullTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_reward_probes = m.counter("bandit.reward_probes")
        self._c_spec_eligible = m.counter("speculative.eligible")
        self._c_spec_accepted = m.counter("speculative.accepted")
        self._c_cache_hits = m.counter("jit_cache.hits")
        self._c_cache_misses = m.counter("jit_cache.misses")
        self._c_fused_blocks = m.counter("fused.blocks_dispatched")
        self._c_fused_steps = m.counter("fused.steps_fused")
        self._c_dispatch_retries = m.counter("dispatch.retries")
        self._c_dispatch_failures = m.counter("dispatch.failures")
        self._c_distill_fallbacks = m.counter("distilled.fallbacks")
        self._c_distill_gate_evals = m.counter("distilled.gate_evals")
        self._c_distill_downgrades = m.counter("distilled.oversize_downgrades")
        if t0_policy is not None and hasattr(t0_policy, "bind_metrics"):
            t0_policy.bind_metrics(m)

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
        # one graph per compile key: the guaranteed refine's and, under keys
        # suffixed with the tier, the distilled loop's
        self.graphs = GraphCache("the scheduler's refine loop")

    def _loop(self, x, step_keys, ts, hs, act) -> torch.Tensor:
        return rows_loop(self.flow_model.dfm_apply, self._one_step, x, step_keys, ts, hs, act,
                         fused_fn=self._fused_fn)

    def _refine_inputs(self, flow_keys, ts, hs, active, key_idx):
        return rows_loop_inputs(flow_keys, ts, hs, active, key_idx,
                                fused_block=self.fused_block)

    def _refine_loop(self, key, flow_keys, x, ts, hs, active, key_idx) -> torch.Tensor:
        """The masked per-row refine of one micro-batch: on the card one replay
        of the graph of its compile key ``key``, the step keys, schedule and
        active mask copied in as data."""
        inputs = self._refine_inputs(flow_keys, ts, hs, active, key_idx)
        with torch.inference_mode():
            return self.graphs(key, self._loop, x, *inputs)

    def _refine_loop_eager(self, flow_keys, x, ts, hs, active, key_idx) -> torch.Tensor:
        """The same refine as eager launches (the graph's yardstick)."""
        inputs = self._refine_inputs(flow_keys, ts, hs, active, key_idx)
        with torch.inference_mode():
            return self._loop(x, *(a.to(x.device) for a in inputs))

    def _distill_fn(self, x, step_keys, ts, hs, act, *leaves) -> torch.Tensor:
        """K steps of the distilled head through the masked row loop (no fused
        block), on the head's params as ``leaves`` (sorted by name)."""
        params = dict(zip(sorted(self.distilled_params), leaves))
        return rows_loop(lambda xt, tb: self.distilled_model.dfm_apply(params, xt, tb),
                         self._one_step, x, step_keys, ts, hs, act)

    def _distill_inputs(self, mb: MicroBatch):
        """``(n_steps, (step keys, ts, hs, active))``: the K-step schedule on
        the DISTILL_STREAM keys of ``mb``'s rows."""
        ts, hs, active, key_idx, _ = distill_schedule_rows(mb.row_t0s, self.distilled_nfe)
        seeds, idx = self._mb_row_streams(mb)
        return len(ts), rows_loop_inputs(_derive_distill_keys(seeds, idx), ts, hs, active,
                                         key_idx)

    def _distill_leaves(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.distilled_params[k] for k in sorted(self.distilled_params))

    def _distill_loop(self, key, x, inputs) -> torch.Tensor:
        """The distilled tier's dispatch: on the card one replay of the graph of
        its compile key ``key``; the head's weights are graph inputs copied in
        at each call, so new params replay the same graph."""
        with torch.inference_mode():
            return self.graphs(key, self._distill_fn, x, *inputs, *self._distill_leaves())

    def _distill_loop_eager(self, x, inputs) -> torch.Tensor:
        """The same distilled loop as eager launches (the graph's yardstick)."""
        with torch.inference_mode():
            return self._distill_fn(x, *(a.to(x.device) for a in inputs),
                                    *self._distill_leaves())

    # ---- request intake --------------------------------------------------

    def submit(self, *, seq_len: int, num_samples: int = 1, seed: int = 0,
               t0: Optional[float] = None, tier: str = GUARANTEED_TIER) -> int:
        """Enqueue one request; returns its request_id. ``t0=None`` means the
        engine decides: the policy's t0 with a ``t0_policy``, else
        ``default_t0``; an explicit t0 is honoured verbatim (never scored).
        ``tier="distilled"`` asks for the distilled head behind its quality
        floor (needs ``distilled_model``); a request that misses the floor
        falls back to the guaranteed path. Rejects unservable requests here
        (bucket overflow, too many samples), so one bad request can never
        poison a queued batch."""
        bucket_seq_len(seq_len, min_bucket=self.min_bucket, max_bucket=self.max_bucket)
        padded = pad_rows(num_samples, self.row_quantum)
        if padded > self.max_rows:
            raise ValueError(f"num_samples {num_samples} pads to {padded} rows > max_rows "
                             f"{self.max_rows} (split the request)")
        if tier == DISTILLED_TIER and self.distilled_model is None:
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

    def _draft_stream_ctx(self):
        stream = self._draft_stream
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _draft_rows(self, seeds, idx, blen: int) -> np.ndarray:
        """The drafts of the rows keyed by ``(seeds, idx)`` at bucket length
        ``blen``, on the host: one ``draft_fn`` call on the draft stream, its
        rows padded up to the row quantum with padding-row streams (seed 0,
        negative indices), as a micro-batch's are, so the draft engine's
        decode graphs see the row counts the draft stage uses. Row-keyed
        drafts do not depend on their neighbours, so the real rows are the
        ones an unpadded call gives."""
        n = len(seeds)
        padded = pad_rows(n, self.row_quantum)
        seeds = np.concatenate([np.asarray(seeds, np.int32), np.zeros(padded - n, np.int32)])
        idx = np.concatenate([np.asarray(idx, np.int32),
                              -(np.arange(n, padded, dtype=np.int32) + 1)])
        draft_keys, _ = _derive_row_keys(seeds, idx)
        with self._draft_stream_ctx(), torch.no_grad():
            x = self.draft_fn(draft_keys, blen)
            if x.device.type != self.device.type or tuple(x.shape) != (padded, blen):
                raise ValueError(f"draft_fn returned {tuple(x.shape)} on {x.device}, expected "
                                 f"({padded}, {blen}) on {self.device}")
            return x[:n].cpu().numpy()       # on the draft stream: waits for the draft

    def _stage_keys_and_draft(self, mb: MicroBatch,
                              predrafted: Optional[Dict[int, np.ndarray]] = None):
        """Draft stage for one micro-batch (runs on the worker thread):
        derive per-row keys, draft at bucket length on the draft stream,
        wait for it. Returns ``(x, flow_keys, t_draft, ready)``: ``ready``
        is the event the refine stream waits on (None on the CPU).

        ``predrafted`` (policy mode) maps request_id -> that request's
        ``(num_samples, bucket_len)`` drafts from the scoring pre-pass; they
        are assembled (padding rows zero) and uploaded instead of drafted
        again: the pre-pass used the same row keys."""
        with self.tracer.span("draft", track="draft_worker", bucket=mb.bucket_len,
                              rows=mb.rows, predrafted=predrafted is not None):
            t0 = time.perf_counter()
            seeds, idx = self._mb_row_streams(mb)
            draft_keys, flow_keys = _derive_row_keys(seeds, idx)
            ready = None
            stream = self._draft_stream
            with self._draft_stream_ctx(), torch.no_grad():
                if predrafted is not None:
                    x = np.zeros((mb.padded_rows, mb.bucket_len), np.int32)
                    for span in mb.spans:
                        x[span.row_offset:span.row_offset + span.rows] = \
                            predrafted[span.request.request_id]
                    x = torch.from_numpy(x).to(self.device)
                else:
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
                out = self._refine_loop(mb.compile_key, flow_keys, x, ts, hs, active, key_idx)
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

    def _count_key(self, key, sp) -> bool:
        """The jit-cache accounting of one dispatch of ``key``; True on a miss
        (the key's first dispatch: a capture on the card)."""
        was_miss = key not in self._compiled
        if was_miss:
            self._compiled.add(key)
            self._c_cache_misses.inc()
        else:
            self._c_cache_hits.inc()
        self.metrics.counter("jit_cache.per_key", key=_key_label(key),
                             kind="miss" if was_miss else "hit").inc()
        sp["cache"] = "miss" if was_miss else "hit"
        return was_miss

    def _stage_refine(self, mb: MicroBatch, x, flow_keys, ready=None):
        """Flow stage for one micro-batch: the masked per-row refine on the
        calling thread's stream, after the draft's ``ready`` event.
        Distilled-tier micro-batches go to :meth:`_stage_distill`."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            x.record_stream(stream)
        if mb.tier == DISTILLED_TIER:
            return self._stage_distill(mb, x)
        # the harvest's drafts, read after the draft's event and before the
        # timed window that feeds the cost model
        harvest = x.cpu().numpy() if self.pair_buffer is not None else None
        span = self.tracer.span("refine", track="refine_dispatch", bucket=mb.bucket_len,
                                rows=mb.rows, padded_rows=mb.padded_rows, tier=mb.tier,
                                key=str(mb.compile_key))
        with span as sp:
            t0 = time.perf_counter()
            key = mb.compile_key
            was_miss = self._count_key(key, sp)
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
            # the bandit's verify step after the cost observation, so the
            # reward probe's own time never enters the per-NFE refine EWMA
            if self._bandit_mode and self._row_scores:
                with self.tracer.span("reward_probe", track="refine_dispatch",
                                      bucket=mb.bucket_len):
                    self._observe_rewards(mb, x)
            # the self-distillation harvest, also after the cost observation:
            # the guaranteed path is the teacher, no extra forward passes
            if harvest is not None:
                self.pair_buffer.add_batch(harvest, x.cpu().numpy(), mb.row_t0s,
                                           mask=mb.row_mask)
        return x, t_flow

    def _stage_distill(self, mb: MicroBatch, x):
        """Distilled-tier flow stage: K = ``distilled_nfe`` steps of the head
        through the same masked row loop, keyed on DISTILL_STREAM. No NFE
        gate runs here: the tier's contract is the quality floor
        (:meth:`_distill_gate`). One attempt: a failure raises
        :class:`DispatchFailure`."""
        span = self.tracer.span("distill", track="refine_dispatch", bucket=mb.bucket_len,
                                rows=mb.rows, padded_rows=mb.padded_rows, tier=mb.tier,
                                key=str(mb.compile_key))
        with span as sp:
            t0 = time.perf_counter()
            key = mb.compile_key
            was_miss = self._count_key(key, sp)
            n_steps, inputs = self._distill_inputs(mb)
            sp["nfe"] = n_steps
            try:
                x = self._distill_loop(key, x, inputs)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
            except Exception as err:  # noqa: BLE001 — device faults vary
                self._c_dispatch_failures.inc()
                raise DispatchFailure(key, 1, err) from err
            t_flow = time.perf_counter() - t0
            self.cost_model.observe(key, t_flow, n_steps, compiled=was_miss)
        return x, t_flow

    def _distill_gate(self, mb: MicroBatch, x) -> Dict[int, Tuple[bool, float]]:
        """The distilled tier's quality floor: the policy's probe on the
        distilled rows, each request's minimum row score against
        ``distilled_accept_score``. ``request_id -> (passed, min score)``."""
        self._c_distill_gate_evals.inc()
        scores = to_host(self.t0_policy.scorer(x))
        out: Dict[int, Tuple[bool, float]] = {}
        for span in mb.spans:
            mn = float(scores[span.row_offset:span.row_offset + span.rows].min())
            out[span.request.request_id] = (mn >= self.distilled_accept_score, mn)
        return out

    def _observe_rewards(self, mb: MicroBatch, x) -> None:
        """The bandit's reward for one refined micro-batch (the verify step):
        the probe re-run on the refined tokens (one scored batch per
        micro-batch), each row's arm fed its refined score less its refine
        seconds priced by the measured per-NFE cost model. Rows whose
        (bucket, draft score) context the pre-pass did not record
        (explicit-t0 requests, chunks) are skipped."""
        pending = [(span, self._row_scores.pop(span.request.request_id))
                   for span in mb.spans if span.request.request_id in self._row_scores]
        if not pending:
            return
        refined = to_host(self.t0_policy.scorer(x))
        self._c_reward_probes.inc()
        row_t0s = mb.row_t0s
        cold_s = self.cost_model.cost_for_nfe(self.cold_nfe)
        for span, (blen, draft_scores) in pending:
            for r in range(span.rows):
                t0r = float(row_t0s[span.row_offset + r])
                nfe_r = guarantees.warm_nfe(self.cold_nfe, t0r)
                row_s = self.cost_model.cost_for_nfe(nfe_r, mb.compile_key)
                if row_s is not None and cold_s:
                    cost_norm = row_s / cold_s
                else:
                    cost_norm = nfe_r / self.cold_nfe
                self.t0_policy.update(blen, float(draft_scores[r]), t0r,
                                      quality_score=float(refined[span.row_offset + r]),
                                      cost_norm=cost_norm)

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

    def _policy_prepass(self, requests: Sequence[ServeRequest]):
        """Traced wrapper of :meth:`_policy_prepass_inner` (the span carries
        the scored and accepted counts)."""
        with self.tracer.span("scoring_prepass", track="scoring",
                              requests=len(requests)) as sp:
            out = self._policy_prepass_inner(requests)
            sp["scored"] = out[2]["scored_requests"]
            sp["accepted"] = len(out[3])
        return out

    def _policy_prepass_inner(self, requests: Sequence[ServeRequest]):
        """The scoring pre-pass (``t0_policy`` mode).

        Drafts every request at its bucket length (one row-keyed
        :meth:`_draft_rows` call per bucket), scores the drafts of requests
        without a t0 override and resolves their t0 through the policy.
        Returns ``(resolved_requests, predrafted, policy_report, accepted)``:
        the drafts are reused by the pipeline (never drafted twice), equal to
        what the draft stage would draft, since the row keys are the same.

        With ``speculative`` a scored request whose every row's probe score
        clears ``accept_score`` leaves ``resolved_requests`` for ``accepted``
        (``[{"request", "tokens", "t0", "scores"}]``, tokens at bucket
        length): it never packs or refines. The policy picks every scored
        request's t0 before any accept decision, so a rejected request serves
        exactly as with speculation off. In bandit mode the pre-pass records
        each scored row's (bucket, draft score) context for its reward and
        credits acceptances to the bandit's accept counters.
        """
        t_start = time.perf_counter()
        by_bucket: Dict[int, List[ServeRequest]] = {}
        for req in requests:
            blen = bucket_seq_len(req.seq_len, min_bucket=self.min_bucket,
                                  max_bucket=self.max_bucket)
            by_bucket.setdefault(blen, []).append(req)

        predrafted: Dict[int, np.ndarray] = {}
        resolved_t0: Dict[int, float] = {}
        resolved_rows: Dict[int, Tuple[float, ...]] = {}
        accepted_info: Dict[int, dict] = {}
        scored = 0
        eligible = 0
        for blen, reqs in sorted(by_bucket.items()):
            seeds, idx, offsets = [], [], {}
            for req in reqs:
                offsets[req.request_id] = len(seeds)
                seeds.extend([req.seed] * req.num_samples)
                idx.extend(range(req.sample_offset, req.sample_offset + req.num_samples))
            x = self._draft_rows(seeds, idx, blen)
            need_score = [r for r in reqs if r.t0 is None]
            if need_score:
                rows = np.concatenate([x[offsets[r.request_id]:offsets[r.request_id]
                                         + r.num_samples] for r in need_score])
                if hasattr(self.t0_policy, "scores_and_t0"):
                    scores_rows, t0_rows = self.t0_policy.scores_and_t0(rows)
                else:
                    scores_rows = None
                    t0_rows = self.t0_policy.t0_for_drafts(rows)
                at = 0
                for r in need_score:
                    rs = t0_rows[at:at + r.num_samples]
                    sc = None if scores_rows is None else scores_rows[at:at + r.num_samples]
                    at += r.num_samples
                    # distilled-tier requests are never accepted (the tier is
                    # not ported; the condition keeps JAX's accept stream)
                    if self.speculative and sc is not None and r.tier != DISTILLED_TIER:
                        eligible += 1
                        if float(sc.min()) >= self.accept_score:
                            accepted_info[r.request_id] = {"t0": float(rs.min()),
                                                           "scores": np.array(sc)}
                            if self._bandit_mode:
                                for v in sc:
                                    self.t0_policy.observe_accept(blen, float(v))
                            continue
                    if self._bandit_mode and sc is not None and r.tier != DISTILLED_TIER:
                        self._row_scores[r.request_id] = (blen, np.array(sc))
                    if self.per_row_t0:
                        resolved_rows[r.request_id] = tuple(float(v) for v in rs)
                    resolved_t0[r.request_id] = float(rs.min())
                scored += len(need_score)
            for req in reqs:
                o = offsets[req.request_id]
                predrafted[req.request_id] = x[o:o + req.num_samples]

        resolved: List[ServeRequest] = []
        accepted: List[dict] = []
        for req in requests:
            info = accepted_info.get(req.request_id)
            if info is not None:
                accepted.append({"request": req, "tokens": predrafted[req.request_id],
                                 "t0": info["t0"], "scores": info["scores"]})
                continue
            if req.t0 is not None:
                resolved.append(req)
            else:
                resolved.append(dataclasses.replace(
                    req, t0=resolved_t0[req.request_id],
                    row_t0s=resolved_rows.get(req.request_id, ())))
        self.metrics.counter("policy.scored_requests").inc(scored)
        self._c_spec_eligible.inc(eligible)
        self._c_spec_accepted.inc(len(accepted))
        report = {
            "scored_requests": scored,
            "prepass_time_s": time.perf_counter() - t_start,
            "t0_histogram": dict(sorted(_histogram(list(resolved_t0.values())).items())),
            "speculative": (None if not self.speculative else {
                "eligible": eligible, "accepted": len(accepted),
                "accept_score": self.accept_score}),
        }
        return resolved, predrafted, report, accepted

    def _pipeline(self, batches: Sequence[MicroBatch],
                  predrafted: Optional[Dict[int, np.ndarray]] = None) -> Iterator[tuple]:
        """``(k, mb, x, t_draft, t_flow)`` per micro-batch, in order: the
        draft of batch k+1 on the worker thread while batch k refines."""
        if not self.overlap or len(batches) <= 1:
            for k, mb in enumerate(batches):
                x, flow_keys, t_draft, ready = self._stage_keys_and_draft(mb, predrafted)
                x, t_flow = self._stage_refine(mb, x, flow_keys, ready)
                yield k, mb, x, t_draft, t_flow
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._stage_keys_and_draft, batches[0], predrafted)
            for k, mb in enumerate(batches):
                x, flow_keys, t_draft, ready = fut.result()
                if k + 1 < len(batches):
                    fut = pool.submit(self._stage_keys_and_draft, batches[k + 1], predrafted)
                x, t_flow = self._stage_refine(mb, x, flow_keys, ready)
                yield k, mb, x, t_draft, t_flow

    def serve_requests(self, requests: Sequence[ServeRequest]
                       ) -> Tuple[Dict[int, RequestResult], dict]:
        # the wall clock starts before the pre-pass: in policy mode the
        # pre-pass is the draft stage (plus scoring), so the rates pay for it
        wall0 = time.perf_counter()
        for req in requests:
            if req.tier == DISTILLED_TIER and self.distilled_model is None:
                raise ValueError("tier='distilled' needs distilled_model/distilled_params "
                                 "on the scheduler")
        policy_report = None
        accepted: List[dict] = []
        # the as-submitted requests: a distilled request that misses its floor
        # is served again from this one (t0 unresolved), as a fresh request
        originals = {r.request_id: r for r in requests}
        results: Dict[int, RequestResult] = {}
        batch_reports: List[dict] = []
        cache_snap = self._jit_cache_snapshot()
        draft_total = flow_total = 0.0
        batches: List[MicroBatch] = []
        distill_stats = {"requests": 0, "served": 0, "fallbacks": 0, "min_served_score": None}
        fallback: List[ServeRequest] = []

        def finish(k: int, mb: MicroBatch, x, t_draft: float, t_flow: float) -> None:
            nonlocal draft_total, flow_total
            draft_total += t_draft
            flow_total += t_flow
            gate = self._distill_gate(mb, x) if mb.tier == DISTILLED_TIER else None
            x_host = x.cpu().numpy()
            for span, span_t0, span_rows in zip(mb.spans, mb.t0_spans, mb.row_t0_spans):
                req = span.request
                if gate is not None:
                    passed, mn = gate[req.request_id]
                    if not passed:
                        self._c_distill_fallbacks.inc()
                        distill_stats["fallbacks"] += 1
                        fallback.append(dataclasses.replace(originals[req.request_id],
                                                            tier=GUARANTEED_TIER))
                        continue
                    distill_stats["served"] += 1
                    ms = distill_stats["min_served_score"]
                    distill_stats["min_served_score"] = mn if ms is None else min(ms, mn)
                    results[req.request_id] = RequestResult(
                        request_id=req.request_id,
                        tokens=x_host[span.row_offset:span.row_offset + span.rows, :req.seq_len],
                        nfe=self.distilled_nfe, t0=span_t0, bucket_len=mb.bucket_len,
                        micro_batch=k)
                    continue
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

        # round 0 serves the submitted mix; round 1 (only when a distilled
        # request misses its floor) serves the fallbacks as guaranteed
        # requests, so the loop ends after at most two rounds
        pending = list(requests)
        while pending:
            distill_stats["requests"] += sum(1 for r in pending if r.tier == DISTILLED_TIER)
            predrafted = None
            resolved = pending
            if self.t0_policy is not None:
                resolved, predrafted, pr, acc_round = self._policy_prepass(pending)
                accepted.extend(acc_round)
                if policy_report is None:
                    policy_report = pr
                else:
                    policy_report["scored_requests"] += pr["scored_requests"]
                    policy_report["prepass_time_s"] += pr["prepass_time_s"]
                    if policy_report.get("speculative") and pr.get("speculative"):
                        for f in ("eligible", "accepted"):
                            policy_report["speculative"][f] += pr["speculative"][f]
                # serial (never hidden behind a refine): in draft_total and the wall
                draft_total += pr["prepass_time_s"]
            round_batches = pack_requests(
                resolved, cold_nfe=self.cold_nfe, default_t0=self.default_t0,
                max_rows=self.max_rows, min_bucket=self.min_bucket, max_bucket=self.max_bucket,
                row_quantum=self.row_quantum, t0_bin_width=self.t0_bin_width,
                distilled_nfe=self.distilled_nfe)
            k0 = len(batches)
            batches.extend(round_batches)
            for k, mb, x, t_draft, t_flow in self._pipeline(round_batches, predrafted):
                finish(k0 + k, mb, x, t_draft, t_flow)
            pending, fallback = fallback, []

        # speculatively accepted requests end here: their pre-pass drafts, cut
        # to the request's length, with zero refine steps (micro_batch -1)
        for acc in accepted:
            req = acc["request"]
            results[req.request_id] = RequestResult(
                request_id=req.request_id, tokens=np.asarray(acc["tokens"])[:, :req.seq_len],
                nfe=0, t0=acc["t0"],
                bucket_len=bucket_seq_len(req.seq_len, min_bucket=self.min_bucket,
                                          max_bucket=self.max_bucket),
                micro_batch=-1)

        wall = time.perf_counter() - wall0
        overlapped = max(0.0, draft_total + flow_total - wall)
        denom = min(draft_total, flow_total)
        rows = sum(mb.rows for mb in batches)

        def req_mean_nfe(r: RequestResult) -> float:
            # heterogeneous rows: the request spent the mean of its rows'
            # own step counts (r.nfe stays the worst-row bound); accepted 0
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
            "adaptive_t0": self.t0_policy is not None,
            "policy": policy_report,
            "speculative": (None if not self.speculative else {
                "enabled": True,
                "eligible": policy_report["speculative"]["eligible"],
                "accepted": len(accepted),
                "accept_rate": (len(accepted) / policy_report["speculative"]["eligible"]
                                if policy_report["speculative"]["eligible"] else 0.0),
                "accept_score": self.accept_score,
                # the worst probe score that shipped unrefined
                "min_accepted_score": (min(float(np.min(a["scores"])) for a in accepted)
                                       if accepted else None),
            }),
            "bandit": self.t0_policy.arm_stats() if self._bandit_mode else None,
            "distilled": (None if self.distilled_model is None else {
                "enabled": True, "nfe": self.distilled_nfe,
                "gate_score": self.distilled_accept_score, **distill_stats}),
            "batches": batch_reports,
        }
        self._row_scores.clear()
        return results, report

    # ---- streaming / SLO-aware admission ---------------------------------

    def _t0_lower_bound(self, req: ServeRequest) -> float:
        """The shallowest t0 this request could be served at: what the
        deadline estimator prices refine work at before the request is
        scored (at flush time)."""
        if req.t0 is not None:
            return float(req.t0)
        if self.t0_policy is not None:
            floor = getattr(getattr(self.t0_policy, "calibration", None), "t0_floor", None)
            if floor is not None:
                # the policy snaps the calibrated t0 down onto its bin grid,
                # up to one bin below the calibration floor: back off a bin
                width = float(getattr(self.t0_policy, "bin_width", 0.0))
                pfloor = float(getattr(self.t0_policy, "t0_floor", 0.0))
                return max(0.0, pfloor, float(floor) - width)
            return 0.0
        return self.default_t0

    def _stream_est_latency_s(self, fb: FillingBucket, unit: int, backlog_s: float) -> float:
        """Estimated time from 'flush now' to 'results out' for a filling
        bucket: pipeline backlog + draft-stage EWMA + measured per-NFE
        refine cost x worst-case steps (a first-dispatch surcharge for a new
        compile key). Zero until the first measurement."""
        if fb.requests and fb.requests[0].tier == DISTILLED_TIER:
            # buckets are tier-homogeneous: a distilled bucket runs K head steps
            n_steps = self.distilled_nfe
            key = (fb.bucket_len, pad_rows(fb.rows, unit), n_steps, DISTILLED_TIER)
        else:
            t0_lb = min(self._t0_lower_bound(r) for r in fb.requests)
            n_steps = guarantees.warm_nfe(self.cold_nfe, t0_lb)
            key = (fb.bucket_len, pad_rows(fb.rows, unit), n_steps)
        est = self.cost_model.estimate_s(key, n_steps, include_compile=True)
        return backlog_s + (self._draft_cost_ewma or 0.0) + (est or 0.0)

    def _mb_est_latency_s(self, mb: MicroBatch) -> float:
        est = self.cost_model.estimate_s(mb.compile_key, mb.n_steps, include_compile=True)
        return (self._draft_cost_ewma or 0.0) + (est or 0.0)

    def _score_chunks_t0(self, chunks: Sequence[ServeRequest]) -> float:
        """Admission-time t0 of an oversize request under a policy: its rows
        drafted and scored chunk by chunk (each within the micro-batch row
        cap), the minimum over all rows, so every chunk gets the
        request-level t0 the batch path's pre-pass would give."""
        t0_min = 1.0
        for chunk in chunks:
            blen = bucket_seq_len(chunk.seq_len, min_bucket=self.min_bucket,
                                  max_bucket=self.max_bucket)
            x = self._draft_rows(np.full((chunk.num_samples,), chunk.seed, np.int32),
                                 np.arange(chunk.sample_offset,
                                           chunk.sample_offset + chunk.num_samples,
                                           dtype=np.int32), blen)
            t0_min = min(t0_min, float(self.t0_policy.t0_for_drafts(x).min()))
        return t0_min

    def _flush_bucket(self, fb: FillingBucket, reason: str, now: float,
                      stats: dict) -> List[dict]:
        """FillingBucket -> dispatched micro-batches (the state machine's
        edge to DISPATCHED). Under a policy the scoring pre-pass runs here,
        per flushed bucket, as the batch path's runs per bucket."""
        occupancy = fb.rows
        self.tracer.instant("bucket_flush", track="flush", reason=reason,
                            bucket=fb.bucket_len, rows=occupancy, requests=len(fb.requests))
        self.metrics.counter("serve.flush", reason=reason).inc()
        self.metrics.histogram("bucket.flush_rows", buckets=(1, 2, 4, 8, 16, 32, 64, 128),
                               bucket=fb.bucket_len).observe(occupancy)
        reqs = fb.flush()               # deadline order
        predrafted = None
        if self.t0_policy is not None:
            reqs, predrafted, prep, accepted = self._policy_prepass(reqs)
            stats["prepass_time_s"] += prep["prepass_time_s"]
            # accepted requests skip packing; the loop yields them as
            # ACCEPTED_DRAFT terminals
            for acc in accepted:
                acc["reason"] = reason
                acc["flushed_s"] = now
            stats["accepted_pending"].extend(accepted)
        batches = pack_requests(
            reqs, cold_nfe=self.cold_nfe, default_t0=self.default_t0,
            max_rows=self.max_rows, min_bucket=self.min_bucket, max_bucket=self.max_bucket,
            row_quantum=self.row_quantum, t0_bin_width=self.t0_bin_width,
            distilled_nfe=self.distilled_nfe)
        for mb in batches:
            for span in mb.spans:
                self.tracer.instant("request_packed", track="flush",
                                    flow_id=span.request.root_id, flow_ph="t",
                                    request_id=span.request.root_id, bucket=mb.bucket_len,
                                    reason=reason)
        return [{"mb": mb, "predrafted": predrafted, "reason": reason, "flushed_s": now}
                for mb in batches]

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
        stats = {"prepass_time_s": 0.0, "accepted_pending": []}
        spec_min_score: Optional[float] = None
        distill_min_score: Optional[float] = None
        # the as-admitted distilled requests: a fallback is admitted again from
        # this one (t0 unresolved), so it serves as a fresh guaranteed request
        originals: Dict[int, ServeRequest] = {}
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
            originals.pop(root, None)
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

        def admit(req: ServeRequest, now: float, *, fallback: bool = False):
            nonlocal first_arrival_s
            if req.parent_id is not None:
                raise ValueError(
                    f"request {req.request_id} carries chunk metadata "
                    f"(parent_id={req.parent_id}); submit the parent request whole — "
                    f"the admission loop splits it")
            if not fallback:
                # a fallback was admitted once already: one offer, one terminal
                m.counter("serve.admitted").inc()
            if req.tier == DISTILLED_TIER:
                if self.distilled_model is None:
                    raise ValueError("tier='distilled' request admitted but the scheduler "
                                     "has no distilled model")
                if req.num_samples > usable_rows(self.max_rows, unit):
                    # chunks share one fate, which a per-chunk gate could split:
                    # oversize distilled requests serve on the guaranteed path
                    self._c_distill_downgrades.inc()
                    req = dataclasses.replace(req, tier=GUARANTEED_TIER)
                else:
                    originals[req.request_id] = req
            if first_arrival_s is None or req.arrival_s < first_arrival_s:
                first_arrival_s = req.arrival_s
            pieces = [req]
            if req.num_samples > usable_rows(self.max_rows, unit):
                pieces = split_request(req, max_rows=self.max_rows, unit=unit,
                                       alloc_id=lambda: next(self._chunk_ids))
                if self.t0_policy is not None and req.t0 is None:
                    t0 = self._score_chunks_t0(pieces)
                    pieces = [dataclasses.replace(p, t0=t0) for p in pieces]
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
                    ready.extend(self._flush_bucket(fb, "full", now, stats))
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
            nonlocal draft_total, flow_total, t_first, distill_min_score
            draft_total += t_draft
            flow_total += t_flow
            mb = pending["mb"]
            k = next(mb_index)
            # the quality floor of a distilled micro-batch, before the clock
            # read: the probe is part of serving it
            gate = self._distill_gate(mb, x) if mb.tier == DISTILLED_TIER else None
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
                status, nfe = COMPLETED, guarantees.warm_nfe(self.cold_nfe, span_t0)
                if gate is not None:
                    # distilled requests are never chunked (oversize ones were
                    # downgraded at admission): the gate decides the request
                    passed, mn = gate[req.request_id]
                    if not passed:
                        # the floor missed: admitted again from the as-admitted
                        # request, as a fresh guaranteed one, without counting
                        # serve.admitted again
                        self._c_distill_fallbacks.inc()
                        tracer.instant("request_fallback", track="flush", flow_id=req.root_id,
                                       flow_ph="t", request_id=req.root_id, score=mn,
                                       gate_score=self.distilled_accept_score)
                        admit(dataclasses.replace(originals.pop(req.request_id),
                                                  tier=GUARANTEED_TIER),
                              finished_s, fallback=True)
                        continue
                    originals.pop(req.request_id, None)
                    distill_min_score = (mn if distill_min_score is None
                                         else min(distill_min_score, mn))
                    status, nfe = DISTILLED, self.distilled_nfe
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
                count_terminal(status, req.priority)
                m.histogram("serve.latency_s", priority=req.priority).observe(latency)
                if deadline is not None:
                    m.counter("serve.slo_total", priority=req.priority, served=True).inc()
                    if met:
                        m.counter("serve.slo_met", priority=req.priority).inc()
                tracer.instant("request_terminal", track="terminal", flow_id=rid,
                               flow_ph="f", request_id=rid, status=status,
                               priority=req.priority, latency_ms=latency * 1e3)
                if t_first is None:
                    t_first = finished_s
                out.append(CompletedRequest(
                    request_id=rid, tokens=tokens, nfe=nfe, t0=span_t0,
                    bucket_len=mb.bucket_len, micro_batch=k,
                    row_t0s=span_rows if chunks == 1 and status != DISTILLED else (),
                    arrival_s=arrival, finished_s=finished_s, latency_s=latency,
                    flush_reason=pending["reason"], deadline_s=deadline, slo_met=met,
                    chunks=chunks, status=status, priority=req.priority))
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
                            ready.extend(self._flush_bucket(fb, reason, now, stats))
                            del filling[fkey]
                    # speculative accepts end here: their pre-pass drafts ship
                    # as ACCEPTED_DRAFT terminals with zero refine steps
                    while stats["accepted_pending"]:
                        acc = stats["accepted_pending"].pop(0)
                        req = acc["request"]
                        now_a = clock.time()
                        if req.root_id in resolved:
                            continue
                        if req.cancelled or req.expired(now_a):
                            item = terminal(req, CANCELLED if req.cancelled else TIMED_OUT,
                                            now_a)
                            if item is not None:
                                yield item
                            continue
                        resolved.add(req.request_id)
                        s_min = float(np.min(acc["scores"]))
                        spec_min_score = (s_min if spec_min_score is None
                                          else min(spec_min_score, s_min))
                        deadline = class_deadline(req)
                        met = None if deadline is None else now_a <= deadline
                        latency = now_a - req.arrival_s
                        latencies.append(latency)
                        class_latencies[req.priority].append(latency)
                        count_terminal(ACCEPTED_DRAFT, req.priority)
                        m.histogram("serve.latency_s", priority=req.priority).observe(latency)
                        if deadline is not None:
                            m.counter("serve.slo_total", priority=req.priority,
                                      served=True).inc()
                            if met:
                                m.counter("serve.slo_met", priority=req.priority).inc()
                        tracer.instant("request_terminal", track="terminal",
                                       flow_id=req.request_id, flow_ph="f",
                                       request_id=req.request_id, status=ACCEPTED_DRAFT,
                                       priority=req.priority, latency_ms=latency * 1e3)
                        if t_first is None:
                            t_first = now_a
                        yield CompletedRequest(
                            request_id=req.request_id,
                            tokens=np.asarray(acc["tokens"])[:, :req.seq_len], nfe=0,
                            t0=acc["t0"],
                            bucket_len=bucket_seq_len(req.seq_len, min_bucket=self.min_bucket,
                                                      max_bucket=self.max_bucket),
                            micro_batch=-1, arrival_s=req.arrival_s, finished_s=now_a,
                            latency_s=latency, flush_reason=acc["reason"], deadline_s=deadline,
                            slo_met=met, chunks=1, status=ACCEPTED_DRAFT,
                            priority=req.priority)
                    # pipeline: the NEXT micro-batch drafts while this one refines
                    if draft_fut is None and ready:
                        draft_pending = pop_ready()
                        if draft_pending is not None:
                            draft_fut = pool.submit(self._stage_keys_and_draft,
                                                    draft_pending["mb"],
                                                    draft_pending["predrafted"])
                    if draft_fut is not None:
                        x, flow_keys, t_draft, ev = draft_fut.result()
                        current, draft_fut, draft_pending = draft_pending, None, None
                        if ready:
                            draft_pending = pop_ready()
                            if draft_pending is not None:
                                draft_fut = pool.submit(self._stage_keys_and_draft,
                                                        draft_pending["mb"],
                                                        draft_pending["predrafted"])
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
        scored_requests = dsum("policy.scored_requests")
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
            "adaptive_t0": self.t0_policy is not None,
            "policy": (None if self.t0_policy is None else
                       {"scored_requests": scored_requests,
                        "prepass_time_s": stats["prepass_time_s"]}),
            "speculative": (None if not self.speculative else {
                "enabled": True,
                "accepted": terminal_counts[ACCEPTED_DRAFT],
                "eligible": scored_requests,
                "accept_rate": (terminal_counts[ACCEPTED_DRAFT] / scored_requests
                                if scored_requests else 0.0),
                "accept_score": self.accept_score,
                "min_accepted_score": spec_min_score,
            }),
            "bandit": self.t0_policy.arm_stats() if self._bandit_mode else None,
            "distilled": (None if self.distilled_model is None else {
                "enabled": True,
                "nfe": self.distilled_nfe,
                "gate_score": self.distilled_accept_score,
                "served": terminal_counts[DISTILLED],
                "fallbacks": dsum("distilled.fallbacks"),
                "gate_evals": dsum("distilled.gate_evals"),
                "oversize_downgrades": dsum("distilled.oversize_downgrades"),
                # the worst probe score that shipped distilled
                "min_served_score": distill_min_score,
            }),
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
        self._row_scores.clear()


def _histogram(values: List[float]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in values:
        k = f"{v:.3f}"
        out[k] = out.get(k, 0) + 1
    return out
