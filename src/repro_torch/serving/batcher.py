"""Request bucketing for the continuous-batching warm-start scheduler (a
copy of the JAX package's ``serving/batcher.py``: pure Python and numpy,
so the two packages pack the same requests into the same micro-batches).

Individual requests (seq_len, num_samples, seed, optional t0 override)
are grouped into shape-padded micro-batches:

  * the sequence dim is rounded up to a pow2 *bucket* (min ``min_bucket``)
    so the number of distinct compiled shapes is O(log max_seq);
  * rows (samples) are packed FIFO up to ``max_rows`` per micro-batch and
    the row count padded up to a multiple of ``row_quantum`` so the
    refine loop compiles for at most ``max_rows / row_quantum`` row
    shapes per bucket while wasting < ``row_quantum`` rows of padding;
  * requests with different effective t0 land in different micro-batches
    (a micro-batch has ONE (ts, hs) schedule); the refine dispatch is
    keyed on (bucket_len, padded_rows, n_steps) though, and the schedule
    enters as a dynamic input, so t0 values in the same warm-NFE class
    still share one compiled fn.

Determinism contract: everything a request's output depends on — its
draft/refine PRNG keys (derived from ``seed`` per *sample row*), its
bucket length (a function of its own seq_len), and its NFE schedule — is
a function of the request alone, never of its neighbours or its position
in the packing order.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import guarantees

# fold_in tags separating the draft-stage and flow-stage key streams
DRAFT_STREAM = 0
FLOW_STREAM = 1
DISTILL_STREAM = 2

# priority classes, best first. Shedding under overload walks this tuple
# BACKWARDS (best_effort is shed first, premium last); dispatch ordering
# walks it forwards (premium micro-batches refine before best_effort).
PRIORITY_CLASSES = ("premium", "standard", "best_effort")
_PRIORITY_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def priority_rank(priority: str) -> int:
    """0 = most important (premium). Lower rank is served/protected first,
    higher rank is shed first."""
    try:
        return _PRIORITY_RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of "
            f"{PRIORITY_CLASSES}") from None


# terminal request statuses (the request lifecycle state machine's exits):
# every admitted request resolves to EXACTLY ONE of these — conservation
# (offered == rejected + shed + completed + accepted_draft + cancelled +
# timed_out + failed) is gated by the overload bench.
COMPLETED = "completed"     # tokens delivered, guarantee enforced
ACCEPTED_DRAFT = "accepted_draft"   # speculative accept: draft shipped, 0 NFE
DISTILLED = "distilled"     # distilled tier: K-step head output passed the
                            # quality floor and shipped (NFE = K in {1, 2})
CANCELLED = "cancelled"     # caller cancelled via CancelToken
TIMED_OUT = "timed_out"     # per-request timeout_s expired
SHED = "shed"               # evicted from a full bounded AdmissionQueue
FAILED = "failed"           # refine dispatch failed after retry budget
TERMINAL_STATUSES = (COMPLETED, ACCEPTED_DRAFT, DISTILLED, CANCELLED,
                     TIMED_OUT, SHED, FAILED)


# request tiers (SLO classes with different pricing):
#   guaranteed — the paper path: warm_nfe(cold_nfe, t0) refine steps with
#     the 1/(1-t0) guarantee enforced per row;
#   distilled  — the cheap class: a distilled few-step head collapses the
#     whole [t0, 1] trajectory into K in {1, 2} steps, behind a calibrated
#     probe-score quality floor. Requests scoring below the floor FALL
#     BACK to the guaranteed path, re-entering packing bit-identical to a
#     fresh guaranteed request (per-row PRNG streams and t0 resolution are
#     pure functions of the request, never of the attempt history).
GUARANTEED_TIER = "guaranteed"
DISTILLED_TIER = "distilled"
TIERS = (GUARANTEED_TIER, DISTILLED_TIER)


class CancelToken:
    """Thread-safe per-request cancellation flag.

    Producers hold the token (or the request_id — see
    :meth:`~repro_torch.serving.scheduler.AdmissionQueue.cancel`) and call
    :meth:`cancel` at any point in the request lifecycle; the serving
    loop observes it at admission, while the request waits in a
    :class:`FillingBucket`, and again when an already-packed micro-batch
    completes (the request is masked out of the results — sibling rows
    are untouched because every row's PRNG stream is derived from its
    own request alone). Cancelling an already-completed request is a
    no-op. Oversize-request chunks share their parent's token, so one
    cancel resolves the whole request.
    """

    def __init__(self):
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One user request to the warm-start serving engine.

    ``arrival_s`` is the admission timestamp on the serving clock (0 for
    batch-mode requests); the streaming admission loop uses it to form
    per-request deadlines (``arrival_s + SLO``).

    ``sample_offset`` / ``parent_id`` / ``parent_samples`` describe an
    oversize-request *chunk* (see :func:`split_request`): a request whose
    rows could not fit one micro-batch is split into chunks that keep
    their rows' ORIGINAL sample indices, so each row's PRNG stream —
    ``fold_in(key(seed), sample_offset + r)`` — is identical to what the
    unsplit request would have used, and the reassembled output is
    bit-identical to serving the request whole.

    ``priority`` is one of :data:`PRIORITY_CLASSES`; under overload the
    bounded admission queue sheds the lowest class first and the
    streaming loop dispatches the highest class first. ``timeout_s`` is
    a per-request latency budget measured from ``arrival_s`` — an
    expired request resolves to a ``TIMED_OUT`` terminal status instead
    of being served (or silently dropped). ``cancel_token`` carries the
    caller's :class:`CancelToken`; it is excluded from equality so
    chunk/metadata comparisons stay value-based.
    """

    request_id: int
    seq_len: int
    num_samples: int = 1
    seed: int = 0
    t0: Optional[float] = None      # None -> engine default
    arrival_s: float = 0.0          # admission time on the serving clock
    priority: str = "standard"      # one of PRIORITY_CLASSES
    timeout_s: Optional[float] = None   # latency budget from arrival_s
    cancel_token: Optional[CancelToken] = dataclasses.field(
        default=None, compare=False, repr=False)
    sample_offset: int = 0          # first sample index (chunks only)
    parent_id: Optional[int] = None     # original request id (chunks only)
    parent_samples: int = 0         # parent's total num_samples (chunks only)
    # heterogeneous per-ROW warm-start times (adaptive per-row t0 mode):
    # one t0 per sample row, resolved by the scheduler's scoring pre-pass.
    # When set, `t0` must equal min(row_t0s) — the request-level value the
    # batcher groups by and the guarantee bound is derived from; rows with
    # deeper t0 enter the shared masked refine schedule later.
    row_t0s: Tuple[float, ...] = ()
    # SLO tier (one of TIERS): distilled-tier requests are served by the
    # K-step distilled head behind a quality floor, falling back to the
    # guaranteed path when the floor rejects them.
    tier: str = GUARANTEED_TIER

    def __post_init__(self):
        if self.seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {self.seq_len}")
        if self.num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {self.num_samples}")
        if not (0 <= self.seed < 2 ** 31):
            # key streams are derived from int32 device arrays; reject
            # seeds that would silently truncate/collide mod 2**32
            raise ValueError(f"seed must lie in [0, 2**31), got {self.seed}")
        if self.t0 is not None and not (0.0 <= self.t0 < 1.0):
            raise ValueError(f"t0 override must lie in [0, 1), got {self.t0}")
        priority_rank(self.priority)    # raises on unknown classes
        if self.tier not in TIERS:
            raise ValueError(
                f"unknown tier {self.tier!r}; expected one of {TIERS}")
        if self.timeout_s is not None and self.timeout_s <= 0.0:
            raise ValueError(
                f"timeout_s must be > 0, got {self.timeout_s}")
        if self.sample_offset < 0:
            raise ValueError(
                f"sample_offset must be >= 0, got {self.sample_offset}")
        if self.parent_id is not None and (
                self.parent_samples < self.sample_offset + self.num_samples):
            raise ValueError(
                f"chunk [{self.sample_offset}, "
                f"{self.sample_offset + self.num_samples}) exceeds "
                f"parent_samples {self.parent_samples}")
        if self.row_t0s:
            if len(self.row_t0s) != self.num_samples:
                raise ValueError(
                    f"row_t0s has {len(self.row_t0s)} entries for "
                    f"num_samples {self.num_samples}")
            if any(not (0.0 <= v < 1.0) for v in self.row_t0s):
                raise ValueError(
                    f"row_t0s must lie in [0, 1), got {self.row_t0s}")
            if self.t0 is None or not math.isclose(
                    self.t0, min(self.row_t0s), abs_tol=1e-12):
                raise ValueError(
                    f"t0 {self.t0} must equal min(row_t0s) "
                    f"{min(self.row_t0s)} when per-row t0s are set")

    @property
    def root_id(self) -> int:
        """The user-visible request id: the parent's for chunks."""
        return self.request_id if self.parent_id is None else self.parent_id

    @property
    def cancelled(self) -> bool:
        return self.cancel_token is not None and self.cancel_token.cancelled

    def expired(self, now: float) -> bool:
        """Has this request's ``timeout_s`` budget run out at ``now``?"""
        return (self.timeout_s is not None
                and now >= self.arrival_s + self.timeout_s)


@dataclasses.dataclass(frozen=True)
class RowSpan:
    """Where a request's sample rows live inside a micro-batch."""

    request: ServeRequest
    row_offset: int                 # first row in the padded batch

    @property
    def rows(self) -> int:
        return self.request.num_samples


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A shape-padded unit of work for the draft/refine pipeline.

    Requests in one micro-batch may carry DIFFERENT warm-start times
    (``t0_spans``, one per span) when the batcher groups by t0-bin: the
    refine loop is then the masked per-row scan
    (:func:`repro_torch.core.sampler.scan_refine_loop_rows`) whose length
    ``n_steps`` realises the worst (minimum) t0 — stored as ``t0``.
    """

    bucket_len: int                 # padded (pow2) sequence length
    t0: float                       # worst (min) effective t0 in the batch
    n_steps: int                    # warm NFE for (cold_nfe, min t0)
    spans: Tuple[RowSpan, ...]
    padded_rows: int                # quantum-padded row count
    t0_spans: Tuple[float, ...] = ()  # per-span effective t0 (len(spans))
    # per-span per-ROW t0 tuples (heterogeneous rows inside one request);
    # empty tuples mean "homogeneous at the span's t0_spans value"
    row_t0_spans: Tuple[Tuple[float, ...], ...] = ()
    # SLO tier of every span (micro-batches never mix tiers): a distilled
    # micro-batch runs the K-step distilled head instead of the guaranteed
    # refine scan, and n_steps is K rather than warm_nfe(cold_nfe, t0).
    tier: str = GUARANTEED_TIER

    def __post_init__(self):
        if not self.t0_spans:
            object.__setattr__(
                self, "t0_spans", tuple(self.t0 for _ in self.spans))
        elif len(self.t0_spans) != len(self.spans):
            raise ValueError(
                f"t0_spans has {len(self.t0_spans)} entries for "
                f"{len(self.spans)} spans")
        if not self.row_t0_spans:
            object.__setattr__(
                self, "row_t0_spans", tuple(() for _ in self.spans))
        elif len(self.row_t0_spans) != len(self.spans):
            raise ValueError(
                f"row_t0_spans has {len(self.row_t0_spans)} entries for "
                f"{len(self.spans)} spans")

    @property
    def rows(self) -> int:
        """Real (non-padding) rows."""
        return sum(s.rows for s in self.spans)

    @property
    def row_t0s(self) -> np.ndarray:
        """(padded_rows,) float64 per-row effective t0. Padding rows get
        the batch's LARGEST t0 (fewest steps) so they can never extend
        the scan; their outputs are discarded anyway."""
        pad_t0 = max(
            max(rt) if rt else t0
            for t0, rt in zip(self.t0_spans, self.row_t0_spans))
        t0s = np.full((self.padded_rows,), pad_t0, np.float64)
        for span, t0, rt in zip(self.spans, self.t0_spans,
                                self.row_t0_spans):
            lo = span.row_offset
            if rt:
                t0s[lo:lo + span.rows] = np.asarray(rt, np.float64)
            else:
                t0s[lo:lo + span.rows] = t0
        return t0s

    @property
    def row_mask(self) -> np.ndarray:
        """(padded_rows,) bool — True on real rows, False on padding."""
        mask = np.zeros((self.padded_rows,), dtype=bool)
        for s in self.spans:
            mask[s.row_offset:s.row_offset + s.rows] = True
        return mask

    @property
    def compile_key(self) -> Tuple:
        """The jit-cache key: everything shape- or trace-relevant. The
        distilled tier gets its OWN entries — a distilled 2-step dispatch
        never shares a trace with a guaranteed n_steps=2 one (different
        backbone, different schedule builder)."""
        key = (self.bucket_len, self.padded_rows, self.n_steps)
        return key if self.tier == GUARANTEED_TIER else key + (self.tier,)


def bucket_seq_len(seq_len: int, *, min_bucket: int = 8,
                   max_bucket: Optional[int] = None) -> int:
    """Round ``seq_len`` up to the pow2 bucket it is served at."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    b = max(min_bucket, 1 << (seq_len - 1).bit_length())
    if max_bucket is not None and b > max_bucket:
        raise ValueError(
            f"seq_len {seq_len} rounds to bucket {b} > max_bucket {max_bucket}"
        )
    return b


def pad_rows(rows: int, quantum: int = 4) -> int:
    """Round a micro-batch row count up to a multiple of ``quantum``.

    A small quantum keeps padding waste under ``quantum - 1`` rows per
    micro-batch while still bounding the compiled row shapes per bucket
    to ``max_rows / quantum``.
    """
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    return -(-rows // quantum) * quantum


def usable_rows(max_rows: int, unit: int = 1) -> int:
    """Largest request row count that fits one micro-batch: the biggest
    multiple of the padding ``unit`` (``lcm(row_quantum, row_multiple)``)
    not exceeding ``max_rows``. Requests above this are split
    (:func:`split_request`) by the streaming admission path."""
    if unit < 1 or max_rows < 1:
        raise ValueError(f"need unit >= 1 and max_rows >= 1, got "
                         f"unit={unit} max_rows={max_rows}")
    cap = (max_rows // unit) * unit
    if cap < 1:
        raise ValueError(
            f"padding unit {unit} exceeds max_rows {max_rows}: no request "
            f"fits a micro-batch")
    return cap


def split_request(req: ServeRequest, *, max_rows: int, unit: int = 1,
                  alloc_id=None) -> List[ServeRequest]:
    """Split an oversize request into servable chunks.

    Each chunk carries at most :func:`usable_rows` samples, remembers its
    rows' original sample indices (``sample_offset``) so per-row PRNG
    streams are unchanged, and points back at the parent request
    (``parent_id`` / ``parent_samples``) so the streaming loop can
    reassemble the chunks into one result. A request that already fits is
    returned unchanged (no chunk metadata added).

    ``alloc_id()`` supplies a fresh request_id per chunk (chunks need
    distinct ids in micro-batch bookkeeping and the predraft maps);
    splitting an oversize request without an allocator is an error.
    """
    cap = usable_rows(max_rows, unit)
    if req.num_samples <= cap:
        return [req]
    if alloc_id is None:
        raise ValueError(
            "split_request needs alloc_id to mint chunk request_ids")
    chunks = []
    parent = req.request_id if req.parent_id is None else req.parent_id
    total = req.num_samples if req.parent_id is None else req.parent_samples
    for off in range(0, req.num_samples, cap):
        n = min(cap, req.num_samples - off)
        # a chunk keeps its rows' own per-row t0 slice (its request-level
        # t0 is that slice's min, like any per-row request)
        row_t0s = req.row_t0s[off:off + n] if req.row_t0s else ()
        chunks.append(dataclasses.replace(
            req, request_id=alloc_id(), num_samples=n,
            sample_offset=req.sample_offset + off,
            parent_id=parent, parent_samples=total,
            row_t0s=row_t0s,
            t0=min(row_t0s) if row_t0s else req.t0))
    return chunks


# FillingBucket states (the SLO admission state machine)
FILLING = "filling"                 # accepting requests
DEADLINE_ARMED = "deadline-armed"   # an SLO deadline is ticking
DISPATCHED = "dispatched"           # flushed to the refine pipeline


class FillingBucket:
    """Admission-side accumulator for one pow2 sequence bucket.

    State machine::

        FILLING ──(first request under an SLO)──► DEADLINE_ARMED
           │                                           │
           └────────────(flush)────────────────────────┴──► DISPATCHED

    A bucket flushes for one of four reasons, checked by
    :meth:`flush_decision` / :meth:`would_overflow`:

      * ``"full"``     — the next request would overflow ``max_rows``;
      * ``"deadline"`` — the oldest request's remaining SLO budget
        (``deadline - now``) no longer covers the estimated dispatch
        latency (measured per-NFE refine cost × worst-case steps, plus
        pipeline backlog);
      * ``"idle"``     — no arrival for ``idle_timeout_s`` (don't hold a
        partial bucket when traffic has gone quiet);
      * ``"drain"``    — the admission source closed.

    Flushed requests come out in deadline order (earliest deadline
    first; ties broken by arrival then id — FIFO for a uniform SLO).
    """

    def __init__(self, bucket_len: int):
        self.bucket_len = bucket_len
        self.requests: List[ServeRequest] = []
        self._deadlines: List[Optional[float]] = []
        self.state = FILLING
        self.last_arrival_s: Optional[float] = None

    @property
    def rows(self) -> int:
        return sum(r.num_samples for r in self.requests)

    @property
    def oldest_deadline_s(self) -> Optional[float]:
        armed = [d for d in self._deadlines if d is not None]
        return min(armed) if armed else None

    def would_overflow(self, num_samples: int, *, max_rows: int,
                       unit: int = 1) -> bool:
        """Would adding a ``num_samples`` request exceed ``max_rows``
        once padded? (The admission loop flushes BEFORE adding.)"""
        if not self.requests:
            return False
        return pad_rows(self.rows + num_samples, unit) > max_rows

    def add(self, req: ServeRequest, *, deadline_s: Optional[float] = None):
        if self.state == DISPATCHED:
            raise ValueError("cannot add to a dispatched bucket")
        self.requests.append(req)
        self._deadlines.append(deadline_s)
        self.last_arrival_s = req.arrival_s
        if deadline_s is not None:
            self.state = DEADLINE_ARMED

    def flush_decision(self, now: float, *, est_latency_s: float = 0.0,
                       idle_timeout_s: Optional[float] = None,
                       max_rows: int, unit: int = 1) -> Optional[str]:
        """Reason to flush now, or ``None`` to keep filling."""
        if not self.requests:
            return None
        if pad_rows(self.rows + 1, unit) > max_rows:
            return "full"
        deadline = self.oldest_deadline_s
        if deadline is not None and now + est_latency_s >= deadline:
            return "deadline"
        if (idle_timeout_s is not None and self.last_arrival_s is not None
                and now - self.last_arrival_s >= idle_timeout_s):
            return "idle"
        return None

    def prune(self, now: float) -> List[Tuple[ServeRequest, str]]:
        """Remove cancelled / timed-out requests, freeing their rows.

        Returns ``[(request, status)]`` with status ``CANCELLED`` or
        ``TIMED_OUT`` for each removed request, so the serving loop can
        surface the terminal status instead of silently dropping it.
        Sibling requests are untouched: their rows, deadlines, and PRNG
        streams (request-derived, never neighbour-derived) are exactly
        what they would have been had the pruned request never arrived.
        """
        if self.state == DISPATCHED:
            raise ValueError("cannot prune a dispatched bucket")
        removed: List[Tuple[ServeRequest, str]] = []
        keep_reqs: List[ServeRequest] = []
        keep_deadlines: List[Optional[float]] = []
        for req, deadline in zip(self.requests, self._deadlines):
            if req.cancelled:
                removed.append((req, CANCELLED))
            elif req.expired(now):
                removed.append((req, TIMED_OUT))
            else:
                keep_reqs.append(req)
                keep_deadlines.append(deadline)
        self.requests = keep_reqs
        self._deadlines = keep_deadlines
        return removed

    def flush(self) -> List[ServeRequest]:
        """Dispatch: return the requests in deadline order and freeze."""
        order = sorted(
            range(len(self.requests)),
            key=lambda i: (
                self._deadlines[i] if self._deadlines[i] is not None
                else float("inf"),
                self.requests[i].arrival_s, self.requests[i].request_id))
        self.state = DISPATCHED
        return [self.requests[i] for i in order]


def t0_bin(t0: float, bin_width: float) -> float:
    """Group label for a t0: the exact value when ``bin_width == 0``
    (legacy: only identical t0s share a micro-batch), else the lower edge
    of its bin — requests whose t0 fall in one bin share micro-batches
    and refine on one masked per-row schedule.

    The snap-down is forgiven a RELATIVE epsilon on ``t0 / bin_width``,
    not just the absolute 1e-12: for small bins (width ~1e-4) one ulp of
    the division result exceeds 1e-12, and a t0 lying EXACTLY on the grid
    (``k * width`` up to float rounding) would snap a full bin below
    itself — below the calibration floor when the grid starts there. An
    intentional sub-grid offset (the t0 = 1 - 1e-12 edge case) is still
    orders of magnitude above the relative term, so genuinely-below-edge
    values keep snapping DOWN.
    """
    if bin_width <= 0.0:
        return float(t0)
    v = float(t0) / bin_width
    return math.floor(v + 1e-12 + abs(v) * 4e-15) * bin_width


def pack_requests(
    requests: Sequence[ServeRequest],
    *,
    cold_nfe: int,
    default_t0: float,
    max_rows: int = 32,
    min_bucket: int = 8,
    max_bucket: Optional[int] = None,
    row_quantum: int = 4,
    row_multiple: int = 1,
    t0_bin_width: float = 0.0,
    distilled_nfe: int = 1,
) -> List[MicroBatch]:
    """Group requests into micro-batches.

    FIFO within each (bucket_len, t0-bin) group: arrival order is
    preserved inside a group so early requests are not starved by later
    small ones, and the packing is deterministic. Padded row counts are
    multiples of ``lcm(row_quantum, row_multiple)`` — the scheduler sets
    ``row_multiple`` to the mesh batch-axis size so sharded refine
    batches always divide the data axis.

    ``t0_bin_width = 0`` (default) groups by exact t0 — every micro-batch
    is t0-homogeneous, the legacy behaviour. ``> 0`` groups by t0-bin:
    per-request adaptive t0 values land in at most ``1/t0_bin_width``
    groups per bucket (the jit cache stays bounded), each micro-batch
    keeps its spans' exact t0s in ``t0_spans``, and its scan length
    realises the bin's worst (minimum) t0.

    Priority is part of the group key: a micro-batch never mixes
    priority classes, so the streaming loop can dispatch premium
    micro-batches ahead of best_effort ones without tearing batches
    apart (and a class's latency is never coupled to a lower class's
    batch). Compile keys are unaffected — priority changes grouping,
    not shapes.

    Tier is part of the group key too: distilled-tier requests form
    their own (bucket, t0-bin, priority) bins whose micro-batches run
    ``distilled_nfe`` (K in {1, 2}) steps of the distilled head instead
    of ``warm_nfe(cold_nfe, t0)`` refine steps, and whose compile keys
    carry the tier so the jit cache never mixes tiers.
    """
    unit = math.lcm(row_quantum, row_multiple)
    if unit > max_rows:
        raise ValueError(
            f"lcm(row_quantum={row_quantum}, row_multiple={row_multiple}) = "
            f"{unit} exceeds max_rows {max_rows}"
        )
    groups: dict = {}
    for req in requests:
        if pad_rows(req.num_samples, unit) > max_rows:
            raise ValueError(
                f"request {req.request_id}: num_samples {req.num_samples} "
                f"pads to {pad_rows(req.num_samples, unit)} rows > max_rows "
                f"{max_rows} (the streaming admission path splits such "
                f"requests automatically — see split_request / serve_stream)"
            )
        t0 = default_t0 if req.t0 is None else req.t0
        blen = bucket_seq_len(req.seq_len, min_bucket=min_bucket,
                              max_bucket=max_bucket)
        groups.setdefault(
            (blen, t0_bin(t0, t0_bin_width), req.priority, req.tier),
            []).append((req, t0))

    batches: List[MicroBatch] = []

    def emit(blen, tier, spans, t0s, row_t0s, used):
        t0_min = min(t0s)
        n_steps = (distilled_nfe if tier == DISTILLED_TIER
                   else guarantees.warm_nfe(cold_nfe, t0_min))
        batches.append(MicroBatch(
            bucket_len=blen, t0=t0_min, n_steps=n_steps,
            spans=tuple(spans), padded_rows=pad_rows(used, unit),
            t0_spans=tuple(t0s), row_t0_spans=tuple(row_t0s), tier=tier,
        ))

    for (blen, _bin, _cls, tier), reqs in groups.items():
        spans: List[RowSpan] = []
        t0s: List[float] = []
        row_t0s: List[Tuple[float, ...]] = []
        used = 0
        for req, t0 in reqs:
            # flush BEFORE the padded row count would exceed max_rows, so
            # padded_rows (the actual dispatch size) respects the cap
            if used and pad_rows(used + req.num_samples, unit) > max_rows:
                emit(blen, tier, spans, t0s, row_t0s, used)
                spans, t0s, row_t0s, used = [], [], [], 0
            spans.append(RowSpan(request=req, row_offset=used))
            t0s.append(t0)
            row_t0s.append(req.row_t0s)
            used += req.num_samples
        if spans:
            emit(blen, tier, spans, t0s, row_t0s, used)
    return batches
