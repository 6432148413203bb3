"""Warm-start serving: the request batcher, drafts, the one-shot
``WarmStartServer`` and the continuous-batching ``WarmStartScheduler``."""

from repro_torch.serving.batcher import (
    ACCEPTED_DRAFT, CANCELLED, COMPLETED, DEADLINE_ARMED, DISPATCHED,
    DISTILLED, DISTILLED_TIER, FAILED, FILLING, GUARANTEED_TIER,
    PRIORITY_CLASSES, SHED, TERMINAL_STATUSES, TIERS, TIMED_OUT, CancelToken,
    FillingBucket, MicroBatch, RowSpan, ServeRequest, bucket_seq_len,
    pack_requests, pad_rows, priority_rank, split_request, t0_bin,
    usable_rows,
)
from repro_torch.serving.drafts import (
    BatchKeyedDraftWarning, batch_keyed_draft, corruption_draft, uniform_draft,
)
from repro_torch.serving.engine import (
    DispatchFailure, DispatchRetryPolicy, PerNFECostModel, WarmStartServer,
    ar_generate, make_prefill_fn, make_refine_step_fn, make_serve_step,
)
from repro_torch.serving.scheduler import (
    DEFAULT_CLASS_SLO_FACTOR, AdmissionQueue, CompletedRequest, QueueClosed,
    QueueFull, RequestResult, WarmStartScheduler,
)

__all__ = [
    "WarmStartServer", "ar_generate", "make_prefill_fn", "make_refine_step_fn",
    "make_serve_step",
    "PerNFECostModel", "DispatchFailure", "DispatchRetryPolicy",
    "ServeRequest", "MicroBatch", "RowSpan", "bucket_seq_len", "pad_rows",
    "pack_requests", "t0_bin", "usable_rows", "split_request",
    "FillingBucket", "FILLING", "DEADLINE_ARMED", "DISPATCHED",
    "PRIORITY_CLASSES", "priority_rank", "CancelToken",
    "COMPLETED", "ACCEPTED_DRAFT", "DISTILLED", "CANCELLED", "TIMED_OUT",
    "SHED", "FAILED", "TERMINAL_STATUSES",
    "GUARANTEED_TIER", "DISTILLED_TIER", "TIERS",
    "WarmStartScheduler", "RequestResult", "CompletedRequest",
    "AdmissionQueue", "QueueClosed", "QueueFull",
    "DEFAULT_CLASS_SLO_FACTOR",
    "uniform_draft", "corruption_draft", "batch_keyed_draft",
    "BatchKeyedDraftWarning",
]
