"""Measured draft cost (port of the cost-ratio part of the JAX package's
``drafting/quality.py``: ``CostRatioReport``, ``measure_cost_ratio``).

:func:`measure_cost_ratio` times the draft stage against one backbone NFE
on the host clock, each call ended by a synchronisation of the card where
JAX calls ``block_until_ready``: the ``draft_cost_ratio`` that
``guarantees.speedup_report`` charges against the speed-up. (The quality
scorer and the score -> t0 calibration are not ported yet.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class CostRatioReport:
    """Measured draft-vs-backbone timing (per generated batch)."""

    draft_time_s: float              # one draft-stage batch
    nfe_time_s: float                # one backbone evaluation + Euler step
    cost_ratio: float                # draft_time_s / nfe_time_s
    batch: int
    seq_len: int
    iters: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _block_until_ready(out) -> None:
    """Wait for the card to finish every CUDA tensor in ``out`` (a tensor or
    a tuple/list of them): synchronise the streams of their devices."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in items if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def _timed_best_of(fn, iters: int) -> float:
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_cost_ratio(draft_fn: Callable[[], torch.Tensor],
                       nfe_fn: Callable[[], torch.Tensor], *, batch: int, seq_len: int,
                       iters: int = 5, warmup: int = 1) -> CostRatioReport:
    """Measure ``draft_cost_ratio`` for :func:`guarantees.speedup_report`.

    ``draft_fn()`` must produce one draft batch, ``nfe_fn()`` one backbone
    function evaluation (+ Euler update) at the same (batch, seq_len). Both
    are warmed first, then timed best-of-``iters`` on the host clock, each
    call ended by waiting for the card (wall time, the quantity the
    guarantee accounting charges).
    """
    for _ in range(warmup):
        _block_until_ready(draft_fn())
        _block_until_ready(nfe_fn())
    draft_s = _timed_best_of(draft_fn, iters)
    nfe_s = _timed_best_of(nfe_fn, iters)
    return CostRatioReport(draft_time_s=draft_s, nfe_time_s=nfe_s,
                           cost_ratio=draft_s / max(nfe_s, 1e-12), batch=batch,
                           seq_len=seq_len, iters=iters)
