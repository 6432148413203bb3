"""Per-request adaptive warm-start time (quality-matched t0): port of the
JAX package's ``drafting/policy.py``, host numpy like its original.

The serving-side face of :mod:`repro_torch.drafting.quality`: given the drafts
a request is about to refine, decide its t0 from their measured quality
— a pretty-good draft enters the flow deep (few steps), a poor one
shallow (more steps) — while keeping the paper's guarantee machinery
intact:

  * the chosen t0 is SNAPPED DOWN to a bin grid (:func:`bin_t0`): the
    serving jit cache stays bounded by the bin count, and snapping down
    (never up) can only ADD refine steps vs the calibrated value —
    guarantee-conservative;
  * a request's NFE bound is ``warm_nfe(cold_nfe, t0_request)`` exactly,
    enforced per row by the scheduler
    (:func:`repro_torch.core.guarantees.require_row_guarantees`);
  * the batch worst case stays ``1/(1 - min t0)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np

from repro_torch.drafting.quality import T0Calibration, to_host


def bin_t0(t0: float, *, width: float = 0.05, floor: float = 0.0) -> float:
    """Snap ``t0`` DOWN to the bin grid ``floor + k * width``.

    Snapping down means the served t0 is never deeper than the calibrated
    one — the refine loop only ever takes MORE steps than the quality
    score asked for, so the per-request guarantee derived from the binned
    t0 dominates the calibrated intent.

    The snap uses the same epsilon policy as
    :func:`repro_torch.serving.batcher.t0_bin` — the function the batcher uses
    to form (bucket, t0-bin) group keys, so a policy-binned t0 (at the
    default ``floor=0``) can never straddle a batcher bin edge. The
    forgiveness epsilon is RELATIVE (scaled by ``t0 / width``) on top of
    the absolute 1e-12: with small widths a t0 lying exactly on the grid
    can otherwise land one ulp below ``k`` after the subtract/divide and
    snap a whole bin down — below the calibration floor when the grid
    starts there.
    """
    if width <= 0.0:
        return max(float(t0), floor)
    v = (float(t0) - floor) / width
    eps = 1e-12 + (abs(float(t0)) / width) * 4e-15
    k = math.floor(v + eps)
    return max(floor, floor + max(k, 0) * width)


@dataclasses.dataclass
class AdaptiveT0Policy:
    """score drafts -> calibrated t0 -> binned per-request t0.

    Args:
      scorer: ``tokens (B, N) -> (B,) scores`` (see
        :func:`repro_torch.drafting.quality.make_quality_scorer`) — costs one
        backbone NFE per scored batch, charged to the draft stage.
      calibration: fitted score -> t0 mapping.
      bin_width: t0 bin grid pitch (also the batcher's grouping bin).
      t0_floor: lower clamp applied after binning (a request can never be
        served shallower than this).
    """

    scorer: Callable
    calibration: T0Calibration
    bin_width: float = 0.05
    t0_floor: float = 0.0

    def t0_for_drafts(self, tokens) -> np.ndarray:
        """(B, N) draft tokens -> (B,) binned per-row t0."""
        return self.scores_and_t0(tokens)[1]

    def scores_and_t0(self, tokens) -> Tuple[np.ndarray, np.ndarray]:
        """(B, N) draft tokens -> ((B,) probe scores, (B,) binned t0).

        The policy-protocol entry point shared with
        :class:`repro_torch.drafting.bandit.BanditT0Policy`: one probe dispatch
        yields both the per-row quality scores (which the scheduler's
        speculative accept/reject stage compares against the acceptance
        threshold) and the per-row warm-start times, so speculation never
        pays a second probe.
        """
        scores = to_host(self.scorer(tokens)).astype(np.float64)
        t0 = self.calibration.t0_for_scores(scores)
        return scores, np.array(
            [bin_t0(v, width=self.bin_width, floor=self.t0_floor)
             for v in t0], np.float64)

    def t0_for_request(self, tokens) -> float:
        """One t0 for a whole request: the MINIMUM over its sample rows —
        the worst draft in the request dictates how shallow the shared
        schedule starts. This collapse is for callers that refine every
        row on ONE schedule slice (the one-shot ``WarmStartServer.serve``
        batch path); the scheduler's masked per-row refine scan supports
        heterogeneous entry, so its pre-pass keeps the full
        :meth:`t0_for_drafts` vector per request (``per_row_t0`` mode)
        instead of calling this."""
        return float(self.t0_for_drafts(tokens).min())
