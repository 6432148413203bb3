"""Speed-up guarantee accounting for warm-start flow matching.

The paper's central claim: if the cold-start sampler uses N Euler steps
over [0, 1], the warm-start sampler with the same step size needs exactly
``ceil(N * (1 - t0))`` steps over [t0, 1] — a *structural* speed-up of
``1 / (1 - t0)`` in backbone evaluations, independent of the data, the
draft model, or acceptance randomness (unlike speculative decoding).

This module turns that into checkable invariants used by tests and the
serving engine, and into a latency model used by the benchmarks.
"""

from __future__ import annotations

import dataclasses
import math


class GuaranteeViolation(RuntimeError):
    """The observed NFE count broke the structural warm-start guarantee.

    Raised (never ``assert``-ed, so it survives ``python -O``) by the
    serving engine and pipeline when a refine loop executed a number of
    backbone evaluations different from ``warm_nfe(cold_nfe, t0)``.
    """


@dataclasses.dataclass(frozen=True)
class SpeedupReport:
    t0: float
    cold_nfe: int
    warm_nfe: int
    draft_cost_ratio: float          # draft-model cost / one backbone NFE
    nfe_speedup: float               # cold_nfe / warm_nfe
    effective_speedup: float         # incl. draft cost
    guaranteed_factor: float         # 1 / (1 - t0)

    def as_row(self) -> str:
        return (
            f"t0={self.t0:.2f} cold_nfe={self.cold_nfe} warm_nfe={self.warm_nfe} "
            f"nfe_speedup={self.nfe_speedup:.2f}x effective={self.effective_speedup:.2f}x "
            f"guaranteed={self.guaranteed_factor:.2f}x"
        )


def warm_nfe(cold_nfe: int, t0: float) -> int:
    """Guaranteed warm-start NFE for the same Euler step size."""
    if not (0.0 <= t0 < 1.0):
        raise ValueError(f"t0 must be in [0,1), got {t0}")
    return max(1, math.ceil(cold_nfe * (1.0 - t0) - 1e-9))


def speedup_report(
    cold_nfe: int, t0: float, draft_cost_ratio: float = 0.0
) -> SpeedupReport:
    """Build the guarantee report.

    Args:
      cold_nfe: steps the baseline DFM uses.
      t0: warm-start time.
      draft_cost_ratio: cost of producing the draft divided by the cost of
        one backbone function evaluation (the paper treats this as
        'negligible'; we account for it explicitly).
    """
    w = warm_nfe(cold_nfe, t0)
    nfe_speedup = cold_nfe / w
    effective = cold_nfe / (w + draft_cost_ratio)
    return SpeedupReport(
        t0=t0,
        cold_nfe=cold_nfe,
        warm_nfe=w,
        draft_cost_ratio=draft_cost_ratio,
        nfe_speedup=nfe_speedup,
        effective_speedup=effective,
        guaranteed_factor=1.0 / (1.0 - t0),
    )


def check_guarantee(cold_nfe: int, t0: float, observed_nfe: int) -> bool:
    """Invariant asserted by tests and the serving engine."""
    return observed_nfe == warm_nfe(cold_nfe, t0)


def require_guarantee(cold_nfe: int, t0: float, observed_nfe: int) -> None:
    """Raise :class:`GuaranteeViolation` unless the NFE invariant holds."""
    if not check_guarantee(cold_nfe, t0, observed_nfe):
        raise GuaranteeViolation(
            f"warm-start NFE guarantee violated: observed {observed_nfe} "
            f"steps, guaranteed {warm_nfe(cold_nfe, t0)} "
            f"(cold_nfe={cold_nfe}, t0={t0})"
        )


def warm_nfe_rows(cold_nfe: int, t0_rows) -> list:
    """Per-row guaranteed NFE for a heterogeneous-t0 micro-batch."""
    return [warm_nfe(cold_nfe, float(t)) for t in t0_rows]


def require_row_guarantees(
    cold_nfe: int, t0_rows, observed_nfe_rows, *, bucket_len: int = -1,
    rows: int = -1,
) -> None:
    """Per-row guarantee gate for adaptive-t0 serving.

    Every row ``r`` of a micro-batch must have executed EXACTLY
    ``warm_nfe(cold_nfe, t0_rows[r])`` backbone-using Euler updates — a
    row exceeding its bound breaks the paper's guarantee, a row below it
    means the masked scan skipped real work. The batch-level worst case
    ``1/(1 - min t0)`` follows: the shared scan length equals the largest
    per-row bound, which belongs to the smallest t0.
    """
    t0_rows = list(t0_rows)
    observed = [int(o) for o in observed_nfe_rows]
    if len(observed) != len(t0_rows):
        raise GuaranteeViolation(
            f"row guarantee check got {len(observed)} observed NFEs for "
            f"{len(t0_rows)} rows"
        )
    for r, (t0, obs) in enumerate(zip(t0_rows, observed)):
        if obs != warm_nfe(cold_nfe, t0):
            where = (f"[micro-batch bucket_len={bucket_len} rows={rows}] "
                     if bucket_len >= 0 else "")
            raise GuaranteeViolation(
                f"{where}per-row warm-start NFE guarantee violated at row "
                f"{r}: observed {obs} steps, guaranteed "
                f"{warm_nfe(cold_nfe, t0)} (cold_nfe={cold_nfe}, t0={t0})"
            )


def require_bucket_guarantee(
    cold_nfe: int, t0: float, observed_nfe: int, *, bucket_len: int, rows: int
) -> None:
    """Per-micro-batch guarantee gate for the continuous-batching
    scheduler: same invariant as :func:`require_guarantee`, with the
    bucket identity attached so a violation names the offending batch."""
    try:
        require_guarantee(cold_nfe, t0, observed_nfe)
    except GuaranteeViolation as e:
        raise GuaranteeViolation(
            f"[micro-batch bucket_len={bucket_len} rows={rows}] {e}"
        ) from None
