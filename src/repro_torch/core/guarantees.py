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
