"""The draft stage and its policies (port of the JAX package's
``drafting/``: ``ar_engine.py``, ``ref.py``, ``quality.py``, ``policy.py``,
``bandit.py`` and ``distill.py``): a KV-cached draft engine over a
transformer or the LSTM, its cache-free oracle, the quality probe and its
score -> t0 calibration, the per-request adaptive t0 and the bandit over t0
arms, the measured draft/NFE cost ratio, and the self-distilled few-step
head of the scheduler's distilled tier with its pair buffer, training loop
and checkpoints."""

from repro_torch.drafting.ar_engine import (
    ARDraftEngine, DraftEngineStats, LSTMDraftAdapter, TransformerDraftAdapter, row_gumbel,
)
from repro_torch.drafting.quality import (
    CostRatioReport, T0Calibration, fit_t0_calibration, make_quality_scorer, measure_cost_ratio,
)
from repro_torch.drafting.policy import AdaptiveT0Policy, bin_t0
from repro_torch.drafting.bandit import BanditT0Policy, default_accept_score
from repro_torch.drafting.distill import (
    DistilledRefiner, DistillReport, PairBuffer, distilled_checkpoint_exists, restore_distilled,
    save_distilled, train_distilled,
)
from repro_torch.drafting.ref import oracle_generate_rows

__all__ = ["ARDraftEngine", "DraftEngineStats", "LSTMDraftAdapter", "TransformerDraftAdapter",
           "row_gumbel", "T0Calibration", "fit_t0_calibration", "make_quality_scorer",
           "measure_cost_ratio", "CostRatioReport",
           "AdaptiveT0Policy", "bin_t0", "BanditT0Policy", "default_accept_score",
           "DistilledRefiner", "DistillReport", "PairBuffer", "train_distilled",
           "save_distilled", "restore_distilled", "distilled_checkpoint_exists",
           "oracle_generate_rows"]
