"""Warm-start flow matching core: paths, the training losses and
couplings, the Euler sampler, guarantees, the drafts and the generation
pipeline."""

from repro_torch.core.guarantees import (
    GuaranteeViolation, SpeedupReport, check_guarantee, require_bucket_guarantee,
    require_guarantee, require_row_guarantees, speedup_report, warm_nfe, warm_nfe_rows,
)
from repro_torch.core.paths import WarmStartPath, cold_start_path, mask_noise, uniform_noise
from repro_torch.core.losses import dfm_cross_entropy, distill_map_loss, ws_dfm_loss
from repro_torch.core.coupling import (
    IndependentCoupling, KNNRefinementCoupling, OracleRefinementCoupling, pair_iterator,
)
from repro_torch.core.sampler import (
    EulerSampler, SamplerStats, categorical_from_probs, categorical_from_probs_rows,
    euler_step_probs, make_euler_one_step, make_euler_one_step_rows, make_refine_step,
    refine_loop_inputs, refine_schedule, refine_schedule_rows, scan_refine_loop,
    scan_refine_loop_rows,
)
from repro_torch.core.draft import ARDraft, CorruptionDraft, DraftModel, HistogramDraft
from repro_torch.core.pipeline import WarmStartPipeline

__all__ = [
    "WarmStartPath", "cold_start_path", "uniform_noise", "mask_noise",
    "dfm_cross_entropy", "distill_map_loss", "ws_dfm_loss",
    "IndependentCoupling", "KNNRefinementCoupling", "OracleRefinementCoupling",
    "pair_iterator",
    "EulerSampler", "SamplerStats", "euler_step_probs", "categorical_from_probs",
    "categorical_from_probs_rows", "make_euler_one_step", "make_euler_one_step_rows",
    "make_refine_step", "refine_loop_inputs", "refine_schedule", "refine_schedule_rows",
    "scan_refine_loop", "scan_refine_loop_rows",
    "warm_nfe", "warm_nfe_rows", "speedup_report", "SpeedupReport", "check_guarantee",
    "require_guarantee", "require_bucket_guarantee", "require_row_guarantees",
    "GuaranteeViolation",
    "DraftModel", "CorruptionDraft", "HistogramDraft", "ARDraft",
    "WarmStartPipeline",
]
