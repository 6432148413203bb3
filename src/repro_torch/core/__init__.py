"""Warm-start flow matching core: paths, the Euler sampler, guarantees."""

from repro_torch.core.guarantees import (
    GuaranteeViolation, require_bucket_guarantee, require_guarantee,
    require_row_guarantees, speedup_report, warm_nfe, warm_nfe_rows,
)
from repro_torch.core.paths import WarmStartPath
from repro_torch.core.sampler import (
    categorical_from_probs, euler_step_probs, make_euler_one_step,
    refine_loop_inputs, refine_schedule, scan_refine_loop,
)

__all__ = ["GuaranteeViolation", "require_guarantee", "require_bucket_guarantee",
           "require_row_guarantees", "speedup_report", "warm_nfe", "warm_nfe_rows",
           "WarmStartPath", "categorical_from_probs",
           "euler_step_probs", "make_euler_one_step", "refine_loop_inputs",
           "refine_schedule", "scan_refine_loop"]
