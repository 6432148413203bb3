"""Warm-start flow matching core: paths, the Euler sampler, guarantees."""

from repro_torch.core.guarantees import (
    GuaranteeViolation, require_guarantee, speedup_report, warm_nfe,
)
from repro_torch.core.paths import WarmStartPath
from repro_torch.core.sampler import (
    categorical_from_probs, euler_step_probs, make_euler_one_step,
    refine_loop_inputs, refine_schedule, scan_refine_loop,
)

__all__ = ["GuaranteeViolation", "require_guarantee", "speedup_report", "warm_nfe",
           "WarmStartPath", "categorical_from_probs",
           "euler_step_probs", "make_euler_one_step", "refine_loop_inputs",
           "refine_schedule", "scan_refine_loop"]
