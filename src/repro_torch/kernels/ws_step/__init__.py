"""Warm-start Euler sampling step: CUDA kernel ``csrc/ws_step.cu``, its
wrapper (``ops``) and plain versions (``ref``)."""

from repro_torch.kernels.ws_step.ops import make_ws_step_fn, seed_from_key, ws_step
from repro_torch.kernels.ws_step.ref import (
    near_tie_rows, ws_step_ref, ws_step_ref_streamed,
)

__all__ = ["ws_step", "make_ws_step_fn", "seed_from_key", "ws_step_ref",
           "ws_step_ref_streamed", "near_tie_rows"]
