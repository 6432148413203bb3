"""Warm-start Euler sampling step: CUDA kernels ``csrc/ws_step.cu`` (one
key per batch, the scheduler's per-row mode, and the step with its Gumbel
noise given or keyed), their wrappers (``ops``) and plain versions
(``ref``)."""

from repro_torch.kernels.ws_step.ops import (
    key_words, make_ws_step_fn, seed_from_key, ws_step, ws_step_gumbel, ws_step_gumbel_keyed,
    ws_step_rows,
)
from repro_torch.kernels.ws_step.ref import (
    keyed_gumbel, keyed_uniform, near_tie_rows, near_tie_rows_probs, ws_step_gumbel_ref,
    ws_step_ref, ws_step_ref_streamed, ws_step_rows_ref,
)

__all__ = ["ws_step", "ws_step_rows", "ws_step_gumbel", "ws_step_gumbel_keyed",
           "make_ws_step_fn", "seed_from_key", "key_words", "ws_step_ref",
           "ws_step_ref_streamed", "ws_step_rows_ref", "ws_step_gumbel_ref", "keyed_gumbel",
           "keyed_uniform", "near_tie_rows", "near_tie_rows_probs"]
