"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

  ws_step    — warm-start Euler sampling step (replaces the TPU kernel
               ``ws_step_streamed_pallas``), its per-row mode for the
               scheduler (``ws_step_rows``), and the step with its noise
               given (``ws_step_gumbel``, replaces ``ws_step_pallas``) or
               keyed and drawn in the kernel (``ws_step_gumbel_keyed``, the
               default Euler step)
  ws_fused   — K fused warm-start Euler steps on one logits buffer
               (replaces ``ws_fused_streamed_pallas``)
  flash_attn — blockwise online-softmax attention (replaces
               ``flash_attention_pallas``)
  draft_decode — batch-invariant decode-step kernels of the AR draft
               transformer: qkv_rope, attn_cached, post_attn, head (replace
               ``qkv_rope_pallas``, ``attn_cached_pallas``,
               ``post_attn_pallas``, ``head_pallas``)

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version (``ref.py``) only for a CPU tensor. ``_build`` compiles
``csrc/*.cu`` with ``nvcc`` on first use; ``repro_torch.counts`` counts
launches.
"""

from repro_torch.counts import launches
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref
from repro_torch.kernels.draft_decode import DraftDecoder, draft_decode_supported
from repro_torch.kernels.ws_fused import make_ws_fused_fn, ws_fused_steps
from repro_torch.kernels.ws_step import (
    make_ws_step_fn, ws_step, ws_step_gumbel, ws_step_gumbel_keyed, ws_step_gumbel_ref,
    ws_step_ref, ws_step_ref_streamed, ws_step_rows,
)

__all__ = ["launches", "ws_step", "ws_step_rows", "ws_step_gumbel", "ws_step_gumbel_keyed",
           "make_ws_step_fn", "ws_step_ref", "ws_step_ref_streamed", "ws_step_gumbel_ref",
           "make_ws_fused_fn", "ws_fused_steps", "flash_attention",
           "flash_attention_ref", "DraftDecoder", "draft_decode_supported"]
