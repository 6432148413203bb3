"""K fused warm-start Euler draws in one launch: CUDA kernel
``csrc/ws_fused.cu``, its wrapper (``ops``) and plain version (``ref``)."""

from repro_torch.kernels.ws_fused.ops import make_ws_fused_fn, ws_fused_steps
from repro_torch.kernels.ws_fused.ref import fused_noise, ws_fused_ref

__all__ = ["make_ws_fused_fn", "ws_fused_steps", "ws_fused_ref", "fused_noise"]
