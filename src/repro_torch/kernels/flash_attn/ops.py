"""``flash_attention``: the wrapper around ``csrc/flash_attn.cu``.

Same signature and layout as the JAX package's ``flash_attn/ops.py``:
q (B, S, H, D), k and v (B, T, KH, D) with KH dividing H (GQA), causal /
bidirectional / sliding-window masks, output (B, S, H, D). A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

SUPPORTED_HEAD_DIMS = (32, 64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    _check(q, k, v)
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel: {SUPPORTED_HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty_like(q)
    _launch(q, k, v, out, causal=causal, window=window, scale=scale)
    _build.count("flash_attn")
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
            causal: bool, window: Optional[int], scale: float) -> None:
    """One launch of the kernel on checked, contiguous CUDA tensors (no count)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _build.library().flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kh, d,
            float(scale), int(causal), int(window or 0), stream)
    _build.check(rc, "flash_attn")
