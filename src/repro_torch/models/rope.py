"""Rotary position embeddings (port of the JAX package's ``models/rope.py``
standard RoPE; the DiT applies it in bidirectional mode too)."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> (sin, cos) each (..., S, head_dim/2)."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = theta ** (-ar / half)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
