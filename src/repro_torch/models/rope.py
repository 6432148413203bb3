"""Rotary position embeddings (port of the JAX package's ``models/rope.py``:
standard RoPE, which the DiT applies in bidirectional mode too,
Gemma3's dual RoPE, ``rope_type="dual"``: local layers rotate at
``local_rope_theta``, global ones at ``rope_theta``, and MLA's decoupled
rotary dims at ``qk_rope_head_dim``)."""

from __future__ import annotations

from typing import Optional, Tuple

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


def rope_context(cfg, positions: torch.Tensor) -> dict:
    """The angles a stack needs at ``positions`` (JAX ``Model._rope_ctx``):
    ``{"global": (sin, cos), "local": (sin, cos)}``, each pair ``(None,
    None)`` for ``rope_type="none"``; the local pair is the global one
    unless ``rope_type="dual"``. A config with ``cfg.mla`` adds ``"mla"``:
    the angles at ``qk_rope_head_dim`` that its MLA layers rotate by, from
    the same query positions (JAX ``mla_attention`` derives them in each
    layer, whatever ``rope_type`` says)."""
    none: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)
    ctx = {}
    if cfg.mla is not None:
        ctx["mla"] = rope_angles(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    if cfg.rope_type == "none":
        return {"global": none, "local": none, **ctx}
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    local = (rope_angles(positions, cfg.head_dim, cfg.local_rope_theta)
             if cfg.rope_type == "dual" else angles)
    return {"global": angles, "local": local, **ctx}
