"""Rotary position embeddings (port of the JAX package's ``models/rope.py``:
standard RoPE, which the DiT applies in bidirectional mode too,
Gemma3's dual RoPE, ``rope_type="dual"``: local layers rotate at
``local_rope_theta``, global ones at ``rope_theta``, MLA's decoupled
rotary dims at ``qk_rope_head_dim``, and Qwen2-VL's M-RoPE,
``rope_type="mrope"``: the rotary half split into three sections, each
rotated by its own stream of the (temporal, height, width) position ids)."""

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


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE (JAX ``mrope_angles``): positions (3, B, S), the
    temporal, height and width ids -> (sin, cos) each (B, S, head_dim/2).
    Frequency slot ``i`` of the rotary half lies in section ``j`` (the first
    ``sections[0]`` slots in section 0, and so on) and turns by stream ``j``
    of ``positions``. Where the three streams are equal this is
    :func:`rope_angles` at that stream, bit for bit."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} != head_dim/2 {half}")
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = theta ** (-ar / half)
    sec = torch.cat([torch.full((n,), i, dtype=torch.long, device=positions.device)
                     for i, n in enumerate(sections)])
    pos = positions[sec].movedim(0, -1).float()        # (B, S, half): slot i's stream
    ang = pos * freq
    return torch.sin(ang), torch.cos(ang)


def vlm_positions(batch: int, grid: Tuple[int, int], text: int, device="cpu"
                  ) -> torch.Tensor:
    """Qwen2-VL's M-RoPE ids for one image of ``grid`` = (h, w) merged patches
    followed by ``text`` tokens: (3, batch, h * w + text) int32. Patch (r,
    c), row-major, sits at (t, h, w) = (0, r, c); the text then runs from
    max(h, w) on all three streams (16, 17, ... after a 16 x 16 grid)."""
    h, w = grid
    r, c = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    img = torch.stack([torch.zeros(h * w, dtype=torch.long), r.flatten(), c.flatten()])
    txt = (max(h, w) + torch.arange(text))[None].expand(3, text)
    pos = torch.cat([img, txt], dim=1).to(torch.int32)
    return pos[:, None].expand(3, batch, pos.shape[1]).contiguous().to(device)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_context(cfg, positions: torch.Tensor, *,
                 mrope_positions: Optional[torch.Tensor] = None) -> dict:
    """The angles a stack needs at ``positions`` (JAX ``Model._rope_ctx``):
    ``{"global": (sin, cos), "local": (sin, cos)}``, each pair ``(None,
    None)`` for ``rope_type="none"``; the local pair is the global one
    unless ``rope_type="dual"``. A config with ``cfg.mla`` adds ``"mla"``:
    the angles at ``qk_rope_head_dim`` that its MLA layers rotate by, from
    the same query positions (JAX ``mla_attention`` derives them in each
    layer, whatever ``rope_type`` says).

    ``mrope_positions`` (3, B, S) are a VLM batch's ``positions``. With
    ``rope_type="mrope"`` they give both pairs by :func:`mrope_angles`, and
    the context adds ``"q_pos"``: their temporal stream, the ids JAX's
    masks compare (``positions`` is then not read). Without them, or for
    another ``rope_type``, an ``"mrope"`` config rotates by standard RoPE at
    ``positions``, as JAX's fallback does."""
    none: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)
    if cfg.rope_type == "mrope" and mrope_positions is not None:
        angles = mrope_angles(mrope_positions, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
        return {"global": angles, "local": angles, "q_pos": mrope_positions[0]}
    ctx = {}
    if cfg.mla is not None:
        ctx["mla"] = rope_angles(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)
    if cfg.rope_type == "none":
        return {"global": none, "local": none, **ctx}
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    local = (rope_angles(positions, cfg.head_dim, cfg.local_rope_theta)
             if cfg.rope_type == "dual" else angles)
    return {"global": angles, "local": local, **ctx}
