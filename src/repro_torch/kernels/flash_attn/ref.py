"""Plain PyTorch version of the flash attention kernel: the same function
as ``csrc/flash_attn.cu`` (and the JAX package's ``flash_attn/ref.py``),
written out with einsum and softmax. The CPU path and the on-card
comparison use it; it is not a port of the kernel."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def attention_mask(s: int, t: int, *, causal: bool, window: Optional[int],
                   device=None) -> torch.Tensor:
    """Boolean (S, T) mask, True = attend (``attn_mask`` semantics)."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(t, device=device)[None, :]
    m = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        m = m & (ki <= qi)
        if window is not None:
            m = m & (ki > qi - window)
    elif window is not None:
        m = m & ((ki - qi).abs() < window)
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,D), k (B,T,KH,D), v (B,T,KH,DV) -> (B,S,H,DV); query head h
    reads KV head h // (H // KH). DV may differ from D (MLA: 192-wide queries
    and keys, 128-wide values), as in the kernel."""
    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                          device=q.device)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)
