"""Shared building blocks of the torch backbone (port of the JAX package's
``models/common.py``).

Weights keep the JAX layout so a checkpoint converts by name alone:
``Dense.w`` is ``(in, out)`` and ``y = x @ w``; the embedding table
is ``(vocab, d)``. Initialisers copy the JAX package's scales, drawn from
an explicit ``torch.Generator`` (the port's seeded init; the values differ
from JAX's, which tests convert with ``repro_torch.convert``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def normal_init(gen: torch.Generator, shape, stddev: float, device) -> torch.Tensor:
    return stddev * torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


class Dense(nn.Module):
    """``x @ w`` with ``w`` stored ``(in, out)`` as in JAX."""

    def __init__(self, in_dim: int, out_dim: int, gen: torch.Generator, device, *,
                 stddev: float | None = None):
        super().__init__()
        if stddev is None:
            stddev = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(normal_init(gen, (in_dim, out_dim), stddev, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w)


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32; ``eps``
    is ``cfg.norm_eps`` (1e-6 for the DiT), as the JAX ``apply_norm``
    passes it."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)
    raise ValueError(name)


class Embedding(nn.Module):
    """Token lookup into a ``(vocab, d)`` table."""

    def __init__(self, vocab: int, dim: int, gen: torch.Generator, device, stddev=0.02):
        super().__init__()
        self.table = nn.Parameter(normal_init(gen, (vocab, dim), stddev, device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.table)


class TimeEmbed(nn.Module):
    """DFM time conditioning: Fourier features of ``t`` (x1000) followed by
    a SiLU MLP, added to every position's embedding."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        h = cfg.time_embed_dim
        self.dim = h
        self.w1 = Dense(h, 4 * h, gen, device)
        self.w2 = Dense(4 * h, cfg.d_model, gen, device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t: (B,) in [0, 1] -> (B, d_model)."""
        half = self.dim // 2
        ar = torch.arange(half, dtype=torch.float32, device=t.device)
        freqs = torch.exp(-math.log(10000.0) * ar / half)
        ang = t.float()[:, None] * freqs[None, :] * 1000.0
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.w2(F.silu(self.w1(feats)))


class MLP(nn.Module):
    """Plain ``up -> act -> down`` MLP (``cfg.mlp_gated`` False)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        self.up = Dense(d, f, gen, device)
        self.down = Dense(f, d, gen, device, stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(activation(self.act, self.up(x)))
