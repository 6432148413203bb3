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
    # scaled in place: no second tensor of the shape (arctic's experts are 17.9 GB each)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(stddev)


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` stored ``(in, out)`` as in JAX; the bias
    (``bias=True``) starts at zero, as ``dense_init`` makes it."""

    def __init__(self, in_dim: int, out_dim: int, gen: torch.Generator, device, *,
                 stddev: float | None = None, bias: bool = False):
        super().__init__()
        if stddev is None:
            stddev = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(normal_init(gen, (in_dim, out_dim), stddev, device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.w)
        return y if self.b is None else y + self.b


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


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in float32, with the
    zero-initialised (gemma-style) ``scale`` of the JAX ``rmsnorm``."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * (1.0 + self.scale.float())).to(x.dtype)


def make_norm(cfg: ModelConfig, device) -> nn.Module:
    """``cfg.norm`` over ``d_model`` (JAX ``init_norm``/``apply_norm``)."""
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, cfg.norm_eps, device)
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model, cfg.norm_eps, device)
    raise ValueError(f"unknown norm {cfg.norm!r}")


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


class Embedding(nn.Module):
    """Token lookup into a ``(vocab, d)`` table; with ``scale`` (Gemma's
    ``embed_scale``) the rows are multiplied by sqrt(d) in float32, as JAX's
    ``embed(..., scale=True)`` does. A tied head reads the table unscaled."""

    def __init__(self, vocab: int, dim: int, gen: torch.Generator, device, stddev=0.02,
                 scale: bool = False):
        super().__init__()
        self.table = nn.Parameter(normal_init(gen, (vocab, dim), stddev, device))
        self.mult = math.sqrt(dim) if scale else None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens.long(), self.table)
        # a Python scalar multiplies a float32 tensor as float32(sqrt(d))
        return x if self.mult is None else x * self.mult


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
    """``up -> act -> down`` MLP; with ``cfg.mlp_gated`` the hidden layer is
    ``act(gate(x)) * up(x)``. Biases with ``cfg.use_bias``. The hidden width
    is ``d_ff`` (default ``cfg.d_ff``; an MoE's shared experts give theirs)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 d_ff: int | None = None):
        super().__init__()
        d, f, bias = cfg.d_model, d_ff or cfg.d_ff, cfg.use_bias
        self.act = cfg.act
        self.up = Dense(d, f, gen, device, bias=bias)
        self.down = Dense(f, d, gen, device, bias=bias,
                          stddev=0.02 / math.sqrt(2 * cfg.num_layers))
        self.gate = Dense(d, f, gen, device, bias=bias) if cfg.mlp_gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        if self.gate is not None:
            return self.down(activation(self.act, self.gate(x)) * up)
        return self.down(activation(self.act, up))
