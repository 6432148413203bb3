"""Transformer block of the torch backbone (port of the ``attn`` branch of
the JAX package's ``models/transformer.py::apply_block``):

    x = x + attn(ln1(x));  x = x + mlp(ln2(x))

The JAX package stacks the layers' weights and scans over them; here the
stack is a list of per-layer modules (see ``Model``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQAAttention
from repro_torch.models.common import MLP, LayerNorm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = GQAAttention(cfg, gen, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, *, sin: torch.Tensor, cos: torch.Tensor,
                mode: str) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), sin=sin, cos=cos, mode=mode)
        return x + self.mlp(self.ln2(x))
