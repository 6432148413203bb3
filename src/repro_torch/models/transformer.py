"""Transformer block of the torch backbone (port of the ``attn`` branch of
the JAX package's ``models/transformer.py::apply_block``):

    x = x + attn(norm1(x));  x = x + mlp(norm2(x))

The JAX package stacks the layers' weights and scans over them; here the
stack is a list of per-layer modules (see ``Model``). Its KV cache keeps
the JAX layout (``init_stack_cache``), which ``Model`` builds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQAAttention
from repro_torch.models.common import MLP, make_norm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device)
        self.attn = GQAAttention(cfg, gen, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, *, sin: Optional[torch.Tensor],
                cos: Optional[torch.Tensor], mode: str,
                window: Optional[int] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), sin=sin, cos=cos, mode=mode, window=window)
        return x + self.mlp(self.ln2(x))

    def forward_cached(self, x: torch.Tensor, cache: dict, *, sin: Optional[torch.Tensor],
                       cos: Optional[torch.Tensor], q_pos: torch.Tensor,
                       window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        h, cache = self.attn.forward_cached(self.ln1(x), cache, sin=sin, cos=cos,
                                            q_pos=q_pos, window=window)
        x = x + h
        return x + self.mlp(self.ln2(x)), cache
