"""Transformer block of the torch backbone (port of the ``attn`` and
``local`` branches of the JAX package's ``models/transformer.py::apply_block``):

    x = x + post_attn(attn(norm1(x)));  x = x + post_ffn(mlp(norm2(x)))

``post_attn``/``post_ffn`` exist only with ``cfg.post_norms`` (Gemma3). A
``local`` block attends within ``cfg.sliding_window`` on the local RoPE
angles; an ``attn`` block within ``global_window`` (None: everywhere) on
the global ones.

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

KINDS = ("attn", "local")   # the layer kinds a Block runs


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device, kind: str = "attn"):
        super().__init__()
        self.kind = kind
        self.window = cfg.sliding_window if kind == "local" else None
        self.ln1 = make_norm(cfg, device)
        self.attn = GQAAttention(cfg, gen, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, gen, device)
        self.post_attn = make_norm(cfg, device) if cfg.post_norms else None
        self.post_ffn = make_norm(cfg, device) if cfg.post_norms else None

    def _attn_args(self, rope: dict, global_window: Optional[int]):
        """(sin, cos, window) of this block (JAX ``apply_block``'s ``attn_args``)."""
        if self.kind == "local":
            return (*rope["local"], self.window)
        return (*rope["global"], global_window)

    def _finish(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.post_attn is not None:
            h = self.post_attn(h)
        x = x + h
        h = self.mlp(self.ln2(x))
        if self.post_ffn is not None:
            h = self.post_ffn(h)
        return x + h

    def forward(self, x: torch.Tensor, *, rope: dict, mode: str,
                global_window: Optional[int] = None) -> torch.Tensor:
        sin, cos, window = self._attn_args(rope, global_window)
        return self._finish(x, self.attn(self.ln1(x), sin=sin, cos=cos, mode=mode,
                                         window=window))

    def forward_cached(self, x: torch.Tensor, cache: dict, *, rope: dict, q_pos: torch.Tensor,
                       global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        sin, cos, window = self._attn_args(rope, global_window)
        h, cache = self.attn.forward_cached(self.ln1(x), cache, sin=sin, cos=cos,
                                            q_pos=q_pos, window=window)
        return self._finish(x, h), cache
