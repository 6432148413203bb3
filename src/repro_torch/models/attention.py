"""GQA self-attention of the torch backbone (port of the no-cache branch of
the JAX package's ``models/attention.py::gqa_attention``).

Masking: ``mode="bidir"`` (the DFM denoiser) sees every position,
``mode="causal"`` only earlier ones.
The JAX backbone computes this in XLA's einsum ``_sdpa``; here it runs
through the ``flash_attn`` kernel (its plain version on the CPU), which
the tests hold against ``_sdpa``. The mask (JAX ``attn_mask``) lives in
the kernel and in ``kernels/flash_attn/ref.py::attention_mask``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models.common import Dense
from repro_torch.models.rope import apply_rope


class GQAAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.h, self.kh, self.hd = cfg.num_heads, cfg.num_kv_heads, hd
        self.wq = Dense(d, cfg.num_heads * hd, gen, device)
        self.wk = Dense(d, cfg.num_kv_heads * hd, gen, device)
        self.wv = Dense(d, cfg.num_kv_heads * hd, gen, device)
        self.wo = Dense(cfg.num_heads * hd, d, gen, device,
                        stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def forward(self, x: torch.Tensor, *, sin: torch.Tensor, cos: torch.Tensor,
                mode: str) -> torch.Tensor:
        b, s, _ = x.shape
        q = apply_rope(self.wq(x).reshape(b, s, self.h, self.hd), sin, cos)
        k = apply_rope(self.wk(x).reshape(b, s, self.kh, self.hd), sin, cos)
        v = self.wv(x).reshape(b, s, self.kh, self.hd)
        out = flash_attention(q, k, v, causal=mode == "causal",
                              scale=1.0 / math.sqrt(self.hd))
        return self.wo(out.reshape(b, s, self.h * self.hd))
