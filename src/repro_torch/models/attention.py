"""GQA self-attention of the torch backbone (port of the JAX package's
``models/attention.py::gqa_attention`` and ``init_gqa_cache``) and the
encoder-decoder's cross attention (``init_cross_attn``,
``cross_attention``, ``encode_cross_kv``).

Masking: ``mode="bidir"`` (the DFM denoiser) sees every position,
``mode="causal"`` only earlier ones; a ``window`` (a ``local`` layer's
``sliding_window``, or ``global_window``) keeps keys with ``|k - q| <
window`` (bidirectional) or ``q - window < k <= q`` (causal). With
``cfg.qk_norm`` (Gemma3) q and k each pass an rmsnorm over head_dim
(``qnorm``/``knorm``) after the projections and before RoPE.
Without a cache the JAX backbone computes this in XLA's einsum ``_sdpa``;
here it runs through the ``flash_attn`` kernel (its plain version on the
CPU), which the tests hold against ``_sdpa``. The mask (JAX ``attn_mask``)
lives in the kernel and in ``kernels/flash_attn/ref.py::attention_mask``.

With a cache (``forward_cached``, the AR decode/prefill path) the chunk's
k/v are written into the cache buffers at the cache's cursor and the
queries attend over the whole buffer under the causal and cache-validity
masks, in plain torch as JAX's ``_sdpa`` does there (no Pallas kernel).
The AR draft engine's fast path is ``kernels/draft_decode`` instead.

Cross attention (:class:`CrossAttention`) reads keys and values made from
the encoder's output, unmasked: JAX computes it in einsum and softmax;
here it runs through the ``flash_attn`` kernel with ``causal=False`` and
S queries against T != S keys, cached or not.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.flash_attn.ref import NEG_INF
from repro_torch.models.common import Dense, RMSNorm
from repro_torch.models.rope import apply_rope


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    """``{"k", "v": (B, T, KH, hd) zeros, "pos": () int32 0}``."""
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kh, hd), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


class GQAAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, hd, bias = cfg.d_model, cfg.head_dim, cfg.use_bias
        self.h, self.kh, self.hd = cfg.num_heads, cfg.num_kv_heads, hd
        self.wq = Dense(d, cfg.num_heads * hd, gen, device, bias=bias)
        self.wk = Dense(d, cfg.num_kv_heads * hd, gen, device, bias=bias)
        self.wv = Dense(d, cfg.num_kv_heads * hd, gen, device, bias=bias)
        self.wo = Dense(cfg.num_heads * hd, d, gen, device, bias=bias,
                        stddev=0.02 / math.sqrt(2 * cfg.num_layers))
        if cfg.qk_norm:
            self.qnorm = RMSNorm(hd, cfg.norm_eps, device)
            self.knorm = RMSNorm(hd, cfg.norm_eps, device)
        else:
            self.qnorm = self.knorm = None

    def _qkv(self, x, sin, cos):
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, self.h, self.hd)
        k = self.wk(x).reshape(b, s, self.kh, self.hd)
        v = self.wv(x).reshape(b, s, self.kh, self.hd)
        if self.qnorm is not None:
            q, k = self.qnorm(q), self.knorm(k)
        if sin is not None:
            q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        return q, k, v

    def forward(self, x: torch.Tensor, *, sin: Optional[torch.Tensor],
                cos: Optional[torch.Tensor], mode: str,
                window: Optional[int] = None) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self._qkv(x, sin, cos)
        out = flash_attention(q, k, v, causal=mode == "causal", window=window,
                              scale=1.0 / math.sqrt(self.hd))
        return self.wo(out.reshape(b, s, self.h * self.hd))

    def forward_cached(self, x: torch.Tensor, cache: dict, *, sin: Optional[torch.Tensor],
                       cos: Optional[torch.Tensor], q_pos: torch.Tensor,
                       window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """x (B, S, D) at positions ``q_pos`` (B, S) -> (out, new cache).

        The chunk's k/v go into ``cache["k"]``/``cache["v"]`` in place (the
        JAX engine donates those buffers); the returned cache holds the
        same buffers and a new cursor ``pos + S``."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, sin, cos)
        kbuf, vbuf = cache["k"], cache["v"]
        t = kbuf.shape[1]
        # the cursor stays a tensor (no read by the host, so a CUDA graph can
        # hold this step); dynamic_update_slice clamps the write to fit
        start = cache["pos"]
        rows = torch.clamp(start, 0, t - s).long() + torch.arange(s, device=kbuf.device)
        kbuf.index_copy_(1, rows, k.to(kbuf.dtype))
        vbuf.index_copy_(1, rows, v.to(vbuf.dtype))
        k_pos = torch.arange(t, device=x.device)
        mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & (k_pos < start + s)
        if window is not None:
            mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
        g = self.h // self.kh
        qh = q.reshape(b, s, self.kh, g, self.hd)
        kf, vf = kbuf.to(x.dtype), vbuf.to(x.dtype)
        scores = torch.einsum("bskgd,btkd->bkgst", qh, kf).float() * (1.0 / math.sqrt(self.hd))
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(vf.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, vf).reshape(b, s, self.h * self.hd)
        new_cache = {"k": kbuf, "v": vbuf, "pos": cache["pos"] + s}
        return self.wo(out), new_cache


class CrossAttention(nn.Module):
    """Whisper's decoder cross attention: q from the decoder, k and v from
    the encoder's output (JAX ``init_cross_attn``: wq/wk/wv/wo with
    ``cfg.use_bias`` biases, wo at stddev 0.02 / sqrt(2 L))."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, h, hd, bias = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.use_bias
        self.h, self.hd = h, hd
        self.wq = Dense(d, h * hd, gen, device, bias=bias)
        self.wk = Dense(d, h * hd, gen, device, bias=bias)
        self.wv = Dense(d, h * hd, gen, device, bias=bias)
        self.wo = Dense(h * hd, d, gen, device, bias=bias,
                        stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def encode_kv(self, enc_out: torch.Tensor) -> dict:
        """enc_out (B, T, D) -> ``{"k", "v": (B, T, H, hd)}`` (JAX
        ``encode_cross_kv``)."""
        b, t, _ = enc_out.shape
        return {"k": self.wk(enc_out).reshape(b, t, self.h, self.hd),
                "v": self.wv(enc_out).reshape(b, t, self.h, self.hd)}

    def forward(self, x: torch.Tensor, kv: dict) -> torch.Tensor:
        """x (B, S, D) attends over every key of ``kv`` (JAX
        ``cross_attention``), cast to x's dtype as JAX casts them."""
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, self.h, self.hd)
        k, v = kv["k"].to(x.dtype), kv["v"].to(x.dtype)
        out = flash_attention(q, k, v, causal=False, scale=1.0 / math.sqrt(self.hd))
        return self.wo(out.reshape(b, s, self.h * self.hd))
