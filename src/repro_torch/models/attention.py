"""GQA self-attention of the torch backbone (port of the JAX package's
``models/attention.py::gqa_attention`` and ``init_gqa_cache``), DeepSeek's
multi-head latent attention (``init_mla``, ``mla_attention``,
``_mla_chunked``, ``init_mla_cache``) and the encoder-decoder's cross
attention (``init_cross_attn``, ``cross_attention``, ``encode_cross_kv``).

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

Given position ids (``q_pos``: a VLM batch's temporal stream, where 256
patches share id 0 and the text starts at 16), JAX's masks compare ids, not
indices: an uncached causal query sees every key whose id is at most its
own (``k_pos = q_pos``), a window keeps ids within ``window``. That is not
index-causal, so such a forward (causal, or with a window) runs in plain
torch under the mask built from the ids (:func:`position_mask`), as the
cached path does; a bidirectional forward without a window masks nothing
and keeps the kernel. The serve's refine and training are bidirectional
without a window: the causal forward with ids is off the main path.

With a cache (``forward_cached``, the AR decode/prefill path) the chunk's
k/v are written into the cache buffers at the cache's cursor and the
queries attend over the whole buffer under the causal and cache-validity
masks, in plain torch as JAX's ``_sdpa`` does there (no Pallas kernel).
The AR draft engine's fast path is ``kernels/draft_decode`` instead.

MLA (:class:`MLAttention`) projects the query through a rank
``q_lora_rank`` bottleneck and the keys and values through a latent
``c_kv`` of ``kv_lora_rank`` floats a token, beside one rotary key ``k_pe``
of ``qk_rope_head_dim`` floats that every head shares; its rope angles
come from the query positions at ``qk_rope_head_dim`` (JAX derives them in
the layer). A query and a key are ``qk_nope_head_dim + qk_rope_head_dim``
wide, a value ``v_head_dim``. Without a cache (the refine, the causal
forward, training) the latent is expanded to per-head keys and values and
the layer runs through the ``flash_attn`` kernel with V narrower than Q and
K, at scale 1/sqrt(qk width): the same function as JAX's naive path and as
its ``_mla_chunked`` (``attn_impl="chunked"``), which differ only in how
XLA tiles it. With a cache, ``c_kv`` and ``k_pe`` are written at the
cursor in place and the layer runs in plain torch, as JAX's einsums do
(no Pallas kernel there): the naive expansion of the whole cache, or with
``cfg.mla_absorb`` the absorbed decode (W_uk folded into the query, W_uv
into the output; the latent read once, never expanded).

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


def _cache_mask(q_pos: torch.Tensor, start: torch.Tensor, s: int, t: int,
                window: Optional[int]) -> torch.Tensor:
    """(B, S, T) boolean: key ``k`` of the buffer is seen by the query at
    ``q_pos`` when ``k <= q_pos``, ``k < start + s`` (written) and, with a
    ``window``, ``k > q_pos - window`` (JAX ``attn_mask`` with ``k_valid``)."""
    k_pos = torch.arange(t, device=q_pos.device)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None]) & (k_pos < start + s)
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    return mask


def position_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, mode: str,
                  window: Optional[int]) -> torch.Tensor:
    """(B, S, T) boolean, True where the query at id ``q_pos`` (B, S) sees
    the key at id ``k_pos`` (B, T) (JAX ``attn_mask`` without ``k_valid``):
    causal ``k <= q``; a window keeps ``q - window < k <= q`` (causal) or
    ``|k - q| < window`` (bidirectional)."""
    q, k = q_pos[:, :, None], k_pos[:, None, :]
    mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                      device=q_pos.device)
    if mode == "causal":
        mask = mask & (k <= q)
    if window is not None:
        mask = (mask & (k > q - window) & (k <= q) if mode != "bidir"
                else mask & ((k - q).abs() < window))
    return mask


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Plain GQA attention (JAX ``_sdpa``): q (B, S, H, D), k and v (B, T, KH,
    D), mask (B, S, T) -> (B, S, H * D); scores in float32, a masked score
    NEG_INF."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qh = q.reshape(b, s, kh, h // kh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qh, k).float() * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, h * v.shape[-1])


def _write_at_cursor(start: torch.Tensor, *pairs) -> None:
    """Each ``(buf (B, T, ...), x (B, S, ...))`` of ``pairs``: ``x`` into
    ``buf`` at rows ``start..start+S-1``, in place. The cursor stays a tensor
    (no read by the host, so a CUDA graph can hold the step) and is clamped
    to fit, as ``dynamic_update_slice``."""
    buf0, x0 = pairs[0]
    t, s = buf0.shape[1], x0.shape[1]
    rows = torch.clamp(start, 0, t - s).long() + torch.arange(s, device=buf0.device)
    for buf, x in pairs:
        buf.index_copy_(1, rows, x.to(buf.dtype))


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
                cos: Optional[torch.Tensor], mode: str, window: Optional[int] = None,
                q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Without a cache. ``q_pos`` (B, S), a VLM batch's temporal ids: a
        causal or windowed forward masks by them in plain torch (see the
        module docstring); otherwise the ``flash_attn`` kernel."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, sin, cos)
        scale = 1.0 / math.sqrt(self.hd)
        if q_pos is not None and (mode == "causal" or window is not None):
            out = masked_attention(q, k, v, position_mask(q_pos, q_pos, mode, window), scale)
            return self.wo(out)
        out = flash_attention(q, k, v, causal=mode == "causal", window=window, scale=scale)
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
        start = cache["pos"]
        _write_at_cursor(start, (kbuf, k), (vbuf, v))
        mask = _cache_mask(q_pos, start, s, kbuf.shape[1], window)
        out = masked_attention(q, kbuf.to(x.dtype), vbuf.to(x.dtype), mask,
                               1.0 / math.sqrt(self.hd))
        new_cache = {"k": kbuf, "v": vbuf, "pos": cache["pos"] + s}
        return self.wo(out), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    """``{"c_kv": (B, T, kv_lora_rank), "k_pe": (B, T, qk_rope_head_dim)
    zeros, "pos": () int32 0}`` (JAX ``init_mla_cache``): the latent and the
    shared rotary key a token, not per-head keys and values."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_pe": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


class MLAttention(nn.Module):
    """DeepSeek's multi-head latent attention (JAX ``init_mla``: ``wq_a``,
    ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo`` at
    stddev 0.02 / sqrt(2 L); no biases). ``sin``/``cos`` are the angles at
    ``qk_rope_head_dim`` of the query positions."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        self.h, self.r = h, m.kv_lora_rank
        self.nd, self.rd, self.vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        qk = self.nd + self.rd
        self.scale = 1.0 / math.sqrt(qk)
        self.wq_a = Dense(d, m.q_lora_rank, gen, device)
        self.q_norm = RMSNorm(m.q_lora_rank, cfg.norm_eps, device)
        self.wq_b = Dense(m.q_lora_rank, h * qk, gen, device)
        self.wkv_a = Dense(d, m.kv_lora_rank + self.rd, gen, device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, device)
        self.wkv_b = Dense(m.kv_lora_rank, h * (self.nd + self.vd), gen, device)
        self.wo = Dense(h * self.vd, d, gen, device, stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def _project(self, x, sin, cos):
        """(q_nope (B,S,H,nd), q_rope (B,S,H,rd) rotated, c_kv (B,S,r), k_pe
        (B,S,rd) rotated)."""
        b, s, _ = x.shape
        q = self.wq_b(self.q_norm(self.wq_a(x))).reshape(b, s, self.h, self.nd + self.rd)
        q_nope, q_rope = q[..., :self.nd], apply_rope(q[..., self.nd:], sin, cos)
        kv_a = self.wkv_a(x)
        c_kv = self.kv_norm(kv_a[..., :self.r])
        k_pe = apply_rope(kv_a[..., self.r:][:, :, None, :], sin, cos)[:, :, 0]
        return q_nope, q_rope, c_kv, k_pe

    def _expand(self, c_kv):
        """The latent (B, T, r) -> per-head (k_nope (B,T,H,nd), v (B,T,H,vd))."""
        b, t, _ = c_kv.shape
        kv = self.wkv_b(c_kv).reshape(b, t, self.h, self.nd + self.vd)
        return kv[..., :self.nd], kv[..., self.nd:]

    def forward(self, x: torch.Tensor, *, sin: torch.Tensor, cos: torch.Tensor, mode: str,
                window: Optional[int] = None) -> torch.Tensor:
        """The layer over the whole sequence: q = [q_nope, q_rope] and k =
        [k_nope, k_pe on every head] (B, S, H, nd + rd), v (B, S, H, vd)
        through ``flash_attn``."""
        b, s, _ = x.shape
        q_nope, q_rope, c_kv, k_pe = self._project(x, sin, cos)
        k_nope, v = self._expand(c_kv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, self.h, self.rd)], dim=-1)
        out = flash_attention(q, k, v.contiguous(), causal=mode == "causal", window=window,
                              scale=self.scale)
        return self.wo(out.reshape(b, s, self.h * self.vd))

    def forward_cached(self, x: torch.Tensor, cache: dict, *, sin: torch.Tensor,
                       cos: torch.Tensor, q_pos: torch.Tensor, window: Optional[int] = None,
                       absorb: bool = False) -> Tuple[torch.Tensor, dict]:
        """x (B, S, D) at positions ``q_pos`` (B, S) -> (out, new cache):
        ``c_kv``/``k_pe`` written at the cursor in place, the queries over
        the whole buffer under the causal and validity masks; the naive
        expansion, or with ``absorb`` (``cfg.mla_absorb``) the latent read
        as it is."""
        b, s, _ = x.shape
        q_nope, q_rope, c_kv, k_pe = self._project(x, sin, cos)
        cbuf, pbuf = cache["c_kv"], cache["k_pe"]
        start = cache["pos"]
        _write_at_cursor(start, (cbuf, c_kv), (pbuf, k_pe))
        mask = _cache_mask(q_pos, start, s, cbuf.shape[1], window)
        c_all, pe_all = cbuf.to(x.dtype), pbuf.to(x.dtype)
        if absorb:
            w = self.wkv_b.w.to(x.dtype).reshape(self.r, self.h, self.nd + self.vd)
            w_uk, w_uv = w[..., :self.nd], w[..., self.nd:]
            q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)             # (B,S,H,r)
            scores = torch.einsum("bshr,btr->bhst", q_lat, c_all)
        else:
            k_nope, v = self._expand(c_all)
            scores = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
        scores = scores + torch.einsum("bshd,btd->bhst", q_rope, pe_all)
        scores = scores.float() * self.scale
        probs = torch.softmax(scores.masked_fill(~mask[:, None], NEG_INF), dim=-1)
        probs = probs.to(x.dtype)
        if absorb:
            out_lat = torch.einsum("bhst,btr->bshr", probs, c_all)            # (B,S,H,r)
            out = torch.einsum("bshr,rhd->bshd", out_lat, w_uv)
        else:
            out = torch.einsum("bhst,bthd->bshd", probs, v)
        new_cache = {"c_kv": cbuf, "k_pe": pbuf, "pos": cache["pos"] + s}
        return self.wo(out.reshape(b, s, self.h * self.vd)), new_cache


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
