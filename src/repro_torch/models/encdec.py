"""Whisper-style encoder-decoder (port of the JAX package's
``models/encdec.py``, arXiv:2212.04356), transformer backbone only: the
mel-spectrogram and conv frontend are a stub, and the caller supplies
precomputed frame embeddings ``frames (B, F, d_model)``.

Encoder: bidirectional attention blocks over the frames plus sinusoidal
positions, then ``enc_norm``. Decoder: self attention (causal, or
bidirectional as the DFM denoiser), cross attention over the encoder's
output, MLP, then ``dec_norm`` and the tied head. Whisper's learned decoder
positions are sinusoids here, as in JAX. LayerNorm, GELU, biases, no RoPE.

``EncDecModel(cfg, device="cuda", seed=0)`` holds its weights as an
``nn.Module`` (``embed``, ``time``, ``enc_blocks.{i}``, ``enc_norm``,
``dec_blocks.{i}``, ``dec_norm``); a JAX checkpoint loads with
``model.load_state_dict(jax_params_to_torch(flat))``. Every attention
without a cache (the encoder's, the decoder's in ``forward``, and every
cross attention) runs through the ``flash_attn`` kernel; the decoder's
self attention over its cache runs in plain torch, as ``Model``'s does.

The cache keeps the JAX tree: ``{"self": {"k", "v": (L, B, T, KH, hd),
"pos": (L,)}, "cross": {"k", "v": (L, B, F, H, hd)}}``. ``prefill``
encodes the frames once and writes the cross keys and values into the
cache, cast to its dtype; every self k/v buffer is written in place.

``dfm_apply`` re-encodes the frames at every call, as JAX's does.
:class:`Conditioned` binds a batch's frames to the model for callers that
take ``dfm_apply(tokens, t)`` (``WarmStartServer``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import CrossAttention, GQAAttention
from repro_torch.models.common import MLP, Embedding, TimeEmbed, make_norm


def check_encdec_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is an encoder-decoder config this port runs:
    layernorm, gelu, biases, no RoPE, no logit softcap, float32."""
    unsupported = []
    if not cfg.is_encoder_decoder:
        unsupported.append("is_encoder_decoder=False")
    if cfg.norm != "layernorm":
        unsupported.append(f"norm={cfg.norm}")
    if cfg.act != "gelu":
        unsupported.append(f"act={cfg.act}")
    if not cfg.use_bias:
        unsupported.append("use_bias=False")
    if cfg.rope_type != "none":
        unsupported.append(f"rope_type={cfg.rope_type}")
    if cfg.attn_logit_softcap:
        unsupported.append("attn_logit_softcap")
    if cfg.dtype != "float32" or cfg.param_dtype != "float32":
        unsupported.append(f"dtype={cfg.dtype}/{cfg.param_dtype}")
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: not supported by the torch port's "
                                  f"encoder-decoder yet: {', '.join(unsupported)}")


def sinusoids(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Float32 positions (N,) -> (N, dim): ``[sin(pos * inv), cos(pos * inv)]``
    with ``inv = exp(-log(1e4) / (dim/2 - 1) * arange(dim/2))`` (JAX
    ``_sinusoids`` and ``_embed_tokens``). torch's float32 ``exp`` and
    XLA's differ in the last bit, which positions up to 1499 amplify: at
    (1500, 1024) the tables differ by up to 1.2e-4."""
    half = dim // 2
    scale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-scale * torch.arange(half, dtype=torch.float32, device=pos.device))
    ang = pos.float()[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoids(length: int, dim: int, device=None) -> torch.Tensor:
    return sinusoids(torch.arange(length, dtype=torch.float32, device=device), dim)


class EncoderBlock(nn.Module):
    """``h += attn(ln1(h))`` (bidirectional), ``h += mlp(ln2(h))``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device)
        self.attn = GQAAttention(cfg, gen, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.ln1(h), sin=None, cos=None, mode="bidir")
        return h + self.mlp(self.ln2(h))


class DecoderBlock(nn.Module):
    """``h += self_attn(ln1(h))``, ``h += cross(ln_x(h), kv)``,
    ``h += mlp(ln2(h))``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device)
        self.self_attn = GQAAttention(cfg, gen, device)
        self.ln_x = make_norm(cfg, device)
        self.cross = CrossAttention(cfg, gen, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, h: torch.Tensor, kv: dict, *, mode: str, q_pos: torch.Tensor,
                cache: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
        a = self.ln1(h)
        if cache is None:
            a, new_cache = self.self_attn(a, sin=None, cos=None, mode=mode), None
        else:
            a, new_cache = self.self_attn.forward_cached(a, cache, sin=None, cos=None,
                                                         q_pos=q_pos)
        h = h + a
        h = h + self.cross(self.ln_x(h), kv)
        return h + self.mlp(self.ln2(h)), new_cache


class EncDecModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        check_encdec_supported(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, gen, dev)
        self.time = TimeEmbed(cfg, gen, dev)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, gen, dev) for _ in range(cfg.num_encoder_layers))
        self.enc_norm = make_norm(cfg, dev)
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, gen, dev)
                                        for _ in range(cfg.num_layers))
        self.dec_norm = make_norm(cfg, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        # JAX ``unembed``: the head is always the embedding table, transposed
        return torch.matmul(x, self.embed.table.T)

    # -- encoder -------------------------------------------------------------

    def encode(self, frames: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
        """frames (B, F, d_model) stub embeddings -> encoder states. With
        ``remat`` each block is checkpointed (JAX checkpoints its scan body)."""
        x = frames.float() + _sinusoids(frames.shape[1], self.cfg.d_model, frames.device)[None]
        for block in self.enc_blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.enc_norm(x)

    def _layer_kvs(self, enc_out: torch.Tensor) -> List[dict]:
        return [block.cross.encode_kv(enc_out) for block in self.dec_blocks]

    def build_cross_kvs(self, enc_out: torch.Tensor) -> dict:
        """Every decoder layer's cross k/v, stacked: ``{"k", "v": (L, B, F,
        H, hd)}`` (JAX ``build_cross_kvs``)."""
        kvs = self._layer_kvs(enc_out)
        return {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}

    # -- decoder -------------------------------------------------------------

    def _embed_tokens(self, tokens: torch.Tensor, pos_offset,
                      t: Optional[torch.Tensor]) -> torch.Tensor:
        s = tokens.shape[1]
        x = self.embed(tokens)
        idx = torch.arange(s, dtype=torch.int32, device=tokens.device) + pos_offset
        x = x + sinusoids(idx, self.cfg.d_model)[None]
        if t is not None:
            x = x + self.time(t)[:, None, :]
        return x

    def _decode_stack(self, x, kvs, q_pos, mode, self_cache=None, remat: bool = False):
        """The decoder blocks over ``x``; ``kvs`` one cross k/v per layer.
        With ``self_cache`` (the cache's ``"self"`` leaves) the self
        attention writes and reads it; returns (normed x, new self leaves).
        With ``remat`` (no cache) each block is checkpointed, as JAX's scan
        body is; the cross k/v are computed outside it."""
        new = []
        for i, block in enumerate(self.dec_blocks):
            lc = None if self_cache is None else {k: v[i] for k, v in self_cache.items()}
            if remat and lc is None:
                x, lc = checkpoint(block, x, kvs[i], mode=mode, q_pos=q_pos,
                                   use_reentrant=False)
            else:
                x, lc = block(x, kvs[i], mode=mode, q_pos=q_pos, cache=lc)
            new.append(lc)
        new_self = None
        if self_cache is not None:
            # the k/v buffers were written through their slices; the cursors restack
            new_self = {"k": self_cache["k"], "v": self_cache["v"],
                        "pos": torch.stack([lc["pos"] for lc in new])}
        return self.dec_norm(x), new_self

    def forward(self, tokens: torch.Tensor, t: Optional[torch.Tensor] = None, *,
                frames: torch.Tensor, mode: Optional[str] = None,
                remat: bool = False) -> torch.Tensor:
        """tokens (B, S), frames (B, F, D) -> logits (B, S, V). With ``t``
        (B,) the decoder is the DFM denoiser (bidirectional,
        time-conditioned); without, a causal LM. ``remat`` checkpoints each
        encoder and decoder block (JAX ``forward(..., remat)``)."""
        kvs = self._layer_kvs(self.encode(frames, remat=remat))
        b, s = tokens.shape
        x = self._embed_tokens(tokens, 0, t)
        q_pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        if mode is None:
            mode = "bidir" if t is not None else "causal"
        x, _ = self._decode_stack(x, kvs, q_pos, mode, remat=remat)
        return self._head(x)

    def dfm_apply(self, tokens: torch.Tensor, t: torch.Tensor, *,
                  extras: Optional[dict] = None) -> torch.Tensor:
        """(tokens (B, N), t (B,), extras ``{"frames": (B, F, D)}``) -> logits."""
        if not extras or "frames" not in extras:
            raise ValueError(f"{self.cfg.name}: dfm_apply needs extras={{'frames': ...}}")
        return self.forward(tokens, t, frames=extras["frames"])

    # -- AR serving with a cache -----------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """Zeroed cache in the JAX layout, on the model's device."""
        cfg, dev = self.cfg, self.device
        layers = cfg.num_layers
        kv = (layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        cross = (layers, batch, cfg.num_audio_frames, cfg.num_heads, cfg.head_dim)
        return {
            "self": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                     "v": torch.zeros(kv, dtype=dtype, device=dev),
                     "pos": torch.zeros((layers,), dtype=torch.int32, device=dev)},
            "cross": {"k": torch.zeros(cross, dtype=dtype, device=dev),
                      "v": torch.zeros(cross, dtype=dtype, device=dev)},
        }

    @staticmethod
    def _cache_kvs(cache: dict) -> List[dict]:
        cross = cache["cross"]
        return [{"k": cross["k"][i], "v": cross["v"][i]} for i in range(cross["k"].shape[0])]

    def _cached(self, tokens, cache, pos):
        b, s = tokens.shape
        x = self._embed_tokens(tokens, pos, None)
        q_pos = (torch.arange(s, dtype=torch.int32, device=x.device)[None] + pos).expand(b, s)
        x, new_self = self._decode_stack(x, self._cache_kvs(cache), q_pos, "causal",
                                         self_cache=cache["self"])
        return x, {"self": new_self, "cross": cache["cross"]}

    def _no_window(self, global_window: Optional[int]) -> None:
        if global_window is not None:
            raise NotImplementedError(f"{self.cfg.name}: the encoder-decoder attends "
                                      f"without a window")

    def prefill(self, batch: dict, cache: dict, *,
                global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """``batch`` ``{"tokens" (B, P), "frames" (B, F, D)}`` -> (logits of
        the last position (B, 1, V), new cache): the frames encoded once,
        every layer's cross k/v written into the cache (in its dtype), the
        tokens decoded causally from position 0."""
        self._no_window(global_window)
        enc_out = self.encode(batch["frames"])
        for kv, ckv in zip(self._layer_kvs(enc_out), self._cache_kvs(cache)):
            ckv["k"].copy_(kv["k"])
            ckv["v"].copy_(kv["v"])
        x, cache = self._cached(batch["tokens"], cache, 0)
        return self._head(x[:, -1:]), cache

    def decode_step(self, tokens: torch.Tensor, cache: dict, pos, *,
                    global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """tokens (B, S) at positions ``pos``.. (``pos`` the current length)
        -> (logits (B, S, V), new cache); the self k/v written in place."""
        self._no_window(global_window)
        x, cache = self._cached(tokens, cache, pos)
        return self._head(x), cache


class Conditioned:
    """A model's ``dfm_apply`` with its extras bound: ``dfm_apply(tokens, t)``
    calls ``model.dfm_apply(tokens, t, extras=extras)``, so a caller that
    takes the unconditioned signature (``WarmStartServer``) serves an
    :class:`EncDecModel` on a fixed batch of frames. A CUDA graph captured
    through it reads the frames' storage: change them in place (``copy_``),
    never by rebinding."""

    def __init__(self, model, extras: dict):
        self.model, self.extras = model, extras

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.device

    def dfm_apply(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.model.dfm_apply(tokens, t, extras=self.extras)
