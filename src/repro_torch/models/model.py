"""The torch backbone: embeddings + time conditioning + attention blocks +
head (port of the JAX package's ``models/model.py`` for dense attention
configs, in DFM-denoiser and causal modes).

``Model(cfg, device="cuda", seed=0)`` holds its weights as an
``nn.Module`` built from a seeded ``torch.Generator`` on ``device``; a JAX
checkpoint loads with ``model.load_state_dict(jax_params_to_torch(flat))``
(``repro_torch.convert``). ``prefill``, ``decode_step`` and
``init_cache`` (the AR draft engine's) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import Dense, Embedding, LayerNorm, TimeEmbed
from repro_torch.models.rope import rope_angles
from repro_torch.models.transformer import Block


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense attention config this port runs."""
    unsupported = []
    if cfg.is_encoder_decoder or cfg.family not in ("dense",):
        unsupported.append(f"family={cfg.family}")
    if cfg.prefix or set(cfg.pattern) != {"attn"}:
        unsupported.append(f"layers={cfg.prefix + cfg.pattern}")
    if cfg.norm != "layernorm":
        unsupported.append(f"norm={cfg.norm}")
    if cfg.rope_type != "default":
        unsupported.append(f"rope_type={cfg.rope_type}")
    if cfg.act not in ("gelu", "silu"):
        unsupported.append(f"act={cfg.act}")
    for flag in ("mlp_gated", "use_bias", "qk_norm", "post_norms", "embed_scale",
                 "attn_logit_softcap"):
        if getattr(cfg, flag):
            unsupported.append(flag)
    if cfg.tie_embeddings:
        unsupported.append("tie_embeddings")
    if cfg.dtype != "float32" or cfg.param_dtype != "float32":
        unsupported.append(f"dtype={cfg.dtype}/{cfg.param_dtype}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not supported by the torch port yet: {', '.join(unsupported)}")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, gen, dev)
        self.blocks = nn.ModuleList(Block(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.d_model, cfg.norm_eps, dev)
        self.time = TimeEmbed(cfg, gen, dev)
        self.head = Dense(cfg.d_model, cfg.vocab_size, gen, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, tokens: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V). With ``t`` (B,) the model is
        the DFM denoiser (bidirectional, time-conditioned); without, a
        causal LM."""
        cfg = self.cfg
        x = self.embed(tokens)
        if t is not None:
            x = x + self.time(t)[:, None, :]
        mode = "bidir" if t is not None else "causal"
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        sin, cos = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        for block in self.blocks:
            x = block(x, sin=sin, cos=cos, mode=mode)
        return self.head(self.final_norm(x))

    def dfm_apply(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(tokens (B, N), t (B,)) -> logits: the v_theta signature the
        sampler expects."""
        return self.forward(tokens, t)


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> Model:
    return Model(cfg, device=device, seed=seed)
