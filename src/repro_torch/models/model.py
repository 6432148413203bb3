"""The torch backbone: embeddings + time conditioning + attention blocks +
head (port of the JAX package's ``models/model.py`` for the dense attention
configs: the DiT and the dense zoo, Gemma3's local/global layers, dual
RoPE, qk-norm, post-norms and scaled embeddings included), in DFM-denoiser
and causal modes, with the AR serving entry points ``init_cache``,
``prefill`` and ``decode_step``.

``Model(cfg, device="cuda", seed=0)`` holds its weights as an
``nn.Module`` built from a seeded ``torch.Generator`` on ``device``; a JAX
checkpoint loads with ``model.load_state_dict(jax_params_to_torch(flat))``
(``repro_torch.convert``).

The layers run in JAX's stack order (``transformer.apply_stack``): the
``prefix`` layers, ``reps`` repeats of ``pattern``, then the remainder
``pattern[:rem]``. The KV cache keeps the JAX tree
(``transformer.init_stack_cache``): ``{"pre": {"x{j}": ...}, "blocks":
{"p{p}": {"k", "v": (reps, B, T, KH, hd), "pos": (reps,) int32}}, "rem":
{"r{j}": ...}}``: prefix layer ``j`` is ``pre/x{j}``, layer ``npre + r * P
+ p`` is slice ``r`` of ``blocks/p{p}``, remainder layer ``j`` is
``rem/r{j}`` (unstacked, ``pos`` a scalar).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_gqa_cache
from repro_torch.models.common import Dense, Embedding, TimeEmbed, make_norm
from repro_torch.models.rope import rope_context
from repro_torch.models.transformer import KINDS, Block


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense attention config this port runs:
    ``attn``/``local`` layers, layernorm or rmsnorm, standard, dual or no
    RoPE, qk-norm, post-norms and scaled embeddings allowed, float32. MoE,
    MLA, encoder-decoder, recurrent and VLM configs, the logit softcap and
    other dtypes raise."""
    unsupported = []
    if cfg.is_encoder_decoder or cfg.family not in ("dense",):
        unsupported.append(f"family={cfg.family}")
    if not set(cfg.prefix + cfg.pattern) <= set(KINDS):
        unsupported.append(f"layers={cfg.prefix + cfg.pattern}")
    if cfg.norm not in ("layernorm", "rmsnorm"):
        unsupported.append(f"norm={cfg.norm}")
    if cfg.rope_type not in ("default", "none", "dual"):
        unsupported.append(f"rope_type={cfg.rope_type}")
    if cfg.act not in ("gelu", "silu", "relu"):
        unsupported.append(f"act={cfg.act}")
    if cfg.attn_logit_softcap:
        unsupported.append("attn_logit_softcap")
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
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, gen, dev, scale=cfg.embed_scale)
        self.blocks = nn.ModuleList(Block(cfg, gen, dev, kind) for kind in layer_kinds(cfg))
        self.final_norm = make_norm(cfg, dev)
        self.time = TimeEmbed(cfg, gen, dev)
        # tied: the head is the embedding table, transposed (JAX ``unembed``)
        self.head = (None if cfg.tie_embeddings
                     else Dense(cfg.d_model, cfg.vocab_size, gen, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.head is None:
            return torch.matmul(x, self.embed.table.T)
        return self.head(x)

    def forward(self, tokens: torch.Tensor, t: Optional[torch.Tensor] = None, *,
                global_window: Optional[int] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V). With ``t`` (B,) the model is
        the DFM denoiser (bidirectional, time-conditioned); without, a
        causal LM."""
        x = self.embed(tokens)
        if t is not None:
            x = x + self.time(t)[:, None, :]
        mode = "bidir" if t is not None else "causal"
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        rope = rope_context(self.cfg, pos)
        for block in self.blocks:
            x = block(x, rope=rope, mode=mode, global_window=global_window)
        return self._head(x)

    def dfm_apply(self, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(tokens (B, N), t (B,)) -> logits: the v_theta signature the
        sampler expects."""
        return self.forward(tokens, t)

    # -- AR serving with a KV cache ------------------------------------------

    def layer_slots(self) -> Iterator[Tuple[str, str, Optional[int]]]:
        """Where layer ``i`` keeps its cache: ``(group, name, index)``, in
        layer order (``index`` is the slice of a stacked leaf, or None)."""
        cfg = self.cfg
        reps, rem = cfg.scan_split()
        for j in range(len(cfg.prefix)):
            yield "pre", f"x{j}", None
        for r in range(reps):
            for p in range(len(cfg.pattern)):
                yield "blocks", f"p{p}", r
        for j in range(len(rem)):
            yield "rem", f"r{j}", None

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
        """Zeroed KV cache in the JAX ``init_stack_cache`` layout, on the
        model's device."""
        cfg = self.cfg
        reps, rem = cfg.scan_split()
        cache: dict = {"blocks": {}, "rem": {}, "pre": {}}
        for j in range(len(cfg.prefix)):
            cache["pre"][f"x{j}"] = init_gqa_cache(cfg, batch, max_len, dtype, self.device)
        if reps:
            for p in range(len(cfg.pattern)):
                one = init_gqa_cache(cfg, batch, max_len, dtype, self.device)
                cache["blocks"][f"p{p}"] = {
                    k: v.expand((reps,) + v.shape).clone() for k, v in one.items()}
        for j in range(len(rem)):
            cache["rem"][f"r{j}"] = init_gqa_cache(cfg, batch, max_len, dtype, self.device)
        return cache

    @staticmethod
    def layer_cache(cache: dict, slot) -> dict:
        """The ``{"k", "v", "pos"}`` views of one layer's cache."""
        group, name, idx = slot
        leaves = cache[group][name]
        return leaves if idx is None else {k: v[idx] for k, v in leaves.items()}

    def _forward_cached(self, tokens, cache, offset, global_window):
        b, s = tokens.shape
        x = self.embed(tokens)
        # offset added as it comes (an int: no copy to the card)
        q_pos = (torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
                 + offset).expand(b, s)
        rope = rope_context(self.cfg, q_pos)
        new: dict = {"blocks": {}, "rem": {}, "pre": {}}
        cursors: dict = {}
        for block, slot in zip(self.blocks, self.layer_slots()):
            x, lc = block.forward_cached(x, self.layer_cache(cache, slot), rope=rope,
                                         q_pos=q_pos, global_window=global_window)
            group, name, idx = slot
            if idx is None:
                new[group][name] = lc
            else:
                cursors.setdefault(name, []).append(lc["pos"])
        for name, pos in cursors.items():
            leaves = cache["blocks"][name]
            new["blocks"][name] = {"k": leaves["k"], "v": leaves["v"], "pos": torch.stack(pos)}
        return x, new

    def prefill(self, batch: dict, cache: dict, *,
                global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """``batch["tokens"]`` (B, P) at positions 0..P-1 -> (logits of the
        last position (B, 1, V), new cache). Writes the cache buffers in
        place (the JAX engine donates them)."""
        x, cache = self._forward_cached(batch["tokens"], cache, 0, global_window)
        return self._head(x[:, -1:]), cache

    def decode_step(self, tokens: torch.Tensor, cache: dict, pos, *,
                    global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """tokens (B, 1) at position ``pos`` (the current length) ->
        (logits (B, 1, V), new cache); cache buffers written in place."""
        x, cache = self._forward_cached(tokens, cache, pos, global_window)
        return self._head(x), cache


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The kind of every layer in stack order: the prefix, ``reps`` repeats
    of the pattern, the remainder (JAX ``apply_stack``)."""
    reps, rem = cfg.scan_split()
    return tuple(cfg.prefix) + tuple(cfg.pattern) * reps + tuple(rem)


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> Model:
    return Model(cfg, device=device, seed=seed)
