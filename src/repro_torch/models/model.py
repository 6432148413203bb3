"""The torch backbone: embeddings + time conditioning + the block stack +
head (port of the JAX package's ``models/model.py`` for the dense attention
configs, the DiT and the dense zoo with Gemma3's local/global layers, dual
RoPE, qk-norm, post-norms and scaled embeddings, and for the recurrent
family: Mamba2 and Zamba2's shared attention, mLSTM and sLSTM), in
DFM-denoiser and causal modes, with the AR serving entry points
``init_cache``, ``prefill`` and ``decode_step``.

``Model(cfg, device="cuda", seed=0)`` holds its weights as an
``nn.Module`` built from a seeded ``torch.Generator`` on ``device``; a JAX
checkpoint loads with ``model.load_state_dict(jax_params_to_torch(flat))``
(``repro_torch.convert``). A config with ``zshared`` layers holds the
shared block once, as ``Model.zshared``.

The layers run in JAX's stack order (``transformer.apply_stack``): the
``prefix`` layers, ``reps`` repeats of ``pattern``, then the remainder
``pattern[:rem]``. The cache keeps the JAX tree
(``transformer.init_stack_cache``): ``{"pre": {"x{j}": ...}, "blocks":
{"p{p}": leaves}, "rem": {"r{j}": ...}}``: prefix layer ``j`` is
``pre/x{j}``, layer ``npre + r * P + p`` is slice ``r`` of ``blocks/p{p}``
(every leaf with a leading ``(reps,)``), remainder layer ``j`` is
``rem/r{j}`` (unstacked, ``pos`` a scalar). A layer's leaves are its
kind's: ``{"k", "v", "pos"}`` for the attention kinds (``zshared``
included), ``{"conv", "ssm", "pos"}`` for ``mamba``, ``{"conv", "c", "n",
"m", "pos"}`` for ``mlstm``, ``{"c", "n", "m", "hid", "pos"}`` for
``slstm``. KV buffers are written in place; every other leaf of the cache
a step returns is a new tensor.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_gqa_cache
from repro_torch.models.common import Dense, Embedding, TimeEmbed, make_norm
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.rope import rope_context
from repro_torch.models.ssm import init_mamba2_cache
from repro_torch.models.transformer import ATTN_KINDS, KINDS, Block, SharedBlock
from repro_torch.models.xlstm import init_mlstm_cache, init_slstm_cache

# the cache leaves written in place (the KV buffers); the others are replaced
IN_PLACE_LEAVES = ("k", "v")


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    """One layer's zeroed cache (JAX ``init_block_cache``)."""
    if kind in ATTN_KINDS:
        return init_gqa_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return init_mamba2_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a config this port runs: the dense, ssm or
    hybrid family with ``attn``, ``local``, ``mamba``, ``mlstm``, ``slstm``
    and ``zshared`` layers, layernorm or rmsnorm, standard, dual or no
    RoPE, qk-norm, post-norms and scaled embeddings allowed, float32. MoE,
    MLA, encoder-decoder and VLM configs, the logit softcap and other
    dtypes raise (an encoder-decoder config is ``EncDecModel``'s)."""
    unsupported = []
    if cfg.is_encoder_decoder or cfg.family not in ("dense", "ssm", "hybrid"):
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
        # Zamba2's shared attention + MLP, held once (JAX ``stack|zshared``)
        self.zshared = SharedBlock(cfg, gen, dev) if "zshared" in cfg.pattern else None
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

    def _layers(self, lo: int, hi: int, x: torch.Tensor, x0: torch.Tensor, rope: dict,
                mode: str, global_window: Optional[int]) -> torch.Tensor:
        for block in self.blocks[lo:hi]:
            x = block(x, rope=rope, mode=mode, global_window=global_window, x0=x0,
                      shared=self.zshared)
        return x

    def forward(self, tokens: torch.Tensor, t: Optional[torch.Tensor] = None, *,
                global_window: Optional[int] = None, remat: bool = False) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V). With ``t`` (B,) the model is
        the DFM denoiser (bidirectional attention, time-conditioned;
        recurrent layers stay causal); without, a causal LM.

        ``remat`` checkpoints what JAX's scan checkpoints: each group of
        ``len(cfg.pattern)`` layers (``cfg.scan_split``), its activations
        recomputed in the backward; the prefix and remainder layers are
        not checkpointed. ``x0`` and the shared block's weights enter
        every group, so their gradients sum over all of them."""
        x = self.embed(tokens)
        if t is not None:
            x = x + self.time(t)[:, None, :]
        mode = "bidir" if t is not None else "causal"
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        rope = rope_context(self.cfg, pos)
        ctx = (rope, mode, global_window)
        x0 = x
        npre, p = len(self.cfg.prefix), len(self.cfg.pattern)
        end = npre + self.cfg.scan_split()[0] * p
        x = self._layers(0, npre, x, x0, *ctx)
        for lo in range(npre, end, p):
            if remat:
                x = checkpoint(self._layers, lo, lo + p, x, x0, *ctx, use_reentrant=False)
            else:
                x = self._layers(lo, lo + p, x, x0, *ctx)
        x = self._layers(end, len(self.blocks), x, x0, *ctx)
        return self._head(x)

    def dfm_apply(self, tokens: torch.Tensor, t: torch.Tensor, *,
                  extras: Optional[dict] = None) -> torch.Tensor:
        """(tokens (B, N), t (B,)) -> logits: the v_theta signature the
        sampler expects. A decoder-only config takes no batch extras."""
        if extras:
            raise NotImplementedError(f"{self.cfg.name}: batch extras {sorted(extras)} are "
                                      f"not ported for decoder-only configs")
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
        """Zeroed cache in the JAX ``init_stack_cache`` layout, on the
        model's device (recurrent states float32 where JAX keeps them so)."""
        cfg = self.cfg
        reps, rem = cfg.scan_split()
        cache: dict = {"blocks": {}, "rem": {}, "pre": {}}

        def one(kind):
            return init_block_cache(cfg, kind, batch, max_len, dtype, self.device)

        for j, kind in enumerate(cfg.prefix):
            cache["pre"][f"x{j}"] = one(kind)
        if reps:
            for p, kind in enumerate(cfg.pattern):
                cache["blocks"][f"p{p}"] = {
                    k: v.expand((reps,) + v.shape).clone() for k, v in one(kind).items()}
        for j, kind in enumerate(rem):
            cache["rem"][f"r{j}"] = one(kind)
        return cache

    @staticmethod
    def layer_cache(cache: dict, slot) -> dict:
        """The views of one layer's cache leaves."""
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
        stacked: dict = {}
        x0 = x
        for block, slot in zip(self.blocks, self.layer_slots()):
            x, lc = block.forward_cached(x, self.layer_cache(cache, slot), rope=rope,
                                         q_pos=q_pos, global_window=global_window, x0=x0,
                                         shared=self.zshared)
            group, name, idx = slot
            if idx is None:
                new[group][name] = lc
            else:
                stacked.setdefault(name, []).append(lc)
        for name, lcs in stacked.items():
            # KV buffers were written through their slices; the rest restacks
            leaves = cache["blocks"][name]
            new["blocks"][name] = {
                k: leaves[k] if k in IN_PLACE_LEAVES else torch.stack([lc[k] for lc in lcs])
                for k in leaves}
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


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0):
    """``EncDecModel`` for an encoder-decoder config, else ``Model``."""
    if cfg.is_encoder_decoder:
        return EncDecModel(cfg, device=device, seed=seed)
    return Model(cfg, device=device, seed=seed)
