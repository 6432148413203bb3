"""The torch backbone: embeddings + time conditioning + the block stack +
head (port of the JAX package's ``models/model.py`` for the dense attention
configs, the DiT and the dense zoo with Gemma3's local/global layers, dual
RoPE, qk-norm, post-norms and scaled embeddings, for the recurrent
family: Mamba2 and Zamba2's shared attention, mLSTM and sLSTM, for the
MoE family: the ``moe``/``moe_res`` layers of ``models/moe.py``, and for
DeepSeek-V3's MLA: the ``mla``/``mla_moe`` layers, dense prefix layers
ahead of the MoE pattern, the shared expert, and for Qwen2-VL: M-RoPE and
the patch prefix), in
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
kind's: ``{"k", "v", "pos"}`` for the GQA kinds (``zshared``
included), ``{"c_kv", "k_pe", "pos"}`` for ``mla``/``mla_moe`` (the latent
and the shared rotary key a token), ``{"conv", "ssm", "pos"}`` for
``mamba``, ``{"conv", "c", "n", "m", "pos"}`` for ``mlstm``, ``{"c", "n",
"m", "hid", "pos"}`` for ``slstm``. KV and latent buffers are written in
place; every other leaf of the cache a step returns is a new tensor.
``cfg.mla_absorb`` takes MLA's absorbed decode in ``prefill`` and
``decode_step``.

A VLM config (``family="vlm"``, Qwen2-VL) holds ``patch_proj``, a
``Dense(VISION_DIM, d_model)``. Its batches may carry ``patches`` (B, P,
1280), the ViT's outputs (a stub: given inputs, as in JAX), projected and
put **before** the token embeddings (the time embedding is then added at
every position, patches included), and ``positions`` (3, B, P + S), the
M-RoPE ids (``models/rope.py``); ``forward`` and ``prefill`` take both,
``decode_step`` takes them as ``batch_extras``, ``dfm_apply`` as
``extras``. As in JAX, ``patches`` count only for a VLM config and
``positions`` only under ``rope_type="mrope"``; without ``positions`` an
mrope config rotates by standard RoPE at the token indices.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_gqa_cache, init_mla_cache
from repro_torch.models.common import Dense, Embedding, TimeEmbed, make_norm
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.moe import check_dispatch
from repro_torch.models.rope import rope_context
from repro_torch.models.ssm import init_mamba2_cache
from repro_torch.models.transformer import (
    GQA_KINDS, KINDS, MLA_KINDS, MOE_KINDS, Block, SharedBlock,
)
from repro_torch.models.xlstm import init_mlstm_cache, init_slstm_cache

# the cache leaves written in place (the KV and latent buffers); the others are replaced
IN_PLACE_LEAVES = ("k", "v", "c_kv", "k_pe")
VISION_DIM = 1280           # Qwen2-VL's ViT output width (the stub frontend's patches)
BATCH_EXTRAS = ("patches", "positions")     # what a decoder-only batch may add to tokens


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    """One layer's zeroed cache (JAX ``init_block_cache``)."""
    if kind in MLA_KINDS:
        return init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind in GQA_KINDS:
        return init_gqa_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return init_mamba2_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a config this port runs: the dense, ssm,
    hybrid, MoE or VLM family with ``attn``, ``local``, ``moe``, ``moe_res``,
    ``mla``, ``mla_moe``, ``mamba``, ``mlstm``, ``slstm`` and ``zshared``
    layers, layernorm or rmsnorm, standard, dual, M-RoPE (its sections
    summing to ``head_dim / 2``) or no RoPE, qk-norm,
    post-norms and scaled embeddings allowed, float32. The MoE family and
    its kinds (``mla_moe`` included) need ``cfg.moe.num_experts > 0``; the
    MLA kinds need ``cfg.mla``; neither takes post-norms, for which JAX's
    MoE and MLA blocks hold no weights. The MoE ``shardmap`` dispatch,
    encoder-decoder configs, the logit softcap and other dtypes raise (an
    encoder-decoder config is ``EncDecModel``'s)."""
    unsupported = []
    kinds = set(cfg.prefix + cfg.pattern)
    if cfg.is_encoder_decoder or cfg.family not in ("dense", "ssm", "hybrid", "moe", "vlm"):
        unsupported.append(f"family={cfg.family}")
    if not kinds <= set(KINDS):
        unsupported.append(f"layers={cfg.prefix + cfg.pattern}")
    if (cfg.family == "moe" or kinds & set(MOE_KINDS)) and cfg.moe.num_experts <= 0:
        unsupported.append(f"moe.num_experts={cfg.moe.num_experts}")
    elif kinds & set(MOE_KINDS):
        if cfg.post_norms:
            unsupported.append("post_norms with MoE layers")
        check_dispatch(cfg)
    if kinds & set(MLA_KINDS):
        if cfg.mla is None:
            unsupported.append(f"MLA layers {sorted(kinds & set(MLA_KINDS))} without cfg.mla")
        elif cfg.post_norms:
            unsupported.append("post_norms with MLA layers")
    if cfg.norm not in ("layernorm", "rmsnorm"):
        unsupported.append(f"norm={cfg.norm}")
    if cfg.rope_type not in ("default", "none", "dual", "mrope"):
        unsupported.append(f"rope_type={cfg.rope_type}")
    elif cfg.rope_type == "mrope" and sum(cfg.mrope_sections) != cfg.head_dim // 2:
        unsupported.append(f"mrope_sections={cfg.mrope_sections} for head_dim {cfg.head_dim}")
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
        # the VLM's projection of the ViT's patches (JAX ``patch_proj``)
        self.patch_proj = (Dense(VISION_DIM, cfg.d_model, gen, dev) if cfg.family == "vlm"
                           else None)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed_inputs(self, tokens: torch.Tensor, t: Optional[torch.Tensor],
                      patches: Optional[torch.Tensor]) -> torch.Tensor:
        """The embedded tokens, a VLM's projected patches before them, plus
        the time embedding at every position (JAX ``_embed_inputs``)."""
        x = self.embed(tokens)
        if self.patch_proj is not None and patches is not None:
            x = torch.cat([self.patch_proj(patches.to(x.dtype)), x], dim=1)
        if t is not None:
            x = x + self.time(t)[:, None, :]
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.head is None:
            return torch.matmul(x, self.embed.table.T)
        return self.head(x)

    def _layers(self, lo: int, hi: int, x: torch.Tensor, x0: torch.Tensor, rope: dict,
                mode: str, global_window: Optional[int]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x, the layers' summed auxiliary loss, None without MoE layers)."""
        aux = None
        for block in self.blocks[lo:hi]:
            x, a = block(x, rope=rope, mode=mode, global_window=global_window, x0=x0,
                         shared=self.zshared)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def forward(self, tokens: torch.Tensor, t: Optional[torch.Tensor] = None, *,
                patches: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                global_window: Optional[int] = None, remat: bool = False,
                return_aux: bool = False):
        """tokens (B, S) -> logits (B, S, V), or with ``return_aux`` (logits,
        aux), aux the MoE layers' auxiliary losses summed in layer order (a
        float32 zero without MoE layers), as JAX's ``forward`` returns. With
        ``t`` (B,) the model is the DFM denoiser (bidirectional attention,
        time-conditioned; recurrent layers stay causal); without, a causal LM.
        A VLM's ``patches`` (B, P, 1280) make the logits (B, P + S, V), the
        patches' rows first; ``positions`` (3, B, P + S) are its M-RoPE ids
        (a causal forward then masks by their temporal stream, in plain
        torch: ``models/attention.py``).

        ``remat`` checkpoints what JAX's scan checkpoints: each group of
        ``len(cfg.pattern)`` layers (``cfg.scan_split``), its activations
        recomputed in the backward, the group's auxiliary loss with it; the
        prefix and remainder layers are not checkpointed. ``x0`` and the
        shared block's weights enter every group, so their gradients sum
        over all of them. The forward draws nothing from torch's generators
        (threefry keys only), so the checkpoint keeps no RNG state: reading
        it would touch the default generator inside a CUDA graph capture."""
        x, auxes = self._trunk(tokens, t, patches, positions, global_window, remat)
        logits = self._head(x)
        if not return_aux:
            return logits
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for aux in auxes:
            if aux is not None:
                total = total + aux
        return logits, total

    def _trunk(self, tokens, t, patches, positions, global_window, remat
               ) -> Tuple[torch.Tensor, list]:
        """(the final hidden states (B, P + S, D), the auxiliary losses of the
        prefix, each scanned group and the remainder, None where no MoE)."""
        x = self._embed_inputs(tokens, t, patches)
        mode = "bidir" if t is not None else "causal"
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=tokens.device)
        rope = rope_context(self.cfg, pos, mrope_positions=positions)
        ctx = (rope, mode, global_window)
        x0 = x
        npre, p = len(self.cfg.prefix), len(self.cfg.pattern)
        end = npre + self.cfg.scan_split()[0] * p
        x, aux = self._layers(0, npre, x, x0, *ctx)
        auxes = [aux]
        for lo in range(npre, end, p):
            if remat:
                x, aux = checkpoint(self._layers, lo, lo + p, x, x0, *ctx, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = self._layers(lo, lo + p, x, x0, *ctx)
            auxes.append(aux)
        x, aux = self._layers(end, len(self.blocks), x, x0, *ctx)
        return x, auxes + [aux]

    def dfm_apply(self, tokens: torch.Tensor, t: torch.Tensor, *,
                  extras: Optional[dict] = None) -> torch.Tensor:
        """(tokens (B, N), t (B,)) -> logits (B, N, V): the v_theta signature
        the sampler expects. ``extras`` may hold a VLM's ``patches`` and
        ``positions`` (see :meth:`forward`); the patches' rows are dropped,
        as JAX drops their logits. Here the head runs on the text rows only:
        a row's logits are the same function of its hidden state either way,
        and at 8 x (256 + 256) tokens and vocab 152 064 the patch rows' logits
        alone would be 1.25 GB."""
        kw = check_batch_extras(extras)
        x, _ = self._trunk(tokens, t, kw.get("patches"), kw.get("positions"), None, False)
        if self.patch_proj is not None and kw.get("patches") is not None:
            x = x[:, kw["patches"].shape[1]:]
        return self._head(x)

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

    def _forward_cached(self, tokens, cache, offset, global_window, extras=None):
        absorb = self.cfg.mla_absorb
        kw = check_batch_extras(extras)
        x = self._embed_inputs(tokens, None, kw.get("patches"))
        b, s, _ = x.shape
        # offset added as it comes (an int: no copy to the card)
        q_pos = (torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
                 + offset).expand(b, s)
        rope = rope_context(self.cfg, q_pos, mrope_positions=kw.get("positions"))
        # under M-RoPE ids the masks compare their temporal stream with the
        # buffer's indices, as JAX's do (reference fault R10)
        q_pos = rope.get("q_pos", q_pos)
        new: dict = {"blocks": {}, "rem": {}, "pre": {}}
        stacked: dict = {}
        x0 = x
        for block, slot in zip(self.blocks, self.layer_slots()):
            x, lc = block.forward_cached(x, self.layer_cache(cache, slot), rope=rope,
                                         q_pos=q_pos, global_window=global_window, x0=x0,
                                         shared=self.zshared, mla_absorb=absorb)
            group, name, idx = slot
            if idx is None:
                new[group][name] = lc
            else:
                stacked.setdefault(name, []).append(lc)
        for name, lcs in stacked.items():
            # KV and latent buffers were written through their slices; the rest restacks
            leaves = cache["blocks"][name]
            new["blocks"][name] = {
                k: leaves[k] if k in IN_PLACE_LEAVES else torch.stack([lc[k] for lc in lcs])
                for k in leaves}
        return x, new

    def prefill(self, batch: dict, cache: dict, *,
                global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """``batch["tokens"]`` (B, P) at positions 0..P-1 -> (logits of the
        last position (B, 1, V), new cache). Writes the cache buffers in
        place (the JAX engine donates them). A VLM batch's ``patches`` go
        into the cache ahead of the tokens; its ``positions`` rotate by
        M-RoPE, and the causal mask then compares their temporal ids with
        the buffer's indices, as JAX's does (reference fault R10:
        ``ROADMAP.md``)."""
        extras = {k: batch[k] for k in BATCH_EXTRAS if k in batch}
        x, cache = self._forward_cached(batch["tokens"], cache, 0, global_window, extras)
        return self._head(x[:, -1:]), cache

    def decode_step(self, tokens: torch.Tensor, cache: dict, pos, *,
                    batch_extras: Optional[dict] = None,
                    global_window: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        """tokens (B, 1) at position ``pos`` (the current length) ->
        (logits (B, 1, V), new cache); cache buffers written in place. With
        ``batch_extras`` ``{"positions": (3, B, 1)}`` an mrope config rotates
        by those ids (and masks by their temporal one); without, by standard
        RoPE at ``pos``: the text-only fallback, as JAX's ``decode_step``."""
        x, cache = self._forward_cached(tokens, cache, pos, global_window, batch_extras)
        return self._head(x), cache


def check_batch_extras(extras: Optional[dict]) -> dict:
    """``extras`` as a dict, checked against BATCH_EXTRAS: a decoder-only
    model takes no other input than its tokens and these (an
    encoder-decoder's ``frames`` raise, by name)."""
    extras = dict(extras or {})
    if set(extras) - set(BATCH_EXTRAS):
        raise NotImplementedError(
            f"batch extras {sorted(set(extras) - set(BATCH_EXTRAS))} are not ported for a "
            f"decoder-only model: it takes only {list(BATCH_EXTRAS)}")
    return extras


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
