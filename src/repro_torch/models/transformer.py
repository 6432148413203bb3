"""Blocks of the torch backbone (port of the JAX package's
``models/transformer.py::apply_block`` for the ``attn``, ``local``,
``moe``, ``moe_res``, ``mla``, ``mla_moe``, ``mamba``, ``mlstm``, ``slstm``
and ``zshared`` kinds):

    attn/local:  x = x + post_attn(attn(ln1(x)));  x = x + post_ffn(mlp(ln2(x)))
    moe/moe_res:  x = x + attn(ln1(x));  x = x + moe(ln2(x))
    mla:  x = x + mla(ln1(x));  x = x + mlp(ln2(x))
    mla_moe:  x = x + mla(ln1(x));  x = x + moe(ln2(x))
    mamba/mlstm/slstm:  x = x + mixer(ln1(x))
    zshared:  h = fuse([x, x0]);  x = x + attn(ln1'(h));  x = x + mlp(ln2'(x))

``post_attn``/``post_ffn`` exist only with ``cfg.post_norms`` (Gemma3). A
``local`` block attends within ``cfg.sliding_window`` on the local RoPE
angles; an ``attn`` block within ``global_window`` (None: everywhere) on
the global ones. The recurrent kinds (``models/ssm.py``,
``models/xlstm.py``) are causal whatever the mode. ``zshared`` is Zamba2's
shared block: each such layer owns only its ``fuse`` projection of
``[x, x0]`` (``x0`` the embedded input after the time embedding) and runs
the model's one :class:`SharedBlock` (``ln1'``, attention, ``ln2'``,
MLP), with the global attention arguments. Like JAX's ``init_block``,
every layer has an ``ln1``, which a ``zshared`` layer never reads; it is
kept so the weights convert both ways. A ``moe``/``moe_res`` block's FFN
is ``models/moe.py``'s :class:`MoE` (the two kinds differ only by the
config: ``moe_res`` is Arctic's, with ``dense_residual``); without a
cache it takes the capacity path, with one JAX's ``_moe_dispatch`` rule.
``mla``/``mla_moe`` (DeepSeek-V3's dense prefix layers and its MoE layers,
with the shared expert) run ``models/attention.py``'s :class:`MLAttention`
on the ``"mla"`` angles of the rope context (``qk_rope_head_dim``, from
the query positions) within ``global_window``; ``mla_moe``'s FFN is the
same :class:`MoE` under the same dispatch rule.

A VLM batch's position ids reach a GQA attention as the rope context's
``"q_pos"`` (their temporal stream), which its masks compare (see
``models/attention.py``).

A block returns ``(x, aux)``: ``aux`` its MoE's auxiliary loss (None for
the kinds without an MoE), which the model sums over the layers as JAX's
``apply_stack`` does.

The JAX package stacks the layers' weights and scans over them; here the
stack is a list of per-layer modules (see ``Model``). Its caches keep the
JAX layout (``init_stack_cache``), which ``Model`` builds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQAAttention, MLAttention
from repro_torch.models.common import MLP, Dense, make_norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2
from repro_torch.models.xlstm import MLSTM, SLSTM

# the kinds a Block runs
KINDS = ("attn", "local", "moe", "moe_res", "mla", "mla_moe", "mamba", "mlstm", "slstm",
         "zshared")
MLA_KINDS = ("mla", "mla_moe")
MOE_KINDS = ("moe", "moe_res", "mla_moe")
# the kinds whose attention runs flash_attn once a forward without a cache: GQA
# (a k/v cache) or MLA (a latent cache)
GQA_KINDS = ("attn", "local", "zshared", "moe", "moe_res")
ATTN_KINDS = GQA_KINDS + MLA_KINDS
RECURRENT = {"mamba": Mamba2, "mlstm": MLSTM, "slstm": SLSTM}


class SharedBlock(nn.Module):
    """Zamba2's attention + MLP, shared by every ``zshared`` layer (JAX
    ``init_shared``: ``stack|zshared|{ln1, attn, ln2, mlp}``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = make_norm(cfg, device)
        self.attn = GQAAttention(cfg, gen, device)
        self.ln2 = make_norm(cfg, device)
        self.mlp = MLP(cfg, gen, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device, kind: str = "attn"):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.kind = kind
        self.window = cfg.sliding_window if kind == "local" else None
        self.ln1 = make_norm(cfg, device)
        if kind in MLA_KINDS:
            self.attn = MLAttention(cfg, gen, device)
            self.ln2 = make_norm(cfg, device)
            if kind == "mla":
                self.mlp = MLP(cfg, gen, device)
                self.post_attn = self.post_ffn = None
            else:
                self.moe = MoE(cfg, gen, device)
        elif kind in ("attn", "local"):
            self.attn = GQAAttention(cfg, gen, device)
            self.ln2 = make_norm(cfg, device)
            self.mlp = MLP(cfg, gen, device)
            self.post_attn = make_norm(cfg, device) if cfg.post_norms else None
            self.post_ffn = make_norm(cfg, device) if cfg.post_norms else None
        elif kind in MOE_KINDS:
            self.attn = GQAAttention(cfg, gen, device)
            self.ln2 = make_norm(cfg, device)
            self.moe = MoE(cfg, gen, device)
        elif kind == "zshared":
            self.fuse = Dense(2 * cfg.d_model, cfg.d_model, gen, device)
        else:
            setattr(self, kind, RECURRENT[kind](cfg, gen, device))

    def _attn_args(self, rope: dict, global_window: Optional[int]):
        """(sin, cos, window) of this block (JAX ``apply_block``'s ``attn_args``;
        MLA rotates at its own width)."""
        if self.kind == "local":
            return (*rope["local"], self.window)
        if self.kind in MLA_KINDS:
            return (*rope["mla"], global_window)
        return (*rope["global"], global_window)

    def _finish(self, x: torch.Tensor, h: torch.Tensor, cached: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.kind in MOE_KINDS:
            x = x + h
            h, aux = self.moe(self.ln2(x), cached=cached)
            return x + h, aux
        if self.post_attn is not None:
            h = self.post_attn(h)
        x = x + h
        h = self.mlp(self.ln2(x))
        if self.post_ffn is not None:
            h = self.post_ffn(h)
        return x + h, None

    def forward(self, x: torch.Tensor, *, rope: dict, mode: str,
                global_window: Optional[int] = None, x0: Optional[torch.Tensor] = None,
                shared: Optional[SharedBlock] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x, aux) of the block over the whole sequence, without a cache."""
        if self.kind in RECURRENT:
            return x + getattr(self, self.kind)(self.ln1(x))[0], None
        sin, cos, window = self._attn_args(rope, global_window)
        if self.kind == "zshared":
            h = self.fuse(torch.cat([x, x0], dim=-1))
            x = x + shared.attn(shared.ln1(h), sin=sin, cos=cos, mode=mode, window=window,
                                q_pos=rope.get("q_pos"))
            return x + shared.mlp(shared.ln2(x)), None
        kw = {} if self.kind in MLA_KINDS else {"q_pos": rope.get("q_pos")}
        return self._finish(x, self.attn(self.ln1(x), sin=sin, cos=cos, mode=mode,
                                         window=window, **kw), cached=False)

    def forward_cached(self, x: torch.Tensor, cache: dict, *, rope: dict, q_pos: torch.Tensor,
                       global_window: Optional[int] = None, x0: Optional[torch.Tensor] = None,
                       shared: Optional[SharedBlock] = None, mla_absorb: bool = False
                       ) -> Tuple[torch.Tensor, dict]:
        """The block over a chunk at positions ``q_pos`` with its cache: KV
        and latent buffers are written in place, a recurrent state comes
        back as new tensors (the one given is not written). ``mla_absorb``
        (``cfg.mla_absorb``) takes MLA's absorbed decode. JAX's serving
        entry points drop the auxiliary loss; so does this."""
        if self.kind in RECURRENT:
            h, cache = getattr(self, self.kind)(self.ln1(x), cache)
            return x + h, cache
        sin, cos, window = self._attn_args(rope, global_window)
        if self.kind == "zshared":
            h = self.fuse(torch.cat([x, x0], dim=-1))
            h, cache = shared.attn.forward_cached(shared.ln1(h), cache, sin=sin, cos=cos,
                                                  q_pos=q_pos, window=window)
            x = x + h
            return x + shared.mlp(shared.ln2(x)), cache
        kw = {"absorb": mla_absorb} if self.kind in MLA_KINDS else {}
        h, cache = self.attn.forward_cached(self.ln1(x), cache, sin=sin, cos=cos,
                                            q_pos=q_pos, window=window, **kw)
        return self._finish(x, h, cached=True)[0], cache
