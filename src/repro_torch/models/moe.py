"""Mixture-of-Experts FFN of the torch backbone (port of the JAX package's
``models/moe.py``: ``init_moe``, ``_capacity``, ``moe_ffn``,
``moe_ffn_dropless``) and the dispatch rule of its ``transformer.py``
(``_moe_dispatch``).

Routing (both paths): float32 router logits, softmax, the top ``k``
experts a token (ties to the lower expert index, as ``jax.lax.top_k``:
a stable descending sort), their weights renormalised with a ``1e-9``
floor.

``moe_ffn`` (the capacity path: training, the DFM denoiser, prefills of
more than ``DROPLESS_MAX_TOKENS`` tokens) sorts the ``T·k`` (token,
expert) slots by expert, stably, and gives each its position within its
expert; the slots at positions ``>= capacity`` are dropped. The kept
tokens are copied into an ``(E, C, d)`` buffer, the three expert products
are batched GEMMs over it, and each token sums its ``k`` weighted slots
in slot order (a dropped slot adds 0). JAX scatter-adds into the buffer
at ``safe_pos``, every dropped slot adding 0 at its expert's last row;
here a dropped slot's copy goes to one spare row past the buffer, which
leaves the same values. It returns the Switch auxiliary loss ``E · Σ_e
f_e p_e`` (``f_e`` the share of slots routed to ``e``, ``p_e`` its mean
router probability).

``moe_ffn_dropless`` (serving with a cache, at most
``DROPLESS_MAX_TOKENS`` tokens: each token depends on itself only) gathers
each slot's expert weights and applies them to its token, as JAX's
``jnp.take`` of ``(T, k, d, ff)`` weights does, in chunks of tokens whose
gathered weights stay within ``DROPLESS_GATHER_BYTES`` a matrix (arctic's
128-token prefill would gather 35.7 GB a matrix at once). A token's
result does not depend on the chunking. Its auxiliary loss is 0, as in
JAX.

Neither path reads the card from the host (no ``nonzero``, boolean
indexing or ``bincount``), so both run inside CUDA graphs: the capacity
path in the refine's, the dropless path in the AR decode's. Both sum a
token's slots in a fixed order, so a replay equals its eager launches.

``cfg.moe.capacity_sharding`` places the buffer's capacity axis on a
mesh in JAX; on one device it changes nothing, here too.
``dispatch_impl="shardmap"`` (JAX's expert-parallel all-to-all) is not
ported (the sharding queue's item).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import MLP, activation, normal_init

# the dropless path serves at most this many tokens a call (JAX transformer.py)
DROPLESS_MAX_TOKENS = 1024
# the dropless path's gathered weights a matrix, at most (one token's k slots
# at least): 25 slots of arctic-480b's 7168 x 4864 float32 experts
DROPLESS_GATHER_BYTES = 3.5e9


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert takes: ``ceil(T·k / E · capacity_factor)``, at
    least 8, rounded up to a multiple of 8 (JAX ``_capacity``)."""
    m = cfg.moe
    c = int(math.ceil(tokens * m.num_experts_per_tok / m.num_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def check_dispatch(cfg: ModelConfig) -> None:
    """Raise for the dispatch the port does not run."""
    if cfg.moe.dispatch_impl == "shardmap":
        raise NotImplementedError(
            f"{cfg.name}: moe.dispatch_impl='shardmap' (the expert-parallel all-to-all of "
            f"models/moe_shardmap.py) is not ported to repro_torch yet: it comes with "
            f"sharding (ROADMAP queue 1, item 7)")


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """(probs (T, E), weights (T, k), experts (T, k) int64) of tokens ``xt``
    (T, d): softmax of the float32 logits, the ``k`` largest (ties to the
    lower index), renormalised."""
    probs = torch.softmax(torch.matmul(xt.float(), router), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = top_w[:, :k], top_i[:, :k]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, gate_i


def aux_loss(probs: torch.Tensor, gate_i: torch.Tensor) -> torch.Tensor:
    """Switch load balance: ``E · Σ_e mean_t(probs) · (slots routed to e) / (T·k)``."""
    e, k = probs.shape[-1], gate_i.shape[-1]
    experts = torch.arange(e, device=probs.device)
    one_hot = (gate_i[:, :, None] == experts).float()                # (T, k, E)
    ce = torch.mean(torch.sum(one_hot, dim=1), dim=0) / k
    return e * torch.sum(torch.mean(probs, dim=0) * ce)


def dispatch_slots(gate_i: torch.Tensor, num_experts: int, cap: int):
    """(row, keep), both (T, k): each (token, slot)'s row in the flattened
    ``(E · C + 1, d)`` buffer, ``e · C + pos`` with ``pos`` its position
    within expert ``e`` after a stable sort of the slots by expert (JAX's
    ``argsort``, ``bincount``, ``cumsum``), and ``pos < C``; a dropped
    slot's row is the spare ``E · C``."""
    t, k = gate_i.shape
    flat_e = gate_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(num_experts, dtype=torch.int64, device=gate_i.device)
    counts.scatter_add_(0, se, torch.ones_like(se))                  # integer: exact
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=gate_i.device) - starts[se]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted                                          # back to slot order
    keep = pos < cap
    row = torch.where(keep, flat_e * cap + pos, num_experts * cap)
    return row.view(t, k), keep.view(t, k)


def _sum_slots(contrib: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): a token's k slots added in slot order."""
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


class MoE(nn.Module):
    """A layer's experts (JAX ``init_moe``): ``router`` (d, E) float32,
    ``up``/``gate`` (E, d, ff), ``down`` (E, ff, d); ``shared`` (an MLP of
    width ``ff · num_shared_experts``) and ``residual`` (an MLP of width
    ``cfg.d_ff``) where the config has them."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        m = cfg.moe
        d, ff, e = cfg.d_model, m.d_ff, m.num_experts
        self.cfg = cfg
        self.act = cfg.act
        self.router = nn.Parameter(normal_init(gen, (d, e), 0.02, device))
        self.up = nn.Parameter(normal_init(gen, (e, d, ff), 1.0 / math.sqrt(d), device))
        self.gate = nn.Parameter(normal_init(gen, (e, d, ff), 1.0 / math.sqrt(d), device))
        self.down = nn.Parameter(normal_init(
            gen, (e, ff, d), 0.02 / math.sqrt(2 * cfg.num_layers), device))
        self.shared = (MLP(cfg, gen, device, d_ff=ff * m.num_shared_experts)
                       if m.num_shared_experts else None)
        self.residual = MLP(cfg, gen, device) if m.dense_residual else None

    def _dense_branches(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.shared is not None:
            y = y + self.shared(x)
        if self.residual is not None:
            y = y + self.residual(x)
        return y

    def forward(self, x: torch.Tensor, *, cached: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX ``_moe_dispatch``: the dropless path for a call with a cache
        (``cached``) over at most ``DROPLESS_MAX_TOKENS`` tokens, else the
        capacity path. Returns (y (B, S, d), the auxiliary loss)."""
        b, s, _ = x.shape
        if cached and b * s <= DROPLESS_MAX_TOKENS:
            return self.dropless(x)
        return self.capacity_ffn(x)

    def capacity_ffn(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX ``moe_ffn``: (y (B, S, d), aux ())."""
        check_dispatch(self.cfg)
        b, s, d = x.shape
        t, e = b * s, self.cfg.moe.num_experts
        xt = x.reshape(t, d)
        probs, gate_w, gate_i = route(xt, self.router, self.cfg.moe.num_experts_per_tok)
        aux = aux_loss(probs, gate_i)
        cap = capacity(t, self.cfg)
        row, keep = dispatch_slots(gate_i, e, cap)
        k = gate_i.shape[1]
        buf = x.new_zeros((e * cap + 1, d))
        buf = buf.index_copy(0, row.reshape(-1), xt.repeat_interleave(k, dim=0))
        buf = buf[:e * cap].view(e, cap, d)
        up = torch.bmm(buf, self.up)
        gate = torch.bmm(buf, self.gate)
        out_buf = torch.bmm(activation(self.act, gate) * up, self.down)
        gathered = out_buf.reshape(e * cap, d)[row.clamp_max(e * cap - 1)]      # (T, k, d)
        contrib = torch.where(keep[..., None], gathered * gate_w[..., None], 0.0)
        return self._dense_branches(x, _sum_slots(contrib).view(b, s, d)), aux

    def dropless(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX ``moe_ffn_dropless``: (y (B, S, d), aux 0), in chunks of
        tokens whose gathered weights fit ``DROPLESS_GATHER_BYTES`` a matrix."""
        b, s, d = x.shape
        t, k = b * s, self.cfg.moe.num_experts_per_tok
        xt = x.reshape(t, d)
        _, gate_w, gate_i = route(xt, self.router, k)
        per_token = k * self.up.shape[1] * self.up.shape[2] * self.up.element_size()
        chunk = max(1, int(DROPLESS_GATHER_BYTES // per_token))
        ys = [self._dropless_chunk(xt[i:i + chunk], gate_w[i:i + chunk], gate_i[i:i + chunk])
              for i in range(0, t, chunk)]
        y = ys[0] if len(ys) == 1 else torch.cat(ys)
        return self._dense_branches(x, y.view(b, s, d)), x.new_zeros((), dtype=torch.float32)

    def _dropless_chunk(self, xt, gate_w, gate_i):
        """The routed experts of ``c`` tokens, one (1, d) x (d, ff) product
        a slot on its gathered weights."""
        c, d = xt.shape
        k = gate_i.shape[1]
        idx = gate_i.reshape(-1)
        xs = xt.repeat_interleave(k, dim=0)[:, None, :]                         # (c·k, 1, d)
        up = torch.bmm(xs, torch.index_select(self.up, 0, idx))
        gate = torch.bmm(xs, torch.index_select(self.gate, 0, idx))
        h = activation(self.act, gate) * up
        out = torch.bmm(h, torch.index_select(self.down, 0, idx))               # (c·k, 1, d)
        return _sum_slots(out.view(c, k, d) * gate_w[..., None])
