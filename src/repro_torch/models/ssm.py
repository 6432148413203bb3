"""Mamba2 (SSD) block of the torch backbone (port of the JAX package's
``models/ssm.py``; arXiv:2405.21060, as used by Zamba2, arXiv:2411.15242):
chunkwise-parallel prefill and training form, O(1)-state decode.

The chunkwise algorithm is the JAX package's, step for step: within a
chunk, decay-masked products (``einsum``, plain float32 matrix products);
across chunks, the state recurrence as a Python loop over the chunks (JAX
scans it), which reads nothing on the host, so a CUDA graph holds it.
Shapes are padded to a multiple of the chunk with ``a = 1``.

Shapes: d_inner = expand * d_model; heads H = d_inner / P (P = head_dim);
state N per head. One B/C group (G = 1). The cache is JAX's
``init_mamba2_cache`` tree: ``{"conv": (B, cw - 1, d_inner + 2N), "ssm":
(B, H, N, P), "pos": () int32}``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Dense, RMSNorm, normal_init


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    return d_inner, heads, s.head_dim, s.state_dim, s.conv_width


def softplus(x: torch.Tensor, zero: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``zero``: a 0-d zero to
    reuse, which a loop makes once)."""
    return torch.logaddexp(x, x.new_zeros(()) if zero is None else zero)


class Mamba2(nn.Module):
    """The leaves of JAX's ``init_mamba2``: ``in_proj`` -> [z (d_inner), xBC
    (d_inner + 2N conv channels), dt (H)], the causal depthwise ``conv_w``
    (cw, channels) and ``conv_b``, ``a_log = log(1..H)``, ``dt_bias = 0``,
    ``d_skip = 1``, the gated ``out_norm`` and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, h, _, n, cw = _dims(cfg)
        conv_ch = d_inner + 2 * n
        self.in_proj = Dense(d, 2 * d_inner + 2 * n + h, gen, device)
        self.conv_w = nn.Parameter(normal_init(gen, (cw, conv_ch), 0.1, device))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, device=device))
        self.a_log = nn.Parameter(torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                                         device=device)))
        self.dt_bias = nn.Parameter(torch.zeros(h, device=device))
        self.d_skip = nn.Parameter(torch.ones(h, device=device))
        self.out_norm = RMSNorm(d_inner, cfg.norm_eps, device)
        self.out_proj = Dense(d_inner, d, gen, device,
                              stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        return mamba2_forward(self, x, self.cfg, cache=cache)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, h, p_dim, n, _ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _conv1d(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv. xbc (B, T, C); state (B, cw - 1, C) carries
    the context. Returns (silu(y) (B, T, C), new state): the last cw - 1
    rows of [state, xbc], a new tensor (the state passed in is not written)."""
    cw = w.shape[0]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], cw - 1, xbc.shape[-1]))
    full = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    new_state = full[:, -(cw - 1):, :] if cw > 1 else state
    t = xbc.shape[1]
    y = full[:, 0:t, :] * w[0][None, None].to(xbc.dtype)
    for i in range(1, cw):
        y = y + full[:, i:i + t, :] * w[i][None, None].to(xbc.dtype)
    return F.silu(y + b.to(xbc.dtype)), new_state


def ssd_chunked(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise SSD scan.

    Args:
      xh: (B, T, H, P) inputs already scaled by dt.
      a:  (B, T, H) per-step decay in (0, 1]: exp(dt * A) with A < 0.
      bmat, cmat: (B, T, N) input/output projections (G = 1, broadcast to heads).
      chunk: chunk length (T must be a multiple; the caller pads).
    Returns: y (B, T, H, P), final state (B, H, N, P).
    """
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    nc = t // chunk
    xh = xh.reshape(b, nc, chunk, h, p)
    a = a.reshape(b, nc, chunk, h)
    bm = bmat.reshape(b, nc, chunk, n)
    cm = cmat.reshape(b, nc, chunk, n)

    la = torch.cumsum(torch.log(torch.clamp_min(a, 1e-20)), dim=2)   # (B, nc, Q, H)
    la_last = la[:, :, -1:, :]                                         # (B, nc, 1, H)

    # intra-chunk: decay[q, k] = exp(la_q - la_k) for k <= q, masked BEFORE
    # the exp so the k > q half never overflows
    dd = la[:, :, :, None, :] - la[:, :, None, :, :]                   # (B, nc, Q, Q, H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], dd, -1e30))
    cb = torch.einsum("bcqn,bckn->bcqk", cm, bm)                       # (B, nc, Q, Q)
    w = cb[..., None] * decay                                           # (B, nc, Q, Q, H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w.to(xh.dtype), xh)

    # chunk states S_c = sum_k exp(la_last - la_k) B_k x_k^T  -> (B, nc, H, N, P)
    dk = torch.exp(la_last - la)                                        # (B, nc, Q, H)
    s_c = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bm, dk.to(xh.dtype), xh)

    # inter-chunk recurrence: the state entering each chunk
    a_chunk = torch.exp(la_last[:, :, 0, :]).to(xh.dtype)              # (B, nc, H)
    s = xh.new_zeros((b, h, n, p))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = a_chunk[:, c, :, None, None] * s + s_c[:, c]
    s_in = torch.stack(s_in, dim=1)                                     # (B, nc, H, N, P)

    dq = torch.exp(la)                                                  # decay from chunk start
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cm, dq.to(xh.dtype), s_in)
    y = (y_intra + y_inter).reshape(b, t, h, p)
    return y, s


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                   cache: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, D) -> (y (B, T, D), new cache or None). With a cache and
    T == 1: one recurrent step; otherwise the chunked scan (its final state
    into the cache, when one is given). The cache passed in is not written:
    the new one holds new tensors."""
    d_inner, h, p_dim, n, _ = _dims(cfg)
    b, t, _ = x.shape
    proj = p.in_proj(x)
    z, xbc, dt_raw = _split_proj(cfg, proj)

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _conv1d(xbc, p.conv_w, p.conv_b, state=conv_state)

    xs = xbc[..., :d_inner].reshape(b, t, h, p_dim)
    bmat = xbc[..., d_inner:d_inner + n]
    cmat = xbc[..., d_inner + n:]

    dt = softplus(dt_raw.float() + p.dt_bias)                           # (B, T, H)
    a_neg = -torch.exp(p.a_log)                                          # (H,)
    a_step = torch.exp(dt * a_neg)                                       # (B, T, H)
    xh = xs * dt[..., None].to(xs.dtype)

    if cache is not None and t == 1:
        # one decode step: S <- a S + B (dt x)^T ; y = C . S
        s_prev = cache["ssm"]
        s_next = (a_step[:, 0, :, None, None].to(xs.dtype) * s_prev
                  + torch.einsum("bn,bhp->bhnp", bmat[:, 0], xh[:, 0]))
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], s_next)[:, None]    # (B, 1, H, P)
        new_cache = {"conv": new_conv, "ssm": s_next, "pos": cache["pos"] + 1}
    else:
        chunk = min(cfg.ssm.chunk, t)
        pad = (-t) % chunk
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            a_p = F.pad(a_step, (0, 0, 0, pad), value=1.0)
            b_p = F.pad(bmat, (0, 0, 0, pad))
            c_p = F.pad(cmat, (0, 0, 0, pad))
        else:
            xh_p, a_p, b_p, c_p = xh, a_step, bmat, cmat
        y, s_final = ssd_chunked(xh_p, a_p, b_p, c_p, chunk)
        y = y[:, :t]
        new_cache = (None if cache is None else
                     {"conv": new_conv, "ssm": s_final, "pos": cache["pos"] + t})

    y = y + xs * p.d_skip[None, None, :, None].to(xs.dtype)
    y = y.reshape(b, t, d_inner)
    y = p.out_norm(y) * F.silu(z)
    return p.out_proj(y), new_cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, h, p_dim, n, cw = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cw - 1, d_inner + 2 * n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, n, p_dim), dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
