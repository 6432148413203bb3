"""xLSTM blocks of the torch backbone (port of the JAX package's
``models/xlstm.py``; arXiv:2405.04517): mLSTM (matrix memory,
parallelisable) and sLSTM (scalar memory, strictly recurrent), 7:1 in
xLSTM-1.3b.

mLSTM runs the stabilised parallel (decay-masked, attention-like) form for
prefill and the DFM denoiser, or the chunkwise form when ``cfg.attn_impl ==
"chunked"`` and T > ``cfg.attn_chunk`` (as JAX picks), and the stabilised
recurrent form (C, n, m) for decode. A prefill with a cache builds the
recurrent state by scanning :func:`mlstm_step` over the tokens, as JAX
does, so the decode that follows equals a token-by-token one. sLSTM is a
loop over time in both modes. The products are plain float32 ``einsum``s
(JAX's are XLA's, outside any Pallas kernel).

The recurrent states ``c``, ``n``, ``m`` (and the sLSTM's ``hid``) are
float32 whatever the cache dtype; a step returns new tensors and writes
none it was given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Dense, RMSNorm, activation, normal_init
from repro_torch.models.ssm import _conv1d, softplus


def log_sigmoid(x: torch.Tensor, zero: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x, zero)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mdims(cfg: ModelConfig):
    d_inner = int(cfg.ssm.mlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    return d_inner, h, d_inner // h


class MLSTM(nn.Module):
    """The leaves of JAX's ``init_mlstm``: ``up`` -> [x branch, z gate], the
    causal ``conv_w`` (4, d_inner) and ``conv_b``, block-diagonal per-head
    ``wq``/``wk``/``wv`` (H, Dk, Dk), the input/forget gates ``w_if``,
    ``out_norm`` and ``down``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, h, dk = _mdims(cfg)
        self.up = Dense(d, 2 * d_inner, gen, device)
        self.conv_w = nn.Parameter(normal_init(gen, (4, d_inner), 0.1, device))
        self.conv_b = nn.Parameter(torch.zeros(d_inner, device=device))
        self.wq = nn.Parameter(normal_init(gen, (h, dk, dk), 1.0 / math.sqrt(dk), device))
        self.wk = nn.Parameter(normal_init(gen, (h, dk, dk), 1.0 / math.sqrt(dk), device))
        self.wv = nn.Parameter(normal_init(gen, (h, dk, dk), 1.0 / math.sqrt(dk), device))
        self.w_if = Dense(d_inner, 2 * h, gen, device)
        self.out_norm = RMSNorm(d_inner, cfg.norm_eps, device)
        self.down = Dense(d_inner, d, gen, device, stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        return mlstm_forward(self, x, self.cfg, cache=cache)


def _headproj(w: torch.Tensor, x: torch.Tensor, h: int, dk: int) -> torch.Tensor:
    """Block-diagonal per-head projection: x (B, T, d_inner) -> (B, T, H, Dk)."""
    b, t, _ = x.shape
    return torch.einsum("bthd,hde->bthe", x.reshape(b, t, h, dk), w.to(x.dtype))


def mlstm_parallel(q, k, v, i_raw, f_raw) -> torch.Tensor:
    """Stabilised parallel mLSTM (xLSTM eq. 19-27). q, k, v (B, T, H, Dk);
    i_raw, f_raw (B, T, H) raw gate pre-activations. Returns h (B, T, H, Dk)."""
    t = q.shape[1]
    lf = log_sigmoid(f_raw.float())                                     # (B, T, H)
    lfc = torch.cumsum(lf, dim=1)
    # logD[t, k] = lfc_t - lfc_k + i_k  (k <= t)
    logd = lfc[:, :, None, :] - lfc[:, None, :, :] + i_raw.float()[:, None, :, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    logd = torch.where(mask[None, :, :, None], logd, -1e30)
    m = torch.amax(logd, dim=2, keepdim=True)                           # (B, T, 1, H)
    d = torch.exp(logd - m)                                             # (B, T, T, H)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qk = torch.einsum("bthd,bshd->btsh", q, k).float() * scale
    w = qk * d
    num = torch.einsum("btsh,bshd->bthd", w.to(v.dtype), v)
    denom = torch.maximum(torch.abs(torch.sum(w, dim=2)), torch.exp(-m[:, :, 0, :]))
    return (num / denom[..., None].to(v.dtype)).to(v.dtype)


def mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int) -> torch.Tensor:
    """Chunkwise-parallel stabilised mLSTM: O(T * chunk) score tensors, a
    (C, n, m) state carried from chunk to chunk. q, k, v (B, T, H, D); gates
    (B, T, H). T must be a multiple of ``chunk`` (the caller pads). Returns
    h (B, T, H, D)."""
    b, t, h, d = q.shape
    nc = t // chunk
    scale = 1.0 / math.sqrt(d)
    qs = q.reshape(b, nc, chunk, h, d)
    ks = k.reshape(b, nc, chunk, h, d)
    vs = v.reshape(b, nc, chunk, h, d)
    i_s = i_raw.float().reshape(b, nc, chunk, h)
    f_s = f_raw.float().reshape(b, nc, chunk, h)

    c_prev = q.new_zeros((b, h, d, d), dtype=torch.float32)
    n_prev = q.new_zeros((b, h, d), dtype=torch.float32)
    m_prev = torch.full((b, h), -1e30, dtype=torch.float32, device=q.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))

    outs = []
    for c in range(nc):
        qj, kj, vj, ij, fj = qs[:, c], ks[:, c], vs[:, c], i_s[:, c], f_s[:, c]
        lf = log_sigmoid(fj)                                            # (B, Q, H)
        lfc = torch.cumsum(lf, dim=1)
        lf_tot = lfc[:, -1]                                             # (B, H)

        # intra-chunk decay matrix in log space
        logd = lfc[:, :, None, :] - lfc[:, None, :, :] + ij[:, None, :, :]
        logd = torch.where(mask[None, :, :, None], logd, -1e30)
        m_intra = torch.amax(logd, dim=2)                               # (B, Q, H)
        m_inter = m_prev[:, None, :] + lfc                              # (B, Q, H)
        m_t = torch.maximum(m_intra, m_inter)

        dmat = torch.exp(logd - m_t[:, :, None, :])                     # (B, Q, Q, H)
        qk = torch.einsum("bthd,bshd->btsh", qj, kj).float() * scale
        w = qk * dmat
        vs_f = vj.float()
        num = torch.einsum("btsh,bshd->bthd", w, vs_f)
        den = torch.sum(w, dim=2)                                       # (B, Q, H)

        # the carried state's contribution
        qf = qj.float() * scale
        scale_inter = torch.exp(m_inter - m_t)                          # (B, Q, H)
        num_inter = torch.einsum("bqhd,bhdv->bqhv", qf, c_prev) * scale_inter[..., None]
        den_inter = torch.einsum("bqhd,bhd->bqh", qf, n_prev) * scale_inter

        den_all = torch.maximum(torch.abs(den + den_inter), torch.exp(-m_t))
        outs.append(((num + num_inter) / den_all[..., None]).to(v.dtype))

        # the state update (stabilised); contribution weights exp(lf_tot - lfc_s + i_s)
        lw = lf_tot[:, None, :] - lfc + ij                              # (B, Q, H)
        m_new = torch.maximum(m_prev + lf_tot, torch.amax(lw, dim=1))
        wgt = torch.exp(lw - m_new[:, None, :])                         # (B, Q, H)
        decay = torch.exp(m_prev + lf_tot - m_new)                      # (B, H)
        kf = kj.float()
        c_prev = decay[..., None, None] * c_prev + torch.einsum(
            "bqh,bqhd,bqhv->bhdv", wgt, kf, vs_f)
        n_prev = decay[..., None] * n_prev + torch.einsum("bqh,bqhd->bhd", wgt, kf)
        m_prev = m_new
    return torch.stack(outs, dim=1).reshape(b, t, h, d)


def mlstm_step(state, q, k, v, i_raw, f_raw):
    """One recurrent step. state = (C (B, H, Dk, Dk), n (B, H, Dk), m (B,
    H)); q, k, v (B, H, Dk); gates (B, H). Returns (h (B, H, Dk), new state)."""
    c, n, m = state
    lf = log_sigmoid(f_raw.float())
    li = i_raw.float()
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)                                      # (B, H)
    ig = torch.exp(li - m_new)
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf = k.float()
    c = fg[..., None, None] * c + ig[..., None, None] * (kf[..., :, None] * v.float()[..., None, :])
    n = fg[..., None] * n + ig[..., None] * kf
    qf = q.float() * scale
    num = torch.einsum("bhd,bhdv->bhv", qf, c)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), torch.exp(-m_new))
    return (num / den[..., None]).to(v.dtype), (c, n, m_new)


def mlstm_forward(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None):
    """x (B, T, D) -> (y (B, T, D), new cache or None)."""
    d_inner, h, dk = _mdims(cfg)
    b, t, _ = x.shape
    use_chunked = cfg.attn_impl == "chunked" and t > cfg.attn_chunk
    up = p.up(x)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _conv1d(xm, p.conv_w, p.conv_b, state=conv_state)
    q = _headproj(p.wq, xc, h, dk)
    k = _headproj(p.wk, xc, h, dk)
    v = _headproj(p.wv, xm, h, dk)
    gates = p.w_if(xm).reshape(b, t, h, 2)
    i_raw, f_raw = gates[..., 0], gates[..., 1]

    new_cache = None
    if cache is not None and t == 1:
        hid, (c, n, m) = mlstm_step((cache["c"], cache["n"], cache["m"]),
                                    q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
        y = hid[:, None]
        new_cache = {"conv": new_conv, "c": c, "n": n, "m": m, "pos": cache["pos"] + 1}
    else:
        if use_chunked:
            chunk = min(cfg.attn_chunk, t)
            pad = (-t) % chunk
            if pad:
                qp, kp, vp = (F.pad(z_, (0, 0, 0, 0, 0, pad)) for z_ in (q, k, v))
                ip = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)   # zero input weight
                fp = F.pad(f_raw, (0, 0, 0, pad))
                y = mlstm_chunked(qp, kp, vp, ip, fp, chunk)[:, :t]
            else:
                y = mlstm_chunked(q, k, v, i_raw, f_raw, chunk)
        else:
            y = mlstm_parallel(q, k, v, i_raw, f_raw)
        if cache is not None:
            # prefill: the recurrent state by scanning the step, as JAX does
            st = (cache["c"], cache["n"], cache["m"])
            for j in range(t):
                _, st = mlstm_step(st, q[:, j], k[:, j], v[:, j], i_raw[:, j], f_raw[:, j])
            c, n, m = st
            new_cache = {"conv": new_conv, "c": c, "n": n, "m": m, "pos": cache["pos"] + t}

    y = y.reshape(b, t, d_inner)
    y = p.out_norm(y) * F.silu(z)
    return p.down(y), new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, h, dk = _mdims(cfg)
    return {
        "conv": torch.zeros((batch, 3, d_inner), dtype=dtype, device=device),
        "c": torch.zeros((batch, h, dk, dk), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dk), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _sdims(cfg: ModelConfig):
    h = cfg.num_heads
    return h, cfg.d_model // h


class SLSTM(nn.Module):
    """The leaves of JAX's ``init_slstm``: the input gates ``w_gates`` (i, f,
    z, o per channel), the block-diagonal recurrent ``r_gates`` (4, H, Dh,
    Dh), ``out_norm`` and the gated FFN ``up``/``down``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        h, dh = _sdims(cfg)
        d_ff = int(cfg.ssm.slstm_proj_factor * d)
        self.w_gates = Dense(d, 4 * d, gen, device)
        self.r_gates = nn.Parameter(normal_init(gen, (4, h, dh, dh), 1.0 / math.sqrt(dh), device))
        self.out_norm = RMSNorm(d, cfg.norm_eps, device)
        self.up = Dense(d, 2 * d_ff, gen, device)
        self.down = Dense(d_ff, d, gen, device, stddev=0.02 / math.sqrt(2 * cfg.num_layers))

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        return slstm_forward(self, x, self.cfg, cache=cache)


def slstm_scan(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, state=None):
    """x (B, T, D); state = (c, n, m, hid), c/n/hid (B, H, Dh), m (B, H).
    Returns (y (B, T, D), state)."""
    h, dh = _sdims(cfg)
    b, t, d = x.shape
    gates_x = p.w_gates(x).reshape(b, t, 4, h, dh)
    if state is None:
        zeros = x.new_zeros((b, h, dh), dtype=torch.float32)
        state = (zeros, zeros, torch.full((b, h), -1e30, dtype=torch.float32,
                                          device=x.device), zeros)
    # the recurrent weights as H blocks of (4 Dh, Dh), and a zero, made once a scan
    r = p.r_gates.float().permute(1, 0, 2, 3).reshape(h, 4 * dh, dh)
    zero = x.new_zeros(())
    c, n, m, hid = state
    ys = []
    for j in range(t):
        gx = gates_x[:, j].float()
        # the recurrent contribution (block-diagonal per head): JAX's
        # einsum("ghde,bhe->bghd", r, hid) as one batched product over heads
        rec = torch.bmm(r, hid.permute(1, 2, 0)).reshape(h, 4, dh, b).permute(3, 1, 0, 2)
        g = gx + rec                                                     # (B, 4, H, Dh)
        gz, go = g[:, 2], g[:, 3]
        gm = g[:, :2].mean(-1)                                           # scalar gates a head
        li = gm[:, 0]
        lf = log_sigmoid(gm[:, 1], zero)
        lfm = lf + m
        m_new = torch.maximum(lfm, li)
        fg = torch.exp(lfm - m_new)[..., None]
        ig = torch.exp(li - m_new)[..., None]
        c = fg * c + ig * torch.tanh(gz)
        n = fg * n + ig
        hid = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        ys.append(hid)
    y = torch.stack(ys, dim=1).reshape(b, t, d).to(x.dtype)
    return y, (c, n, m, hid)


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None):
    state = None
    if cache is not None:
        state = (cache["c"], cache["n"], cache["m"], cache["hid"])
    y, (c, n, m, hid) = slstm_scan(p, x, cfg, state)
    y = p.out_norm(y)
    up = p.up(y)
    d_ff = up.shape[-1] // 2
    y = p.down(activation("gelu", up[..., :d_ff]) * up[..., d_ff:])
    new_cache = None
    if cache is not None:
        new_cache = {"c": c, "n": n, "m": m, "hid": hid, "pos": cache["pos"] + x.shape[1]}
    return y, new_cache


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    h, dh = _sdims(cfg)

    def z():
        return torch.zeros((batch, h, dh), dtype=torch.float32, device=device)

    return {"c": z(), "n": z(), "m": torch.full((batch, h), -1e30, dtype=torch.float32,
                                                device=device),
            "hid": z(), "pos": torch.zeros((), dtype=torch.int32, device=device)}
