"""Plain PyTorch versions of the four draft-decode kernels
(``csrc/draft_decode.cu``), computing what the JAX package's Pallas bodies
``_qkv_rope_kernel``, ``_attn_kernel``, ``_post_attn_kernel`` and
``_head_kernel`` compute (``kernels/draft_decode/kernel.py``).

Batch invariance: like the Pallas grid (one program per token), these
evaluate one token row at a time at fixed ``(1, ·)`` shapes, so a row's
result never depends on how many rows share the call. That is what makes
the batched prefill equal the token-by-token scan bitwise on the CPU. The
CPU path and the on-card comparison use them; they are not a port of the
kernels.

Parameters come as the JAX package's dicts of tensors: a norm is
``{"scale"[, "bias"]}`` (rmsnorm has no bias), a projection
``{"w": (in, out)[, "b": (out,)]}``; a missing ``"b"`` means no bias, a
missing ``"gate"`` an ungated MLP.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import activation

NEG_INF = -2.3819763e38   # the mask constant of models/attention.py


def norm_row(x: torch.Tensor, ln: dict, *, kind: str, eps: float) -> torch.Tensor:
    """``_norm_row``: layernorm or rmsnorm of rows at fixed (1, D) shape."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return (xf - mu) * torch.rsqrt(var + eps) * ln["scale"] + ln["bias"]
    var = xf.square().mean(-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + ln["scale"])


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if p.get("b") is not None else y


def rope_row(x: torch.Tensor, pos: int, *, heads: int, head_dim: int,
             theta: float) -> torch.Tensor:
    """``_rope_row``: RoPE of one token ``x (1, heads*head_dim)`` at ``pos``
    with frequencies ``theta ** (-j / half)``."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = float(pos) * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    xh = x.reshape(heads, head_dim)
    x1, x2 = xh[:, :half], xh[:, half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(1, -1)


def qkv_rope_ref(x: torch.Tensor, ln: dict, attn_p: dict, kbuf: torch.Tensor,
                 vbuf: torch.Tensor, start: torch.Tensor, *, pos0: int, seq: int,
                 norm: str, eps: float, use_rope: bool, theta: float, heads: int,
                 kv_heads: int, head_dim: int) -> torch.Tensor:
    """x (R, D), R = B * seq rows at positions ``pos0 + r % seq`` -> q (R,
    H*hd); k and v are written into ``kbuf``/``vbuf`` (B, T, KH*hd) at the
    cursor ``start`` (clamped as ``dynamic_update_slice`` clamps)."""
    t = kbuf.shape[1]
    w0 = min(max(int(start), 0), t - seq)   # dynamic_update_slice's clamp
    qs = []
    for r in range(x.shape[0]):
        b, i = divmod(r, seq)
        h = norm_row(x[r:r + 1], ln, kind=norm, eps=eps)
        q, k, v = _dense(attn_p["wq"], h), _dense(attn_p["wk"], h), _dense(attn_p["wv"], h)
        if use_rope:
            q = rope_row(q, pos0 + i, heads=heads, head_dim=head_dim, theta=theta)
            k = rope_row(k, pos0 + i, heads=kv_heads, head_dim=head_dim, theta=theta)
        kbuf[b, w0 + i] = k[0]
        vbuf[b, w0 + i] = v[0]
        qs.append(q)
    return torch.cat(qs)


def attn_cached_ref(q: torch.Tensor, kbuf: torch.Tensor, vbuf: torch.Tensor,
                    start: torch.Tensor, *, pos0: int, seq: int, heads: int,
                    kv_heads: int, head_dim: int) -> torch.Tensor:
    """q (R, H*hd) against the row's whole buffer kbuf/vbuf (B, T, KH*hd):
    keys ``col <= pos`` and ``col < start + seq`` count; direct softmax,
    ``(p @ v) / l``. Query head h reads kv head h // (H / KH)."""
    t = kbuf.shape[1]
    g = heads // kv_heads
    end = int(start) + seq
    col = torch.arange(t, device=q.device)
    outs = []
    for r in range(q.shape[0]):
        b, i = divmod(r, seq)
        qh = q[r].reshape(kv_heads, g, head_dim)
        kh = kbuf[b].reshape(t, kv_heads, head_dim)
        vh = vbuf[b].reshape(t, kv_heads, head_dim)
        sc = torch.einsum("kgd,tkd->kgt", qh, kh) * (1.0 / math.sqrt(head_dim))
        sc = torch.where((col <= pos0 + i) & (col < end), sc, NEG_INF)
        p = torch.exp(sc - sc.max(-1, keepdim=True).values)
        out = torch.einsum("kgt,tkd->kgd", p, vh) / p.sum(-1, keepdim=True)
        outs.append(out.reshape(1, heads * head_dim))
    return torch.cat(outs)


def post_attn_ref(a: torch.Tensor, x: torch.Tensor, attn_p: dict, ln: dict, mlp_p: dict,
                  *, norm: str, eps: float, act: str) -> torch.Tensor:
    """wo (+b) -> residual -> ln2 -> up (gated or not) -> down (+b) ->
    residual, per row: a (R, H*hd), x (R, D) -> (R, D)."""
    outs = []
    for r in range(x.shape[0]):
        xr = x[r:r + 1] + _dense(attn_p["wo"], a[r:r + 1])
        hn = norm_row(xr, ln, kind=norm, eps=eps)
        up = _dense(mlp_p["up"], hn)
        if "gate" in mlp_p:
            up = activation(act, _dense(mlp_p["gate"], hn)) * up
        else:
            up = activation(act, up)
        outs.append(xr + _dense(mlp_p["down"], up))
    return torch.cat(outs)


def head_ref(x: torch.Tensor, fn: dict, w: torch.Tensor, *, norm: str,
             eps: float) -> torch.Tensor:
    """Final norm -> vocab projection, per row: x (R, D), w (D, V) (for a
    tied head the embedding table, transposed) -> logits (R, V)."""
    return torch.cat([norm_row(x[r:r + 1], fn, kind=norm, eps=eps) @ w
                      for r in range(x.shape[0])])
