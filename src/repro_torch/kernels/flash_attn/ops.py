"""``flash_attention``: the wrapper around ``csrc/flash_attn.cu``.

Same signature and layout as the JAX package's ``flash_attn/ops.py``:
q (B, S, H, D), k and v (B, T, KH, D) with KH dividing H (GQA), causal /
bidirectional / sliding-window masks, output (B, S, H, D). V may be
narrower than q and k: v (B, T, KH, DV) gives an output (B, S, H, DV)
(MLA's values, 128 wide against its 192-wide queries and keys). A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version.
With grad enabled and an input that requires grad, the call goes through
``FlashAttentionFn`` (the same forward, and the attention gradient), so a
backbone trains through the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import NEG_INF, attention_mask, flash_attention_ref

# the (q/k head_dim, v head_dim) pairs the kernel is built for: one width for all
# three, or MLA's (192, 128) and its smoke config's (48, 32)
SUPPORTED_HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (256, 256),
                       (192, 128), (48, 32))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"expected q (B,S,H,D), k (B,T,KH,D) and v (B,T,KH,DV); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    _check(q, k, v)
    d = q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal=causal, window=window, scale=scale)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
             window: Optional[int], scale: float) -> torch.Tensor:
    """The kernel on a CUDA tensor (counted), the plain version on a CPU one."""
    dims = (q.shape[3], v.shape[3])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if dims not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim (q/k, v) {dims} not supported by the kernel: "
                         f"{SUPPORTED_HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = q.new_empty(q.shape[:3] + (dims[1],))
    _launch(q, k, v, out, causal=causal, window=window, scale=scale)
    _build.count("flash_attn")
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient: the forward is :func:`_forward` (the
    kernel on the card, counted as in serving; the plain version on the
    CPU), the backward the softmax-attention gradient in ``torch.matmul``
    and elementwise ops (:func:`attention_backward`), with P recomputed
    from q and k under the forward's mask. The JAX package differentiates
    attention through XLA's ``_sdpa`` (its Pallas kernel is forward-only),
    so these products stay ``torch.matmul`` as XLA's are."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out = _forward(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, d_out, causal=ctx.causal,
                                        window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def attention_backward(q, k, v, d_out, *, causal: bool, window: Optional[int],
                       scale: float):
    """Gradients of ``out = softmax(scale q k^T, masked) v`` for q (B,S,H,D),
    k (B,T,KH,D), v (B,T,KH,DV) and ``d_out`` (B,S,H,DV) (DV may differ from
    D: MLA's values are narrower than its queries and keys):

        S = scale q k^T (masked as ``attention_mask``), P = softmax(S)
        dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(P * dP))
        dQ = scale dS K;  dK = scale dS^T Q

    with dK and dV summed over the G = H / KH query heads of each KV head.
    Float32, batched over (B, KH, G).

    ``rowsum(P * dP)`` equals FlashAttention's ``rowsum(dO * O)``; it is
    taken from the recomputed P, as autograd of JAX's ``_sdpa`` takes it,
    and not from the kernel's O: the rows of dS must sum to zero in P's own
    rounding, or dQ and dK pick up the rounding of O against P times K's
    component common to all positions (the DiT's time embedding). With O
    from the kernel that cost 5.4e-3 of wq's max |g| (the full-width DiT,
    32 x 256 tokens, on an H100); from P, 1.4e-4 against autograd through
    the plain version."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh

    def heads(x):     # (B, S, H, D or DV) -> (B, KH, G, S, D or DV)
        return x.reshape(b, s, kh, g, x.shape[3]).permute(0, 2, 3, 1, 4)

    qh, doh = heads(q), heads(d_out)
    kt = k.permute(0, 2, 1, 3)[:, :, None]        # (B, KH, 1, T, D)
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    mask = attention_mask(s, t, causal=causal, window=window, device=q.device)
    scores = torch.matmul(qh, kt.transpose(-1, -2)) * scale
    p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), doh).sum(2)           # (B, KH, T, DV)
    dp = torch.matmul(doh, vt.transpose(-1, -2))                  # (B, KH, G, S, T)
    ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
    dq = torch.matmul(ds, kt) * scale                              # (B, KH, G, S, D)
    dk = torch.matmul(ds.transpose(-1, -2), qh).sum(2) * scale     # (B, KH, T, D)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
            causal: bool, window: Optional[int], scale: float) -> None:
    """One launch of the kernel on checked, contiguous CUDA tensors (no
    count). Its output carries no gradient: with grad enabled and an input
    that requires one, only :class:`FlashAttentionFn` may launch it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attn launched outside FlashAttentionFn with inputs that "
                           "require grad: its output would be cut from the autograd graph")
    b, s, h, d = q.shape
    t, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _build.library().flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kh, d, dv,
            float(scale), int(causal), int(window or 0), stream)
    _build.check(rc, "flash_attn")
