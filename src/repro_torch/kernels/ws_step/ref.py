"""Plain PyTorch versions of the fused warm-start Euler sampling step (the
JAX package's ``ws_step/ref.py``), fed by the kernel's threefry noise.

Given backbone logits, the current token, the mixing weight
``a = clip(h * velocity_scale(t), 0, 1)`` and Gumbel noise, the next
token of the CTMC Euler step is

    x_next = argmax_v log((1 - a) * onehot(x_t) + a * softmax(logits / T))[v] + g[v]

``ws_step_ref`` materialises the probabilities; ``ws_step_ref_streamed``
computes the decomposed score that ``csrc/ws_step.cu`` streams (the
argmax of ``lg + g`` over ``v != x`` against the ``v == x`` score). The
two agree except on floating-point near-ties at the argmax boundary;
:func:`near_tie_rows` names the rows where that may happen.

``ws_step_rows_ref`` is the plain version of the per-row mode (the JAX
package's ``make_euler_one_step_rows``): ``euler_step_probs`` and a Gumbel
argmax whose noise for request row ``b`` is ``jax.random.gumbel(keys[b],
(N, V))``.

``ws_step_gumbel_ref`` is the plain version of the TPU kernel
``ws_step_pallas`` (``_ws_step_kernel``): the probability-space score with
Gumbel noise drawn beforehand, over the first ``valid_v`` of ``Vp``
columns. :func:`near_tie_rows_probs` names its near-tie rows: that score
is a different floating-point function from the streamed decomposition
that :func:`near_tie_rows` measures. :func:`keyed_gumbel` is the noise
that the keyed ``ws_step_gumbel`` kernel hashes, element by element.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import prng

MIN_PROB = 1e-30
NEG = -1e30
_TINY = float(np.finfo(np.float32).tiny)


def ws_step_ref(logits: torch.Tensor, x_t: torch.Tensor, a: torch.Tensor,
                gumbel: torch.Tensor, *, temperature: float = 1.0) -> torch.Tensor:
    lf = logits.float() / temperature
    p1 = torch.softmax(lf, dim=-1)
    onehot = torch.nn.functional.one_hot(x_t.long(), logits.shape[-1]).float()
    probs = (1.0 - a[:, None]) * onehot + a[:, None] * p1
    score = torch.log(torch.clamp_min(probs, MIN_PROB)) + gumbel
    return torch.argmax(score, dim=-1).to(torch.int32)


def ws_step_rows_ref(keys: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor,
                     a: torch.Tensor, *, temperature: float = 1.0) -> torch.Tensor:
    """Row-keyed draw: ``keys (B, 2)``, ``logits (B, N, V)``, ``x_t (B, N)``,
    ``a (B,)``; the probabilities of ``core.sampler.euler_step_probs`` and
    the argmax of ``categorical_from_probs_rows``. (B, N) int32."""
    p1 = torch.softmax(logits.float() / temperature, dim=-1)
    aa = a.float().reshape(-1, 1, 1)
    onehot = torch.nn.functional.one_hot(x_t.long(), logits.shape[-1]).float()
    probs = (1.0 - aa) * onehot + aa * p1
    g = prng.gumbel(keys, logits.shape[1:], device=logits.device)
    return torch.argmax(torch.log(torch.clamp_min(probs, MIN_PROB)) + g, dim=-1).to(torch.int32)


def _decomposed(logits, x_t, a, gumbel, temperature):
    lf = logits.float() / temperature
    m = lf.max(dim=-1, keepdim=True).values
    s = torch.exp(lf - m).sum(dim=-1, keepdim=True)
    xi = x_t.long()[:, None]
    cand = (lf + gumbel).scatter(-1, xi, NEG)
    best, bidx = cand.max(dim=-1, keepdim=True)
    aa = a.float()[:, None]
    score_other = torch.log(torch.clamp_min(aa, MIN_PROB)) + best - m - torch.log(s)
    lx = lf.gather(-1, xi)
    gx = gumbel.gather(-1, xi)
    p1x = torch.exp(lx - m) / s
    score_x = torch.log(torch.clamp_min((1.0 - aa) + aa * p1x, MIN_PROB)) + gx
    return cand, score_x, score_other, xi, bidx


def ws_step_ref_streamed(logits: torch.Tensor, x_t: torch.Tensor, a: torch.Tensor,
                         gumbel: torch.Tensor, *, temperature: float = 1.0) -> torch.Tensor:
    """Full-width replica of the streamed kernel's decomposed score."""
    _, score_x, score_other, xi, bidx = _decomposed(logits, x_t, a, gumbel, temperature)
    return torch.where(score_x >= score_other, xi, bidx)[:, 0].to(torch.int32)


def near_tie_rows(logits: torch.Tensor, x_t: torch.Tensor, a: torch.Tensor,
                  gumbel: torch.Tensor, *, temperature: float = 1.0,
                  tol: float = 1e-5) -> torch.Tensor:
    """Rows whose draw hinges on two competing scores within ``tol``: the
    keep-vs-move scores ``score_x``/``score_other``, or the best two
    ``lg + g`` candidates over ``v != x``. Two correct implementations
    that sum in different orders may disagree there, and only there."""
    cand, score_x, score_other, _, _ = _decomposed(logits, x_t, a, gumbel, temperature)
    keep_vs_move = (score_x - score_other).abs()[:, 0] <= tol
    if cand.shape[-1] < 3:
        return keep_vs_move
    top2 = cand.topk(2, dim=-1).values
    return keep_vs_move | ((top2[:, 0] - top2[:, 1]) <= tol)


def _probs_scores(logits, x_t, a, gumbel, valid_v, temperature):
    """``log(max(probs, 1e-30)) + g`` over ``(R, Vp)``, the columns
    ``>= valid_v`` at ``NEG``, as ``_ws_step_kernel`` forms it."""
    vp = logits.shape[-1]
    valid = torch.arange(vp, device=logits.device) < valid_v
    lg = torch.where(valid, logits.float() / temperature, NEG)
    m = lg.max(dim=-1, keepdim=True).values
    e = torch.exp(lg - m)
    p1 = e / e.sum(dim=-1, keepdim=True)
    onehot = (torch.arange(vp, device=logits.device) == x_t.reshape(-1, 1)).float()
    aa = a.float().reshape(-1, 1)
    probs = (1.0 - aa) * onehot + aa * p1
    score = torch.log(torch.clamp_min(probs, MIN_PROB)) + gumbel
    return torch.where(valid, score, NEG)


def ws_step_gumbel_ref(logits: torch.Tensor, x_t: torch.Tensor, a: torch.Tensor,
                       gumbel: torch.Tensor, *, valid_v: int,
                       temperature: float = 1.0) -> torch.Tensor:
    """``logits (R, Vp)``, ``x_t (R, 1)``, ``a (R, 1)``, ``gumbel (R, Vp)`` ->
    ``(R, 1)`` int32: the first argmax of the probability-space score over
    the valid columns."""
    score = _probs_scores(logits, x_t, a, gumbel, valid_v, temperature)
    return torch.argmax(score, dim=-1, keepdim=True).to(torch.int32)


def near_tie_rows_probs(logits: torch.Tensor, x_t: torch.Tensor, a: torch.Tensor,
                        gumbel: torch.Tensor, *, valid_v: int, temperature: float = 1.0,
                        tol: float = 1e-5) -> torch.Tensor:
    """``(R,)`` bool: rows whose best two probability-space scores lie
    within ``tol``. Two correct implementations of ``ws_step_gumbel`` that
    sum the softmax in different orders may disagree there, and only there."""
    score = _probs_scores(logits, x_t, a, gumbel, valid_v, temperature)
    if valid_v < 2:
        return torch.zeros(score.shape[0], dtype=torch.bool, device=score.device)
    top2 = score.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) <= tol


def keyed_uniform(seed: Tuple[int, int], rows: int, vp: int, *, device=None) -> torch.Tensor:
    """``(rows, vp)`` float32: the uniform under the keyed ``ws_step_gumbel``
    kernel's noise, as the kernel forms each element. For row ``r`` and
    column ``v`` the bits are ``x0 ^ x1`` of ``threefry2x32(key, (0, r * vp +
    v))``; their top 23 bits make ``f`` in [0, 1); ``u = max(f * 1 + tiny,
    tiny)`` with one rounding (the kernel's FMA; ``f * 1`` is exact, so the
    float32 sum rounds once too). That is ``jax.random.uniform(key, (rows,
    vp), minval=tiny, maxval=1)``, bit for bit."""
    if rows * vp >= 1 << 32:
        raise NotImplementedError("random bits arrays of 2**32 elements or more")
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    v = torch.arange(vp, dtype=torch.int64, device=device)[None, :]
    x0, x1 = prng.threefry2x32(int(seed[0]), int(seed[1]), 0, r * vp + v)
    f = (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * 1.0 + _TINY, _TINY)


def keyed_gumbel(seed: Tuple[int, int], rows: int, vp: int, *, device=None) -> torch.Tensor:
    """The keyed ``ws_step_gumbel`` kernel's noise, ``-log(-log u)`` of
    :func:`keyed_uniform`: ``jax.random.gumbel(key, (rows, vp))``, whose
    uniform it equals bit for bit (``prng.gumbel``'s values exactly; JAX's
    own log may round the last bit otherwise)."""
    return -torch.log(-torch.log(keyed_uniform(seed, rows, vp, device=device)))
