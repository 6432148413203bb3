"""Training losses for (warm-start) discrete flow matching (torch port of
the JAX package's ``core/losses.py``).

The DFM objective (paper eq. 6 with J=1, w = delta_{x1}) reduces to the
cross-entropy of the posterior predictor ``v_theta(t, x_t)`` against the
terminal sample ``x_1`` where ``x_t`` is drawn from the pinned marginal.
The warm-start variant only changes (a) the source sample (draft instead
of noise) and (b) the time range ``[t0, 1]``: paper Fig. 2 (right).

``apply_fn`` is a callable on tensors, ``(tokens (B, N), t (B,)) ->
logits (B, N, V)``: the port's model holds its weights, so there is no
``params`` argument.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import prng
from repro_torch.core.paths import WarmStartPath


def dfm_cross_entropy(logits: torch.Tensor, x_tgt: torch.Tensor, *,
                      weights: Optional[torch.Tensor] = None,
                      z_loss: float = 0.0) -> torch.Tensor:
    """Token-wise CE of v_theta(t, x_t) toward x1, in float32.

    Args:
      logits: (..., N, V) float.
      x_tgt: (..., N) int targets (x_1).
      weights: optional (..., N) mask/weights.
      z_loss: auxiliary logsumexp^2 regulariser (coefficient ~1e-4).
    Returns:
      scalar mean loss.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, x_tgt.long()[..., None])[..., 0]
    nll = lse - tgt_logit
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if weights is not None:
        weights = weights.float()
        return torch.sum(nll * weights) / torch.clamp_min(torch.sum(weights), 1.0)
    return torch.mean(nll)


def distill_map_loss(apply_fn: Callable[..., torch.Tensor], x_draft: torch.Tensor,
                     x_refined: torch.Tensor, t0: torch.Tensor, *,
                     weights: Optional[torch.Tensor] = None, z_loss: float = 0.0):
    """Flow-map self-distillation loss for the few-step refiner head: the
    refined terminal tokens predicted in one jump from the draft at its
    warm-start time (no interpolation, no time sampling).

    Args:
      apply_fn: distilled head ``(tokens (B, N), t (B,)) -> logits``.
      x_draft: (B, N) int draft tokens at the rows' warm-start times.
      x_refined: (B, N) int refined tokens the guaranteed path produced.
      t0: (B,) per-row warm-start times the pairs were harvested at.
    Returns:
      (loss, aux dict): ``agreement`` is the fraction of argmax predictions
      already matching the teacher.
    """
    logits = apply_fn(x_draft, torch.as_tensor(t0, dtype=torch.float32,
                                               device=x_draft.device))
    loss = dfm_cross_entropy(logits, x_refined, weights=weights, z_loss=z_loss)
    agree = (torch.argmax(logits, dim=-1) == x_refined).float()
    if weights is not None:
        w = weights.float()
        agreement = torch.sum(agree * w) / torch.clamp_min(torch.sum(w), 1.0)
    else:
        agreement = torch.mean(agree)
    return loss, {"loss": loss, "agreement": agreement}


def ws_dfm_loss(apply_fn: Callable[..., torch.Tensor], rng: torch.Tensor,
                x_src: torch.Tensor, x_tgt: torch.Tensor, path: WarmStartPath, *,
                weights: Optional[torch.Tensor] = None, z_loss: float = 0.0):
    """One WS-DFM loss evaluation (paper Fig. 2 right).

    Args:
      apply_fn: callable ``(tokens, t) -> logits (B, N, V)``.
      rng: PRNG key (the port's threefry key, ``prng.key``).
      x_src: (B, N) draft tokens x_{t0} (paired with x_tgt), or noise when
        ``path.t0 == 0`` (cold-start baseline, paper Fig. 2 left).
      x_tgt: (B, N) refined/data tokens x_1.
      path: the (warm-start) probability path.
    Returns:
      (loss, aux dict)
    """
    rng_t, rng_xt = prng.split(rng, 2)
    t = path.sample_t(rng_t, (x_src.shape[0],), device=x_src.device)
    x_t = path.interpolate(rng_xt, x_src, x_tgt, t)
    logits = apply_fn(x_t, t)
    loss = dfm_cross_entropy(logits, x_tgt, weights=weights, z_loss=z_loss)
    frac_done = torch.mean((x_t == x_tgt).float())
    return loss, {"loss": loss, "t_mean": torch.mean(t), "frac_target": frac_done}
