"""The WS-DFM training step (paper Fig. 2 right) over the port's DiT
backbone and every family the port serves (dense, recurrent,
encoder-decoder): torch port of the JAX package's ``training/train_step.py``.

batch dict:
  x_src:  (B, N) int32: draft samples x_{t0} (or noise for cold start)
  x_tgt:  (B, N) int32: refined/data samples x_1
  + ``frames`` (B, F, d_model) for the encoder-decoder family.

The same step with ``path.t0 = 0`` is the cold-start DFM baseline (paper
Fig. 2 left). The step runs eagerly: gradients by ``torch.autograd.grad``
(attention through ``FlashAttentionFn``: the ``flash_attn`` kernel forward
on the card, its gradient in ``torch.matmul``), clipping by the global
norm, then the optimizer on the JAX leaves in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import jax_leaves
from repro_torch.core.losses import dfm_cross_entropy
from repro_torch.core.paths import WarmStartPath
from repro_torch.optim.schedule import clip_by_global_norm
from repro_torch.training.state import TrainState

EXTRA_KEYS = ("frames", "patches", "positions")


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet ({where})")


def make_loss_fn(model, cfg: ModelConfig, path: WarmStartPath, *,
                 z_loss: float = 1e-4, mtp_weight: float = 0.1, remat: bool = False):
    """Returns loss_fn(model, batch, rng) -> (loss, metrics); ``rng`` is a
    host key (``prng.key``). Each of ``EXTRA_KEYS`` present in the batch
    reaches the model as a keyword (``EncDecModel`` takes ``frames``; a
    decoder-only ``Model`` refuses extras), and ``remat`` too (JAX
    ``fwd_batch`` and ``model.forward(..., remat=remat)``)."""
    if cfg.moe.num_experts:
        raise _not_ported("the MoE router auxiliary loss", "the zoo's MoE family")

    def loss_fn(model, batch, rng):
        extras = {k: batch[k] for k in EXTRA_KEYS if k in batch}
        if extras and not (cfg.is_encoder_decoder and set(extras) == {"frames"}):
            raise _not_ported(f"batch extras {sorted(extras)} for {cfg.name}",
                              "only the encoder-decoder family's frames are; patches and "
                              "positions are the zoo's VLM family's")
        x_src, x_tgt = batch["x_src"], batch["x_tgt"]
        rng_t, rng_xt = prng.split(rng, 2)
        t = path.sample_t(rng_t, (x_src.shape[0],), device=x_src.device)
        x_t = path.interpolate(rng_xt, x_src, x_tgt, t)
        logits = model(x_t, t, remat=remat, **extras)

        loss = dfm_cross_entropy(logits, x_tgt, z_loss=z_loss)
        metrics = {"ce": loss, "t_mean": torch.mean(t)}

        if cfg.mtp_depth:
            # DeepSeek MTP adapted as an auxiliary shifted-target CE on the
            # same trunk logits (depth 1)
            mtp = dfm_cross_entropy(logits[:, :-1], x_tgt[:, 1:])
            loss = loss + mtp_weight * mtp
            metrics["mtp"] = mtp

        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def grads_of(loss: torch.Tensor, leaves):
    """d loss / d every parameter, as ``{JAX leaf: [tensor, ...]}`` beside
    ``leaves`` (``jax_leaves(model)``), by ``torch.autograd.grad`` (nothing
    accumulates in ``.grad``; an unused parameter gets zeros, as in JAX)."""
    flat = [p for ps in leaves.values() for p in ps]
    flat_grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for g, p in zip(flat_grads, flat))
    return {name: [next(it) for _ in ps] for name, ps in leaves.items()}


def loss_and_grads(loss_fn, model, leaves, batch, rng):
    """(loss, metrics, grads) of one batch (:func:`grads_of`)."""
    loss, metrics = loss_fn(model, batch, rng)
    return loss, metrics, grads_of(loss, leaves)


def apply_gradients(state: TrainState, leaves, grads, optimizer, grad_clip: float):
    """Clip ``grads`` by their global norm (in place), then one optimizer
    step on the model's weights: (new state, the global norm before
    clipping)."""
    _, gnorm = clip_by_global_norm([g for gs in grads.values() for g in gs], grad_clip)
    _, opt_state = optimizer.update(grads, state.opt_state, leaves)
    return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1), gnorm


def make_train_step(model, cfg: ModelConfig, run: RunConfig, optimizer,
                    path: Optional[WarmStartPath] = None):
    """Builds train_step(state, batch, rng) -> (state, metrics): the unit the
    JAX package jits for training shapes (here eager launches)."""
    path = path or WarmStartPath(t0=run.t0)
    loss_fn = make_loss_fn(model, cfg, path, remat=(run.remat != "none"))
    leaves = jax_leaves(model)

    def train_step(state: TrainState, batch, rng):
        if state.params is not model:
            raise ValueError("train_step was built for another model than the state's")
        _, metrics, grads = loss_and_grads(loss_fn, model, leaves, batch, rng)
        new_state, gnorm = apply_gradients(state, leaves, grads, optimizer, run.grad_clip)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return new_state, metrics

    return train_step
