"""The WS-DFM training step (paper Fig. 2 right) over the port's DiT
backbone and every family the port serves (dense, recurrent,
encoder-decoder, MoE): torch port of the JAX package's ``training/train_step.py``.

batch dict:
  x_src:  (B, N) int32: draft samples x_{t0} (or noise for cold start)
  x_tgt:  (B, N) int32: refined/data samples x_1
  + ``frames`` (B, F, d_model) for the encoder-decoder family;
  + ``patches`` (B, P, 1280) and ``positions`` (3, B, P + N) for the VLM
    family (the loss is over the text logits only, as JAX's).

The same step with ``path.t0 = 0`` is the cold-start DFM baseline (paper
Fig. 2 left). ``make_train_step`` builds the un-jitted step, as JAX's:
gradients by ``torch.autograd.grad`` (attention through
``FlashAttentionFn``: the ``flash_attn`` kernel forward on the card, its
gradient in ``torch.matmul``), clipping by the global norm, then the
optimizer on the JAX leaves in place. ``jit_train_step`` is the port's
``jax.jit`` of it: on the card one CUDA graph a compile key (the batch's
keys, shapes and dtypes), captured on the first call of a key, whose one
step is the capture's warm-up, and one replay each later call; on the CPU
the step runs as it is.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.graphs import GraphCache, compile_key
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import jax_leaves
from repro_torch.core.losses import dfm_cross_entropy
from repro_torch.core.paths import WarmStartPath
from repro_torch.models.model import check_batch_extras
from repro_torch.optim.adamw import device_scalars, next_step
from repro_torch.optim.schedule import clip_by_global_norm
from repro_torch.training.state import TrainState

EXTRA_KEYS = ("frames", "patches", "positions")


def make_loss_fn(model, cfg: ModelConfig, path: WarmStartPath, *,
                 z_loss: float = 1e-4, mtp_weight: float = 0.1, remat: bool = False):
    """Returns loss_fn(model, batch, rng) -> (loss, metrics); ``rng`` is a
    key (``prng.key``) on the host or, inside a CUDA graph, on the card.
    Each of ``EXTRA_KEYS`` present in the batch
    reaches the model as a keyword (``EncDecModel`` takes ``frames``, a
    decoder-only ``Model`` ``patches`` and ``positions``), and ``remat`` too
    (JAX ``fwd_batch`` and ``model.forward(..., remat=remat)``). A VLM's
    logits lose the patches' rows before the loss. With MoE
    layers the loss adds ``router_aux_weight`` times their auxiliary loss,
    reported as ``moe_aux``."""
    moe = bool(cfg.moe.num_experts)

    def loss_fn(model, batch, rng):
        extras = {k: batch[k] for k in EXTRA_KEYS if k in batch}
        if not cfg.is_encoder_decoder:
            check_batch_extras(extras)
        x_src, x_tgt = batch["x_src"], batch["x_tgt"]
        rng_t, rng_xt = prng.split(rng, 2)
        t = path.sample_t(rng_t, (x_src.shape[0],), device=x_src.device)
        x_t = path.interpolate(rng_xt, x_src, x_tgt, t)
        if moe:
            logits, aux = model(x_t, t, remat=remat, return_aux=True, **extras)
        else:
            logits = model(x_t, t, remat=remat, **extras)

        # vlm: logits cover [vision prefix + text]; loss only on the text part
        if cfg.family == "vlm" and "patches" in extras:
            logits = logits[:, extras["patches"].shape[1]:]

        loss = dfm_cross_entropy(logits, x_tgt, z_loss=z_loss)
        metrics = {"ce": loss, "t_mean": torch.mean(t)}

        if moe:
            loss = loss + cfg.moe.router_aux_weight * aux
            metrics["moe_aux"] = aux

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


def advance(state: TrainState) -> TrainState:
    """``state`` one step on: its step and its optimizer's (host counters;
    the weights and moments changed in place)."""
    return TrainState(params=state.params, opt_state=next_step(state.opt_state),
                      step=state.step + 1)


def apply_gradients(state: TrainState, leaves, grads, optimizer, grad_clip: float,
                    hyper=None):
    """Clip ``grads`` by their global norm (in place), then one optimizer
    step on the model's weights: (new state, the global norm before
    clipping). ``hyper`` is the optimizer's host prologue for this step as
    a float32 tensor on the card (a graph's input); by default it is
    computed from ``state``."""
    _, gnorm = clip_by_global_norm([g for gs in grads.values() for g in gs], grad_clip)
    if hyper is None:
        hyper = device_scalars(optimizer.hyper(state.opt_state), state.params.device)
    optimizer.apply(grads, state.opt_state, leaves, hyper)
    return advance(state), gnorm


def make_train_step(model, cfg: ModelConfig, run: RunConfig, optimizer,
                    path: Optional[WarmStartPath] = None):
    """Builds train_step(state, batch, rng) -> (state, metrics): the unit the
    JAX package jits for training shapes, here as eager launches
    (:func:`jit_train_step` makes it one CUDA graph replay). ``hyper``, a
    keyword, takes the optimizer's step values as a tensor on the card."""
    path = path or WarmStartPath(t0=run.t0)
    loss_fn = make_loss_fn(model, cfg, path, remat=(run.remat != "none"))
    leaves = jax_leaves(model)

    def train_step(state: TrainState, batch, rng, *, hyper=None):
        if state.params is not model:
            raise ValueError("train_step was built for another model than the state's")
        _, metrics, grads = loss_and_grads(loss_fn, model, leaves, batch, rng)
        new_state, gnorm = apply_gradients(state, leaves, grads, optimizer, run.grad_clip,
                                           hyper)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return new_state, metrics

    train_step.model, train_step.optimizer = model, optimizer
    return train_step


def jit_train_step(step):
    """``jax.jit`` of a step from :func:`make_train_step`, as the JAX
    Trainer does: ``jitted(state, batch, rng) -> (state, metrics)``, the
    same contract. On the card each compile key (the batch's keys with
    each entry's shape and dtype, extras included: what JAX's jit retraces
    on) is one CUDA graph (``GraphCache(stateful=True)``): the key's first
    call runs the step once as the capture's warm-up and returns its
    metrics, every later call fills the graph's inputs (the batch, the key
    as a (2,) tensor on the card, the optimizer's step values from its host
    prologue) and replays. The graph writes the weights and moments of the
    state it was captured on: a call with another optimizer state drops
    the graphs and captures again. ``jitted.graphs`` is the cache
    (captures, replays, capture times). Off the card it calls ``step``."""
    graphs = GraphCache("the train step", stateful=True, hint=(
        "a train step reads nothing back to the host: move a .item(), float() or "
        "data-dependent shape out of the loss"))
    bound = []               # the optimizer state's buffers the graphs write
    metric_names = {}        # compile key -> the names of the graph's outputs

    def jitted(state: TrainState, batch, rng):
        names = list(batch)
        if batch[names[0]].device.type != "cuda":
            return step(state, batch, rng)
        if state.params is not step.model:
            raise ValueError("train_step was built for another model than the state's")
        buffers = tuple(state.opt_state[1:])      # the moments' dicts (or factors')
        if len(bound) != len(buffers) or any(a is not b for a, b in zip(bound, buffers)):
            graphs.clear()
            bound[:] = buffers
        ckey = compile_key(batch)

        def body(*inputs):
            *vals, key, hyper = inputs
            _, metrics = step(state, dict(zip(names, vals)), key, hyper=hyper)
            metric_names[ckey] = list(metrics)
            return tuple(metrics.values())

        hyper = torch.from_numpy(step.optimizer.hyper(state.opt_state))
        out = graphs(ckey, body, *batch.values(), rng, hyper)
        return advance(state), dict(zip(metric_names[ckey], out))

    jitted.graphs = graphs
    jitted.step = step
    return jitted
