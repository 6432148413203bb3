"""Self-distilled few-step refiner: the serving stack's cheap SLO tier
(port of the JAX package's ``drafting/distill.py``).

A whole flow-matching refine trajectory collapsed into a 1-2 step head,
distilled against the serving pipeline itself:

  * :class:`PairBuffer` -- a bounded, thread-safe FIFO of ``(draft,
    refined, t0)`` rows harvested from the scheduler's guaranteed refine
    dispatches (the guaranteed path is the teacher; no extra teacher
    forward passes). It holds numpy rows on the host, as JAX's does;
  * :class:`DistilledRefiner` -- a small flow-map head ``dfm_apply(params,
    tokens, t) -> logits`` that predicts the refined terminal token
    distribution directly from the draft at its warm-start time (loss:
    :func:`repro_torch.core.losses.distill_map_loss`). Its params are a
    flat dict of tensors with the JAX leaf names and shapes;
  * :func:`train_distilled` -- the self-distillation loop over the buffer
    (the port's AdamW, the loss through autograd): one step a batch, on the
    card one CUDA graph replay (:func:`jit_distill_step`, one graph a batch
    shape, as JAX jits its step once a length);
  * :func:`save_distilled` / :func:`restore_distilled` -- checkpoints
    through ``repro_torch.checkpoint`` in the JAX package's layout, so a
    head saved by either package restores in the other.

The scheduler serves ``tier="distilled"`` requests with ``distilled_nfe``
(K in {1, 2}) steps of this head through the same masked row loop as the
guaranteed path, behind a probe-score quality floor, and falls back to the
guaranteed refine, bit-identical to a fresh guaranteed request.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.io import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.convert import DISTILLED_LEAVES
from repro_torch.core.losses import distill_map_loss
from repro_torch.device import resolve_device
from repro_torch.graphs import GraphCache, compile_key
from repro_torch.optim.adamw import AdamW, device_scalars, next_step


class PairBuffer:
    """Bounded FIFO of ``(draft, refined, t0)`` training rows.

    Fed by the scheduler's refine dispatches (``pair_buffer=``): every
    guaranteed micro-batch adds its real (non-padding) rows -- the draft that
    entered the refine, the refined tokens that left it and the row's
    warm-start time. Rows of different lengths coexist; :meth:`batches`
    groups them by length so every training batch is rectangular. Oldest
    rows are evicted first past ``capacity``.

    Thread-safe: the streaming loop appends while a trainer takes snapshots.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rows: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._added = 0
        self._evicted = 0

    def add_batch(self, draft, refined, t0_rows, *, mask=None) -> int:
        """Append the real rows of one micro-batch: ``draft`` and ``refined``
        (B, N) int tokens, ``t0_rows`` (B,), ``mask`` (B,) bool (False rows,
        the padding, are skipped). Returns the number of rows added."""
        draft = np.asarray(draft)
        refined = np.asarray(refined)
        t0_rows = np.asarray(t0_rows, np.float64)
        if draft.shape != refined.shape or draft.ndim != 2:
            raise ValueError(f"draft/refined must share a (B, N) shape, got "
                             f"{draft.shape} vs {refined.shape}")
        if t0_rows.shape != (draft.shape[0],):
            raise ValueError(f"t0_rows shape {t0_rows.shape} does not match batch "
                             f"{draft.shape[0]}")
        added = 0
        with self._lock:
            for r in range(draft.shape[0]):
                if mask is not None and not bool(mask[r]):
                    continue
                self._rows.append((np.asarray(draft[r], np.int32).copy(),
                                   np.asarray(refined[r], np.int32).copy(),
                                   float(t0_rows[r])))
                self._added += 1
                added += 1
                if len(self._rows) > self.capacity:
                    self._rows.popleft()
                    self._evicted += 1
        return added

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._rows), "added": self._added,
                    "evicted": self._evicted, "capacity": self.capacity}

    def snapshot(self) -> dict:
        """Length-grouped arrays: ``{N: (draft (M, N), refined, t0 (M,))}``."""
        with self._lock:
            rows = list(self._rows)
        groups: dict = {}
        for d, x, t0 in rows:
            groups.setdefault(d.shape[0], []).append((d, x, t0))
        return {n: (np.stack([d for d, _, _ in g]), np.stack([x for _, x, _ in g]),
                    np.asarray([t for _, _, t in g], np.float64))
                for n, g in groups.items()}

    def batches(self, batch_size: int, *, rng: Optional[np.random.Generator] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of rectangular ``(draft, refined, t0)`` batches: rows
        grouped by length (ascending), each group shuffled by ``rng`` if
        given, chunked to at most ``batch_size`` rows."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        for _, (draft, refined, t0) in sorted(self.snapshot().items()):
            order = np.arange(draft.shape[0])
            if rng is not None:
                rng.shuffle(order)
            for lo in range(0, order.shape[0], batch_size):
                sel = order[lo:lo + batch_size]
                yield draft[sel], refined[sel], t0[sel]


Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistilledRefiner:
    """The distilled flow-map head, tiny by design.

    ``dfm_apply(params, tokens (B, N), t (B,)) -> logits (B, N, V)``: token
    embedding, a 3-tap depthwise positional mix (zero padding), FiLM on the
    warm-start time, one ``tanh`` MLP block with a residual, and an output
    projection plus ``copy_gate * one_hot(tokens)``: the head starts as a
    draft copier and learns only the corrections.
    """

    vocab_size: int
    d_model: int = 32
    hidden: int = 64
    copy_gate_init: float = 2.0

    def init(self, generator_or_seed: Union[int, torch.Generator] = 0, *,
             device="cuda") -> Params:
        """Seeded params on ``device`` at the JAX initialisers' scales (0.02
        normals, zero biases and FiLM, the mix centred on the token); the
        values differ from JAX's. ``generator_or_seed`` is a seed or a
        ``torch.Generator`` on ``device``."""
        dev = resolve_device(device)
        gen = generator_or_seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(generator_or_seed))
        s = 0.02
        v, d, h = self.vocab_size, self.d_model, self.hidden

        def normal(*shape):
            return s * torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

        def zeros(*shape):
            return torch.zeros(shape, device=dev, dtype=torch.float32)

        mix = normal(3, d)
        mix[1] += 1.0
        return {
            "embed": normal(v, d), "mix": mix, "t_film": zeros(2, d),
            "w1": normal(d, h), "b1": zeros(h), "w2": normal(h, d), "b2": zeros(d),
            "out": normal(d, v), "out_b": zeros(v),
            "copy_gate": torch.tensor(self.copy_gate_init, dtype=torch.float32, device=dev),
        }

    def dfm_apply(self, params: Params, tokens: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        tok = tokens.long()
        e = params["embed"][tok]                                    # (B, N, d)
        left = F.pad(e, (0, 0, 1, 0))[:, :-1]
        right = F.pad(e, (0, 0, 0, 1))[:, 1:]
        mix = params["mix"]
        hid = left * mix[0] + e * mix[1] + right * mix[2]
        tc = torch.as_tensor(t, dtype=torch.float32, device=e.device)[:, None, None]
        film = params["t_film"]
        hid = hid * (1.0 + tc * film[0]) + tc * film[1]
        z = torch.tanh(torch.matmul(hid, params["w1"]) + params["b1"])
        hid = hid + torch.matmul(z, params["w2"]) + params["b2"]
        logits = torch.matmul(hid, params["out"]) + params["out_b"]
        onehot = F.one_hot(tok, self.vocab_size).to(torch.float32)
        return logits + params["copy_gate"] * onehot


@dataclasses.dataclass(frozen=True)
class DistillReport:
    """What one :func:`train_distilled` run did."""

    steps: int
    epochs: int
    pairs: int                  # distinct buffered rows trained against
    first_loss: float
    final_loss: float
    final_agreement: float      # argmax-vs-teacher token agreement

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def make_distill_step(model: DistilledRefiner, params: Params, opt: AdamW, *,
                      z_loss: float = 0.0):
    """The head's un-jitted train step (JAX's ``train_step`` inside
    ``train_distilled``): ``step(opt_state, draft, refined, t0) ->
    (opt_state, loss, agreement)``, the distillation loss through autograd
    and one AdamW step on ``params`` (tensors that require grad) in place.
    ``hyper``, a keyword, takes AdamW's step values as a tensor on the
    card."""
    leaves = {k: [params[k]] for k in DISTILLED_LEAVES}

    def step(opt_state, draft, refined, t0, *, hyper=None):
        loss, aux = distill_map_loss(lambda x, t: model.dfm_apply(params, x, t),
                                     draft, refined, t0, z_loss=z_loss)
        grads = torch.autograd.grad(loss, [params[k] for k in DISTILLED_LEAVES])
        if hyper is None:
            hyper = device_scalars(opt.hyper(opt_state), draft.device)
        opt.apply({k: [g] for k, g in zip(DISTILLED_LEAVES, grads)}, opt_state, leaves, hyper)
        return next_step(opt_state), loss.detach(), aux["agreement"]

    step.optimizer = opt
    return step


def jit_distill_step(step):
    """``jax.jit`` of :func:`make_distill_step`'s step, with its contract:
    on the card one CUDA graph a batch shape (``GraphCache(stateful=True)``:
    the shape's first call is the capture's warm-up, its one step; each
    later call fills the batch and AdamW's step values and replays), the
    weights and moments of the first call's state written in place; off
    the card the step itself. ``jitted.graphs`` is the cache."""
    graphs = GraphCache("the distilled head's train step", stateful=True)

    def jitted(opt_state, draft, refined, t0):
        if draft.device.type != "cuda":
            return step(opt_state, draft, refined, t0)

        def body(draft, refined, t0, hyper):
            return step(opt_state, draft, refined, t0, hyper=hyper)[1:]

        key = compile_key({"draft": draft, "refined": refined, "t0": t0})
        hyper = torch.from_numpy(step.optimizer.hyper(opt_state))
        loss, agreement = graphs(key, body, draft, refined, t0, hyper)
        return next_step(opt_state), loss, agreement

    jitted.graphs = graphs
    return jitted


def train_distilled(
    model: DistilledRefiner,
    buffer: PairBuffer,
    *,
    key: Union[int, torch.Generator] = 0,
    params: Optional[Params] = None,
    epochs: int = 1,
    batch_size: int = 64,
    learning_rate: float = 3e-2,
    weight_decay: float = 0.0,
    z_loss: float = 0.0,
    seed: int = 0,
    device="cuda",
) -> Tuple[Params, DistillReport]:
    """Self-distillation loop over a harvested pair buffer: one AdamW step a
    rectangular batch (:func:`jit_distill_step`: on the card a graph replay,
    one capture a batch shape), in the batch order of ``buffer.batches(...,
    rng=np.random.default_rng(seed))``, as JAX's; each step's loss and
    agreement are read on the host, outside the graph. ``key`` seeds
    ``model.init`` when ``params`` is None; given ``params`` are copied, not
    changed. Returns ``(new params, DistillReport)``; the params are new
    tensors that need no gradient."""
    if len(buffer) == 0:
        raise ValueError("PairBuffer is empty — serve some guaranteed traffic with "
                         "pair_buffer= attached first")
    dev = resolve_device(device)
    opt = AdamW(learning_rate=learning_rate, weight_decay=weight_decay)
    if params is None:
        params = model.init(key, device=dev)
    params = {k: v.detach().to(dev).clone().requires_grad_(True) for k, v in params.items()}
    opt_state = opt.init({k: [params[k]] for k in DISTILLED_LEAVES})
    step = jit_distill_step(make_distill_step(model, params, opt, z_loss=z_loss))

    rng = np.random.default_rng(seed)
    steps = 0
    first_loss = final_loss = final_agreement = float("nan")
    for _ in range(epochs):
        for draft, refined, t0 in buffer.batches(batch_size, rng=rng):
            draft = torch.from_numpy(np.asarray(draft, np.int32)).to(dev)
            refined = torch.from_numpy(np.asarray(refined, np.int32)).to(dev)
            t0 = torch.from_numpy(np.asarray(t0, np.float32)).to(dev)
            opt_state, loss, agreement = step(opt_state, draft, refined, t0)
            final_loss = float(loss)
            final_agreement = float(agreement)
            if steps == 0:
                first_loss = final_loss
            steps += 1
    report = DistillReport(steps=steps, epochs=epochs, pairs=len(buffer),
                           first_loss=first_loss, final_loss=final_loss,
                           final_agreement=final_agreement)
    return {k: v.detach() for k, v in params.items()}, report


def save_distilled(directory, params: Params, step: int = 0) -> str:
    """Checkpoint head params (flat npz + manifest, atomic), keyed as the
    JAX package keys ``{"params": params}``."""
    return save_checkpoint(str(directory), {"params": params}, step)


def restore_distilled(directory, model: DistilledRefiner, step: Optional[int] = None, *,
                      device="cuda") -> Params:
    """Restore head params saved by :func:`save_distilled` (either
    package's) onto ``device``; ``model`` gives the shapes, so it must be
    the config the head was trained with."""
    template = {"params": model.init(0, device=device)}
    return restore_checkpoint(str(directory), template, step)["params"]


def distilled_checkpoint_exists(directory) -> bool:
    """True when ``directory`` holds at least one distilled checkpoint."""
    return latest_step(str(directory)) is not None
