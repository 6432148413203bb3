"""Host-side training loop: data iterator -> train step -> metrics, periodic
checkpointing (torch port of the JAX package's ``training/trainer.py``).
Used by ``launch/train.py``. It trains every decoder-only config; an
encoder-decoder one trains through ``make_train_step`` with its frames in
the batch (``check_fit_batches``).

The JAX trainer jits its step; here the step runs as eager launches on the
model's device. Every step's loss and grad norm stay on the device
(``step_losses``, ``step_grad_norms``) and, on the card, a CUDA event marks
each step's start (``step_ms`` reads them after ``fit``); the host reads
the card only at the ``log_every`` steps, as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List, Mapping, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint.io import save_checkpoint
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import jax_params_to_torch
from repro_torch.core.paths import WarmStartPath
from repro_torch.optim import build_optimizer
from repro_torch.training.state import TrainState
from repro_torch.training.train_step import make_train_step


def check_fit_batches(cfg: ModelConfig) -> None:
    """Raise for a config whose batches need more than ``x_src``/``x_tgt``.
    ``fit`` builds only those, as the JAX trainer does, which therefore
    fails on an encoder-decoder config at its first step (``KeyError:
    'frames'``, reference fault R9 in ROADMAP); here the error comes
    before the first step and names the way that works."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: Trainer.fit builds batches of x_src and x_tgt only, and this "
            f"encoder-decoder config needs 'frames' (B, F, d_model) in each batch: train it "
            f"through make_train_step with batch['frames']")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Trainer:
    model: object
    cfg: ModelConfig
    run: RunConfig
    path: Optional[WarmStartPath] = None

    def __post_init__(self):
        self.optimizer = build_optimizer(self.run)
        self.path = self.path or WarmStartPath(t0=self.run.t0)
        self._step_fn = make_train_step(self.model, self.cfg, self.run, self.optimizer,
                                        self.path)

    def init_state(self, params: Optional[Mapping[str, np.ndarray]] = None) -> TrainState:
        """A fresh state on the model's weights: its seeded init, or
        ``params`` (a JAX parameter tree, flat ``{"a|b": array}``) loaded
        into it, so that both packages can start from one init."""
        if params is not None:
            sd = {k: v.to(self.model.device) for k, v in jax_params_to_torch(params).items()}
            self.model.load_state_dict(sd, strict=True)
        return TrainState.create(self.model, self.optimizer)

    def fit(self, state: TrainState, batches: Iterator, *, steps: Optional[int] = None,
            log_fn: Callable[[int, dict], None] = None,
            checkpoint_every: int = 0) -> TrainState:
        check_fit_batches(self.cfg)
        steps = steps or self.run.total_steps
        device = self.model.device
        rng = prng.key(self.run.seed + 1)
        history = []
        self.step_losses: List[torch.Tensor] = []
        self.step_grad_norms: List[torch.Tensor] = []
        self.step_events: List[torch.cuda.Event] = []
        _sync(device)
        t_start = time.time()
        for i in range(steps):
            x_src, x_tgt = next(batches)
            batch = {"x_src": _to_device(x_src, device), "x_tgt": _to_device(x_tgt, device)}
            rng, sub = prng.split(rng, 2)
            if device.type == "cuda":
                self.step_events.append(torch.cuda.Event(enable_timing=True))
                self.step_events[-1].record()
            state, metrics = self._step_fn(state, batch, sub)
            self.step_losses.append(metrics["loss"])
            self.step_grad_norms.append(metrics["grad_norm"])
            if (i + 1) % self.run.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items()}
                _sync(device)
                m["steps_per_s"] = (i + 1) / (time.time() - t_start)
                history.append((i + 1, m))
                if log_fn:
                    log_fn(i + 1, m)
            if checkpoint_every and (i + 1) % checkpoint_every == 0:
                save_checkpoint(self.run.checkpoint_dir, state, step=int(state.step))
        if device.type == "cuda":
            self.step_events.append(torch.cuda.Event(enable_timing=True))
            self.step_events[-1].record()
        self.history = history
        return state

    def step_ms(self) -> List[float]:
        """Each step's time on the card's clock, from its start event to the
        next step's (the last to the event after it); [] off the card."""
        if not self.step_events:
            return []
        self.step_events[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.step_events, self.step_events[1:])]


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host batch onto ``device``: through pinned memory and a
    non-blocking copy on the card, so the host does not wait for the
    stream (a pageable copy would)."""
    t = torch.as_tensor(np.asarray(x, np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
