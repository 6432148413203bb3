"""Lightweight draft models supplying the warm-start initial distribution
(port of the JAX package's ``core/draft.py``).

The common contract: *negligible generation cost* next to one backbone
NFE, which :meth:`DraftModel.calibrate_cost_ratio` measures.

  * ``CorruptionDraft`` — sample true data, corrupt a fraction of tokens
    (the paper's pretty-good / fair / poor tiers for two-moons).
  * ``ARDraft``          — any AR sampling entry point (the paper's LSTM,
    ``models.LSTMModel.generate``).
  * ``HistogramDraft``   — per-position categorical fitted to data.

Every draw is ``jax.random``'s for the same key (``repro_torch.prng``), so
a draft equals the JAX package's token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device


class DraftModel:
    """Interface: generate (num, N) int32 draft samples."""

    def generate(self, rng: torch.Tensor, num: int) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    @property
    def cost_ratio(self) -> float:
        """Draft cost / one backbone NFE (for guarantees.py accounting): the
        MEASURED ratio once :meth:`calibrate_cost_ratio` has run, before that
        the subclass's static estimate (0.0 here, the paper's "negligible")."""
        measured = getattr(self, "_measured_cost", None)
        if measured is not None:
            return measured.cost_ratio
        return self._estimated_cost_ratio()

    def _estimated_cost_ratio(self) -> float:
        return 0.0

    def calibrate_cost_ratio(self, nfe_fn: Callable[[], torch.Tensor], *, rng: torch.Tensor,
                             num: int, seq_len: int, iters: int = 5):
        """Replace the estimated cost_ratio with a measured one.

        ``nfe_fn()`` must run exactly one backbone function evaluation (+
        Euler update) at the same (num, seq_len) the draft produces; timing
        is wall-clock best-of-``iters`` (see
        :func:`repro_torch.drafting.quality.measure_cost_ratio`).
        """
        from repro_torch.drafting.quality import measure_cost_ratio

        report = measure_cost_ratio(lambda: self.generate(rng, num), nfe_fn, batch=num,
                                    seq_len=seq_len, iters=iters)
        self._measured_cost = report
        return report


@dataclasses.dataclass
class CorruptionDraft(DraftModel):
    """Draw a data sample and re-randomise each token w.p. ``corruption``.

    corruption ~ 0.05 -> 'pretty good', 0.3 -> 'fair', 0.6 -> 'poor'
    (paper Fig. 4 tiers for the two-moons study).
    """

    data: np.ndarray           # (M, N) int
    vocab_size: int
    corruption: float = 0.3
    jitter: int = 0            # optional +-jitter on token values (grid data)
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def generate(self, rng: torch.Tensor, num: int) -> torch.Tensor:
        k1, k2, k3, k4 = prng.split(rng, 4)
        dev = self.device
        idx = prng.randint(k1, (num,), 0, self.data.shape[0], device=dev)
        x = torch.as_tensor(np.asarray(self.data, np.int32), device=dev)[idx.long()]
        if self.jitter:
            dx = prng.randint(k4, x.shape, -self.jitter, self.jitter + 1, device=dev)
            x = torch.clamp(x + dx, 0, self.vocab_size - 1)
        corrupt = prng.uniform(k2, x.shape, device=dev) < float(np.float32(self.corruption))
        rand = prng.randint(k3, x.shape, 0, self.vocab_size, device=dev)
        return torch.where(corrupt, rand, x)


@dataclasses.dataclass
class HistogramDraft(DraftModel):
    """Independent per-position categorical fitted to the data: the cheapest
    possible draft, marginals only."""

    probs: np.ndarray  # (N, V) float, rows sum to 1
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def fit(data: np.ndarray, vocab_size: int, smoothing: float = 1.0, *,
            device="cuda") -> "HistogramDraft":
        n = data.shape[1]
        counts = np.full((n, vocab_size), smoothing, np.float64)
        for i in range(n):
            np.add.at(counts[i], data[:, i], 1.0)
        return HistogramDraft(probs=(counts / counts.sum(-1, keepdims=True)).astype(np.float32),
                              device=device)

    def generate(self, rng: torch.Tensor, num: int) -> torch.Tensor:
        logits = torch.log(torch.as_tensor(self.probs, device=self.device))   # (N, V)
        return prng.categorical(rng, logits.expand((num,) + tuple(logits.shape))).to(torch.int32)


@dataclasses.dataclass
class ARDraft(DraftModel):
    """Autoregressive draft: the paper's LSTM role.

    ``decode_fn(params, rng, num, seq_len) -> (num, seq_len) int32`` is an
    AR sampling entry point (``models.LSTMModel.generate``); its tokens lie
    where its parameters do.
    """

    decode_fn: Callable
    params: Any
    seq_len: int
    _cost_ratio: float = 0.02    # static ESTIMATE; calibrate_cost_ratio
                                 # replaces it with the measured ratio

    def generate(self, rng: torch.Tensor, num: int) -> torch.Tensor:
        return self.decode_fn(self.params, rng, num, self.seq_len)

    def _estimated_cost_ratio(self) -> float:
        return self._cost_ratio
