"""Draft-quality scoring, score -> t0 calibration and measured draft cost
(port of the JAX package's ``drafting/quality.py``).

The paper's Fig. 4 ties the warm-start time to draft quality tiers
(pretty-good / fair / poor -> deep / medium / shallow t0):

* :func:`make_quality_scorer` -- the per-token likelihood probe of a draft
  under the learned flow path: the backbone at ``t_probe`` on the draft
  itself, read as the mean log-probability it keeps on the draft's tokens
  (one backbone evaluation per scored batch and probe time). On the card
  the probe is one CUDA graph replay a call, captured once per token shape
  (JAX's ``@jax.jit`` keeps one executable per shape); its scores stay on
  the device until a caller reads them.
* :func:`fit_t0_calibration` -- the monotone score -> t0 mapping fitted on
  the corruption tiers (:class:`T0Calibration`).
* :func:`measure_cost_ratio` -- the draft stage against one backbone NFE on
  the host clock, each call ended by a synchronisation of the card where
  JAX calls ``block_until_ready``: the ``draft_cost_ratio`` that
  ``guarantees.speedup_report`` charges against the speed-up.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.draft import CorruptionDraft
from repro_torch.device import resolve_device
from repro_torch.graphs import GraphCache

# paper Fig. 4 tiers: (corruption rate, target warm-start time)
DEFAULT_TIERS: Tuple[Tuple[float, float], ...] = (
    (0.05, 0.9),   # pretty good
    (0.30, 0.7),   # fair
    (0.60, 0.5),   # poor
)


def to_host(x) -> np.ndarray:
    """A scorer's output (a tensor on any device, or an array) as numpy: the
    port's ``np.asarray`` of a JAX array, a read of the card."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _probe(apply_fn, times: Tuple[float, ...], temperature: float,
           tokens: torch.Tensor) -> torch.Tensor:
    tokens = tokens.to(torch.int32)

    def one_time(tp: float) -> torch.Tensor:
        t = torch.full((tokens.shape[0],), tp, dtype=torch.float32, device=tokens.device)
        logits = apply_fn(tokens, t).float() / temperature
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, tokens.long()[..., None])[..., 0].mean(dim=-1)

    total = one_time(times[0])
    for tp in times[1:]:
        total = total + one_time(tp)
    return total / len(times)


def make_quality_scorer(apply_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], *,
                        t_probe: float = 0.5, temperature: float = 1.0,
                        probe_times: Optional[Sequence[float]] = None,
                        device="cuda") -> Callable:
    """Build ``score(tokens (B, N)) -> (B,) mean per-token log-prob``, a
    float32 tensor on ``device``.

    ``apply_fn(tokens, t (B,)) -> logits (B, N, V)`` is the backbone's
    ``dfm_apply`` (the port's model holds its weights, so no ``params``).
    The probe asks the denoiser, at mid-path time ``t_probe``, how much mass
    its ``p1`` prediction keeps on the draft's own tokens. ``probe_times``
    (2-3 values, e.g. ``(0.3, 0.5, 0.7)``) replaces ``t_probe`` with a
    multi-time probe: the mean of the per-token log-prob over the times, one
    backbone evaluation each. ``tokens`` may be numpy or a tensor anywhere;
    they go to ``device`` first. The returned function keeps its CUDA
    graphs in ``score.graphs``.
    """
    times = tuple(float(t) for t in (probe_times if probe_times is not None else (t_probe,)))
    if not times:
        raise ValueError("probe_times must name at least one probe time")
    if any(not (0.0 < t < 1.0) for t in times):
        raise ValueError(f"probe times must lie in (0, 1), got {times}")
    dev = resolve_device(device)
    probe = functools.partial(_probe, apply_fn, times, float(temperature))
    graphs = GraphCache("the quality probe")

    def score(tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
        with torch.inference_mode():
            return graphs(tuple(tokens.shape), probe, tokens)

    score.graphs = graphs
    return score


@dataclasses.dataclass(frozen=True)
class T0Calibration:
    """Monotone piecewise-linear score -> t0 mapping.

    ``scores`` ascend; ``t0s`` are non-decreasing (higher likelihood ->
    deeper warm start). Outside the anchored range the mapping clamps to
    [t0_floor, t0_ceil].
    """

    scores: Tuple[float, ...]
    t0s: Tuple[float, ...]
    t0_floor: float = 0.0
    t0_ceil: float = 0.95

    def __post_init__(self):
        if len(self.scores) != len(self.t0s) or len(self.scores) < 2:
            raise ValueError("need >= 2 (score, t0) anchors")
        if list(self.scores) != sorted(self.scores):
            raise ValueError("anchor scores must ascend")
        if not (0.0 <= self.t0_floor <= self.t0_ceil < 1.0):
            raise ValueError(
                f"need 0 <= t0_floor <= t0_ceil < 1, got "
                f"[{self.t0_floor}, {self.t0_ceil}]")

    def t0_for_scores(self, scores) -> np.ndarray:
        s = np.asarray(scores, np.float64)
        t0 = np.interp(s, np.asarray(self.scores), np.asarray(self.t0s))
        return np.clip(t0, self.t0_floor, self.t0_ceil)

    def t0_for_score(self, score: float) -> float:
        return float(self.t0_for_scores([score])[0])


def fit_t0_calibration(scorer: Callable, data: np.ndarray, vocab_size: int, *,
                       tiers: Sequence[Tuple[float, float]] = DEFAULT_TIERS,
                       num_per_tier: int = 64, seed: int = 0,
                       t0_floor: Optional[float] = None,
                       t0_ceil: Optional[float] = None, device="cuda") -> T0Calibration:
    """Offline calibration from the corruption tiers (paper Fig. 4).

    For each (corruption_rate, target_t0) tier, corrupt ``num_per_tier``
    held-out rows at that rate (``CorruptionDraft`` on ``device``, keyed
    ``key(seed + i)`` as JAX's), run the probe, and anchor ``target_t0`` at
    the tier's mean score. Anchors are sorted by score and the t0 sequence
    made monotone, so a noisy probe can never produce an inverted mapping.
    """
    anchors = []
    for i, (rate, target_t0) in enumerate(tiers):
        draft = CorruptionDraft(data=data, vocab_size=vocab_size, corruption=rate,
                                device=device)
        x = draft.generate(prng.key(seed + i), num_per_tier)
        s = float(to_host(scorer(x)).mean())
        anchors.append((s, float(target_t0)))
    anchors.sort(key=lambda a: a[0])
    scores = [float(a[0]) for a in anchors]
    # enforce monotone non-decreasing t0 along ascending score
    t0s = [float(v) for v in np.maximum.accumulate([a[1] for a in anchors])]
    floor = min(t0s) if t0_floor is None else t0_floor
    ceil = max(t0s) if t0_ceil is None else t0_ceil
    return T0Calibration(scores=tuple(scores), t0s=tuple(t0s), t0_floor=floor, t0_ceil=ceil)


@dataclasses.dataclass(frozen=True)
class CostRatioReport:
    """Measured draft-vs-backbone timing (per generated batch)."""

    draft_time_s: float              # one draft-stage batch
    nfe_time_s: float                # one backbone evaluation + Euler step
    cost_ratio: float                # draft_time_s / nfe_time_s
    batch: int
    seq_len: int
    iters: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _block_until_ready(out) -> None:
    """Wait for the card to finish every CUDA tensor in ``out`` (a tensor or
    a tuple/list of them): synchronise the streams of their devices."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in items if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def _timed_best_of(fn, iters: int) -> float:
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_cost_ratio(draft_fn: Callable[[], torch.Tensor],
                       nfe_fn: Callable[[], torch.Tensor], *, batch: int, seq_len: int,
                       iters: int = 5, warmup: int = 1) -> CostRatioReport:
    """Measure ``draft_cost_ratio`` for :func:`guarantees.speedup_report`.

    ``draft_fn()`` must produce one draft batch, ``nfe_fn()`` one backbone
    function evaluation (+ Euler update) at the same (batch, seq_len). Both
    are warmed first, then timed best-of-``iters`` on the host clock, each
    call ended by waiting for the card (wall time, the quantity the
    guarantee accounting charges).
    """
    for _ in range(warmup):
        _block_until_ready(draft_fn())
        _block_until_ready(nfe_fn())
    draft_s = _timed_best_of(draft_fn, iters)
    nfe_s = _timed_best_of(nfe_fn, iters)
    return CostRatioReport(draft_time_s=draft_s, nfe_time_s=nfe_s,
                           cost_ratio=draft_s / max(nfe_s, 1e-12), batch=batch,
                           seq_len=seq_len, iters=iters)
