"""Online bandit selection of warm-start (t0, NFE) arms: port of the JAX
package's ``drafting/bandit.py``, host numpy like its original, so a
snapshot taken in either package restores in the other.

The calibrated lookup (:class:`repro_torch.drafting.policy.AdaptiveT0Policy`)
is static: a probe score maps to ONE t0 forever, so serving always pays
the calibrated refine cost even when the measured outcome says a deeper
(cheaper) entry would have refined just as well. FastFlow frames
per-request step-count selection as bandit inference with an online
reward; this module is that frame over the warm-start knob:

  * **contexts** are ``(bucket_len, score-bin)`` pairs — the probe score
    is discretised through the calibration onto the serving t0 bin grid,
    so the context count is bounded by (buckets x t0 bins) exactly like
    the jit cache;
  * **arms** are binned t0 values (each t0 IS an NFE via
    ``warm_nfe(cold_nfe, t0)``), restricted to ``t0 >= calibrated t0``
    for the context. The calibrated lookup is every context's floor arm,
    so the bandit can only ever spend FEWER refine steps than the static
    policy — the mean-NFE win is structural, and the paper's guarantee
    (exactly ``warm_nfe`` steps for the served t0) holds for every arm;
  * **reward** is fed by the same backbone-likelihood probe that scored
    the draft, re-run on the REFINED rows (the verify step of
    draft-and-verify), minus a measured-seconds cost term priced by the
    serving engine's per-NFE EWMA cost model — the bandit optimizes
    measured time, not a proxy;
  * the **prior** is conservative and seeded from the existing
    :class:`~repro_torch.drafting.quality.T0Calibration`: each context's
    calibrated arm starts with ``prior_weight`` pseudo-pulls at
    ``prior_reward``, so an unexplored bandit serves exactly the
    calibrated policy until evidence says a deeper arm is safe;
  * :meth:`snapshot` / :meth:`restore` round-trip the whole learning
    state through a JSON-able dict, so serving restarts don't reset the
    bandit to its prior.

:class:`BanditT0Policy` is protocol-compatible with
:class:`~repro_torch.drafting.policy.AdaptiveT0Policy` (``scores_and_t0``,
``t0_for_drafts``, ``t0_for_request``, and the ``calibration`` /
``bin_width`` / ``t0_floor`` attributes the scheduler reads), so the two
are interchangeable as ``WarmStartScheduler(t0_policy=...)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.drafting.policy import bin_t0
from repro_torch.drafting.quality import T0Calibration, to_host

# snapshot schema version (restore rejects unknown versions)
SNAPSHOT_VERSION = 1


def default_accept_score(calibration: T0Calibration) -> float:
    """Conservative speculative-acceptance threshold: the calibration's
    TOP anchor score (the mean probe score of the best corruption tier).
    A draft row must look at least as good as the pretty-good tier's
    average before it may ship with zero refine steps."""
    return float(calibration.scores[-1])


@dataclasses.dataclass
class _Arm:
    """Running mean reward for one (context, t0) arm."""

    count: float = 0.0
    value: float = 0.0

    def update(self, reward: float) -> None:
        self.count += 1.0
        self.value += (reward - self.value) / self.count


class BanditT0Policy:
    """Per-(bucket, score-bin) bandit over binned t0 arms.

    Args:
      scorer: ``tokens (B, N) -> (B,) scores`` — the same backbone
        likelihood probe the calibrated policy uses (1 NFE per batch).
      calibration: fitted score -> t0 mapping; seeds every context's
        conservative prior and bounds its arm range from below.
      bin_width / t0_floor: the serving t0 bin grid (identical semantics
        to :class:`~repro_torch.drafting.policy.AdaptiveT0Policy`).
      exploration: ``"ucb"`` (deterministic given state — the default,
        UCB1 with ``ucb_c``) or ``"epsilon"`` (epsilon-greedy over the
        context's arms, ``epsilon`` + ``seed``).
      prior_weight / prior_reward: pseudo-pulls seeding the CALIBRATED
        arm of each fresh context — the conservative prior.
      cost_weight: weight of the normalized measured-cost term in the
        reward (reward = quality_norm - cost_weight * cost_norm).
      accept_score: speculative acceptance threshold on the probe score;
        ``None`` derives :func:`default_accept_score` from the
        calibration.
    """

    def __init__(
        self,
        *,
        scorer: Callable,
        calibration: T0Calibration,
        bin_width: float = 0.05,
        t0_floor: float = 0.0,
        exploration: str = "ucb",
        ucb_c: float = 0.4,
        epsilon: float = 0.1,
        seed: int = 0,
        prior_weight: float = 4.0,
        prior_reward: float = 0.5,
        cost_weight: float = 0.5,
        accept_score: Optional[float] = None,
    ):
        if exploration not in ("ucb", "epsilon"):
            raise ValueError(
                f"exploration must be 'ucb' or 'epsilon', got "
                f"{exploration!r}")
        if bin_width <= 0.0:
            raise ValueError(
                f"bin_width must be > 0 for bandit arms, got {bin_width}")
        if not (0.0 <= epsilon <= 1.0):
            raise ValueError(f"epsilon must lie in [0, 1], got {epsilon}")
        self.scorer = scorer
        self.calibration = calibration
        self.bin_width = float(bin_width)
        self.t0_floor = float(t0_floor)
        self.exploration = exploration
        self.ucb_c = float(ucb_c)
        self.epsilon = float(epsilon)
        self.seed = int(seed)
        self.prior_weight = float(prior_weight)
        self.prior_reward = float(prior_reward)
        self.cost_weight = float(cost_weight)
        self.accept_score = (default_accept_score(calibration)
                             if accept_score is None else float(accept_score))
        # the deepest arm on the grid: the calibration ceiling, snapped
        # down — no arm may exceed what the calibration would ever grant
        self._ceil_k = self._grid_k(bin_t0(
            calibration.t0_ceil, width=self.bin_width, floor=self.t0_floor))
        # context -> {grid index k: _Arm}; contexts materialise lazily
        self._arms: Dict[Tuple[int, int], Dict[int, _Arm]] = {}
        self._accepts: Dict[Tuple[int, int], int] = {}
        self._selects: Dict[Tuple[int, int], int] = {}
        self._rng = np.random.default_rng(self.seed)
        # optional repro_torch.obs.MetricsRegistry (duck-typed): arm pulls,
        # reward updates and speculative accepts as labelled counters
        self._metrics = None

    def bind_metrics(self, registry) -> None:
        """Attach a metrics registry; the scheduler calls this so bandit
        arm pulls / updates / accepts surface in serving telemetry."""
        self._metrics = registry

    # ---- grid / context helpers -----------------------------------------

    def _grid_k(self, t0: float) -> int:
        """Grid index of a binned t0 (t0 == t0_floor + k * bin_width)."""
        return int(round((float(t0) - self.t0_floor) / self.bin_width))

    def _grid_t0(self, k: int) -> float:
        return self.t0_floor + k * self.bin_width

    def _base_k(self, score: float) -> int:
        """The context's floor arm: the calibrated lookup, binned."""
        cal_t0 = self.calibration.t0_for_score(float(score))
        return self._grid_k(bin_t0(
            cal_t0, width=self.bin_width, floor=self.t0_floor))

    def _context(self, bucket_len: int, score: float) -> Tuple[int, int]:
        return (int(bucket_len), self._base_k(score))

    def _context_arms(self, ctx: Tuple[int, int]) -> Dict[int, _Arm]:
        arms = self._arms.get(ctx)
        if arms is None:
            base_k = ctx[1]
            arms = {k: _Arm() for k in range(base_k,
                                             max(base_k, self._ceil_k) + 1)}
            # conservative prior: the calibrated arm starts ahead, so an
            # untrained bandit reproduces the calibrated policy
            arms[base_k] = _Arm(count=self.prior_weight,
                                value=self.prior_reward)
            self._arms[ctx] = arms
        return arms

    # ---- selection -------------------------------------------------------

    def _select_arm(self, ctx: Tuple[int, int]) -> int:
        arms = self._context_arms(ctx)
        self._selects[ctx] = self._selects.get(ctx, 0) + 1
        ks = sorted(arms)
        if self.exploration == "epsilon":
            if self._rng.random() < self.epsilon:
                return int(self._rng.choice(ks))
            # greedy; ties break toward the DEEPEST (cheapest) arm
            return max(ks, key=lambda k: (arms[k].value, k))
        # UCB1: untried arms first (deepest first — the cheap end of the
        # range is where the win is), then value + exploration bonus
        untried = [k for k in ks if arms[k].count <= 0.0]
        if untried:
            return max(untried)
        total = sum(arms[k].count for k in ks)
        return max(ks, key=lambda k: (
            arms[k].value
            + self.ucb_c * math.sqrt(math.log(total + 1.0) / arms[k].count),
            k))

    def select(self, bucket_len: int, scores) -> np.ndarray:
        """(B,) probe scores -> (B,) per-row t0 arms for ``bucket_len``."""
        out = np.empty((len(scores),), np.float64)
        for i, s in enumerate(np.asarray(scores, np.float64)):
            k = self._select_arm(self._context(bucket_len, s))
            out[i] = self._grid_t0(k)
            if self._metrics is not None:
                self._metrics.counter(
                    "bandit.arm_pulls", bucket=int(bucket_len),
                    t0=f"{self._grid_t0(k):.3f}").inc()
        return out

    # ---- policy protocol (interchangeable with AdaptiveT0Policy) ---------

    def scores_and_t0(self, tokens) -> Tuple[np.ndarray, np.ndarray]:
        """(B, N) draft tokens -> ((B,) probe scores, (B,) arm t0s).

        The bucket length is the tokens' own padded length — the pre-pass
        drafts at bucket length, so the context key needs no side channel.
        """
        scores = to_host(self.scorer(tokens)).astype(np.float64)
        return scores, self.select(int(np.shape(tokens)[1]), scores)

    def t0_for_drafts(self, tokens) -> np.ndarray:
        return self.scores_and_t0(tokens)[1]

    def t0_for_request(self, tokens) -> float:
        """Min over rows — the one-shot batch path's collapse (see
        :meth:`AdaptiveT0Policy.t0_for_request`)."""
        return float(self.t0_for_drafts(tokens).min())

    # ---- reward ----------------------------------------------------------

    def reward(self, *, quality_score: float,
               cost_norm: float) -> float:
        """Scalar reward: calibrated-range-normalized probe quality of
        the refined row minus the weighted normalized measured cost."""
        lo, hi = self.calibration.scores[0], self.calibration.scores[-1]
        span = max(hi - lo, 1e-9)
        q = min(1.0, max(0.0, (float(quality_score) - lo) / span))
        return q - self.cost_weight * min(1.0, max(0.0, float(cost_norm)))

    def update(self, bucket_len: int, draft_score: float, t0: float, *,
               quality_score: float, cost_norm: float) -> float:
        """Fold one refined row's outcome into its (context, arm).

        ``draft_score`` keys the context the arm was selected under;
        ``t0`` is the arm that served the row; ``quality_score`` is the
        probe re-run on the REFINED row; ``cost_norm`` is the row's
        measured refine seconds normalized by the cold-path cost (the
        scheduler prices it via ``PerNFECostModel.cost_for_nfe``).
        Returns the scalar reward that was applied.
        """
        ctx = self._context(bucket_len, draft_score)
        arms = self._context_arms(ctx)
        k = self._grid_k(t0)
        if k not in arms:
            # an explicit/foreign t0 outside the context's arm range
            # (e.g. a request-level override) carries no arm to credit
            return 0.0
        r = self.reward(quality_score=quality_score, cost_norm=cost_norm)
        arms[k].update(r)
        if self._metrics is not None:
            self._metrics.counter("bandit.updates").inc()
        return r

    def observe_accept(self, bucket_len: int, draft_score: float) -> None:
        """Count a speculative acceptance under this context (stats only
        — acceptance bypasses the arms entirely: 0 NFE, no refine to
        score)."""
        ctx = self._context(bucket_len, draft_score)
        self._context_arms(ctx)
        self._accepts[ctx] = self._accepts.get(ctx, 0) + 1
        if self._metrics is not None:
            self._metrics.counter("bandit.accepts").inc()

    # ---- introspection / persistence ------------------------------------

    def arm_stats(self) -> dict:
        """Per-context arm table for reports/benches: pull counts, mean
        rewards, accept/select counters, keyed by a readable label."""
        out = {}
        for ctx in sorted(self._arms):
            blen, base_k = ctx
            arms = self._arms[ctx]
            out[f"bucket={blen} t0_cal={self._grid_t0(base_k):.3f}"] = {
                "selects": self._selects.get(ctx, 0),
                "accepts": self._accepts.get(ctx, 0),
                "arms": {
                    f"{self._grid_t0(k):.3f}": {
                        "count": round(arms[k].count, 6),
                        "value": round(arms[k].value, 6),
                    } for k in sorted(arms)
                },
            }
        return out

    def snapshot(self) -> dict:
        """JSON-able learning state (arms, counters, exploration RNG)."""
        return {
            "version": SNAPSHOT_VERSION,
            "exploration": self.exploration,
            "bin_width": self.bin_width,
            "t0_floor": self.t0_floor,
            "ceil_k": self._ceil_k,
            "contexts": [
                {
                    "bucket_len": ctx[0],
                    "base_k": ctx[1],
                    "selects": self._selects.get(ctx, 0),
                    "accepts": self._accepts.get(ctx, 0),
                    "arms": [
                        {"k": k, "count": arm.count, "value": arm.value}
                        for k, arm in sorted(self._arms[ctx].items())
                    ],
                }
                for ctx in sorted(self._arms)
            ],
            "rng_state": self._rng.bit_generator.state,
        }

    def restore(self, snap: dict) -> None:
        """Restore a :meth:`snapshot` (serving restarts keep learning).

        The snapshot must come from a policy on the SAME t0 grid — a
        changed ``bin_width`` / ``t0_floor`` would silently remap every
        arm, so that is rejected instead.
        """
        if snap.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"unknown bandit snapshot version {snap.get('version')!r} "
                f"(expected {SNAPSHOT_VERSION})")
        if (not math.isclose(snap["bin_width"], self.bin_width)
                or not math.isclose(snap["t0_floor"], self.t0_floor)):
            raise ValueError(
                f"snapshot grid (width={snap['bin_width']}, "
                f"floor={snap['t0_floor']}) does not match this policy "
                f"(width={self.bin_width}, floor={self.t0_floor})")
        self._arms = {}
        self._selects = {}
        self._accepts = {}
        for entry in snap["contexts"]:
            ctx = (int(entry["bucket_len"]), int(entry["base_k"]))
            self._arms[ctx] = {
                int(a["k"]): _Arm(count=float(a["count"]),
                                  value=float(a["value"]))
                for a in entry["arms"]
            }
            if entry.get("selects"):
                self._selects[ctx] = int(entry["selects"])
            if entry.get("accepts"):
                self._accepts[ctx] = int(entry["accepts"])
        rng_state = snap.get("rng_state")
        if rng_state is not None:
            self._rng = np.random.default_rng(self.seed)
            self._rng.bit_generator.state = rng_state
