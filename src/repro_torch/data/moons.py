"""Two-moons on a 128x128 integer grid — the paper's §4.1 setting, exactly:
state x = (x^1, x^2), N=2 tokens, vocab V=128 per token.
(a numpy copy of the JAX package's ``data/moons.py``)

Includes the paper's evaluation metric (symmetric KL between the empirical
2-D histograms of generated and true samples) and the three contrived
draft-model quality tiers of Fig. 4(c-e).
"""

from __future__ import annotations

import numpy as np


def sample_moons(n: int, rng: np.random.Generator, noise: float = 0.06) -> np.ndarray:
    """Continuous two-moons in [-1.5, 2.5] x [-1, 1.5]-ish."""
    n1 = n // 2
    n2 = n - n1
    th1 = rng.uniform(0, np.pi, n1)
    th2 = rng.uniform(0, np.pi, n2)
    x1 = np.stack([np.cos(th1), np.sin(th1)], -1)
    x2 = np.stack([1.0 - np.cos(th2), 0.5 - np.sin(th2)], -1)
    pts = np.concatenate([x1, x2], 0)
    pts = pts + rng.normal(0, noise, pts.shape)
    rng.shuffle(pts)
    return pts


def quantize(pts: np.ndarray, grid: int = 128) -> np.ndarray:
    """Map continuous points to integer grid tokens in [0, grid)."""
    lo = np.array([-1.6, -1.2])
    hi = np.array([2.6, 1.7])
    q = np.floor((pts - lo) / (hi - lo) * grid).astype(np.int32)
    return np.clip(q, 0, grid - 1)


def moons_dataset(n: int, seed: int = 0, grid: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return quantize(sample_moons(n, rng), grid)


def draft_tier_dataset(n: int, tier: str, seed: int = 0, grid: int = 128) -> np.ndarray:
    """The paper's three contrived draft models (Fig. 4c-e):
    'pretty_good' — near-data with small jitter;
    'fair'        — data blurred with larger jitter + 20% uniform;
    'poor'        — heavy blur + 50% uniform noise."""
    rng = np.random.default_rng(seed + 99)
    base = quantize(sample_moons(n, rng), grid)
    u = rng.integers(0, grid, size=base.shape, dtype=np.int32)
    if tier == "pretty_good":
        jit = rng.integers(-3, 4, base.shape)
        out = np.clip(base + jit, 0, grid - 1)
        mask = rng.random(base.shape) < 0.02
    elif tier == "fair":
        jit = rng.integers(-10, 11, base.shape)
        out = np.clip(base + jit, 0, grid - 1)
        mask = rng.random(base.shape) < 0.2
    elif tier == "poor":
        jit = rng.integers(-25, 26, base.shape)
        out = np.clip(base + jit, 0, grid - 1)
        mask = rng.random(base.shape) < 0.5
    else:
        raise ValueError(tier)
    return np.where(mask, u, out).astype(np.int32)


def symmetric_kl(samples_a: np.ndarray, samples_b: np.ndarray,
                 grid: int = 128, smoothing: float = 0.5,
                 bins: int = 32) -> float:
    """Paper Table 1 metric: SKL between coarse 2-D histograms."""
    def hist(s):
        h, _, _ = np.histogram2d(
            s[:, 0], s[:, 1], bins=bins, range=[[0, grid], [0, grid]]
        )
        h = h + smoothing
        return h / h.sum()

    pa, pb = hist(samples_a), hist(samples_b)
    return float(np.sum(pa * np.log(pa / pb)) + np.sum(pb * np.log(pb / pa)))
