"""Toy image substrate (CIFAR-10 analog at CPU scale): 8x8 grayscale
shape images (disks / squares / crosses with intensity gradients + noise),
8-bit tokenised exactly like the paper's §4.3 (each pixel = one token,
vocab 256), rasterised row-major into 64-token sequences.
(a numpy copy of the JAX package's ``data/images.py``)

Includes a Fréchet-distance FID proxy on mean/covariance of pixel features.
"""

from __future__ import annotations

import numpy as np

RES = 8
SEQ = RES * RES
VOCAB = 256


def _disk(rng):
    yy, xx = np.mgrid[0:RES, 0:RES]
    cy, cx = rng.uniform(2.5, 4.5, 2)
    r = rng.uniform(1.8, 3.2)
    img = np.clip(1.2 - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / r, 0, 1)
    return img


def _square(rng):
    img = np.zeros((RES, RES))
    s = rng.integers(3, 6)
    y0 = rng.integers(0, RES - s)
    x0 = rng.integers(0, RES - s)
    img[y0 : y0 + s, x0 : x0 + s] = rng.uniform(0.6, 1.0)
    return img


def _cross(rng):
    img = np.zeros((RES, RES))
    c = rng.integers(2, 6)
    w = rng.uniform(0.5, 1.0)
    img[c - 1 : c + 1, :] = w
    img[:, c - 1 : c + 1] = w * 0.8
    return img


def images_dataset(n: int, seed: int = 0) -> np.ndarray:
    """(n, 64) int32 token sequences."""
    rng = np.random.default_rng(seed)
    kinds = [_disk, _square, _cross]
    out = np.empty((n, SEQ), np.int32)
    for i in range(n):
        img = kinds[int(rng.integers(0, 3))](rng)
        grad = np.linspace(0, rng.uniform(0, 0.3), RES)[None, :]
        img = np.clip(img * rng.uniform(0.7, 1.0) + grad + rng.normal(0, 0.03, img.shape), 0, 1)
        out[i] = np.floor(img * 255.999).astype(np.int32).reshape(-1)
    return out


def frechet_distance(a: np.ndarray, b: np.ndarray) -> float:
    """FID proxy: Fréchet distance between Gaussians fit to raw pixel
    vectors (float in [0,1])."""
    fa = a.astype(np.float64) / 255.0
    fb = b.astype(np.float64) / 255.0
    mu_a, mu_b = fa.mean(0), fb.mean(0)
    ca = np.cov(fa, rowvar=False) + 1e-6 * np.eye(fa.shape[1])
    cb = np.cov(fb, rowvar=False) + 1e-6 * np.eye(fb.shape[1])
    diff = mu_a - mu_b
    # trace term via eigendecomposition of ca @ cb
    eig = np.linalg.eigvals(ca @ cb)
    covmean_tr = np.sum(np.sqrt(np.maximum(eig.real, 0)))
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2 * covmean_tr)
