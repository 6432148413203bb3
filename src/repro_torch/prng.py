"""JAX's threefry2x32 PRNG, in torch, bit for bit.

The port keys every random draw exactly as the JAX package does, so the
same seed gives the same drafts, the same per-step keys and the same
Gumbel noise on both sides. This module copies the key operations of
``jax.random`` under the default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (the default from jax 0.5 on):

* a key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
  key words (``key_data`` of the JAX key); leading dims batch keys the
  way ``jax.vmap`` would;
* ``split(k, n)[i] = threefry(k, (0, i))`` and
  ``fold_in(k, d) = threefry(k, (0, d))``;
* ``random_bits(k, shape)`` hashes the flat index ``i`` of each element
  as the counter ``(0, i)`` and xors the two output words.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF`` after every
add and shift. Keys and the scheduling of keys live on the host; bits
for a draw are made on the ``device`` the draw is for.

``threefry2x32``, ``gumbel_from_bits`` and ``threefry_gumbel`` also copy
the counter-based noise of the ``ws_step`` kernel
(``repro/kernels/ws_step/kernel.py``), which the CUDA kernel computes
in-kernel from the same words.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def _round4(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, r)
        x1 = x0 ^ x1
    return x0, x1


def threefry2x32(k0: Word, k1: Word, c0: Word, c1: Word) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry-2x32 (20 rounds, JAX's parameterisation) on uint32 words
    held in int64 tensors; broadcasts like torch arithmetic. Returns the
    two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    c0 = torch.as_tensor(c0, dtype=torch.int64)
    c1 = torch.as_tensor(c1, dtype=torch.int64)
    ks2 = k0 ^ k1 ^ _KS_PARITY
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    x0, x1 = _round4(x0, x1, _ROTATIONS[0])
    x0 = (x0 + k1) & MASK
    x1 = (x1 + ks2 + 1) & MASK
    x0, x1 = _round4(x0, x1, _ROTATIONS[1])
    x0 = (x0 + ks2) & MASK
    x1 = (x1 + k0 + 2) & MASK
    x0, x1 = _round4(x0, x1, _ROTATIONS[0])
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1 + 3) & MASK
    x0, x1 = _round4(x0, x1, _ROTATIONS[1])
    x0 = (x0 + k1) & MASK
    x1 = (x1 + ks2 + 4) & MASK
    x0, x1 = _round4(x0, x1, _ROTATIONS[0])
    x0 = (x0 + ks2) & MASK
    x1 = (x1 + k0 + 5) & MASK
    return x0, x1


# -- keys ----------------------------------------------------------------------

def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` as its key data ``(2,)``.

    With 64-bit mode off JAX takes the seed as an int32, so the high word
    is 0 and the low word is the seed's two's-complement bits."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & MASK], dtype=torch.int64)


def key_data(keys: torch.Tensor) -> torch.Tensor:
    """The uint32 key words ``(..., 2)`` (a key already is its data)."""
    if keys.shape[-1:] != (2,):
        raise ValueError(f"keys must have trailing dim 2, got {tuple(keys.shape)}")
    return keys


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2) -> (..., num, 2)``."""
    ctr = torch.arange(num, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, ctr)
    return torch.stack([x0, x1], dim=-1)


def fold_in(keys: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in`` (data taken as uint32); broadcasts over a
    batch of keys and a batch of data like ``vmap(fold_in)``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1], 0, d)
    return torch.stack([x0, x1], dim=-1)


# -- bits and the samplers built on them ----------------------------------------

def random_bits(keys: torch.Tensor, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element: ``keys.shape[:-1] + shape`` int64."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("random bits arrays of 2**32 elements or more")
    device = keys.device if device is None else torch.device(device)
    ctr = torch.arange(n, dtype=torch.int64, device=device)
    if keys.shape == (2,) and keys.device.type == "cpu":
        # one host key: its words enter the hash as integers, with no copy to
        # ``device`` (a blocking host-to-card copy waits for the stream: once
        # per refine step on the default Euler step)
        x0, x1 = threefry2x32(int(keys[0]), int(keys[1]), 0, ctr)
        return (x0 ^ x1).reshape(shape)
    keys = keys.to(device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(lead + (1,))
    k1 = keys[..., 1].reshape(lead + (1,))
    x0, x1 = threefry2x32(k0, k1, 0, ctr)
    return (x0 ^ x1).reshape(lead + shape)


_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """23 mantissa bits under exponent 0: a float32 in [0, 1)."""
    fb = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, *, device=None) -> torch.Tensor:
    """``jax.random.uniform`` for float32."""
    f = _bits_to_unit_float(random_bits(keys, shape, device))
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # XLA fuses f * span + lo into one FMA: the float32 product is exact in
    # float64, so one rounding of the float64 sum to float32 matches it
    return torch.clamp_min((f.double() * span + lo).float(), lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int], *, device=None) -> torch.Tensor:
    """``jax.random.gumbel`` for float32 (its default "low" mode)."""
    u = uniform(keys, shape, _F32_TINY, 1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the first argmax of
    ``gumbel(key, ...) + logits``. One key ``(2,)`` draws the noise for all
    of ``logits`` at once; keys ``(B, 2)`` key row ``b`` of ``logits (B,
    V)`` by ``keys[b]``, like ``vmap(categorical)``. int64 indices."""
    noise = gumbel(keys, logits.shape[keys.ndim - 1:], device=logits.device)
    return torch.argmax(noise + logits, dim=-1)


def randint(keys: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
            *, device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds and results."""
    for bound in (minval, maxval):
        if not -(1 << 31) <= int(bound) < (1 << 31):
            raise ValueError(f"randint bounds must fit in int32, got {bound}")
    sub = split(keys, 2)
    hi = random_bits(sub[..., 0, :], shape, device)
    lo = random_bits(sub[..., 1, :], shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span      # uint32 product, as JAX wraps it
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + off % span).to(torch.int32)


# -- the ws_step kernel's counter-based noise ------------------------------------

_F32_BELOW_ONE = 1.0 - 2.0 ** -24


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> standard Gumbel(0, 1) float32, u strictly in (0, 1).

    ``(bits >> 8) + 0.5`` rounds to 2**24 in float32 when ``bits >> 8`` is
    0xFFFFFF, so u would be 1 and the noise +inf, as the JAX package's
    ``gumbel_from_bits`` gives it (once in 2**24 elements; such a column
    wins the draw whatever the mixing weight). u is clamped at the largest
    float32 below 1, which changes that element only."""
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(torch.clamp_max(u, _F32_BELOW_ONE)))


def threefry_gumbel(seed: Tuple[int, int], rows: int, cols: int, *,
                    device=None) -> torch.Tensor:
    """The ``ws_step`` kernel's noise: Gumbel of ``threefry(seed, (row,
    col))``'s first word, keyed by absolute coordinates. ``(rows, cols)``
    float32."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    bits, _ = threefry2x32(int(seed[0]) & MASK, int(seed[1]) & MASK, r, c)
    return gumbel_from_bits(bits)
