"""Row-keyed draft-stage generators (port of ``uniform_draft``,
``corruption_draft`` and ``batch_keyed_draft`` of the JAX package's
``serving/drafts.py``).

Contract: ``draft_fn(keys (B, 2), seq_len) -> tokens (B, seq_len)`` int32,
where row ``b`` depends only on ``keys[b]``; the draws are
``jax.random``'s for those keys (``repro_torch.prng``), so both packages
draft the same tokens from the same keys. The AR draft model is
``repro_torch.drafting.ARDraftEngine.generate_rows``.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device


def uniform_draft(vocab_size: int, *, device="cuda") -> Callable:
    """Uniform-noise draft (the cold-start initial distribution)."""
    dev = resolve_device(device)

    def draft(keys: torch.Tensor, seq_len: int) -> torch.Tensor:
        return prng.randint(keys, (seq_len,), 0, vocab_size, device=dev)

    return draft


def corruption_draft(data, vocab_size: int, corruption: float = 0.25, *,
                     device="cuda") -> Callable:
    """Corpus-row + token-corruption draft (the demo stand-in for a
    lightweight AR draft model). ``data`` (rows, L) must be at least as
    long in the sequence dim as the largest bucket served."""
    dev = resolve_device(device)
    data = torch.as_tensor(np.asarray(data), dtype=torch.int32, device=dev)

    def draft(keys: torch.Tensor, seq_len: int) -> torch.Tensor:
        if seq_len > data.shape[1]:
            raise ValueError(f"bucket seq_len {seq_len} exceeds draft corpus length "
                             f"{data.shape[1]}")
        sub = prng.split(keys, 3)
        idx = prng.randint(sub[..., 0, :], (), 0, data.shape[0], device=dev)
        rows = data[idx.long(), :seq_len]
        noise = prng.randint(sub[..., 1, :], (seq_len,), 0, vocab_size, device=dev)
        flip = prng.uniform(sub[..., 2, :], (seq_len,), device=dev) < corruption
        return torch.where(flip, noise, rows)

    return draft


class BatchKeyedDraftWarning(UserWarning):
    """A batch-keyed draft was adapted into the row-keyed contract —
    per-request determinism is NOT guaranteed (see
    :func:`batch_keyed_draft`)."""


def batch_keyed_draft(generate: Callable, *, warn: bool = True) -> Callable:
    """Adapt a batch-keyed generator ``(key, num, seq_len) -> (num, L)`` to
    the row-keyed contract.

    **This drops the per-request determinism guarantee**: the whole batch
    is keyed off the FIRST row's key, so a row's tokens change with its
    neighbours and its position in the batch. A
    :class:`BatchKeyedDraftWarning` is emitted once per adapted draft on
    first use (silence with ``warn=False``). For a row-keyed AR draft use
    :class:`repro_torch.drafting.ARDraftEngine` instead.
    """
    warned = []

    def draft(keys: torch.Tensor, seq_len: int) -> torch.Tensor:
        if warn and not warned:
            warned.append(True)
            warnings.warn(
                "batch_keyed_draft: drafts are keyed off the first row's key — outputs "
                "are NOT invariant to micro-batch packing (per-request determinism is "
                "lost). Use a row-keyed draft (e.g. repro_torch.drafting.ARDraftEngine."
                "as_draft_fn()) for request-seeded serving.",
                BatchKeyedDraftWarning, stacklevel=2)
        return generate(keys[0], keys.shape[0], seq_len)

    return draft
