"""Coupling distributions Q(x_src, x_tgt) for (warm-start) flow matching: a
numpy copy of the JAX package's ``core/coupling.py`` (which is numpy-only;
the port keeps its own copy). The same ``np.random.Generator`` gives the
same pairs, array for array.

The paper replaces the independent coupling ``Q(x0, x1) = P0(x0) P1(x1)``
with a *refinement* coupling ``Q(x_t0, x1) = P_t0(x_t0) P_refine(x1 |
x_t0)``:

  * text: an oracle rewrites the draft (offline: a rule-based normaliser,
    ``data/text.py`` ``WordOracle``);
  * images / generic: k-nearest-neighbour retrieval in the training set
    (Euclidean in token/pixel space), as the paper does for CIFAR-10
    (§4.3);
  * marginal repair: k' random data samples per draft, so that Q(x1)
    mixes toward P1 (paper footnote 2).

Pair building is host-side data preparation, as in the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]  # (x_src, x_tgt), each (N,) int


@dataclasses.dataclass
class IndependentCoupling:
    """Baseline DFM coupling: noise source, independent data target."""

    vocab_size: int
    seq_len: int

    def build(self, data: np.ndarray, drafts: Optional[np.ndarray], rng: np.random.Generator):
        n = data.shape[0]
        src = rng.integers(0, self.vocab_size, size=(n, self.seq_len), dtype=np.int32)
        return src, data.astype(np.int32)


@dataclasses.dataclass
class KNNRefinementCoupling:
    """Paper §4.3: each draft paired with its k nearest data neighbours plus
    k' random data injections (marginal repair). Euclidean distance in the
    raw token/pixel space; a subsample of candidates bounds the O(drafts x
    data) cost."""

    k: int = 5
    k_inject: int = 5
    max_candidates: int = 20000
    chunk: int = 256

    def build(self, data: np.ndarray, drafts: np.ndarray, rng: np.random.Generator):
        """Returns (src, tgt) arrays of shape (num_pairs, N)."""
        if drafts is None:
            raise ValueError("KNN refinement needs draft samples")
        cand_idx = rng.choice(data.shape[0], size=min(self.max_candidates, data.shape[0]),
                              replace=False)
        cand = data[cand_idx].astype(np.float32)
        cand_sq = (cand * cand).sum(-1)

        srcs, tgts = [], []
        for s in range(0, drafts.shape[0], self.chunk):
            d = drafts[s : s + self.chunk].astype(np.float32)
            # ||d - c||^2 = d^2 - 2 d.c + c^2
            d2 = (d * d).sum(-1, keepdims=True) - 2.0 * d @ cand.T + cand_sq[None]
            nn = np.argpartition(d2, self.k, axis=-1)[:, : self.k]
            for row in range(d.shape[0]):
                draft_row = drafts[s + row].astype(np.int32)
                for j in nn[row]:
                    srcs.append(draft_row)
                    tgts.append(data[cand_idx[j]].astype(np.int32))
                # marginal repair: k' random data targets for the same draft
                for j in rng.integers(0, data.shape[0], size=self.k_inject):
                    srcs.append(draft_row)
                    tgts.append(data[j].astype(np.int32))
        return np.stack(srcs), np.stack(tgts)


@dataclasses.dataclass
class OracleRefinementCoupling:
    """Text-domain refinement: an oracle maps draft -> refined sequence;
    ``inject_prob`` mixes raw data samples into the target marginal
    (footnote 2)."""

    oracle: Callable[[np.ndarray], np.ndarray]  # (B, N) -> (B, N)
    inject_prob: float = 0.1

    def build(self, data: np.ndarray, drafts: np.ndarray, rng: np.random.Generator):
        refined = self.oracle(drafts).astype(np.int32)
        n = drafts.shape[0]
        inject = rng.random(n) < self.inject_prob
        tgt = refined.copy()
        repl = rng.integers(0, data.shape[0], size=int(inject.sum()))
        tgt[inject] = data[repl].astype(np.int32)
        return drafts.astype(np.int32), tgt


def pair_iterator(src: np.ndarray, tgt: np.ndarray, batch_size: int,
                  rng: np.random.Generator, *, drop_last: bool = True) -> Iterator[Pair]:
    """Shuffled epoch-looping iterator over coupled pairs."""
    n = src.shape[0]
    if tgt.shape[0] != n:
        raise ValueError(f"src has {n} pairs, tgt {tgt.shape[0]}")
    while True:
        order = rng.permutation(n)
        for s in range(0, n - (batch_size if drop_last else 0) + 1, batch_size):
            idx = order[s : s + batch_size]
            if len(idx) == 0:
                break
            yield src[idx], tgt[idx]
