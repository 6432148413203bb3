"""Plain PyTorch version of the K-step fused warm-start draw: K composed
plain single steps (``ws_step_ref_streamed``) on one frozen logits
buffer, each step's tokens feeding the next.

The noise is the kernel's counter-based threefry (``prng.threefry2x32``,
word 0, through ``prng.gumbel_from_bits``). Row ``r`` draws step ``j``
with the key words ``seeds[j, r // key_group]`` and the counter
``(r % key_group, col)``:

* single key (``key_group = R``, seeds ``(K, 1, 2)``): the counter is
  the absolute ``(row, col)``, so step ``j`` is ``prng.threefry_gumbel``
  of ``seeds[j]``, as one ``ws_step`` call draws it;
* per row (``key_group = N``, seeds ``(K, B, 2)``): the counter is
  ``(position within the request, col)``, as the JAX package's
  ``ws_fused/ops.py`` lays it out, so a request's draw does not depend on
  where it sits in the batch.

``a (K, R // a_group)`` is each step's mixing weight; ``a = 0`` freezes a
row. There is no row padding (the kernel runs one warp per row).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.kernels.ws_step.ref import near_tie_rows, ws_step_ref_streamed


def fused_noise(seeds: torch.Tensor, rows: int, vocab: int, key_group: int) -> torch.Tensor:
    """One step's noise ``(rows, vocab)`` from its key words ``(G, 2)``,
    ``G = rows // key_group`` (with one key, ``prng.threefry_gumbel``)."""
    dev = seeds.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)
    kw = (seeds & prng.MASK)[r // key_group]                    # (R, 2)
    c0 = (r % key_group)[:, None]
    col = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    bits, _ = prng.threefry2x32(kw[:, 0:1], kw[:, 1:2], c0, col)
    return prng.gumbel_from_bits(bits)


def ws_fused_ref(seeds: torch.Tensor, logits: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                 *, key_group: int, a_group: int, temperature: float = 1.0,
                 tie_tol: Optional[float] = None):
    """K draws: ``seeds (K, G, 2)`` int64 key words, ``logits (R, V)``,
    ``x (R,)``, ``a (K, R // a_group)``. Returns ``(R,)`` int32; with
    ``tie_tol``, also the rows that met a near tie at any step on this
    path (``ws_step.ref.near_tie_rows``), where another correct summation
    order may take another branch."""
    rows, vocab = logits.shape
    r = torch.arange(rows, device=logits.device)
    x = x.to(torch.int32)
    ties = torch.zeros(rows, dtype=torch.bool, device=logits.device)
    for j in range(seeds.shape[0]):
        g = fused_noise(seeds[j].to(logits.device), rows, vocab, key_group)
        aj = a[j][r // a_group]
        if tie_tol is not None:
            ties |= near_tie_rows(logits, x, aj, g, temperature=temperature, tol=tie_tol)
        x = ws_step_ref_streamed(logits, x, aj, g, temperature=temperature)
    return x if tie_tol is None else (x, ties)
