"""JAX parameters -> the torch ``Model``'s state dict.

The JAX package checkpoints a parameter tree as a flat numpy dict keyed by
``|``-joined tree paths (``checkpoint/io.py::_flatten``, the layout of its
``arrays.npz``). Layer weights there are stacked along a leading axis per
pattern position (``stack|blocks|p0|attn|wq|w`` is ``(L, d, H*hd)``); the
torch model keeps one module per layer, in the order the JAX stack runs
them: repeat ``r`` of the scanned group, pattern position ``p``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^stack\|blocks\|p(\d+)\|(.+)$")


def jax_params_to_torch(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"a|b|c": array}`` -> ``{"a.b.c": tensor}`` for ``Model.load_state_dict``.

    Layer ``r * P + p`` of the torch stack is repeat ``r`` of pattern
    position ``p`` (P positions); the port's configs have no prefix or
    remainder layers, whose leaves raise.
    """
    n_pattern = len({m.group(1) for m in map(_BLOCK.match, flat) if m})
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        m = _BLOCK.match(name)
        if m is None:
            if name.startswith("stack|"):
                raise KeyError(f"stack leaf {name} has no counterpart in the torch model")
            out[name.replace("|", ".")] = torch.from_numpy(arr.copy())
            continue
        pos, rest = int(m.group(1)), m.group(2).replace("|", ".")
        for r in range(arr.shape[0]):
            out[f"blocks.{r * n_pattern + pos}.{rest}"] = torch.from_numpy(arr[r].copy())
    return out
