"""JAX parameters -> the torch ``Model``'s state dict, and the LSTM's tree.

The JAX package checkpoints a parameter tree as a flat numpy dict keyed by
``|``-joined tree paths (``checkpoint/io.py::_flatten``, the layout of its
``arrays.npz``). Layer weights there are stacked along a leading axis per
pattern position (``stack|blocks|p0|attn|wq|w`` is ``(L, d, H*hd)``); the
torch model keeps one module per layer, in the order the JAX stack runs
them: repeat ``r`` of the scanned group, pattern position ``p``, then the
remainder layers ``stack|rem|r{j}|...`` (unstacked).

Every other leaf maps by name: biases (``...|wq|b``), the gated MLP's
``mlp|gate|w`` and norms without a bias (rmsnorm: ``scale`` only) have
torch parameters of the same path. A tied-embedding config has no
``head`` leaf and no torch ``head``: both read the embedding table.

The LSTM draft (``models/lstm.py``) is functional in both packages: its
flat leaves ``embed|table``, ``layers|{i}|wx|w``, ``layers|{i}|wh|w`` and
``head|w`` become the same tree of torch tensors.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

_BLOCK = re.compile(r"^stack\|blocks\|p(\d+)\|(.+)$")
_LSTM_LAYER = re.compile(r"^layers\|(\d+)\|(wx|wh)\|w$")
_REM = re.compile(r"^stack\|rem\|r(\d+)\|(.+)$")


def jax_params_to_torch(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"a|b|c": array}`` -> ``{"a.b.c": tensor}`` for ``Model.load_state_dict``.

    Layer ``r * P + p`` of the torch stack is repeat ``r`` of pattern
    position ``p`` (P positions, R repeats); remainder layer ``j`` is layer
    ``R * P + j``. Prefix-layer leaves (``stack|pre|...``) raise: the port
    runs no config that has them.
    """
    block_leaves = {m.group(1): np.asarray(flat[m.string]).shape[0]
                    for m in map(_BLOCK.match, flat) if m}
    n_pattern = len(block_leaves)
    n_stacked = n_pattern * max(block_leaves.values(), default=0)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        m, rem = _BLOCK.match(name), _REM.match(name)
        if m is not None:
            pos, rest = int(m.group(1)), m.group(2).replace("|", ".")
            for r in range(arr.shape[0]):
                out[f"blocks.{r * n_pattern + pos}.{rest}"] = torch.from_numpy(arr[r].copy())
        elif rem is not None:
            layer = n_stacked + int(rem.group(1))
            out[f"blocks.{layer}.{rem.group(2).replace('|', '.')}"] = torch.from_numpy(arr.copy())
        elif name.startswith("stack|"):
            raise KeyError(f"stack leaf {name} has no counterpart in the torch model")
        else:
            out[name.replace("|", ".")] = torch.from_numpy(arr.copy())
    return out



def jax_lstm_params_to_torch(flat: Mapping[str, np.ndarray], *, device="cuda") -> dict:
    """``{"embed|table", "layers|i|wx|w", "layers|i|wh|w", "head|w"}`` -> the
    ``LSTMModel`` parameter tree on ``device``. Any other leaf raises."""
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.array(flat[name], dtype=np.float32)).to(dev)

    layer_ids = set()
    for name in flat:
        m = _LSTM_LAYER.match(name)
        if m is not None:
            layer_ids.add(int(m.group(1)))
        elif name not in ("embed|table", "head|w"):
            raise KeyError(f"leaf {name} has no counterpart in the torch LSTM")
    if layer_ids != set(range(len(layer_ids))):
        raise KeyError(f"LSTM layers {sorted(layer_ids)} are not 0..n-1")
    return {"embed": {"table": t("embed|table")},
            "layers": [{"wx": {"w": t(f"layers|{i}|wx|w")}, "wh": {"w": t(f"layers|{i}|wh|w")}}
                       for i in range(len(layer_ids))],
            "head": {"w": t("head|w")}}
