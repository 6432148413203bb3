"""JAX parameters <-> the torch ``Model``'s state dict, and the LSTM's tree.

The JAX package checkpoints a parameter tree as a flat numpy dict keyed by
``|``-joined tree paths (``checkpoint/io.py::_flatten``, the layout of its
``arrays.npz``). Layer weights there are stacked along a leading axis per
pattern position (``stack|blocks|p0|attn|wq|w`` is ``(L, d, H*hd)``); the
torch model keeps one module per layer, in the order the JAX stack runs
them: the prefix layers ``stack|pre|x{j}|...``, then repeat ``r`` of the
scanned group, pattern position ``p`` (Gemma3's six positions are
``p0``-``p5``), then the remainder layers ``stack|rem|r{j}|...``
(prefix and remainder unstacked). Zamba2's shared block
``stack|zshared|...`` (one copy, unstacked) is the model's ``zshared``
module; its per-layer ``fuse`` and unused ``ln1`` are ordinary layer leaves.
The recurrent kinds' leaves (``mamba|a_log``, ``mlstm|wq``,
``slstm|r_gates``, ...) map by name like the rest, and so do MLA's
(``attn|wq_a|w``, ``attn|q_norm|scale``, ``attn|wkv_b|w``, ...) and an MoE
layer's shared expert (``moe|shared|up|w``, ...).

Every other leaf maps by name: biases (``...|wq|b``), the gated MLP's
``mlp|gate|w``, norms without a bias (rmsnorm: ``scale`` only), qk-norm's
``attn|qnorm|scale``/``attn|knorm|scale`` and the post-norms
``post_attn``/``post_ffn`` have torch parameters of the same path. A tied-embedding config has no
``head`` leaf and no torch ``head``: both read the embedding table.

The encoder-decoder (``EncDecModel``) stacks its two block lists along
the layer axis: ``enc_blocks|attn|wq|w`` is ``(L_enc, d, H*hd)``, slice
``i`` the torch ``enc_blocks.{i}.attn.wq.w``, and ``dec_blocks|...`` the
same for ``dec_blocks.{i}``; ``enc_norm``, ``dec_norm``, ``time`` and
``embed`` map by name.

The LSTM draft (``models/lstm.py``) is functional in both packages: its
flat leaves ``embed|table``, ``layers|{i}|wx|w``, ``layers|{i}|wh|w`` and
``head|w`` become the same tree of torch tensors.

The other way, :func:`torch_params_to_jax` stacks the layers back into the
JAX leaves (checkpoints the JAX package restores), and :func:`jax_leaves`
groups the model's parameters by JAX leaf, in JAX's leaf order, for the
optimizers and the global norm.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_BLOCK = re.compile(r"^stack\|blocks\|p(\d+)\|(.+)$")
_LSTM_LAYER = re.compile(r"^layers\|(\d+)\|(wx|wh)\|w$")
_REM = re.compile(r"^stack\|rem\|r(\d+)\|(.+)$")
_PRE = re.compile(r"^stack\|pre\|x(\d+)\|(.+)$")
_TORCH_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")
_ENCDEC = re.compile(r"^(enc_blocks|dec_blocks)\|(.+)$")       # JAX, stacked by layer
_TORCH_ENCDEC = re.compile(r"^(enc_blocks|dec_blocks)\.(\d+)\.(.+)$")
_SHARED = "stack|zshared|"        # JAX's shared-block leaves; the torch ``zshared.``


def jax_params_to_torch(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"a|b|c": array}`` -> ``{"a.b.c": tensor}`` for ``Model.load_state_dict``.

    Prefix layer ``j`` is layer ``j``; layer ``X + r * P + p`` of the torch
    stack is repeat ``r`` of pattern position ``p`` (X prefix layers, P
    positions, R repeats); remainder layer ``j`` is layer ``X + R * P + j``.
    """
    block_leaves = {m.group(1): np.asarray(flat[m.string]).shape[0]
                    for m in map(_BLOCK.match, flat) if m}
    n_pre = len({m.group(1) for m in map(_PRE.match, flat) if m})
    n_pattern = len(block_leaves)
    n_stacked = n_pattern * max(block_leaves.values(), default=0)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        m, rem, pre = _BLOCK.match(name), _REM.match(name), _PRE.match(name)
        encdec = _ENCDEC.match(name)
        if encdec is not None:
            group, rest = encdec.group(1), encdec.group(2).replace("|", ".")
            for i in range(arr.shape[0]):
                out[f"{group}.{i}.{rest}"] = torch.from_numpy(arr[i].copy())
        elif m is not None:
            pos, rest = int(m.group(1)), m.group(2).replace("|", ".")
            for r in range(arr.shape[0]):
                out[f"blocks.{n_pre + r * n_pattern + pos}.{rest}"] = torch.from_numpy(
                    arr[r].copy())
        elif rem is not None or pre is not None:
            layer = (n_pre + n_stacked + int(rem.group(1)) if rem is not None
                     else int(pre.group(1)))
            rest = (rem or pre).group(2).replace("|", ".")
            out[f"blocks.{layer}.{rest}"] = torch.from_numpy(arr.copy())
        elif name.startswith(_SHARED):
            out["zshared." + name[len(_SHARED):].replace("|", ".")] = torch.from_numpy(
                arr.copy())
        elif name.startswith("stack|"):
            raise KeyError(f"stack leaf {name} has no counterpart in the torch model")
        else:
            out[name.replace("|", ".")] = torch.from_numpy(arr.copy())
    return out



def jax_leaf_name(torch_name: str, reps: int, n_pattern: int,
                  n_pre: int = 0) -> Tuple[str, Optional[int]]:
    """``blocks.{i}.rest`` -> (``stack|pre|x{i}|rest``, None) for the
    ``n_pre`` prefix layers, then, with ``l = i - n_pre``,
    (``stack|blocks|p{l % P}|rest``, slice ``l // P``) for the ``reps * P``
    stacked layers and (``stack|rem|r{j}|rest``, None) for remainder layer
    ``j``; ``zshared.rest`` -> (``stack|zshared|rest``, None);
    ``enc_blocks.{i}.rest`` -> (``enc_blocks|rest``, slice ``i``), and so
    for ``dec_blocks``; any other name -> (its ``|`` path, None)."""
    encdec = _TORCH_ENCDEC.match(torch_name)
    if encdec is not None:
        return f"{encdec.group(1)}|{encdec.group(3).replace('.', '|')}", int(encdec.group(2))
    if torch_name.startswith("zshared."):
        return _SHARED + torch_name[len("zshared."):].replace(".", "|"), None
    m = _TORCH_BLOCK.match(torch_name)
    if m is None:
        return torch_name.replace(".", "|"), None
    layer, rest = int(m.group(1)), m.group(2).replace(".", "|")
    if layer < n_pre:
        return f"stack|pre|x{layer}|{rest}", None
    layer -= n_pre
    if layer < reps * n_pattern:
        return f"stack|blocks|p{layer % n_pattern}|{rest}", layer // n_pattern
    return f"stack|rem|r{layer - reps * n_pattern}|{rest}", None


def jax_leaves(model) -> Dict[str, List[torch.nn.Parameter]]:
    """The model's parameters grouped as the JAX package's parameter tree:
    ``{leaf name: [parameter, ...]}`` in JAX's leaf order (dict keys sorted
    level by level), a stacked leaf listing its layers in slice order."""
    cfg = model.cfg
    reps, n_pattern = cfg.scan_split()[0], len(cfg.pattern)
    slots: Dict[str, dict] = {}
    for name, param in model.named_parameters():
        leaf, idx = jax_leaf_name(name, reps, n_pattern, len(cfg.prefix))
        slots.setdefault(leaf, {})[idx] = param
    # a leaf's slots are {None} (unstacked) or its slices 0..n-1
    return {leaf: [slots[leaf][i] for i in sorted(slots[leaf])]
            for leaf in sorted(slots, key=lambda k: k.split("|"))}


def torch_params_to_jax(state: Mapping[str, torch.Tensor], cfg) -> Dict[str, np.ndarray]:
    """The inverse of :func:`jax_params_to_torch`: a state dict (names as
    ``Model.state_dict`` gives them) -> the JAX package's flat
    ``{"a|b|c": array}`` (``checkpoint/io.py::_flatten`` of its parameter
    tree), layer ``X + r * P + p`` stacked back as slice ``r`` of
    ``stack|blocks|p{p}|...`` after the X prefix layers. Arrays are numpy, on the host."""
    reps, n_pattern = cfg.scan_split()[0], len(cfg.pattern)
    out: Dict[str, np.ndarray] = {}
    stacked: Dict[str, dict] = {}
    for name, tensor in state.items():
        arr = tensor.detach().cpu().numpy()
        leaf, idx = jax_leaf_name(name, reps, n_pattern, len(cfg.prefix))
        if idx is None:
            out[leaf] = arr
        else:
            stacked.setdefault(leaf, {})[idx] = arr
    for leaf, arrs in stacked.items():
        out[leaf] = np.stack([arrs[i] for i in sorted(arrs)])
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


# the distilled head's leaves, in the JAX tree's order (dict keys sorted)
DISTILLED_LEAVES = ("b1", "b2", "copy_gate", "embed", "mix", "out", "out_b", "t_film",
                     "w1", "w2")


def jax_distilled_params_to_torch(params: Mapping[str, np.ndarray], *,
                                  device="cuda") -> Dict[str, torch.Tensor]:
    """A JAX ``DistilledRefiner`` params dict (its ten leaves, numpy arrays
    or anything ``np.asarray`` reads) -> the port's head params: the same
    names and shapes, float32 tensors on ``device``. A missing or unknown
    leaf raises."""
    dev = resolve_device(device)
    if set(params) != set(DISTILLED_LEAVES):
        raise KeyError(f"distilled head leaves {sorted(params)}, expected "
                       f"{list(DISTILLED_LEAVES)}")
    return {k: torch.from_numpy(np.array(params[k], dtype=np.float32)).to(dev)
            for k in DISTILLED_LEAVES}
