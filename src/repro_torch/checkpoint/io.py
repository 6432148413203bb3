"""Checkpointing: a flat ``.npz`` + JSON manifest in the JAX package's
layout (torch port of its ``checkpoint/io.py``), so that a checkpoint
either package writes restores in the other.

Layout:  <dir>/step_<N>/arrays.npz    flat {"|"-joined path: array}
         <dir>/step_<N>/manifest.json  step, keys, shapes, dtypes
Atomic via tmp-dir rename. Every leaf is keyed as JAX's ``_flatten`` keys a
JAX ``TrainState``: ``params|<leaf>`` (the model's layers stacked back into
the JAX leaves, ``convert.torch_params_to_jax``), ``opt_state|step``,
``opt_state|mu|<leaf>``, ``nu``, ``nu_max`` (AdamW; none without AMSGrad)
or ``vr``/``vc`` (Adafactor), and ``step``. bfloat16 leaves are stored as
JAX's numpy writes them (2-byte raw records).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.convert import jax_params_to_torch, torch_params_to_jax

_SEP = "|"
_RAW_BF16 = np.dtype("V2")


def _join(prefix: str, key: str) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else key


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW_BF16)
    return t.numpy()


def _walk(prefix: str, node, out: Dict[str, np.ndarray]) -> None:
    if node is None:
        return
    if isinstance(node, torch.nn.Module):
        for k, a in torch_params_to_jax(node.state_dict(), node.cfg).items():
            out[_join(prefix, k)] = a
    elif _is_namedtuple(node):
        for field in node._fields:
            _walk(_join(prefix, field), getattr(node, field), out)
    elif isinstance(node, dict):
        for k, v in node.items():
            _walk(_join(prefix, k), v, out)
    else:
        out[prefix] = _to_numpy(node)


def flatten(state) -> Dict[str, np.ndarray]:
    """``{key: numpy array}`` of a port ``TrainState`` (or any tree of
    NamedTuples, dicts, tensors and ``Model``s), keyed as the JAX package's
    ``_flatten`` keys the same JAX tree."""
    out: Dict[str, np.ndarray] = {}
    _walk("", state, out)
    return out


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _RAW_BF16 else str(a.dtype)


def save_checkpoint(directory: str, state, step: int) -> str:
    dest = os.path.join(directory, f"step_{step:08d}")
    tmp = dest + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.rename(tmp, dest)
    return dest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _array(arrays: Dict[str, np.ndarray], key: str, shape) -> np.ndarray:
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = arrays[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(shape)}")
    return arr


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if arr.dtype != _RAW_BF16:
            raise ValueError(f"expected a bfloat16 leaf, got {arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)   # a copy; keeps 0-d leaves 0-d
    return t.to(like.device)


def _restore(prefix: str, node, arrays: Dict[str, np.ndarray]):
    if node is None:
        return None
    if isinstance(node, torch.nn.Module):
        want = torch_params_to_jax(node.state_dict(), node.cfg)
        flat = {k: _array(arrays, _join(prefix, k), v.shape) for k, v in want.items()}
        sd = {k: v.to(node.device) for k, v in jax_params_to_torch(flat).items()}
        node.load_state_dict(sd, strict=True)
        return node
    if _is_namedtuple(node):
        return type(node)(*(_restore(_join(prefix, f), getattr(node, f), arrays)
                            for f in node._fields))
    if isinstance(node, dict):
        return {k: _restore(_join(prefix, k), v, arrays) for k, v in node.items()}
    return _tensor(_array(arrays, prefix, node.shape), node)


def restore_checkpoint(directory: str, template, step: Optional[int] = None):
    """Restore into the structure of ``template`` (a ``TrainState`` of the
    same model and optimizer as saved). The template's model is loaded in
    place; every other leaf is a new tensor on the template leaf's device
    and dtype."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return _restore("", template, arrays)
