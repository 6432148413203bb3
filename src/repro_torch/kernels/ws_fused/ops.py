"""``ws_fused``: the wrapper around ``csrc/ws_fused.cu``, with the
signatures and validation of the JAX package's ``kernels/ws_fused/ops.py``.

``ws_fused_steps(keys, logits, x_t, ts, hs, path)`` runs K warm-start Euler
draws against ONE frozen logits buffer in one launch, carrying each row's
token in a register from step to step. Its oracle is K composed single
draws on the same logits (``impl="composed"``: K launches of the kernel
at K = 1, each equal to one ``ws_step`` launch in the single-key layout).

Two key layouts, as in the JAX package:
  * single key: ``keys (K, 2)``, one key per step shared by all rows (the
    ``scan_refine_loop`` regime); the noise counter is the absolute
    ``(row, col)``, so step ``j`` equals ``ws_step(keys[j], ...)``;
  * per row: ``keys (K, B, 2)``, one key per (step, request row) (the
    ``scan_refine_loop_rows`` regime); the counter is ``(position within
    the request, col)``, so the draw is invariant to the packing.

``ts``/``hs`` are ``(K,)`` or ``(K, B)``; ``a = clip(h * velocity_scale(t),
0, 1)`` is formed once per call on the tensor's device, and ``h = 0``
freezes a row bit for bit. A CUDA tensor launches the kernel (or raises);
a CPU tensor takes the plain version (``ref.ws_fused_ref``).

Not carried over: ``pick_tiles_fused`` and ``fused_row_bytes`` model the
TPU's VMEM (row block and vocab tile sizes), which a kernel that keeps a
row's state in registers does not have; the TPU hardware PRNG (``hw_prng`` accepts only ``None``
or ``False``); and ``interpret``, ``row_block``, ``vocab_tile`` and
``vmem_budget``, which only tune or emulate the TPU kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core.paths import WarmStartPath
from repro_torch.kernels import _build
from repro_torch.kernels.ws_fused.ref import ws_fused_ref


def fused_inputs(keys: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor, ts, hs,
                 path: WarmStartPath):
    """Validate the public arguments and lay them out for the kernel:
    ``(seeds (K, G, 2), logits (R, V), x (R,), a (K, A), key_group,
    a_group)`` with ``G = R // key_group`` and ``A = R // a_group``. K = 0
    gives ``None``."""
    dev = logits.device
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    hs = torch.as_tensor(hs, dtype=torch.float32, device=dev)
    if ts.shape != hs.shape:
        raise ValueError(f"ts/hs shape mismatch: {tuple(ts.shape)} vs {tuple(hs.shape)}")
    num_steps = ts.shape[0]
    if num_steps == 0:
        return None
    seeds = prng.key_data(keys)
    rows_mode = seeds.ndim == 3
    squeeze = logits.ndim == 3
    if squeeze:
        b, n, v = logits.shape
        r = b * n
        lg = logits.reshape(r, v)
        x = x_t.reshape(r)
    elif logits.ndim == 2:
        r, v = logits.shape
        lg, x = logits, x_t
    else:
        raise ValueError(f"logits must be (B, N, V) or (R, V), got {tuple(logits.shape)}")
    if rows_mode and not squeeze:
        raise ValueError("per-row keys (K, B) require (B, N, V) logits")
    if rows_mode and tuple(seeds.shape[:2]) != (num_steps, b):
        raise ValueError(
            f"per-row keys shape {tuple(seeds.shape[:2])} != (K={num_steps}, B={b})")
    if not rows_mode and tuple(seeds.shape) != (num_steps, 2):
        raise ValueError(f"expected (K,) keys, got seed words {tuple(seeds.shape)}")
    key_group = n if rows_mode else r
    seeds = seeds.reshape(num_steps, r // key_group, 2)
    if ts.ndim == 1:
        a_group = r
        a = torch.clamp(hs * path.velocity_scale(ts), 0.0, 1.0)[:, None]
    elif ts.ndim == 2 and squeeze and ts.shape[1] == b:
        a_group = n
        a = torch.clamp(hs * path.velocity_scale(ts), 0.0, 1.0)
    else:
        raise ValueError(f"bad ts shape {tuple(ts.shape)}")
    return seeds, lg, x, a, key_group, a_group


def ws_fused_steps(keys: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor, ts, hs,
                   path: WarmStartPath, *, temperature: float = 1.0,
                   impl: Optional[str] = None, hw_prng: Optional[bool] = None) -> torch.Tensor:
    """K fused warm-start Euler steps; returns tokens shaped like ``x_t``."""
    if hw_prng:
        raise ValueError("hw_prng: the TPU hardware PRNG has no counterpart on the card; "
                         "the kernel draws the counter-based threefry noise")
    prepared = fused_inputs(keys, logits, x_t, ts, hs, path)
    if prepared is None:
        return x_t
    seeds, lg, x, a, key_group, a_group = prepared
    if impl is None or impl == "auto":
        impl = "fused"
    if impl == "composed":
        for j in range(seeds.shape[0]):
            x = _fused(seeds[j:j + 1], lg, x, a[j:j + 1], key_group, a_group, temperature)
        return x.reshape(x_t.shape)
    if impl != "fused":
        raise ValueError(f"unknown ws_fused impl {impl!r}")
    return _fused(seeds, lg, x, a, key_group, a_group, temperature).reshape(x_t.shape)


def _fused(seeds, lg, x, a, key_group, a_group, temperature) -> torch.Tensor:
    """One call of the kernel (CUDA) or of its plain version (CPU)."""
    if lg.device.type == "cpu":
        return ws_fused_ref(seeds, lg, x, a, key_group=key_group, a_group=a_group,
                            temperature=temperature)
    if lg.device.type != "cuda":
        raise ValueError(f"ws_fused runs on cuda or cpu, got {lg.device}")
    lg = lg.contiguous()
    if lg.dtype != torch.float32:
        raise ValueError(f"logits must be float32, got {lg.dtype}")
    r = lg.shape[0]
    if x.device != lg.device or x.shape != (r,):
        raise ValueError(f"x_t must hold one token per row on {lg.device}")
    x32 = x.to(torch.int32).contiguous()
    sd = seeds.to(device=lg.device, dtype=torch.int64).contiguous()
    a = a.contiguous()
    out = torch.empty(r, dtype=torch.int32, device=lg.device)
    _launch(lg, x32, a, sd, out, key_group, a_group, temperature)
    _build.count("ws_fused")
    return out


def _launch(lg, x, a, seeds, out, key_group: int, a_group: int, temperature: float, *,
            lanes: int = 0) -> None:
    """One launch on checked, contiguous CUDA tensors (no count). ``lanes``
    forces the lanes a row (2, 4, 8, 16 or 32; 0: the kernel's choice from
    V), for the tests: the tokens are the same at every one."""
    r, v = lg.shape
    with torch.cuda.device(lg.device):
        stream = torch.cuda.current_stream(lg.device).cuda_stream
        rc = _build.library().ws_fused_launch(
            lg.data_ptr(), x.data_ptr(), a.data_ptr(), seeds.data_ptr(), out.data_ptr(),
            r, v, seeds.shape[0], key_group, a_group, float(temperature), int(lanes), stream)
    _build.check(rc, "ws_fused")


def make_ws_fused_fn(path: WarmStartPath, *, temperature: float = 1.0,
                     impl: Optional[str] = None, hw_prng: Optional[bool] = None):
    """``fused_fn(keys, logits, x_t, ts, hs)`` with the path and knobs bound:
    the plug-in shape ``core/sampler.py`` expects for fused-block loops."""

    def fused_fn(keys, logits, x_t, ts, hs):
        return ws_fused_steps(keys, logits, x_t, ts, hs, path, temperature=temperature,
                              impl=impl, hw_prng=hw_prng)

    return fused_fn
