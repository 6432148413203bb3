"""``ws_step``: the wrapper around ``csrc/ws_step.cu``, with the
``step_fn`` signature of the JAX package's ``kernels/ws_step/ops.py``.

``ws_step(rng, logits, x_t, t, h, path)`` flattens ``(B, N, V)`` logits to
rows, forms ``a = clip(h * velocity_scale(t), 0, 1)`` per row and draws
the next token of every row with the threefry noise keyed by the step
key's two words and the absolute ``(row, col)``. A CUDA tensor launches
the kernel (or raises); a CPU tensor takes the plain streamed version on
the same noise (``prng.threefry_gumbel``). A step key on the card is read
by the kernel (:func:`key_words`), one on the host goes to it as two
integers: the same words give the same bits.

``ws_step_rows(keys, logits, x_t, t, h, path)`` is the per-row mode that
the scheduler's ``make_euler_one_step_rows`` runs: ``keys (B, 2)`` (one
key per request row, ``prng``'s int64 key words), ``logits (B, N, V)``,
``t``/``h`` per request row; row ``b``'s noise is
``jax.random.gumbel(keys[b], (N, V))``, as the JAX package draws it in
XLA. A CUDA tensor launches ``ws_step_rows_kernel`` (same file, same
draw); a CPU tensor takes :func:`ws_step_rows_ref`.

``ws_step_gumbel(logits, x_t, a, gumbel, valid_v=...)`` wraps the port of
the TPU kernel ``ws_step_pallas``: the step with its Gumbel noise given,
scored in probability space; it is ``ws_step``'s ``impl="reference"``.
``ws_step_gumbel_keyed(rng, logits, x_t, a, valid_v=...)`` is the same
step with the noise ``jax.random.gumbel(rng, (R, Vp))`` drawn inside the
kernel: the default Euler step of ``core.sampler.make_euler_one_step`` on
the card, one launch. A CUDA tensor launches ``ws_step_gumbel_kernel`` (or
raises); a CPU tensor takes :func:`ws_step_gumbel_ref` (keyed: on
:func:`keyed_gumbel`'s noise).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core.paths import WarmStartPath
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.ws_step.ref import (
    keyed_gumbel, ws_step_gumbel_ref, ws_step_ref_streamed, ws_step_rows_ref,
)


def seed_from_key(rng: torch.Tensor) -> Tuple[int, int]:
    """The kernel's two uint32 seed words (the key data) of a step key."""
    kd = prng.key_data(rng).reshape(-1)[:2].tolist()
    return int(kd[0]), int(kd[1])


def key_words(rng: torch.Tensor) -> torch.Tensor:
    """The two words of a step key as the kernels read them from the card:
    ``(2,)`` int64 (a view of the key, no copy), equal to
    :func:`seed_from_key`'s integers."""
    kd = prng.key_data(rng).reshape(-1)[:2]
    if kd.dtype != torch.int64:
        raise ValueError(f"a key's words are int64, got {kd.dtype}")
    return kd.contiguous()


def _kernel_seed(rng: torch.Tensor, device: torch.device):
    """What a launch on ``device`` takes for the key: its words on the card
    when the key lies there (no synchronisation: a CUDA graph can hold it),
    else the host's two integers."""
    if rng.device.type == "cpu":
        return seed_from_key(rng)
    if rng.device != device:
        raise ValueError(f"the step key lies on {rng.device}, the logits on {device}")
    return key_words(rng)


def ws_step(rng: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor, t, h,
            path: WarmStartPath, *, temperature: float = 1.0,
            impl: Optional[str] = None) -> torch.Tensor:
    """Fused next-token draw for one Euler step; tokens shaped like ``x_t``.

    ``impl``: None, "auto" or "streamed" run the streamed step with the
    counter noise; "reference" draws ``jax.random.gumbel(rng, (R, V))``'s
    noise and runs :func:`ws_step_gumbel` on it (the JAX dispatcher's
    reference path)."""
    if logits.ndim == 3:
        b, n, v = logits.shape
        r = b * n
        lg = logits.reshape(r, v)
        x = x_t.reshape(r)
        tt = torch.as_tensor(t, dtype=torch.float32, device=logits.device)
        tt = tt.reshape(-1, 1).expand(b, n).reshape(r)
    elif logits.ndim == 2:
        r, v = logits.shape
        lg, x = logits, x_t
        tt = torch.as_tensor(t, dtype=torch.float32, device=logits.device).expand(r)
    else:
        raise ValueError(f"logits must be (B, N, V) or (R, V), got {tuple(logits.shape)}")
    hh = torch.as_tensor(h, dtype=torch.float32, device=logits.device)
    a = torch.clamp(hh * path.velocity_scale(tt), 0.0, 1.0)
    if impl == "reference":
        g = prng.gumbel(rng, (r, v), device=logits.device)
        out = ws_step_gumbel(lg, x.reshape(r, 1), a.reshape(r, 1), g, valid_v=v, row_block=1,
                             temperature=temperature)
        return out.reshape(x_t.shape)
    if impl not in (None, "auto", "streamed"):
        raise ValueError(f"unknown ws_step impl {impl!r}")

    if logits.device.type == "cpu":
        g = prng.threefry_gumbel(seed_from_key(rng), r, v, device=logits.device)
        out = ws_step_ref_streamed(lg, x, a, g, temperature=temperature)
        return out.reshape(x_t.shape)
    if logits.device.type != "cuda":
        raise ValueError(f"ws_step runs on cuda or cpu, got {logits.device}")
    lg = lg.contiguous()
    if lg.dtype != torch.float32:
        raise ValueError(f"logits must be float32, got {lg.dtype}")
    if x.device != logits.device or x.shape != (r,):
        raise ValueError(f"x_t must hold one token per row on {logits.device}")
    x32 = x.to(torch.int32).contiguous()
    a = a.contiguous()
    out = torch.empty(r, dtype=torch.int32, device=logits.device)
    _launch(lg, x32, a, out, _kernel_seed(rng, logits.device), temperature)
    _build.count("ws_step")
    return out.reshape(x_t.shape)


def _launch(lg: torch.Tensor, x: torch.Tensor, a: torch.Tensor, out: torch.Tensor, seed,
            temperature: float, *, lanes: int = 0) -> None:
    """One launch of the kernel on checked, contiguous CUDA tensors (no count).
    ``seed``: the key's two words as integers, or as a ``(2,)`` int64 tensor
    on the card (:func:`key_words`), which the kernel reads. ``lanes``
    forces the lanes a row (2, 4, 8, 16 or 32; 0: the kernel's choice from
    V), for the tests: the tokens are the same at every one."""
    r, v = lg.shape
    lib = _build.library()
    with torch.cuda.device(lg.device):
        stream = torch.cuda.current_stream(lg.device).cuda_stream
        if isinstance(seed, torch.Tensor):
            rc = lib.ws_step_dkey_launch(lg.data_ptr(), x.data_ptr(), a.data_ptr(),
                                         seed.data_ptr(), out.data_ptr(), r, v,
                                         float(temperature), int(lanes), stream)
        else:
            rc = lib.ws_step_launch(lg.data_ptr(), x.data_ptr(), a.data_ptr(), out.data_ptr(),
                                    r, v, seed[0], seed[1], float(temperature), int(lanes),
                                    stream)
    _build.check(rc, "ws_step")


def lanes_for(vocab: int) -> int:
    """The lanes a row that the ``ws_step`` and ``ws_step_rows`` kernels take
    at this vocabulary (the card's library answers)."""
    return int(_build.library().ws_step_lanes(int(vocab)))


def ws_step_rows(keys: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor, t, h,
                 path: WarmStartPath, *, temperature: float = 1.0) -> torch.Tensor:
    """Row-keyed next-token draw: ``keys (B, 2)``, ``logits (B, N, V)``,
    ``x_t (B, N)``, ``t (B,)``, ``h`` scalar or ``(B,)``. (B, N) int32."""
    if logits.ndim != 3:
        raise ValueError(f"per-row keys need (B, N, V) logits, got {tuple(logits.shape)}")
    b, n, v = logits.shape
    keys = prng.key_data(keys)
    if keys.shape != (b, 2):
        raise ValueError(f"per-row keys must be (B={b}, 2), got {tuple(keys.shape)}")
    if n * v >= 1 << 32:
        raise NotImplementedError("random bits arrays of 2**32 elements or more")
    dev = logits.device
    tt = torch.as_tensor(t, dtype=torch.float32, device=dev).expand(b)
    hh = torch.as_tensor(h, dtype=torch.float32, device=dev)
    a = torch.clamp(hh * path.velocity_scale(tt), 0.0, 1.0)
    if dev.type == "cpu":
        return ws_step_rows_ref(keys, logits, x_t, a, temperature=temperature)
    if dev.type != "cuda":
        raise ValueError(f"ws_step_rows runs on cuda or cpu, got {dev}")
    lg = logits.contiguous()
    if lg.dtype != torch.float32:
        raise ValueError(f"logits must be float32, got {lg.dtype}")
    if x_t.device != dev or x_t.shape != (b, n):
        raise ValueError(f"x_t must be (B, N) = ({b}, {n}) on {dev}")
    x32 = x_t.to(torch.int32).contiguous()
    kd = keys.to(device=dev, dtype=torch.int64).contiguous()
    a = a.contiguous()
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    _launch_rows(lg, x32, a, kd, out, temperature)
    _build.count("ws_step_rows")
    return out


def _launch_rows(lg: torch.Tensor, x: torch.Tensor, a: torch.Tensor, keys: torch.Tensor,
                 out: torch.Tensor, temperature: float, *, lanes: int = 0) -> None:
    """One launch of the per-row kernel on checked CUDA tensors (no count);
    ``lanes`` as in :func:`_launch`."""
    b, n, v = lg.shape
    with torch.cuda.device(lg.device):
        stream = torch.cuda.current_stream(lg.device).cuda_stream
        rc = _build.library().ws_step_rows_launch(
            lg.data_ptr(), x.data_ptr(), a.data_ptr(), keys.data_ptr(), out.data_ptr(),
            b * n, v, n, float(temperature), int(lanes), stream)
    _build.check(rc, "ws_step_rows")


def make_ws_step_fn(path: WarmStartPath, *, temperature: float = 1.0, device="cuda",
                    impl: Optional[str] = None):
    """``step_fn(rng, logits, x_t, t, h)`` for ``WarmStartServer(step_fn=...)``
    or ``EulerSampler(step_fn=...)``; ``impl`` as in :func:`ws_step`.

    ``device`` is where the step will run (default the card, which raises
    without one); logits on another device raise."""
    dev = resolve_device(device)

    def step_fn(rng, logits, x_t, t, h):
        if logits.device.type != dev.type:
            raise ValueError(f"ws_step built for {dev}, got logits on {logits.device}")
        return ws_step(rng, logits, x_t, t, h, path, temperature=temperature, impl=impl)

    return step_fn


def ws_step_gumbel(logits: torch.Tensor, x_t: torch.Tensor, a: torch.Tensor,
                   gumbel: torch.Tensor, *, valid_v: int, row_block: int = 8,
                   temperature: float = 1.0) -> torch.Tensor:
    """The Euler step with its Gumbel noise given (the TPU kernel
    ``ws_step_pallas``'s signature): ``logits (R, Vp)`` float32, ``x_t (R,
    1)``, ``a (R, 1)`` float32 mixing weights, ``gumbel (R, Vp)`` float32;
    the columns ``>= valid_v`` are padding. Returns ``(R, 1)`` int32.

    ``R`` must be a multiple of ``row_block``, as the TPU kernel demands;
    on the card G lanes take each row, so ``row_block`` changes nothing
    else there."""
    if logits.ndim != 2:
        raise ValueError(f"logits must be (R, Vp), got {tuple(logits.shape)}")
    r, vp = logits.shape
    if tuple(x_t.shape) != (r, 1) or tuple(a.shape) != (r, 1):
        raise ValueError(f"x_t and a must be (R, 1) = ({r}, 1), got {tuple(x_t.shape)} "
                         f"and {tuple(a.shape)}")
    if tuple(gumbel.shape) != (r, vp):
        raise ValueError(f"gumbel must be (R, Vp) = ({r}, {vp}), got {tuple(gumbel.shape)}")
    if row_block < 1 or r % row_block != 0:
        raise ValueError(f"rows {r} must be a multiple of row_block {row_block}")
    if not 0 < valid_v <= vp:
        raise ValueError(f"valid_v must lie in [1, {vp}], got {valid_v}")
    dev = logits.device
    if dev.type == "cpu":
        return ws_step_gumbel_ref(logits, x_t, a, gumbel, valid_v=valid_v,
                                  temperature=temperature)
    if dev.type != "cuda":
        raise ValueError(f"ws_step_gumbel runs on cuda or cpu, got {dev}")
    for name, arr in (("logits", logits), ("a", a), ("gumbel", gumbel)):
        if arr.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {arr.dtype}")
    if any(arr.device != dev for arr in (x_t, a, gumbel)):
        raise ValueError(f"x_t, a and gumbel must lie on {dev} with the logits")
    out = torch.empty((r, 1), dtype=torch.int32, device=dev)
    _launch_gumbel(logits.contiguous(), x_t.to(torch.int32).contiguous(), a.contiguous(),
                   gumbel.contiguous(), out, valid_v, temperature)
    _build.count("ws_step_gumbel")
    return out


def _launch_gumbel(lg: torch.Tensor, x: torch.Tensor, a: torch.Tensor, g: torch.Tensor,
                   out: torch.Tensor, valid_v: int, temperature: float, *,
                   lanes: int = 0) -> None:
    """One launch of ``ws_step_gumbel_kernel`` with the noise given, on
    checked CUDA tensors (no count). ``lanes`` forces the lanes a row (0:
    the kernel's choice from ``valid_v``); unlike ``ws_step``'s, the tokens
    may differ between two G off near ties (the softmax sum's order is G's)."""
    r, vp = lg.shape
    with torch.cuda.device(lg.device):
        stream = torch.cuda.current_stream(lg.device).cuda_stream
        rc = _build.library().ws_step_gumbel_launch(
            lg.data_ptr(), x.data_ptr(), a.data_ptr(), g.data_ptr(), out.data_ptr(), r, vp,
            valid_v, float(temperature), int(lanes), stream)
    _build.check(rc, "ws_step_gumbel")


def ws_step_gumbel_keyed(rng: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor,
                         a: torch.Tensor, *, valid_v: Optional[int] = None,
                         temperature: float = 1.0) -> torch.Tensor:
    """:func:`ws_step_gumbel` on the noise ``jax.random.gumbel(rng, (R,
    Vp))``, which the kernel hashes itself: ``rng`` a key ``(2,)`` (on the
    host its two words go to the kernel as integers; on the card the kernel
    reads them, as a CUDA graph of the refine loop needs), ``logits (R,
    Vp)`` float32, ``x_t (R,)``, ``a`` float32 holding ``R / a_group``
    weights, row ``r`` mixing with ``a.reshape(-1)[r // a_group]`` (one
    weight, one per batch row of ``a_group`` positions, or one per row);
    ``valid_v`` defaults to ``Vp``. Returns ``(R,)`` int32.

    At the same lanes a row its tokens equal :func:`ws_step_gumbel`'s on
    ``prng.gumbel(rng, (R, Vp))``'s noise, bit for bit."""
    if logits.ndim != 2:
        raise ValueError(f"logits must be (R, Vp), got {tuple(logits.shape)}")
    r, vp = logits.shape
    valid_v = vp if valid_v is None else valid_v
    if not 0 < valid_v <= vp:
        raise ValueError(f"valid_v must lie in [1, {vp}], got {valid_v}")
    if tuple(x_t.shape) != (r,):
        raise ValueError(f"x_t must be (R,) = ({r},), got {tuple(x_t.shape)}")
    a = a.reshape(-1)
    if a.numel() == 0 or r % a.numel() != 0:
        raise ValueError(f"a must hold one weight for every R / a_group rows; R = {r}, "
                         f"{a.numel()} weights")
    if r * vp >= 1 << 32:
        raise NotImplementedError("random bits arrays of 2**32 elements or more")
    dev = logits.device
    if dev.type == "cpu":
        g = keyed_gumbel(seed_from_key(rng), r, vp, device=dev)
        aa = a.repeat_interleave(r // a.numel()).reshape(r, 1)
        return ws_step_gumbel_ref(logits, x_t.reshape(r, 1), aa, g, valid_v=valid_v,
                                  temperature=temperature)[:, 0]
    if dev.type != "cuda":
        raise ValueError(f"ws_step_gumbel runs on cuda or cpu, got {dev}")
    for name, arr in (("logits", logits), ("a", a)):
        if arr.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {arr.dtype}")
    if x_t.device != dev or a.device != dev:
        raise ValueError(f"x_t and a must lie on {dev} with the logits")
    out = torch.empty(r, dtype=torch.int32, device=dev)
    _launch_gumbel_keyed(logits.contiguous(), x_t.to(torch.int32).contiguous(),
                         a.contiguous(), _kernel_seed(rng, dev), out, valid_v, temperature)
    _build.count("ws_step_gumbel")
    return out


def _launch_gumbel_keyed(lg: torch.Tensor, x: torch.Tensor, a: torch.Tensor, seed,
                         out: torch.Tensor, valid_v: int, temperature: float, *,
                         lanes: int = 0) -> None:
    """One launch of ``ws_step_gumbel_kernel`` with the noise keyed by the
    two words ``seed`` (integers, or a ``(2,)`` int64 tensor on the card as
    in :func:`_launch`), on checked CUDA tensors (no count); ``a`` holds one
    weight for every ``R / a.numel()`` rows; ``lanes`` as in
    :func:`_launch_gumbel`."""
    r, vp = lg.shape
    lib = _build.library()
    with torch.cuda.device(lg.device):
        stream = torch.cuda.current_stream(lg.device).cuda_stream
        if isinstance(seed, torch.Tensor):
            rc = lib.ws_step_gumbel_dkey_launch(
                lg.data_ptr(), x.data_ptr(), a.data_ptr(), seed.data_ptr(), out.data_ptr(), r,
                vp, valid_v, r // a.numel(), float(temperature), int(lanes), stream)
        else:
            rc = lib.ws_step_gumbel_keyed_launch(
                lg.data_ptr(), x.data_ptr(), a.data_ptr(), seed[0], seed[1], out.data_ptr(), r,
                vp, valid_v, r // a.numel(), float(temperature), int(lanes), stream)
    _build.check(rc, "ws_step_gumbel")
