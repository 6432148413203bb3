"""Euler CTMC sampling for warm-start discrete flow matching (torch port of
the serving loops of the JAX package's ``core/sampler.py``).

Starting at ``t = t0`` from draft samples, each step forms

    p_next = (1 - a) * onehot(x_t) + a * softmax(v_theta(x_t, t)),
    a      = clip(h * velocity_scale(t), 0, 1)

and draws the next state from it, until ``t`` reaches 1. The ``(t, h)``
schedule is computed on the host once (numpy, identical to the JAX
package's) and the key is split once, one key per step; the loop itself
is a Python loop over that schedule. On the card ``EulerSampler(jit=True)``
runs it as one CUDA graph replay a call (:mod:`repro_torch.graphs`),
captured once per ``model_fn`` and shape as JAX jits it once.
``kernels/ws_step`` provides the fused step (``step_fn``). Without one, the default step is the
probability update and a Gumbel-max draw with ``jax.random.gumbel``'s
noise: on the CPU in plain torch (``euler_step_probs`` +
``categorical_from_probs``), on the card one launch of the
``ws_step_gumbel`` kernel, which draws the same noise inside.

The scheduler's loop is row-keyed (the ``_rows`` functions): every request
row has its own flow key and enters the shared schedule at its own step,
and its step keys ``fold_in(flow_keys[b], key_idx[i, b])`` are folded on
the host once per micro-batch and uploaded in one copy (``rows_loop_inputs``);
the loop itself (``rows_loop``) reads nothing on the host, so the scheduler
captures it once per compile key. ``fused_block = K > 1`` runs K draws per
backbone evaluation through the ``ws_fused`` kernel (``fused_fn``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import guarantees
from repro_torch.core.paths import WarmStartPath
from repro_torch.graphs import GraphCache


class SamplerStats(NamedTuple):
    nfe: int                # backbone evaluations actually taken
    final_t: float


def euler_step_probs(logits: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor,
                     h, path: WarmStartPath, *, temperature: float = 1.0) -> torch.Tensor:
    """Next-state categorical probabilities for one Euler step, a convex
    combination of ``onehot(x_t)`` and ``p1`` (``a`` is clipped to [0, 1]
    so the final, possibly partial, step stays a distribution)."""
    p1 = torch.softmax(logits.float() / temperature, dim=-1)
    a = torch.clamp(torch.as_tensor(h, dtype=torch.float32, device=logits.device)
                    * path.velocity_scale(t), 0.0, 1.0)
    a = a.reshape(a.shape + (1,) * (p1.ndim - a.ndim))
    onehot = torch.nn.functional.one_hot(x_t.long(), logits.shape[-1]).float()
    return (1.0 - a) * onehot + a * p1


def categorical_from_probs(rng: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sampling from (possibly unnormalised) probabilities, with
    ``jax.random.gumbel``'s noise for the key ``rng``."""
    g = prng.gumbel(rng, probs.shape, device=probs.device)
    score = torch.log(torch.clamp_min(probs, 1e-30)) + g
    return torch.argmax(score, dim=-1).to(torch.int32)


def categorical_from_probs_rows(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Row-keyed Gumbel-max: ``keys (B, 2)``, ``probs (B, ...)``; row ``b``'s
    noise is ``jax.random.gumbel(keys[b], probs.shape[1:])``, so a request's
    draw depends on its own key alone."""
    g = prng.gumbel(keys, probs.shape[1:], device=probs.device)
    score = torch.log(torch.clamp_min(probs, 1e-30)) + g
    return torch.argmax(score, dim=-1).to(torch.int32)


def make_euler_one_step_rows(path: WarmStartPath, *, temperature: float = 1.0):
    """Row-keyed Euler update ``one_step(keys (B, 2), logits, x_t, t (B,), h)``:
    the probability update and ``categorical_from_probs_rows``, which the
    ``ws_step`` kernel's per-row mode computes for a CUDA tensor
    (:func:`repro_torch.kernels.ws_step.ws_step_rows`; its plain version
    for a CPU tensor)."""
    # imported here: the kernels package imports core.paths, so a top-level
    # import would close a cycle when ``repro_torch.kernels`` loads first
    from repro_torch.kernels.ws_step.ops import ws_step_rows

    def one_step(keys, logits, x_t, t, h):
        return ws_step_rows(keys, logits, x_t, t, h, path, temperature=temperature)

    return one_step


def refine_schedule(t0: float, cold_nfe_h: float, n: int):
    """Per-step ``(t, h)`` arrays for the warm-start Euler loop.

    ``t[i] = t0 + i * h`` and ``h[i] = min(h, 1 - t[i])`` so the last
    (possibly partial) step lands exactly on ``t = 1``.
    """
    ts = (t0 + np.arange(n, dtype=np.float64) * cold_nfe_h).astype(np.float32)
    hs = np.minimum(np.float32(cold_nfe_h), np.float32(1.0) - ts).astype(np.float32)
    return ts, hs


def refine_schedule_rows(t0_rows, cold_nfe_h: float, cold_nfe: int):
    """Per-row schedule matrices for a heterogeneous-t0 micro-batch.

    Every row takes the step size ``cold_nfe_h`` but enters the shared loop
    at its own step: row ``r`` is inactive for the first ``n_max - n_r``
    steps (``n_r = warm_nfe(cold_nfe, t0_rows[r])``) and then takes exactly
    its ``n_r`` steps. ``key_idx`` is the row's local step counter, so the
    keys a row sees do not depend on its neighbours; a batch whose rows
    share one t0 reproduces :func:`refine_schedule` in every column.

    Returns ``(ts, hs, active, key_idx, nfe_rows)``: ``(n_max, B)`` float32,
    float32, bool, int32, and the per-row NFE ``(B,)`` int32.
    """
    t0_rows = np.asarray(t0_rows, np.float64)
    if t0_rows.ndim != 1:
        raise ValueError(f"t0_rows must be 1-D, got shape {t0_rows.shape}")
    nfe_rows = np.array([guarantees.warm_nfe(cold_nfe, float(t)) for t in t0_rows], np.int32)
    n_max = int(nfe_rows.max())
    local = np.arange(n_max, dtype=np.int64)[:, None] - (n_max - nfe_rows)[None, :]
    active = local >= 0
    # same float path as refine_schedule: f64 accumulate, f32 cast, f32 h clip
    ts = (t0_rows[None, :] + np.where(active, local, 0) * cold_nfe_h).astype(np.float32)
    hs = np.where(active, np.minimum(np.float32(cold_nfe_h), np.float32(1.0) - ts),
                  np.float32(0.0)).astype(np.float32)
    key_idx = np.where(active, local, 0).astype(np.int32)
    return ts, hs, active, key_idx, nfe_rows


def distill_schedule_rows(t0_rows, num_steps: int):
    """Per-row K-step schedule of the distilled tier: ``h_r = (1 - t0_r) / K``
    with the final-step clip, every row active on every step. Same outputs
    as :func:`refine_schedule_rows`. (The distilled tier itself is not
    ported yet; the schedule is.)"""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    t0_rows = np.asarray(t0_rows, np.float64)
    if t0_rows.ndim != 1:
        raise ValueError(f"t0_rows must be 1-D, got shape {t0_rows.shape}")
    if np.any(t0_rows < 0.0) or np.any(t0_rows >= 1.0):
        raise ValueError(f"t0_rows must lie in [0, 1), got {t0_rows}")
    b = t0_rows.shape[0]
    h_rows = (1.0 - t0_rows) / num_steps
    local = np.arange(num_steps, dtype=np.int64)[:, None]
    ts = (t0_rows[None, :] + local * h_rows[None, :]).astype(np.float32)
    hs = np.minimum(h_rows[None, :].astype(np.float32), np.float32(1.0) - ts).astype(np.float32)
    active = np.ones((num_steps, b), dtype=bool)
    key_idx = np.broadcast_to(np.arange(num_steps, dtype=np.int32)[:, None],
                              (num_steps, b)).astype(np.int32)
    nfe_rows = np.full((b,), num_steps, np.int32)
    return ts, hs, active, key_idx, nfe_rows


def _pad_blocks(arr: torch.Tensor, n: int, nf: int, pad_value) -> torch.Tensor:
    """Pad a leading-``nf`` schedule array up to ``n`` steps (block tail)."""
    if n == nf:
        return arr
    pad = torch.full((n - nf,) + tuple(arr.shape[1:]), pad_value, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad], dim=0)


def rows_loop_inputs(flow_keys: torch.Tensor, ts, hs, active, key_idx, *,
                     fused_block: int = 1):
    """The host's half of :func:`scan_refine_loop_rows`: the step keys
    ``fold_in(flow_keys[b], key_idx[i, b])`` and the schedule as host tensors
    ``(step_keys (n, B, 2), ts (n, B), hs (n, B), active (n, B) bool)``, each
    uploaded in one copy by the caller. With ``fused_block = K > 1`` every
    array is blocked to ``(ceil(n/K), K, ...)``, the tail block padded with
    ``t = 1, h = 0`` steps (frozen by the kernel) and inactive."""
    fk = prng.key_data(flow_keys).cpu()
    ts = torch.as_tensor(np.asarray(ts), dtype=torch.float32)
    hs = torch.as_tensor(np.asarray(hs), dtype=torch.float32)
    key_idx = torch.as_tensor(np.asarray(key_idx), dtype=torch.int64)
    act = torch.as_tensor(np.asarray(active, dtype=bool))
    if fused_block > 1:
        n = ts.shape[0]
        k = min(fused_block, n)
        nb = -(-n // k)

        def blocked(arr, pad_value):
            return _pad_blocks(arr, nb * k, n, pad_value).reshape((nb, k) + tuple(arr.shape[1:]))

        ts, hs, key_idx, act = (blocked(ts, 1.0), blocked(hs, 0.0), blocked(key_idx, 0),
                                blocked(act, False))
    return prng.fold_in(fk, key_idx), ts, hs, act


def rows_loop(logits_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              one_step: Callable, x: torch.Tensor, step_keys: torch.Tensor, ts: torch.Tensor,
              hs: torch.Tensor, act: torch.Tensor, *,
              fused_fn: Optional[Callable] = None) -> torch.Tensor:
    """The device's half of :func:`scan_refine_loop_rows` on
    :func:`rows_loop_inputs`' arrays, on ``x``'s device: it reads nothing on
    the host, so one CUDA graph holds it for every active mask of a shape.
    Each step keeps an inactive row's token with ``torch.where`` (JAX's
    ``jnp.where``; bitwise the step's own draw when the row is active). With
    ``fused_fn`` each block is one backbone evaluation at the block's first
    step time and one ``fused_fn(keys (K, B, 2), logits, x, ts (K, B), hs
    (K, B))`` launch, whose ``h = 0`` steps freeze their rows."""
    if fused_fn is not None:
        for i in range(ts.shape[0]):
            logits = logits_fn(x, ts[i, 0])
            x = fused_fn(step_keys[i], logits, x, ts[i], hs[i])
        return x
    for i in range(ts.shape[0]):
        logits = logits_fn(x, ts[i])
        x = torch.where(act[i][:, None], one_step(step_keys[i], logits, x, ts[i], hs[i]), x)
    return x


def scan_refine_loop_rows(logits_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          one_step: Callable, x_init: torch.Tensor, flow_keys: torch.Tensor,
                          ts, hs, active, key_idx, *, fused_block: int = 1,
                          fused_fn: Optional[Callable] = None):
    """Masked per-row refine loop: rows whose t0 (and NFE) differ, each on its
    own slice of the shared schedule (see :func:`refine_schedule_rows`).

    Args:
      logits_fn: ``(tokens (B,N), t (B,)) -> logits (B,N,V)``.
      one_step: row-keyed step (see :func:`make_euler_one_step_rows`).
      x_init: (B, N) int32 draft state.
      flow_keys: (B, 2) per-row keys (host); step ``i`` of row ``b`` draws
        with ``fold_in(flow_keys[b], key_idx[i, b])``.
      ts / hs / active / key_idx: ``(n, B)`` schedule matrices (numpy).
      fused_block / fused_fn: with ``K > 1`` the loop runs ceil(n/K) blocks
        of K draws against one backbone evaluation each; ``fused_fn`` gets
        the block's folded keys ``(K, B, 2)``. Inactive steps carry ``h =
        0``, which the kernel freezes bit for bit, and the tail block is
        padded with ``t = 1, h = 0`` steps.

    Rows on steps where ``active`` is False pass through unchanged; the
    backbone still evaluates the whole batch at every step. It is
    :func:`rows_loop_inputs` on the host, one copy of each array to the
    device, and :func:`rows_loop` (the part a CUDA graph captures).
    """
    if fused_block > 1 and fused_fn is None:
        raise ValueError("fused_block > 1 requires fused_fn "
                         "(see repro_torch.kernels.make_ws_fused_fn)")
    inputs = rows_loop_inputs(flow_keys, ts, hs, active, key_idx, fused_block=fused_block)
    dev = x_init.device
    return rows_loop(logits_fn, one_step, x_init, *(a.to(dev) for a in inputs),
                     fused_fn=fused_fn if fused_block > 1 else None)


def make_euler_one_step(path: WarmStartPath, *, temperature: float = 1.0,
                        step_fn: Optional[Callable] = None):
    """The single Euler update ``(rng, logits, x_t, t, h) -> x_next``:
    ``step_fn`` when given, else the probability update and a categorical
    draw with ``jax.random.gumbel(rng, logits.shape)``'s noise.

    That default runs as ``euler_step_probs`` + ``categorical_from_probs``
    for CPU logits; for CUDA logits it is :func:`gumbel_step`, one launch of
    the ``ws_step_gumbel`` kernel, which draws the same noise inside (JAX
    draws it in XLA) and computes the same score."""
    if step_fn is not None:
        return step_fn

    def one_step(rng, logits, x_t, t, h):
        if logits.device.type == "cpu":
            probs = euler_step_probs(logits, x_t, t, h, path, temperature=temperature)
            return categorical_from_probs(rng, probs)
        return gumbel_step(rng, logits, x_t, t, h, path, temperature=temperature)

    return one_step


def gumbel_step(rng: torch.Tensor, logits: torch.Tensor, x_t: torch.Tensor, t, h,
                path: WarmStartPath, *, temperature: float = 1.0) -> torch.Tensor:
    """The default Euler step through ``ws_step_gumbel_keyed``: the noise of
    ``categorical_from_probs`` (``jax.random.gumbel(rng, logits.shape)``,
    hashed in the kernel from the key's two words, read on the card when the
    key lies there, as in the refine graph) and ``a = clip(h *
    velocity_scale(t), 0, 1)``, one weight per batch row (or per position,
    or one for all), on the flattened ``(B * N, V)`` rows. Tokens shaped
    like ``x_t``."""
    # imported here, as in make_euler_one_step_rows (import cycle)
    from repro_torch.kernels.ws_step.ops import ws_step_gumbel_keyed

    v = logits.shape[-1]
    a = torch.clamp(torch.as_tensor(h, dtype=torch.float32, device=logits.device)
                    * path.velocity_scale(t), 0.0, 1.0)
    if tuple(a.shape) != tuple(x_t.shape[:a.ndim]):
        a = a.reshape(a.shape + (1,) * (x_t.ndim - a.ndim)).expand(x_t.shape)
    out = ws_step_gumbel_keyed(rng, logits.reshape(-1, v), x_t.reshape(-1), a, valid_v=v,
                               temperature=temperature)
    return out.reshape(x_t.shape)


def refine_loop_inputs(rng: torch.Tensor, t0: float, h: float, n: int, *, device=None):
    """``(keys (n, 2), ts (n,), hs (n,))`` for an n-step refine: the key is
    split once on the host (one key per step, shared across the batch);
    ``ts``/``hs`` go to ``device`` as float32 (stay on the host for None)."""
    ts, hs = refine_schedule(t0, h, n)
    keys = prng.split(rng, n)
    return keys, torch.from_numpy(ts).to(device), torch.from_numpy(hs).to(device)


def scan_refine_loop(logits_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     one_step: Callable, x_init: torch.Tensor, keys: torch.Tensor,
                     ts: torch.Tensor, hs: torch.Tensor, *, argmax_final: bool = False,
                     fused_block: int = 1, fused_fn: Optional[Callable] = None):
    """The whole refine loop over ``(keys, t, h)``: one backbone evaluation
    and one ``one_step`` per schedule entry.

    Args:
      logits_fn: ``(tokens (B,N), t (B,)) -> logits (B,N,V)``.
      one_step: ``(key, logits, x, t (B,), h) -> x_next``.
      x_init: (B, N) int32 start state at ``ts[0]``.
      keys / ts / hs: leading-``n`` loop inputs (see :func:`refine_loop_inputs`).
      argmax_final: replace the last stochastic step with argmax(p1).
      fused_block / fused_fn: with ``K > 1`` the loop runs over ceil(n/K)
        blocks: one backbone evaluation at the block's first step time and
        K draws by ``fused_fn(keys (K, 2), logits, x, ts (K,), hs (K,))``
        (the ``ws_fused`` kernel); the tail block is padded with ``h = 0``
        steps, which the kernel freezes bit for bit. ``argmax_final`` keeps
        its last step unfused on fresh logits.
    """
    b = x_init.shape[0]
    n = ts.shape[0]
    x = x_init
    if fused_block > 1:
        if fused_fn is None:
            raise ValueError("fused_block > 1 requires fused_fn "
                             "(see repro_torch.kernels.make_ws_fused_fn)")
        nf = n - 1 if argmax_final else n
        if nf > 0:
            k = min(fused_block, nf)
            nb = -(-nf // k)
            # h = 0 tail padding: frozen rows, any key/t; use the last ones
            bts = _pad_blocks(ts[:nf], nb * k, nf, 1.0).reshape(nb, k)
            bhs = _pad_blocks(hs[:nf], nb * k, nf, 0.0).reshape(nb, k)
            bkeys = torch.cat([keys[:nf]] + [keys[nf - 1:nf]] * (nb * k - nf), dim=0)
            bkeys = bkeys.reshape((nb, k) + tuple(keys.shape[1:])).to(x.device)
            for i in range(nb):
                logits = logits_fn(x, bts[i, 0].expand(b))
                x = fused_fn(bkeys[i], logits, x, bts[i], bhs[i])
        if argmax_final:
            x = torch.argmax(logits_fn(x, ts[n - 1].expand(b)), dim=-1).to(torch.int32)
        return x
    for i in range(n):
        tb = ts[i].expand(b)
        logits = logits_fn(x, tb)
        if argmax_final and i == n - 1:
            x = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            x = one_step(keys[i], logits, x, tb, hs[i])
    return x


@dataclasses.dataclass(frozen=True)
class EulerSampler:
    """Fixed-step Euler CTMC sampler over ``t in [path.t0, 1]``.

    Attributes:
      path: probability path (carries t0).
      num_steps: steps the *cold-start* sampler takes over [0, 1]; the
        warm-start sampler takes ``ceil(num_steps * (1 - t0))`` of the same
        size, the paper's guaranteed reduction.
      temperature: softmax temperature on v_theta.
      argmax_final: the last step takes argmax(p1) instead of a draw.
      step_fn: replacement for the default step (:func:`make_euler_one_step`),
        signature ``(rng, logits, x_t, t, h) -> x_next``.
      fused_block: K > 1 runs the loop in blocks of K draws against one
        backbone evaluation, through the ``ws_fused`` kernel; backbone
        evaluations drop to ceil(nfe / K). Opt-in; 1 is the paper's loop.
      jit: on the card, run the whole loop as one CUDA graph replay a call,
        captured once per ``model_fn`` and ``x_init`` shape, dtype and
        device (JAX's ``_jit_cache`` per ``model_fn``, its jit per shape);
        the tokens equal ``jit=False``'s bit for bit. A ``model_fn`` or
        ``step_fn`` that synchronises with the host cannot be captured and
        raises: pass ``jit=False``, which runs the loop eagerly. On the CPU
        the loop is eager either way.
    """

    path: WarmStartPath
    num_steps: int = 20
    temperature: float = 1.0
    argmax_final: bool = False
    step_fn: Optional[Callable] = None
    fused_block: int = 1
    jit: bool = True

    def __post_init__(self):
        # the jit cache of this sampler: its graphs (and what they hold) die
        # with it; the dataclass is frozen, so set as the JAX sampler does
        object.__setattr__(self, "graphs", GraphCache(
            "EulerSampler's refine loop",
            hint="a model_fn or step_fn that synchronises with the host cannot be "
                 "captured; pass jit=False to run the loop eagerly"))

    @property
    def h(self) -> float:
        return 1.0 / self.num_steps

    @property
    def nfe(self) -> int:
        """Guaranteed function-evaluation count (see guarantees.py)."""
        return self.path.num_steps(self.h)

    @property
    def backbone_evals(self) -> int:
        """Backbone evaluations actually run (<= nfe; fused blocks share one
        evaluation among ``fused_block`` draws)."""
        if self.fused_block <= 1:
            return self.nfe
        nf = self.nfe - 1 if self.argmax_final else self.nfe
        evals = -(-nf // self.fused_block) if nf > 0 else 0
        return evals + (1 if self.argmax_final else 0)

    def sample(self, rng: torch.Tensor, model_fn: Callable[[torch.Tensor, torch.Tensor],
                                                           torch.Tensor],
               x_init: torch.Tensor):
        """Run the sampler on ``x_init``'s device.

        Args:
          rng: PRNG key ``(2,)`` (``repro_torch.prng``).
          model_fn: ``(tokens (B,N), t (B,)) -> logits (B,N,V)``.
          x_init: (B, N) int32: drafts at ``t = t0`` or noise at ``t = 0``.
        Returns:
          (x_final, SamplerStats)
        """
        keys, ts, hs = refine_loop_inputs(rng, self.path.t0, self.h, self.nfe)
        loop = functools.partial(self._loop, model_fn)
        dev = x_init.device
        with torch.no_grad():
            if self.jit:
                # the compile key: model_fn and x_init's shape, dtype and device
                # (the sampler's own fields are frozen)
                key = (model_fn, tuple(x_init.shape), x_init.dtype, dev)
                x = self.graphs(key, loop, x_init, keys, ts, hs)
            else:
                x = loop(x_init, keys, ts.to(dev), hs.to(dev))
        return x, SamplerStats(nfe=self.backbone_evals, final_t=1.0)

    def _loop(self, model_fn, x_init, keys, ts, hs):
        one_step = make_euler_one_step(self.path, temperature=self.temperature,
                                       step_fn=self.step_fn)
        fused_fn = None
        if self.fused_block > 1:
            from repro_torch.kernels.ws_fused import make_ws_fused_fn
            fused_fn = make_ws_fused_fn(self.path, temperature=self.temperature)
        return scan_refine_loop(model_fn, one_step, x_init, keys, ts, hs,
                                argmax_final=self.argmax_final,
                                fused_block=self.fused_block, fused_fn=fused_fn)


def make_refine_step(apply_fn: Callable, path: WarmStartPath, *, temperature: float = 1.0,
                     step_fn: Optional[Callable] = None):
    """One DFM refine step ``f(params, rng, x_t (B,N), t (B,), h) -> x_next``:
    ``apply_fn(params, x_t, t)`` and the Euler update of
    :func:`make_euler_one_step`."""
    one_step = make_euler_one_step(path, temperature=temperature, step_fn=step_fn)

    def refine_step(params, rng, x_t, t, h):
        logits = apply_fn(params, x_t, t)
        return one_step(rng, logits, x_t, t, h)

    return refine_step
