"""Euler CTMC sampling for warm-start discrete flow matching (torch port of
the single-key serving loop of the JAX package's ``core/sampler.py``).

Starting at ``t = t0`` from draft samples, each step forms

    p_next = (1 - a) * onehot(x_t) + a * softmax(v_theta(x_t, t)),
    a      = clip(h * velocity_scale(t), 0, 1)

and draws the next state from it, until ``t`` reaches 1. The ``(t, h)``
schedule is computed on the host once (numpy, identical to the JAX
package's) and the key is split once, one key per step; the loop itself
is a Python loop over that schedule. ``kernels/ws_step`` provides the
fused step (``step_fn``); this module holds the plain per-step path.

The fused K-step block (``fused_block > 1``, the ``ws_fused`` kernel) and
the per-row-keyed (``_rows``) functions belong to the scheduler slice of
the port and are not here.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.paths import WarmStartPath


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


def refine_schedule(t0: float, cold_nfe_h: float, n: int):
    """Per-step ``(t, h)`` arrays for the warm-start Euler loop.

    ``t[i] = t0 + i * h`` and ``h[i] = min(h, 1 - t[i])`` so the last
    (possibly partial) step lands exactly on ``t = 1``.
    """
    ts = (t0 + np.arange(n, dtype=np.float64) * cold_nfe_h).astype(np.float32)
    hs = np.minimum(np.float32(cold_nfe_h), np.float32(1.0) - ts).astype(np.float32)
    return ts, hs


def make_euler_one_step(path: WarmStartPath, *, temperature: float = 1.0,
                        step_fn: Optional[Callable] = None):
    """The single Euler update ``(rng, logits, x_t, t, h) -> x_next``:
    probability update + categorical draw, or ``step_fn`` (the fused
    ``ws_step`` kernel) when given."""
    if step_fn is not None:
        return step_fn

    def one_step(rng, logits, x_t, t, h):
        probs = euler_step_probs(logits, x_t, t, h, path, temperature=temperature)
        return categorical_from_probs(rng, probs)

    return one_step


def refine_loop_inputs(rng: torch.Tensor, t0: float, h: float, n: int, *, device=None):
    """``(keys (n, 2), ts (n,), hs (n,))`` for an n-step refine: the key is
    split once on the host (one key per step, shared across the batch);
    ``ts``/``hs`` go to ``device`` as float32."""
    ts, hs = refine_schedule(t0, h, n)
    keys = prng.split(rng, n)
    return keys, torch.from_numpy(ts).to(device), torch.from_numpy(hs).to(device)


def scan_refine_loop(logits_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     one_step: Callable, x_init: torch.Tensor, keys: torch.Tensor,
                     ts: torch.Tensor, hs: torch.Tensor, *, argmax_final: bool = False,
                     fused_block: int = 1):
    """The whole refine loop over ``(keys, t, h)``: one backbone evaluation
    and one ``one_step`` per schedule entry.

    Args:
      logits_fn: ``(tokens (B,N), t (B,)) -> logits (B,N,V)``.
      one_step: ``(key, logits, x, t (B,), h) -> x_next``.
      x_init: (B, N) int32 start state at ``ts[0]``.
      keys / ts / hs: leading-``n`` loop inputs (see :func:`refine_loop_inputs`).
      argmax_final: replace the last stochastic step with argmax(p1).
      fused_block: must be 1; K > 1 (K draws per backbone evaluation) needs
        the unported ``ws_fused`` kernel and raises.
    """
    if fused_block > 1:
        raise NotImplementedError(
            "fused_block > 1 needs the ws_fused kernel, which is not ported yet")
    b = x_init.shape[0]
    n = ts.shape[0]
    x = x_init
    for i in range(n):
        tb = ts[i].expand(b)
        logits = logits_fn(x, tb)
        if argmax_final and i == n - 1:
            x = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            x = one_step(keys[i], logits, x, tb, hs[i])
    return x
