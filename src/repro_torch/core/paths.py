"""Probability paths for discrete flow matching (torch port of the JAX
package's ``core/paths.py``).

The linear warm-start path runs on ``t in [t0, 1]`` between a draft
distribution and the data; ``kappa(t) = (t - t0) / (1 - t0)``. The CTMC
generator used at sampling time is ``u = (p1 - onehot(x_t)) / (1 - t)``
for this schedule, independent of t0; the guaranteed speed-up comes from
the shortened horizon ``1 - t0`` (see ``guarantees.py``). Training draws
``t`` and ``x_t`` from the path with the port's threefry PRNG, equal to the
JAX package's for the same key.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class WarmStartPath:
    """Linear warm-start probability path on ``t in [t0, 1]``.

    Attributes:
      t0: warm-start time. 0.0 == standard (cold-start) DFM.
      eps: numerical floor keeping ``1 - t`` away from zero at sampling.
    """

    t0: float = 0.0
    eps: float = 1e-4

    def __post_init__(self):
        if not (0.0 <= self.t0 < 1.0):
            raise ValueError(f"t0 must lie in [0, 1), got {self.t0}")

    # ---- schedule -------------------------------------------------------

    def kappa(self, t: torch.Tensor) -> torch.Tensor:
        """Mixture weight toward the data sample x1 at time t (float32)."""
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.clamp((t - self.t0) / (1.0 - self.t0), 0.0, 1.0)

    def kappa_dot(self, t: torch.Tensor) -> torch.Tensor:
        """d kappa / dt (constant for the linear schedule)."""
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.full_like(t, 1.0 / (1.0 - self.t0))

    def velocity_scale(self, t: torch.Tensor) -> torch.Tensor:
        """Scalar multiplying ``(p1 - onehot(x_t))`` in the CTMC generator:
        ``1 / max(1 - t, eps)`` in float32."""
        t = torch.as_tensor(t, dtype=torch.float32)
        return 1.0 / torch.clamp_min(1.0 - t, self.eps)

    # ---- sampling the path ----------------------------------------------

    def sample_t(self, rng: torch.Tensor, shape=(), *, device=None) -> torch.Tensor:
        """t ~ Uniform[t0, 1): ``t0 + (1 - t0) * jax.random.uniform(rng,
        shape)`` as the JAX package's jitted train step computes it, with the
        product and the sum fused into one float32 rounding (XLA contracts
        them into an FMA under jit; op by op it rounds twice)."""
        u = prng.uniform(rng, shape, device=device)
        span = float(np.float32(1.0 - self.t0))
        lo = float(np.float32(self.t0))
        # a float32 product is exact in float64: one rounding of the sum
        return (u.double() * span + lo).float()

    def interpolate(self, rng: torch.Tensor, x_src: torch.Tensor, x_tgt: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
        """Draw ``x_t`` token-wise from the pinned marginal: ``x_tgt`` where
        ``jax.random.uniform(rng, x_src.shape) < kappa(t)``, else ``x_src``.

        ``t`` broadcasts against ``x_src.shape[:-1]`` (one time per row)."""
        k = self.kappa(t)
        k = k.reshape(k.shape + (1,) * (x_src.ndim - k.ndim))
        take_tgt = prng.uniform(rng, x_src.shape, device=x_src.device) < k
        return torch.where(take_tgt, x_tgt, x_src)

    # ---- step count / guarantee -----------------------------------------

    def num_steps(self, h: float) -> int:
        """Euler steps needed to cover [t0, 1] at step size h."""
        return max(1, math.ceil((1.0 - self.t0) / h - 1e-9))


def cold_start_path(eps: float = 1e-4) -> WarmStartPath:
    """The standard DFM path (the paper's baseline)."""
    return WarmStartPath(t0=0.0, eps=eps)


def uniform_noise(rng: torch.Tensor, shape, vocab_size: int, *, device=None) -> torch.Tensor:
    """x0 ~ Uniform([V]^N), the cold-start initial distribution:
    ``jax.random.randint(rng, shape, 0, vocab_size)``'s draw, int32."""
    return prng.randint(rng, shape, 0, vocab_size, device=device)


def mask_noise(shape, mask_token: int, *, device=None) -> torch.Tensor:
    """x0 = the mask token everywhere (Gat et al. 2024 variant), int32."""
    return torch.full(tuple(shape), mask_token, dtype=torch.int32, device=device)
