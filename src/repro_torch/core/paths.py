"""Probability paths for discrete flow matching (torch port of the JAX
package's ``core/paths.py``).

The linear warm-start path runs on ``t in [t0, 1]`` between a draft
distribution and the data; ``kappa(t) = (t - t0) / (1 - t0)``. The CTMC
generator used at sampling time is ``u = (p1 - onehot(x_t)) / (1 - t)``
for this schedule, independent of t0; the guaranteed speed-up comes from
the shortened horizon ``1 - t0`` (see ``guarantees.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


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

    def velocity_scale(self, t: torch.Tensor) -> torch.Tensor:
        """Scalar multiplying ``(p1 - onehot(x_t))`` in the CTMC generator:
        ``1 / max(1 - t, eps)`` in float32."""
        t = torch.as_tensor(t, dtype=torch.float32)
        return 1.0 / torch.clamp_min(1.0 - t, self.eps)

    def num_steps(self, h: float) -> int:
        """Euler steps needed to cover [t0, 1] at step size h."""
        return max(1, math.ceil((1.0 - self.t0) / h - 1e-9))
