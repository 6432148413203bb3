"""Learning-rate schedules and gradient clipping (torch port of the JAX
package's ``optim/schedule.py``).

A schedule maps the optimizer's step (a host int) to a float32 learning
rate, computed on the host in float32 in the JAX expression's order and
returned as a Python float (exactly that float32 value).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

_F32 = np.float32


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * base_lr`` at ``total_steps``."""
    def sched(step) -> float:
        s = _F32(int(step))
        warm = s / _F32(max(warmup_steps, 1))
        prog = np.clip((s - _F32(warmup_steps)) / _F32(max(total_steps - warmup_steps, 1)),
                       _F32(0), _F32(1))
        cos = _F32(final_frac) + _F32((1 - final_frac) * 0.5) * (
            _F32(1) + np.cos(_F32(np.pi) * prog))
        return float(_F32(base_lr) * (warm if s < warmup_steps else cos))
    return sched


def constant(base_lr: float):
    return lambda step: float(_F32(base_lr))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (the gradients of every
    parameter, in the JAX leaf order), in float32 on their device, with no
    read by the host. Each tensor's sum of squares is its
    ``torch._foreach_norm`` squared (one multi-tensor launch for all); as in
    XLA, the order of the sums within and across tensors is the
    reduction's, so the result agrees to float32 rounding."""
    tensors = [t.float() for t in tensors]
    return torch.sqrt(torch.sum(torch.stack(torch._foreach_norm(tensors)).square()))


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``;
    returns them and the global norm (a float32 tensor on their device)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    grads = list(grads)
    torch._foreach_mul_(grads, scale)
    return grads, norm
