"""Train state: params + optimizer state + step counter (torch port of the
JAX package's ``training/state.py``).

``params`` is the ``Model`` itself: it holds its weights, which the
optimizer updates in place, so a new state shares the module with the
old. ``step`` is an int32 scalar on the host, as the optimizer's is.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.convert import jax_leaves


class TrainState(NamedTuple):
    params: Any          # the Model (an nn.Module)
    opt_state: Any
    step: torch.Tensor

    @classmethod
    def create(cls, model, optimizer) -> "TrainState":
        return cls(params=model, opt_state=optimizer.init(jax_leaves(model)),
                   step=torch.zeros((), dtype=torch.int32))
