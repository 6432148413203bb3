"""Adafactor (Shazeer & Stern 2018): factored second moments, no first
moment (beta1 = 0). Torch port of the JAX package's ``optim/adafactor.py``.

The JAX package stacks the layers of each pattern position into one leaf
(``stack|blocks|p0|attn|wq|b`` is ``(L, d)``), and Adafactor factors
leaves by their stacked shape: a per-layer bias or norm scale is a 2-D
leaf there, with row factors ``(L,)`` and column factors ``(d,)``, and the
update clipping's RMS is taken over all L layers of a leaf at once. So this
optimizer works on the JAX leaves: it stacks the gradients and parameters
of the layers that form one leaf (``repro_torch.convert.jax_leaves``),
updates the stacked leaf and writes each layer back in place. A
per-parameter Adafactor would compute a different optimizer.

As AdamW's, ``update`` is a host prologue (:meth:`Adafactor.hyper`: the
step's ``beta`` and learning rate in float32) and a device body
(:meth:`Adafactor.apply`) that reads them from a float32 tensor, a CUDA
graph's input, or from Python floats, with the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Union

import numpy as np
import torch

from repro_torch.optim.adamw import (
    Leaves, device_scalars, is_stacked, leaf_shape, lr_at, next_step,
)


class AdafactorState(NamedTuple):
    step: torch.Tensor               # () int32, on the host
    vr: Dict[str, torch.Tensor]      # row factors (or full v for vectors)
    vc: Dict[str, torch.Tensor]      # col factors (zeros-size-1 placeholder for vectors)


def stack_leaf(name: str, tensors: List[torch.Tensor]) -> torch.Tensor:
    """The JAX leaf of ``tensors``: stacked along a new leading axis for a
    stacked leaf, else the one tensor."""
    return torch.stack(tensors) if is_stacked(name) else tensors[0]


@dataclasses.dataclass(frozen=True)
class Adafactor:
    learning_rate: Union[Callable[[int], float], float] = 1e-3
    decay: float = 0.8          # t^-decay running average
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params: Leaves) -> AdafactorState:
        vr, vc = {}, {}
        for name, ps in params.items():
            shape, dev = leaf_shape(name, ps), ps[0].device
            if len(shape) >= 2:
                vr[name] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                vc[name] = torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32, device=dev)
            else:
                vr[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
                vc[name] = torch.zeros((1,), dtype=torch.float32, device=dev)
        return AdafactorState(step=torch.zeros((), dtype=torch.int32), vr=vr, vc=vc)

    def update_leaf(self, g: torch.Tensor, vr: torch.Tensor, vc: torch.Tensor,
                    p: torch.Tensor, beta, lr):
        """The JAX ``upd`` on one (stacked) leaf: returns (new p, vr, vc).
        ``beta`` and ``lr`` are Python floats or float32 0-d tensors on the
        leaf's device (``1 - beta`` rounds to the same float32 either way)."""
        gf = g.float()
        g2 = torch.square(gf) + self.eps
        if p.ndim >= 2:
            vr_new = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
            vc_new = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
            rfac = vr_new / torch.clamp_min(torch.mean(vr_new, dim=-1, keepdim=True), self.eps)
            u = gf / torch.sqrt(rfac[..., None] * vc_new[..., None, :] + self.eps)
        else:
            vr_new = beta * vr + (1 - beta) * g2
            vc_new = vc
            u = gf / torch.sqrt(vr_new + self.eps)
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.mean(torch.square(u)) + self.eps)
        u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
        if self.weight_decay:
            u = u + self.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), vr_new, vc_new

    def hyper(self, state: AdafactorState) -> np.ndarray:
        """The host prologue of the step after ``state``'s: (beta, lr) in
        float32."""
        step = int(state.step) + 1
        f32 = np.float32
        return np.array([f32(1.0) - f32(step) ** f32(-self.decay),
                         lr_at(self.learning_rate, step)], np.float32)

    def update(self, grads: Leaves, state: AdafactorState, params: Leaves):
        """One step on ``params`` in place; returns ``(params, new state)``."""
        device = next(iter(params.values()))[0].device
        self.apply(grads, state, params, device_scalars(self.hyper(state), device))
        return params, next_step(state)

    @torch.no_grad()
    def apply(self, grads: Leaves, state: AdafactorState, params: Leaves, hyper) -> None:
        """The device body of one step, in place on ``params`` and the
        factors: ``hyper`` is :meth:`hyper`'s (beta, lr) as a float32 tensor
        on the parameters' device, or as Python floats."""
        beta, lr = hyper
        for name, ps in params.items():
            p_new, vr, vc = self.update_leaf(stack_leaf(name, grads[name]), state.vr[name],
                                             state.vc[name], stack_leaf(name, ps), beta, lr)
            state.vr[name].copy_(vr)
            state.vc[name].copy_(vc)
            if is_stacked(name):
                torch._foreach_copy_(ps, list(p_new.unbind(0)))
            else:
                ps[0].copy_(p_new)
