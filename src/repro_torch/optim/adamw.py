"""AdamW with optional AMSGrad (the paper trains with AMSGrad, Reddi et al.
2018) and a configurable moment dtype: torch port of the JAX package's
``optim/adamw.py``.

The parameters come as the JAX leaves (``repro_torch.convert.jax_leaves``):
``{leaf name: [tensor, ...]}`` in the JAX leaf order, one tensor a layer
for a stacked leaf (``stack|blocks|p{p}|...``), one for the rest. The
moments are one tensor a leaf in the JAX leaf's shape (stacked), so the
state is the JAX ``AdamWState`` leaf for leaf; the update is elementwise
and runs on each layer's view of them. Parameters and moments are updated
in place (the JAX optimizer returns new trees).

``update`` computes the JAX ``upd`` term for term in float32 with
multi-tensor ``torch._foreach_*`` ops, each of which keeps that order. The
step, learning rate and bias corrections are host values (float32,
computed on the host from the host step), so nothing reads the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

Leaves = Dict[str, List[torch.Tensor]]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# the JAX leaves that stack layers: a pattern position's repeats, and the
# encoder-decoder's blocks (``convert.jax_leaf_name``)
STACKED_PREFIXES = ("stack|blocks|", "enc_blocks|", "dec_blocks|")


def is_stacked(name: str) -> bool:
    """Whether JAX leaf ``name`` stacks layers along its leading axis."""
    return name.startswith(STACKED_PREFIXES)


def leaf_shape(name: str, tensors: List[torch.Tensor]) -> tuple:
    if is_stacked(name):
        return (len(tensors),) + tuple(tensors[0].shape)
    return tuple(tensors[0].shape)


def layer_views(name: str, leaf: torch.Tensor) -> List[torch.Tensor]:
    """The per-layer views of a stacked leaf (or the leaf itself)."""
    return list(leaf.unbind(0)) if is_stacked(name) else [leaf]


def lr_at(learning_rate, step: int) -> float:
    if callable(learning_rate):
        return float(learning_rate(step))
    return float(np.float32(learning_rate))


class AdamWState(NamedTuple):
    step: torch.Tensor                          # () int32, on the host
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    nu_max: Optional[Dict[str, torch.Tensor]]   # AMSGrad running max (None if disabled)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False
    moments_dtype: Optional[str] = None   # None -> same as param dtype

    def _mdt(self, p: torch.Tensor):
        return p.dtype if self.moments_dtype is None else _DTYPES[self.moments_dtype]

    def init(self, params: Leaves) -> AdamWState:
        def zeros():
            return {n: torch.zeros(leaf_shape(n, ps), dtype=self._mdt(ps[0]),
                                   device=ps[0].device) for n, ps in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros(), nu=zeros(),
                          nu_max=zeros() if self.amsgrad else None)

    @torch.no_grad()
    def update(self, grads: Leaves, state: AdamWState, params: Leaves):
        """One step on ``params`` in place; returns ``(params, new state)``."""
        step = int(state.step) + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(step))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(step))
        lr = lr_at(self.learning_rate, step)
        b1, b2 = self.b1, self.b2

        g, p, m, v, vmax = [], [], [], [], []
        for name, ps in params.items():
            g += [x.float() for x in grads[name]]
            p += ps
            m += layer_views(name, state.mu[name])
            v += layer_views(name, state.nu[name])
            if self.amsgrad:
                vmax += layer_views(name, state.nu_max[name])
        # moments kept in another dtype update through float32 copies
        m32 = [x if x.dtype == torch.float32 else x.float() for x in m]
        v32 = [x if x.dtype == torch.float32 else x.float() for x in v]
        vmax32 = [x if x.dtype == torch.float32 else x.float() for x in vmax]

        # m_new = b1 * m + (1 - b1) * g
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1 - b1))
        # v_new = b2 * v + (1 - b2) * g^2
        torch._foreach_mul_(v32, b2)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_add_(v32, sq)
        del sq
        # denom = sqrt(max(vmax, v_new) / bc2) + eps  (AMSGrad) or sqrt(v_new / bc2) + eps
        if self.amsgrad:
            torch._foreach_maximum_(vmax32, v32)
            denom = torch._foreach_div(vmax32, bc2)
        else:
            denom = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        # upd = (m_new / bc1) / denom (+ wd * p);  p = p - lr * upd
        upd = torch._foreach_div(m32, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p, upd)

        for dst, src in ((m, m32), (v, v32), (vmax, vmax32)):
            lowp = [(d, s) for d, s in zip(dst, src) if d is not s]
            if lowp:
                torch._foreach_copy_([d for d, _ in lowp], [s for _, s in lowp])
        return params, state._replace(step=torch.tensor(step, dtype=torch.int32))
