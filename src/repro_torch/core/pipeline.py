"""End-to-end warm-start generation pipeline (paper Fig. 1, bottom; port of
the JAX package's ``core/pipeline.py``).

    drafts = draft_model.generate(...)          # negligible cost
    x_1    = EulerSampler(path(t0)).sample(...) # ceil(N*(1-t0)) NFEs

with NFE accounting asserting the guarantee. On the card each refine step
with no ``step_fn`` is one ``ws_step_gumbel`` launch, and every backbone
evaluation of a ``repro_torch.models.Model`` runs its attention through
``flash_attn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import prng
from repro_torch.core import guarantees
from repro_torch.core.draft import DraftModel
from repro_torch.core.paths import WarmStartPath, uniform_noise
from repro_torch.core.sampler import EulerSampler
from repro_torch.device import resolve_device


@dataclasses.dataclass
class WarmStartPipeline:
    """Draft -> flow-refine generation.

    Attributes:
      model_fn: ``(tokens (B,N), t (B,)) -> logits`` of the trained v_theta.
      draft: the lightweight draft model (None -> cold start from noise).
      path: warm-start path (t0 = 0 with draft None reproduces DFM).
      cold_nfe: steps the cold-start baseline uses (defines step size h).
      device: where the flow runs; the drafts are moved there.
    """

    model_fn: Callable
    draft: Optional[DraftModel]
    path: WarmStartPath
    cold_nfe: int
    vocab_size: int
    seq_len: int
    temperature: float = 1.0
    argmax_final: bool = False
    step_fn: Optional[Callable] = None
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def sampler(self) -> EulerSampler:
        # memoised, as in the JAX pipeline (which caches its compiled loop there)
        smp = getattr(self, "_sampler", None)
        if smp is None:
            smp = EulerSampler(path=self.path, num_steps=self.cold_nfe,
                               temperature=self.temperature, argmax_final=self.argmax_final,
                               step_fn=self.step_fn)
            self._sampler = smp
        return smp

    def generate(self, rng: torch.Tensor, num: int):
        """Returns (samples (num, N) int32 on ``device``, guarantees.SpeedupReport)."""
        k_draft, k_flow = prng.split(rng, 2)
        if self.draft is None:
            x_init = uniform_noise(k_draft, (num, self.seq_len), self.vocab_size,
                                   device=self.device)
            draft_cost = 0.0
        else:
            x_init = self.draft.generate(k_draft, num).to(self.device)
            draft_cost = self.draft.cost_ratio
        x, stats = self.sampler().sample(k_flow, self.model_fn, x_init)
        guarantees.require_guarantee(self.cold_nfe, self.path.t0, int(stats.nfe))
        report = guarantees.speedup_report(self.cold_nfe, self.path.t0, draft_cost)
        return x, report
