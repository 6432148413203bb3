"""One-shot warm-start serving: drafts, ``WarmStartServer`` and the AR
serving helpers."""

from repro_torch.serving.drafts import (
    BatchKeyedDraftWarning, batch_keyed_draft, corruption_draft, uniform_draft,
)
from repro_torch.serving.engine import (
    PerNFECostModel, WarmStartServer, ar_generate, make_prefill_fn, make_serve_step,
)

__all__ = ["uniform_draft", "corruption_draft", "batch_keyed_draft", "BatchKeyedDraftWarning",
           "PerNFECostModel", "WarmStartServer", "make_serve_step", "make_prefill_fn",
           "ar_generate"]
