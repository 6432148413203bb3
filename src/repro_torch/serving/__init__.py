"""One-shot warm-start serving: drafts and ``WarmStartServer``."""

from repro_torch.serving.drafts import corruption_draft, uniform_draft
from repro_torch.serving.engine import PerNFECostModel, WarmStartServer

__all__ = ["uniform_draft", "corruption_draft", "PerNFECostModel", "WarmStartServer"]
