"""The draft stage (port of the JAX package's ``drafting/ar_engine.py``,
``drafting/ref.py`` and the cost-ratio part of ``drafting/quality.py``): a
KV-cached draft engine over a transformer or the LSTM, its cache-free
oracle, and the measured draft/NFE cost ratio."""

from repro_torch.drafting.ar_engine import (
    ARDraftEngine, DraftEngineStats, LSTMDraftAdapter, TransformerDraftAdapter, row_gumbel,
)
from repro_torch.drafting.quality import CostRatioReport, measure_cost_ratio
from repro_torch.drafting.ref import oracle_generate_rows

__all__ = ["ARDraftEngine", "DraftEngineStats", "LSTMDraftAdapter", "TransformerDraftAdapter",
           "row_gumbel", "measure_cost_ratio", "CostRatioReport", "oracle_generate_rows"]
