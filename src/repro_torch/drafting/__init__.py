"""The AR draft stage (port of the JAX package's ``drafting/ar_engine.py``
and ``drafting/ref.py``): a KV-cached transformer draft engine and its
cache-free oracle."""

from repro_torch.drafting.ar_engine import (
    ARDraftEngine, DraftEngineStats, TransformerDraftAdapter, row_gumbel,
)
from repro_torch.drafting.ref import oracle_generate_rows

__all__ = ["ARDraftEngine", "DraftEngineStats", "TransformerDraftAdapter", "row_gumbel",
           "oracle_generate_rows"]
