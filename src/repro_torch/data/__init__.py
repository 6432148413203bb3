"""The data substrates of the paper's experiments (numpy copies of the JAX
package's ``data``: the port imports nothing of it)."""

from repro_torch.data.moons import (
    moons_dataset, draft_tier_dataset, symmetric_kl, sample_moons, quantize,
)
from repro_torch.data.text import (
    CHARS, VOCAB as TEXT_VOCAB, SyntheticCorpus, WordOracle, NGramProxyLM,
    encode, decode,
)
from repro_torch.data.images import images_dataset, frechet_distance, SEQ as IMAGE_SEQ

__all__ = [
    "moons_dataset", "draft_tier_dataset", "symmetric_kl", "sample_moons", "quantize",
    "CHARS", "TEXT_VOCAB", "SyntheticCorpus", "WordOracle", "NGramProxyLM",
    "encode", "decode", "images_dataset", "frechet_distance", "IMAGE_SEQ",
]
