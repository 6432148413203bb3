"""Minitron 4B — Nemotron-4 15B pruned via activation-based structured
pruning + distillation [arXiv:2407.14679].

32 layers, d_model 3072, 24 heads (GQA kv=8), d_ff 9216, vocab 256000,
LayerNorm, squared-ReLU non-gated MLP (Nemotron family), RoPE, untied
embeddings.

The port's copy of the JAX package's ``configs/minitron_4b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    pattern=("attn",),
    rope_theta=10_000.0,
    norm="layernorm",
    act="relu",                      # squared-ReLU approximated as ReLU MLP
    mlp_gated=False,
    tie_embeddings=False,
    max_seq_len=4096,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="minitron-4b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=512,
        dtype="float32",
    )
