"""StarCoder2 3B — dense code LM with GQA and RoPE [arXiv:2402.19173].

30 layers, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152,
LayerNorm + biases, non-gated GELU MLP, RoPE theta 999999, tied embeddings,
16k sliding window in the original (we keep full attention as the model
card's default eval mode; window is exercised by the long-context variant).

The port's copy of the JAX package's ``configs/starcoder2_3b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    pattern=("attn",),
    rope_theta=999_999.0,
    use_bias=True,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
    max_seq_len=16384,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-3b-smoke",
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
