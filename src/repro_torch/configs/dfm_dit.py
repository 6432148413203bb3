"""The paper's own DFM denoiser: DiT-style transformer (Peebles & Xie 2022)
as used by Gat et al. (2024) and the paper's §4.2 — 12 layers, 12 heads,
hidden 768 (~90M params at vocab 27 for Text-8).

Bidirectional attention + additive time conditioning (the `t` input of
v_theta). Copy of the JAX package's ``configs/dfm_dit.py``; note that
``replace(d_model=..., num_heads=...)`` keeps ``head_dim=64``, so
``tiny_config``'s query projection is ``(192, 384)``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dfm-dit",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=27,                 # Text-8: a-z + space
    pattern=("attn",),
    rope_theta=10_000.0,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    tie_embeddings=False,
    max_seq_len=4096,
    dtype="float32",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="dfm-dit-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        max_seq_len=512,
    )


def tiny_config(vocab_size: int = 27, seq_len: int = 256) -> ModelConfig:
    """CPU-trainable variant used by examples/ and benchmarks/."""
    return CONFIG.replace(
        name="dfm-dit-tiny",
        num_layers=4,
        d_model=192,
        num_heads=6,
        num_kv_heads=6,
        d_ff=768,
        vocab_size=vocab_size,
        max_seq_len=seq_len,
    )
