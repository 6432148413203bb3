"""Zamba2 2.7B — Mamba2 backbone with a shared attention+MLP block invoked
periodically (weights shared, per-invocation fuse projection)
[arXiv:2411.15242].

54 layers, d_model 2560, shared attention 32 heads (kv=32), d_ff 10240,
vocab 32000, Mamba2 state 64, pattern: 5 Mamba2 blocks then one shared-
attention invocation (9 groups).

The port's copy of the JAX package's ``configs/zamba2_2_7b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig, SSMSettings

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "zshared"),
    rope_theta=10_000.0,
    ssm=SSMSettings(state_dim=64, conv_width=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
    max_seq_len=1_048_576,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-2.7b-smoke",
        num_layers=6,            # one full 5 mamba + 1 shared group
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm=SSMSettings(state_dim=16, conv_width=4, expand=2, head_dim=32, chunk=32),
        max_seq_len=512,
        dtype="float32",
    )
