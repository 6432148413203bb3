"""Snowflake Arctic 480B — dense-MoE hybrid: every layer runs a top-2 MoE
(128 experts) in parallel with a dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

35 layers, d_model 7168, 56 heads (GQA kv=8), dense residual d_ff 4864,
expert d_ff 4864, vocab 32000, RMSNorm, SwiGLU.

The port's copy of the JAX package's ``configs/arctic_480b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                         # dense residual branch
    vocab_size=32000,
    pattern=("moe_res",),
    rope_theta=1_000_000.0,
    moe=MoESettings(
        num_experts=128,
        num_experts_per_tok=2,
        d_ff=4864,
        dense_residual=True,
        capacity_factor=1.25,
        router_aux_weight=0.001,
    ),
    tie_embeddings=False,
    max_seq_len=32768,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="arctic-480b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        moe=MoESettings(num_experts=4, num_experts_per_tok=2, d_ff=64,
                        dense_residual=True),
        max_seq_len=512,
        dtype="float32",
    )
