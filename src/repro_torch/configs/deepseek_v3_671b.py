"""DeepSeek-V3 671B — MoE with Multi-head Latent Attention and multi-token
prediction [arXiv:2412.19437].

61 layers (first 3 dense, 58 MoE), d_model 7168, 128 heads (MLA:
q_lora 1536, kv_lora 512, qk nope 128 + rope 64, v 128), dense-layer
d_ff 18432, MoE: 1 shared + 256 routed experts, top-8, expert d_ff 2048,
vocab 129280. MTP implemented as an auxiliary next-token head (depth-1)
on the train step.

The port's copy of the JAX package's ``configs/deepseek_v3_671b.py``, field for field.
"""

from repro_torch.configs.base import MLASettings, ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                      # dense layers / not used by experts
    vocab_size=129280,
    prefix=("mla",) * 3,
    pattern=("mla_moe",),
    rope_theta=10_000.0,
    moe=MoESettings(
        num_experts=256,
        num_experts_per_tok=8,
        d_ff=2048,
        num_shared_experts=1,
        capacity_factor=1.25,
        router_aux_weight=0.0001,    # v3 uses (mostly) aux-loss-free balancing
    ),
    mla=MLASettings(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
    tie_embeddings=False,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v3-smoke",
        num_layers=2,
        prefix=("mla",),
        pattern=("mla_moe",),
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        moe=MoESettings(num_experts=4, num_experts_per_tok=2, d_ff=64,
                        num_shared_experts=1),
        mla=MLASettings(q_lora_rank=64, kv_lora_rank=32,
                        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
        max_seq_len=512,
        dtype="float32",
    )
