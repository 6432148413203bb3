"""Gemma 3 1B (pretrained) — dense decoder with 5:1 local:global sliding
window attention, 128k context [hf:google/gemma-3-1b-pt; Gemma 3 report,
arXiv:2503.19786].

26 layers, d_model 1152, 4 query heads (GQA kv=1), head_dim 256,
d_ff 6912, vocab 262144, sliding window 512, RoPE theta 1e6 (global) /
1e4 (local), RMSNorm with qk-norm and post-norms, tied embeddings scaled
by sqrt(d_model).

The port's copy of the JAX package's ``configs/gemma3_1b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=512,
    rope_type="dual",
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    qk_norm=True,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-1b-smoke",
        num_layers=6,            # one full 5:1 pattern group
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=16,
        max_seq_len=512,
        dtype="float32",
    )
