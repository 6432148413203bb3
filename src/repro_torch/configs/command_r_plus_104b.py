"""Command R+ 104B — dense decoder, GQA, no biases
[hf:CohereForAI/c4ai-command-r-plus; card: CohereForAI/c4ai-command-r-v01].

64 layers, d_model 12288, 96 heads (GQA kv=8), d_ff 33792, vocab 256000,
LayerNorm (no bias per the no-bias card note), SwiGLU, tied embeddings,
RoPE theta 75e4 (Command-R family uses large theta for 128k context).

The port's copy of the JAX package's ``configs/command_r_plus_104b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    pattern=("attn",),
    rope_theta=750_000.0,
    norm="layernorm",
    use_bias=False,
    tie_embeddings=True,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="command-r-plus-104b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        max_seq_len=512,
        dtype="float32",
    )
