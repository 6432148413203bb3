"""Qwen2-VL 72B — VLM decoder with M-RoPE and dynamic resolution
[arXiv:2409.12191]. The ViT frontend is a STUB: the caller supplies patch
embeddings (B, P, 1280) which a linear projector maps to d_model;
M-RoPE 3-D position ids (t/h/w) are supplied alongside.

80 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064,
RMSNorm, SwiGLU, untied embeddings, mrope sections (16, 24, 24).

The port's copy of the JAX package's ``configs/qwen2_vl_72b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    pattern=("attn",),
    rope_type="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    num_vision_tokens=256,           # stub patch count prepended
    tie_embeddings=False,
    use_bias=False,
    max_seq_len=131072,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-72b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        mrope_sections=(8, 4, 4),
        d_ff=256,
        vocab_size=512,
        num_vision_tokens=8,
        max_seq_len=512,
        dtype="float32",
    )
