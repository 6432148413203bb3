"""Whisper medium — encoder-decoder speech model [arXiv:2212.04356].
Transformer backbone only: the mel + conv frontend is a STUB; the caller
supplies 1500 precomputed frame embeddings of width d_model.

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA, kv=16),
d_ff 4096, vocab 51865, LayerNorm + biases, GELU, no RoPE (sinusoidal
positions; the decoder's learned ones are sinusoids too, as in the JAX
package's ``models/encdec.py``).

The port's copy of the JAX package's ``configs/whisper_medium.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    pattern=("attn",),
    rope_type="none",
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    use_bias=True,
    tie_embeddings=True,
    is_encoder_decoder=True,
    num_encoder_layers=24,
    num_audio_frames=1500,
    max_seq_len=524288,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-medium-smoke",
        num_layers=2,
        num_encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_audio_frames=32,
        max_seq_len=512,
        dtype="float32",
    )
