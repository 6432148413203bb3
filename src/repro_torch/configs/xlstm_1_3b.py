"""xLSTM 1.3B — sLSTM + mLSTM recurrent LM, block ratio 7 mLSTM : 1 sLSTM
[arXiv:2405.04517].

48 layers, d_model 2048, 4 heads (assignment's GQA kv=4 maps to the 4
memory heads of the xLSTM blocks), no separate FFN (d_ff=0; the blocks
carry their own up/down projections), vocab 50304 (GPT-NeoX tokenizer).

The port's copy of the JAX package's ``configs/xlstm_1_3b.py``, field for field.
"""

from repro_torch.configs.base import ModelConfig, SSMSettings

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    rope_type="none",
    norm="layernorm",
    tie_embeddings=True,
    ssm=SSMSettings(mlstm_proj_factor=2.0, slstm_proj_factor=1.3333),
    max_seq_len=1_048_576,   # recurrent: context bounded only by state
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-1.3b-smoke",
        num_layers=8,            # one full 7:1 pattern group
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        vocab_size=512,
        max_seq_len=512,
        dtype="float32",
    )
