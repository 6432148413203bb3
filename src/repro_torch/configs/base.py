"""Model configs for the PyTorch port: this package's own copy of the JAX
package's ``repro/configs/base.py`` ``ModelConfig`` and ``RunConfig`` (the
port imports nothing of the JAX package). Field names, defaults and
derived values are identical, so a config means the same model and the
same run on both sides.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple


# --------------------------------------------------------------------------
# Layer-type vocabulary (see models/transformer.py):
#   "attn"        full-attention transformer block (attn + MLP)
#   "local"       sliding-window attention block
#   "moe"         attention + MoE-FFN block
#   "mla"         MLA attention + MLP block (DeepSeek dense layers)
#   "mla_moe"     MLA attention + MoE block (DeepSeek MoE layers)
#   "moe_res"     attention + (MoE || dense residual) block (Arctic)
#   "mamba"       Mamba2 SSD block
#   "zshared"     Zamba2 shared attention+MLP block (weights shared)
#   "mlstm"       xLSTM matrix-memory block
#   "slstm"       xLSTM scalar-memory block
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoESettings:
    num_experts: int = 0
    num_experts_per_tok: int = 2
    d_ff: int = 0                    # per-expert hidden size
    num_shared_experts: int = 0      # DeepSeek shared expert(s)
    dense_residual: bool = False     # Arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    router_noise: float = 0.0
    # §Perf knob: sharding of the (E, C, d) dispatch buffer's capacity dim.
    # "none"  — capacity replicated across data shards (baseline; GSPMD
    #           gathers tokens to every expert shard);
    # "data"  — capacity sharded over the data axis (each data shard
    #           scatters its local tokens; combine via reduce-scatter).
    capacity_sharding: str = "none"
    # §Perf knob: dispatch implementation for training/prefill.
    # "gspmd"    — capacity scatter, collectives chosen by the partitioner;
    # "shardmap" — explicit expert-parallel all_to_all (moe_shardmap.py).
    dispatch_impl: str = "gspmd"


@dataclasses.dataclass(frozen=True)
class MLASettings:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMSettings:
    state_dim: int = 64      # N (SSD state per head-channel)
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64       # mamba2 P
    chunk: int = 128
    # xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # layer pattern: optional `prefix` layers, then `pattern` repeats,
    # remainder handled explicitly (all unrolled except the repeats).
    pattern: Tuple[str, ...] = ("attn",)
    prefix: Tuple[str, ...] = ()
    # attention details
    rope_theta: float = 10000.0
    rope_type: str = "default"       # none | default | mrope | dual (gemma3)
    sliding_window: int = 4096
    local_rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    use_bias: bool = False           # starcoder2 uses bias
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu
    mlp_gated: bool = True           # gated (SwiGLU) vs plain 2-layer MLP
    post_norms: bool = False         # gemma3: post-attn/post-ffn norms
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: scale embeds by sqrt(d_model)
    max_seq_len: int = 131072

    moe: MoESettings = MoESettings()
    mla: Optional[MLASettings] = None
    ssm: SSMSettings = SSMSettings()

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_audio_frames: int = 1500

    # vlm (qwen2-vl)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    num_vision_tokens: int = 0       # patch embeds prepended in input stub

    # deepseek multi-token prediction auxiliary head
    mtp_depth: int = 0

    # dtypes
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "float32"

    # DFM-denoiser mode additions
    time_embed_dim: int = 256

    # long-context variant: replace full attention with sliding window of
    # this size when lowering long_500k for full-attention archs (see
    # DESIGN.md §4 policy). None = faithful (full attention everywhere).
    long_context_window: Optional[int] = 8192

    # attention implementation: "xla" (einsum, O(S*T) scores — baseline) |
    # "chunked" (flash-style online softmax over key chunks, O(S*chunk)
    # scores — §Perf iteration; the Pallas kernel is the TPU execution
    # path and is validated against both).
    attn_impl: str = "xla"
    attn_chunk: int = 1024
    # MLA decode: absorb the latent up-projections into the query/output
    # (DeepSeek-V2 §"absorbed" inference trick) instead of expanding the
    # per-head K/V for the whole cache every step. §Perf iteration.
    mla_absorb: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: heads {self.num_heads} not divisible by kv {self.num_kv_heads}")

    def scan_split(self) -> Tuple[int, Tuple[str, ...]]:
        """(num_scanned_groups, remainder_layer_types) of the JAX package's
        stacked layer layout (prefix layers are unrolled there)."""
        n = self.num_layers - len(self.prefix)
        reps = n // len(self.pattern)
        rem = n - reps * len(self.pattern)
        return reps, self.pattern[:rem]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Trainer/launcher knobs (the JAX package's ``RunConfig``, same fields
    and defaults; the checkpoint directory sits under the temp directory,
    ``$TMPDIR`` when set)."""
    arch: str = "dfm_dit"
    shape: str = "train_4k"
    t0: float = 0.8                  # warm-start time (0 = cold-start DFM)
    cold_nfe: int = 1024             # baseline step count (paper text exps)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 300
    batch_size: int = 32
    seed: int = 0
    grad_clip: float = 1.0
    amsgrad: bool = True             # paper uses AMSGrad
    optimizer: str = "adamw"         # adamw | adafactor
    moments_dtype: str = "float32"   # bfloat16 for >=100B configs
    remat: str = "none"              # none | block | full
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    log_every: int = 10
