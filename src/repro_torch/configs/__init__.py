"""Model and run configs of the port (own copies of the JAX package's).

``get_config`` / ``get_smoke_config`` map an ``--arch`` id to its full and
reduced config as the JAX registry does, for the architectures the port
runs: the DiT (``dfm-dit``), the dense zoo (``starcoder2-3b``,
``minitron-4b``, ``command-r-plus-104b``, ``gemma3-1b``) and the recurrent
family (``zamba2-2.7b``: Mamba2 with Zamba2's shared attention;
``xlstm-1.3b``: mLSTM/sLSTM), the encoder-decoder family
(``whisper-medium``), the MoE family (``arctic-480b``: top-2 of 128
experts beside a dense residual FFN) and the MLA family
(``deepseek-v3-671b``: multi-head latent attention, three dense prefix
layers, then top-8 of 256 experts beside a shared one, MTP depth 1) and
the VLM family (``qwen2-vl-72b``: M-RoPE over (t, h, w) position ids, a
prefix of projected patch embeddings). That is the whole of the JAX zoo.
"""

from repro_torch.configs import (
    arctic_480b, command_r_plus_104b, deepseek_v3_671b, dfm_dit, gemma3_1b, minitron_4b,
    qwen2_vl_72b, starcoder2_3b, whisper_medium, xlstm_1_3b, zamba2_2_7b,
)
from repro_torch.configs.base import ModelConfig, RunConfig

_MODULES = {
    "gemma3-1b": gemma3_1b,
    "starcoder2-3b": starcoder2_3b,
    "minitron-4b": minitron_4b,
    "command-r-plus-104b": command_r_plus_104b,
    "dfm-dit": dfm_dit,
    "zamba2-2.7b": zamba2_2_7b,
    "xlstm-1.3b": xlstm_1_3b,
    "whisper-medium": whisper_medium,
    "arctic-480b": arctic_480b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "qwen2-vl-72b": qwen2_vl_72b,
}

# the JAX registry's other ids, by the family the port still lacks (none since the VLM)
_NOT_PORTED: dict = {}


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet: its {_NOT_PORTED[arch]} "
            f"layers are missing; available: {list_archs()}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs():
    """The ids this registry holds, sorted (the JAX ``list_archs`` lists its
    whole zoo)."""
    return sorted(_MODULES)


__all__ = ["ModelConfig", "RunConfig", "get_config", "get_smoke_config", "list_archs"]
