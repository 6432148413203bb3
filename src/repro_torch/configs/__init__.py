"""Model and run configs of the port (own copies of the JAX package's).

``get_config`` / ``get_smoke_config`` map an ``--arch`` id to its full and
reduced config as the JAX registry does, for the one architecture the port
runs, ``dfm-dit``; the rest of the zoo raises.
"""

from repro_torch.configs import dfm_dit
from repro_torch.configs.base import ModelConfig, RunConfig

_MODULES = {"dfm-dit": dfm_dit}


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (the model-zoo slice); "
            f"available: {sorted(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ModelConfig", "RunConfig", "get_config", "get_smoke_config"]
