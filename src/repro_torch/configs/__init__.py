"""Model configs of the port (own copies of the JAX package's)."""

from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig"]
