"""Checkpoints in the JAX package's ``.npz`` + manifest layout."""

from repro_torch.checkpoint.io import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]
