"""The WS-DFM training path (torch port of the JAX package's ``training``)."""

from repro_torch.training.state import TrainState
from repro_torch.training.train_step import jit_train_step, make_loss_fn, make_train_step
from repro_torch.training.trainer import Trainer

__all__ = ["TrainState", "jit_train_step", "make_loss_fn", "make_train_step", "Trainer"]
