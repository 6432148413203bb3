"""The torch DiT backbone (dense attention configs) and the LSTM draft."""

from repro_torch.models.lstm import LSTMConfig, LSTMModel
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model", "LSTMConfig", "LSTMModel"]
