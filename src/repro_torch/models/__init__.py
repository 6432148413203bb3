"""The torch backbones (decoder-only ``Model``, the encoder-decoder
``EncDecModel``) and the LSTM draft."""

from repro_torch.models.encdec import Conditioned, EncDecModel
from repro_torch.models.lstm import LSTMConfig, LSTMModel
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "EncDecModel", "Conditioned", "build_model", "LSTMConfig", "LSTMModel"]
