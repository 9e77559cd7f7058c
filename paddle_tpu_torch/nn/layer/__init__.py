"""paddle_tpu_torch.nn.layer — the port's layers (`paddle_tpu/nn/layer`)."""
from .activation import Tanh
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "Tanh"]
