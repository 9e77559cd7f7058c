"""paddle_tpu_torch.nn.layer — the port's layers (`paddle_tpu/nn/layer`)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .common import Dropout, Embedding, Flatten, Linear
from .container import LayerList, Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .layers import Layer
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer_all

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "Flatten",
           "LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Sequential", "LayerList", "Conv1D", "Conv2D",
           "Conv3D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "CrossEntropyLoss"] + _activation_all + _transformer_all
