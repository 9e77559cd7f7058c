"""paddle_tpu_torch.nn.layer — the port's layers (`paddle_tpu/nn/layer`)."""
from .activation import ReLU, Tanh
from .common import Dropout, Embedding, Flatten, Linear
from .container import LayerList, Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["Linear", "Embedding", "Dropout", "Flatten", "LayerNorm",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "Tanh", "ReLU", "Sequential", "Conv1D", "Conv2D", "Conv3D",
           "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "CrossEntropyLoss"]
