"""paddle_tpu_torch.nn — the part of `paddle_tpu.nn` the port's models
use: the layers `Linear`, `Embedding`, `Dropout`, `Flatten`,
`LayerNorm`, the BatchNorm family, `Tanh`, `ReLU`, `Conv1D/2D/3D`,
`MaxPool2D`, `AvgPool2D`, `AdaptiveAvgPool2D`, `CrossEntropyLoss`,
`Sequential` and `LayerList`, `functional`,
`initializer`, and the gradient clips (`nn/clip.py`)."""
from __future__ import annotations

from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv2D, Conv3D,
                    CrossEntropyLoss, Dropout, Embedding, Flatten, LayerList,
                    LayerNorm, Linear, MaxPool2D, ReLU, Sequential, Tanh)

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Linear", "Embedding", "Dropout", "Flatten", "LayerNorm",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "Tanh",
           "ReLU", "Conv1D", "Conv2D", "Conv3D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "CrossEntropyLoss", "Sequential",
           "LayerList", "functional", "initializer"]
