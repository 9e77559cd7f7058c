"""paddle_tpu_torch.nn — the part of `paddle_tpu.nn` the port has:
`Layer` (a `torch.nn.Module` with Paddle's methods) and `ParamAttr`;
the layers `Linear`, `Embedding`, `Dropout`, `Flatten`, `LayerNorm`,
the BatchNorm family, every activation layer of
`paddle_tpu/nn/layer/activation.py`, `Conv1D/2D/3D`, `MaxPool2D`,
`AvgPool2D`, `AdaptiveAvgPool2D`, `CrossEntropyLoss`, `Sequential` and
`LayerList`; `MultiHeadAttention` and the `Transformer` family;
`functional`, `initializer`, and the gradient clips (`nn/clip.py`)."""
from __future__ import annotations

from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_all
from .param_attr import ParamAttr

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "ParamAttr", "functional", "initializer"] + _layer_all
