"""paddle_tpu_torch.nn — the part of `paddle_tpu.nn` the port's models
use: the layers `Linear`, `Embedding`, `Dropout`, `LayerNorm`, `Tanh`
and `LayerList` (torch's `ModuleList`), `functional`, `initializer`,
and the gradient clips (`nn/clip.py`)."""
from __future__ import annotations

from torch.nn import ModuleList as LayerList

from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, LayerNorm, Linear, Tanh

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Linear", "Embedding", "Dropout", "LayerNorm", "Tanh",
           "LayerList", "functional", "initializer"]
