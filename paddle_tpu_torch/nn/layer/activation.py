"""`Tanh` and `ReLU`: the port of `paddle_tpu/nn/layer/activation.py`'s."""
from __future__ import annotations

import torch.nn as nn

from .. import functional as F

__all__ = ["Tanh", "ReLU"]


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)
