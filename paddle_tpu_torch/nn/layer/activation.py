"""`Tanh`: the port of `paddle_tpu/nn/layer/activation.py`'s."""
from __future__ import annotations

import torch.nn as nn

from .. import functional as F

__all__ = ["Tanh"]


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
