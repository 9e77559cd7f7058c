"""`LayerNorm`: the port of `paddle_tpu/nn/layer/norm.py` (:140-167),
over the plain `layer_norm` op (`ops/norm_ops.py`); the weight ones and
the bias zeros, f32 on `device` (None: the card). `amp.decorate` leaves
its parameters f32, as the JAX package's `_is_norm_layer` does."""
from __future__ import annotations

import torch.nn as nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import Constant, create_parameter

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = 1
        for s in self._normalized_shape:
            n *= s
        self.weight = create_parameter([n], dev, initializer=Constant(1.0))
        self.bias = create_parameter([n], dev, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
