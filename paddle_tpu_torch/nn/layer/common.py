"""`Linear`, `Embedding`, `Dropout` and `Flatten`: the port of
`paddle_tpu/nn/layer/common.py` (:21-79, :113), as `torch.nn.Module`s.

Parameters keep the JAX package's names and layouts (`Linear.weight`
is [in, out], Xavier-normal; the bias zeros), so a state dict carries
over name for name. They are f32 on `device` (None: the card), drawn
from `generator` (a `torch.Generator` on that device; None: a fresh one
seeded 0). `weight_attr` / `bias_attr` are read as `nn.ParamAttr`
says: an initializer replaces the default draw, `bias_attr=False`
leaves `Linear` without a bias. `Dropout` draws its masks from its
`generator` (None: the package generator of the input's device,
`ops.random`)."""
from __future__ import annotations

import torch
import torch.nn as nn

from .. import functional as F
from ..initializer import create_parameter, init_source

__all__ = ["Linear", "Embedding", "Dropout", "Flatten"]


class Linear(nn.Module):
    """y = x W + b, W [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = create_parameter([in_features, out_features], dev,
                                       gen, attr=weight_attr)
        self.register_parameter("bias", create_parameter(
            [out_features], dev, gen, is_bias=True, attr=bias_attr))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(nn.Module):
    """Rows of an [num_embeddings, embedding_dim] table; the row
    `padding_idx` starts at zero and takes no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        if sparse:
            raise NotImplementedError("Embedding: sparse=True is not ported")
        dev, gen = init_source(device, generator)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = create_parameter([num_embeddings, embedding_dim],
                                       dev, gen, attr=weight_attr)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        if axis is not None:
            raise NotImplementedError("Dropout: axis is not ported")
        if mode != "upscale_in_train":
            raise NotImplementedError(f"Dropout: mode={mode!r} is not ported")
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)
