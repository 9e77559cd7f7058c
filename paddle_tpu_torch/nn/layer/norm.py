"""`LayerNorm` and the BatchNorm family: the port of
`paddle_tpu/nn/layer/norm.py` (:24-167), over the plain `layer_norm`
and `batch_norm` ops (`ops/norm_ops.py`); the weights ones and the
biases zeros, f32 on `device` (None: the card). `amp.decorate` leaves
their parameters and buffers f32, as the JAX package's `_is_norm_layer`
does. `LayerNorm` reads `weight_attr` / `bias_attr` as `nn.ParamAttr`
says (False: no weight, or no bias).

A BatchNorm layer keeps its running statistics in the persistent f32
buffers `_mean` (zeros) and `_variance` (ones), the JAX package's names,
so that its state dict carries over key for key. In training (unless
`use_global_stats`) it normalises by the batch's statistics and writes
the new running ones into those buffers in place, under `no_grad`:
`momentum * old + (1 - momentum) * batch`, Paddle's convention (0.9).
The training statistics are one-pass E[x^2] - E[x]^2 in f32, which
cancels when |mean| >> std; `set_flags({"FLAGS_stable_bn_stats": 1})`
(or the environment variable) switches to the two-pass variance.
`SyncBatchNorm` is not ported."""
from __future__ import annotations

import torch
import torch.nn as nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import Constant, create_parameter

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = 1
        for s in self._normalized_shape:
            n *= s
        self.register_parameter("weight", create_parameter(
            [n], dev, initializer=Constant(1.0), attr=weight_attr))
        self.register_parameter("bias", create_parameter(
            [n], dev, is_bias=True, attr=bias_attr))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.register_parameter("weight", create_parameter(
            [num_features], dev, initializer=Constant(1.0),
            attr=weight_attr))
        self.register_parameter("bias", create_parameter(
            [num_features], dev, is_bias=True, attr=bias_attr))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)
        if self.training and not self._use_global_stats:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    """BatchNorm with an optional activation after it (`act`, a name in
    `ops.activation`: "relu", "gelu", "tanh")."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, *, device=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            from ...ops import activation as A

            out = getattr(A, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)
