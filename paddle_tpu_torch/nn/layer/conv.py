"""`Conv1D`, `Conv2D` and `Conv3D`: the port of
`paddle_tpu/nn/layer/conv.py` (:20-97), as `torch.nn.Module`s over
`nn.functional.conv*` (`ops/conv.py`).

`weight` is [out_channels, in_channels / groups, *kernel_size] and
`bias` [out_channels] (absent with `bias_attr=False`), with the JAX
package's names, so a state dict carries over name for name. Both are
f32 on `device` (None: the card), uniform in [-1/sqrt(fan_in),
1/sqrt(fan_in)) with fan_in = in_channels / groups x the kernel's size,
drawn from `generator` (None: a fresh one seeded 0). `weight_attr` and
`padding_mode` are accepted and ignored: the JAX layers take only the
default initializer and zero padding too."""
from __future__ import annotations

import numpy as np
import torch.nn as nn

from .. import functional as F
from ..initializer import Uniform, create_parameter, init_source

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return [int(v)] * n
    return list(v)


class _ConvNd(nn.Module):
    _fn = None

    def __init__(self, n, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        init = Uniform(-bound, bound)
        self.weight = create_parameter(
            [out_channels, in_channels // groups] + self._kernel_size, dev,
            gen, initializer=init)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = create_parameter([out_channels], dev, gen,
                                         initializer=init)

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._dilation, self._groups,
                              self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 *, device=None, generator=None):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device, generator)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 *, device=None, generator=None):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device, generator)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 *, device=None, generator=None):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device, generator)
