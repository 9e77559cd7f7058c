"""`MaxPool2D`, `AvgPool2D` and `AdaptiveAvgPool2D`: the port of
`paddle_tpu/nn/layer/pooling.py` (:15-80), over `nn.functional`'s
pooling ops (`ops/conv.py`). Keyword arguments go to the op as given
(`data_format`, `exclusive`, `ceil_mode`)."""
from __future__ import annotations

import torch.nn as nn

from .. import functional as F

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class _Pool(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = kwargs

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              **self.kwargs)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = kwargs

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, **self.kwargs)

    def extra_repr(self):
        return f"output_size={self.output_size}"
