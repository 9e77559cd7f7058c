"""Activation layers: the port of `paddle_tpu/nn/layer/activation.py`
(28 names), each a `Layer` over its op in `nn.functional`
(`ops.activation`). `PReLU` holds its weight ([num_parameters], filled
with `init`) on its keyword-only `device` (None: the card); `RReLU`
draws its slopes in training only."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = [
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
    "LeakyReLU", "PReLU", "RReLU", "ELU", "SELU", "CELU", "Silu", "Swish",
    "Mish", "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink",
    "Softshrink", "Softplus", "Softsign", "Tanhshrink", "ThresholdedReLU",
    "LogSigmoid", "Maxout", "GLU",
]


def _mk(name, fname, **defaults):
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            merged = dict(defaults)
            merged.update({k: v for k, v in kwargs.items() if k != "name"})
            self._kwargs = merged

        def forward(self, x):
            return getattr(F, fname)(x, **self._kwargs)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _mk("ReLU", "relu")
ReLU6 = _mk("ReLU6", "relu6")
Sigmoid = _mk("Sigmoid", "sigmoid")
Tanh = _mk("Tanh", "tanh")
Silu = _mk("Silu", "silu")
Swish = _mk("Swish", "swish")
Mish = _mk("Mish", "mish")
Hardswish = _mk("Hardswish", "hardswish")
Softsign = _mk("Softsign", "softsign")
Tanhshrink = _mk("Tanhshrink", "tanhshrink")
LogSigmoid = _mk("LogSigmoid", "log_sigmoid")
SELU = _mk("SELU", "selu")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        from ..initializer import Constant

        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)
