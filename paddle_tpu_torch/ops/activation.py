"""Activations: the port of `paddle_tpu/ops/activation.py` (31 names),
with the JAX kernels' formulas: `gelu` is the exact erf form unless
`approximate` (GPT's blocks use the tanh form); `softplus` is
log(1 + e^(beta x)) / beta, x itself above `threshold`; `mish` is
x tanh(softplus(x)); `hardsigmoid` is clip(slope x + offset, 0, 1);
`selu`, `celu`, `elu`, `leaky_relu` and `prelu` as in `jax.nn`.
`rrelu` (in training) and `gumbel_softmax` draw from the package
generator of x's device (`ops.random`). `softmax_` writes its result
into x and returns x, where the JAX op rebinds x's value."""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ._common import _cast, register

_this = sys.modules[__name__]
__all__ = []


def _export(name, fn):
    setattr(_this, name, fn)
    __all__.append(name)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_SIMPLE = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0, 6),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "softsign": F.softsign,
    "tanhshrink": lambda x: x - torch.tanh(x),
    "log_sigmoid": F.logsigmoid,
}


def _make(op_name, fn):
    register(op_name)

    def op(x, name=None):
        (x,) = _cast(op_name, x)
        return fn(x)

    op.__name__ = op_name
    op.__qualname__ = op_name
    return op


for _n, _f in _SIMPLE.items():
    _export(_n, _make(_n, _f))


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _cast("softmax", x)
    out = torch.softmax(x, int(axis))
    return out.to(dtype) if dtype is not None else out


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _cast("log_softmax", x)
    out = torch.log_softmax(x, int(axis))
    return out.to(dtype) if dtype is not None else out


def gelu(x, approximate=False, name=None):
    (x,) = _cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def elu(x, alpha=1.0, name=None):
    (x,) = _cast("elu", x)
    return torch.where(x > 0, x, float(alpha) * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = _cast("selu", x)
    return float(scale) * torch.where(x > 0, x,
                                      float(alpha) * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = _cast("celu", x)
    return F.celu(x, float(alpha))


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = _cast("leaky_relu", x)
    return torch.where(x >= 0, x, float(negative_slope) * x)


def prelu(x, weight, data_format="NCHW", name=None):
    x, weight = _cast("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format == "NCHW" else -1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    if training:
        (x,) = _cast("rrelu", x)
        a = torch.rand(x.shape, device=x.device).to(x.dtype)
        a = float(lower) + (float(upper) - float(lower)) * a
        return torch.where(x >= 0, x, a * x)
    return leaky_relu(x, (lower + upper) / 2)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = _cast("hardtanh", x)
    return torch.clamp(x, float(min), float(max))


def hardshrink(x, threshold=0.5, name=None):
    (x,) = _cast("hardshrink", x)
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    (x,) = _cast("softshrink", x)
    t = float(threshold)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t,
                                                 torch.zeros_like(x)))


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = _cast("hardsigmoid", x)
    return torch.clamp(float(slope) * x + float(offset), 0.0, 1.0)


def hardswish(x, name=None):
    (x,) = _cast("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = _cast("softplus", x)
    bx = float(beta) * x
    return torch.where(bx > threshold, x, _softplus(bx) / float(beta))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    (x,) = _cast("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, float(value)))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (x,) = _cast("stanh", x)
    return float(scale_b) * torch.tanh(float(scale_a) * x)


def glu(x, axis=-1, name=None):
    (x,) = _cast("glu", x)
    return F.glu(x, int(axis))


def maxout(x, groups, axis=1, name=None):
    (x,) = _cast("maxout", x)
    axis = int(axis) % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // int(groups), int(groups)]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def softmax_(x, axis=-1, dtype=None, name=None):
    out = softmax(x, axis, dtype)
    x.copy_(out)
    return x


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    (x,) = _cast("gumbel_softmax", x)
    u = torch.rand(x.shape, device=x.device).clamp_min(
        torch.finfo(torch.float32).tiny)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / float(temperature), int(axis))
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            int(axis), torch.argmax(y, int(axis), keepdim=True), 1.0)
        y = (onehot - y).detach() + y     # straight-through
    return y


for _fn in (softmax, log_softmax, gelu, elu, selu, celu, leaky_relu, prelu,
            rrelu, hardtanh, hardshrink, softshrink, hardsigmoid, hardswish,
            softplus, thresholded_relu, stanh, glu, maxout, softmax_,
            gumbel_softmax):
    _export(_fn.__name__, _fn)
del _fn
