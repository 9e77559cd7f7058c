"""Parameter initializers: the port of `paddle_tpu/nn/initializer`
`Constant`, `Normal`, `Uniform` and `XavierNormal` (:51-108).

An initializer fills a tensor in place: `init(tensor, generator)`. The
random ones draw from the `torch.Generator` given (one on the tensor's
device), in f32, and cast to the tensor's dtype, as the JAX package
draws f32 normals from its key and casts. The numbers are not JAX's:
the tests carry weights across with `convert.load_reference_state_dict`.
`create_parameter` is `Layer.create_parameter` (nn/layer/layers.py:111)
for the port's layers: an f32 `nn.Parameter` on a device, zeros for a
bias and Xavier-normal otherwise unless an initializer is given, read
through the layer's `ParamAttr` (`attr=`).
`init_source(device, generator)` resolves a layer's `device=` (None:
the card) and `generator=` (None: a fresh one seeded 0 there).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ...device import resolve_device

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "create_parameter", "init_source"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:
        rf = int(np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
    else:
        fan_in = fan_out = int(np.prod(shape)) if shape else 1
    return fan_in, fan_out


class Initializer:
    def __call__(self, tensor, generator=None):
        raise NotImplementedError


def _normal(tensor, generator, mean, std):
    v = torch.randn(tuple(tensor.shape), generator=generator,
                    device=tensor.device, dtype=torch.float32)
    with torch.no_grad():
        tensor.copy_((mean + std * v).to(tensor.dtype))
    return tensor


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            tensor.fill_(self.value)
        return tensor


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, tensor, generator=None):
        return _normal(tensor, generator, self.mean, self.std)


class Uniform(Initializer):
    """Uniform in [low, high), drawn in f32."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, tensor, generator=None):
        v = torch.rand(tuple(tensor.shape), generator=generator,
                       device=tensor.device, dtype=torch.float32)
        with torch.no_grad():
            tensor.copy_((self.low + (self.high - self.low) * v).to(
                tensor.dtype))
        return tensor


class XavierNormal(Initializer):
    """std = sqrt(2 / (fan_in + fan_out)); a [in, out] weight's fans
    are its two dims."""

    def __call__(self, tensor, generator=None):
        fi, fo = _fans(tensor.shape)
        return _normal(tensor, generator, 0.0, math.sqrt(2.0 / (fi + fo)))


def init_source(device=None, generator=None):
    """(torch.device, torch.Generator) of a layer's weights: `device`
    through `resolve_device`, `generator` or one seeded 0 there."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


def create_parameter(shape, device, generator=None, initializer=None,
                     is_bias=False, *, dtype=None, attr=None):
    """An `nn.Parameter` of `shape` on `device` (f32 unless `dtype`),
    filled from `generator` as `attr` says. `attr` is a layer's
    `weight_attr` / `bias_attr`: None, a `ParamAttr`, an initializer,
    a name, or False (no parameter: None is returned). The attribute's
    initializer replaces `initializer`, whose own default is Constant(0)
    for a bias, else XavierNormal; a non-trainable attribute gives a
    parameter that does not require grad; its name is kept as
    `param_name`."""
    from ..param_attr import ParamAttr

    if attr is False:
        return None
    attr = ParamAttr._to_attr(attr)
    initializer = attr.initializer or initializer
    if initializer is None:
        initializer = Constant(0.0) if is_bias else XavierNormal()
    t = torch.empty(tuple(int(s) for s in shape),
                    dtype=dtype or torch.float32, device=device)
    initializer(t, generator)
    p = nn.Parameter(t, requires_grad=bool(attr.trainable))
    if attr.name is not None:
        p.param_name = attr.name
    return p
