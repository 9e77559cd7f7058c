"""Helpers of the port's op modules: the amp hand-off under a JAX op
name, the registration with amp of the op names the factories build,
axis and shape arguments, scalars turned into tensors
beside a tensor operand, and the device of a creation op."""
from __future__ import annotations

import numpy as np
import torch

from ..amp import maybe_cast_inputs, register_op
from ..core.dtype import convert_dtype, default_float_dtype
from ..device import resolve_device

def register(name):
    """A factory's op name, made known to amp (its `_cast` call takes
    the name from a variable, which amp's source scan cannot read)."""
    register_op(name)
    return name


def _cast(name, *vals):
    """`vals` through `amp.maybe_cast_inputs` under the op's JAX name."""
    return maybe_cast_inputs(name, vals)


def device_of(*vals, device=None):
    """The device of the first tensor among `vals`, else `device`
    resolved (None: the card)."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device(device)


def as_tensor(v, like):
    """`v` as a tensor on `like`'s device: a tensor as it is; a Python
    scalar as a 0-d tensor (float32 for a float, int64 for an int,
    bool for a bool), which type promotion weighs below `like`'s
    dimensions, as jnp weighs a weak-typed scalar; a numpy array as its
    dtype (a float64 array as the default float dtype)."""
    if isinstance(v, torch.Tensor):
        return v
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(v, np.ndarray):
        t = torch.as_tensor(v)
        if t.dtype == torch.float64:
            t = t.to(default_float_dtype())
        return t.to(dev)
    return torch.as_tensor(v, device=dev)


def pair(x, y):
    """The two operands of a binary op as tensors on one device."""
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, y)
    if not isinstance(y, torch.Tensor):
        y = as_tensor(y, x)
    return x, y


def axes(axis):
    """An axis argument as None, an int or a tuple of ints (a tensor
    read on the host)."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, x):
    """The dims a reduction over `axis` covers: every dim for None."""
    a = axes(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def shape_list(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def float_dtype(dtype):
    return convert_dtype(dtype) or default_float_dtype()


def scalar(v):
    """A Python number of a 0-d or one-element tensor, else `v`."""
    return v.item() if isinstance(v, torch.Tensor) else v
