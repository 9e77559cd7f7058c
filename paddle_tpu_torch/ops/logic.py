"""Comparison, logical and bitwise ops: the port of
`paddle_tpu/ops/logic.py` (21 names). `equal_all`, `allclose` and
`is_empty` give a 0-d bool tensor; `is_tensor` a Python bool.
`out` is accepted and ignored, as in the JAX package."""
from __future__ import annotations

import sys

import torch

from ._common import _cast, pair, register

_this = sys.modules[__name__]
__all__ = []


def _export(name, fn):
    setattr(_this, name, fn)
    __all__.append(name)


_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "less_than": torch.lt,
    "less_equal": torch.le,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "bitwise_left_shift": torch.bitwise_left_shift,
    "bitwise_right_shift": torch.bitwise_right_shift,
}


def _make(op_name, fn):
    register(op_name)

    def op(x, y, out=None, name=None):
        x, y = _cast(op_name, x, y)
        return fn(*pair(x, y))

    op.__name__ = op_name
    op.__qualname__ = op_name
    return op


for _n, _f in _CMP.items():
    _export(_n, _make(_n, _f))


def logical_not(x, out=None, name=None):
    (x,) = _cast("logical_not", x)
    return torch.logical_not(x)


def bitwise_not(x, out=None, name=None):
    (x,) = _cast("bitwise_not", x)
    return torch.bitwise_not(x)


def equal_all(x, y, name=None):
    """True when x and y have one shape and equal values."""
    x, y = _cast("equal_all", x, y)
    same = tuple(x.shape) == tuple(y.shape) and bool((x == y).all())
    return torch.tensor(same, device=x.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _cast("allclose", x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.tensor(torch.allclose(x.to(dt), y.to(dt), float(rtol),
                                       float(atol), bool(equal_nan)),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _cast("isclose", x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.isclose(x.to(dt), y.to(dt), float(rtol), float(atol),
                         bool(equal_nan))


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


for _fn in (logical_not, bitwise_not, equal_all, allclose, isclose,
            is_empty, is_tensor):
    _export(_fn.__name__, _fn)
del _fn
