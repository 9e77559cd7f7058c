"""Creation ops: the port of `paddle_tpu/ops/creation.py` (28 names).

An op that makes a tensor from nothing (`zeros`, `arange`, `eye`, ...)
puts it on its keyword-only `device` (None: the card); one that takes a
tensor keeps that tensor's device. Float results given no dtype take
the default float dtype (float32); integer ones (`arange` of ints,
`full` of an int, the index ops) are int64 where the JAX package, x64
off, gives int32. `empty` and `empty_like` are zeros, as in the JAX
package. `one_hot` gives a zero row for an index outside
[0, num_classes), as `jax.nn.one_hot` does, in the default float dtype.
`lu`-style pivots and the other linalg outputs live in `ops.linalg`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype, default_float_dtype, index_dtype
from ..core.tensor import to_tensor
from ._common import _cast, as_tensor, device_of, float_dtype, scalar, \
    shape_list

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat",
    "tril", "triu", "meshgrid", "assign", "to_tensor", "clone",
    "complex", "real", "imag", "as_real", "as_complex", "tril_indices",
    "triu_indices", "one_hot",
]

_builtin_complex = complex


def zeros(shape, dtype=None, name=None, *, device=None):
    return torch.zeros(shape_list(shape), dtype=float_dtype(dtype),
                       device=device_of(device=device))


def ones(shape, dtype=None, name=None, *, device=None):
    return torch.ones(shape_list(shape), dtype=float_dtype(dtype),
                      device=device_of(device=device))


def _fill_dtype(fill_value):
    if isinstance(fill_value, torch.Tensor):
        dt = fill_value.dtype
    elif isinstance(fill_value, bool):
        dt = torch.bool
    elif isinstance(fill_value, (int, np.integer)):
        dt = index_dtype()
    elif isinstance(fill_value, _builtin_complex):
        dt = torch.complex64
    else:
        dt = default_float_dtype()
    return default_float_dtype() if dt == torch.float64 else dt


def full(shape, fill_value, dtype=None, name=None, *, device=None):
    dt = convert_dtype(dtype) or _fill_dtype(fill_value)
    return torch.full(shape_list(shape), scalar(fill_value), dtype=dt,
                      device=device_of(fill_value, device=device))


def empty(shape, dtype=None, name=None, *, device=None):
    return zeros(shape, dtype, name, device=device)


def zeros_like(x, dtype=None, name=None):
    (x,) = _cast("zeros_like", x)
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    (x,) = _cast("ones_like", x)
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    (x,) = _cast("full_like", x)
    return torch.full_like(x, scalar(fill_value), dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


def arange(start=0, end=None, step=1, dtype=None, name=None, *, device=None):
    start, end, step = scalar(start), scalar(end), scalar(step)
    if end is None:
        start, end = 0, start
    dt = convert_dtype(dtype)
    if dt is None:
        dt = (default_float_dtype()
              if any(isinstance(v, float) for v in (start, end, step))
              else index_dtype())
    return torch.arange(start, end, step, dtype=dt,
                        device=device_of(device=device))


def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    return torch.linspace(scalar(start), scalar(stop), int(scalar(num)),
                          dtype=float_dtype(dtype),
                          device=device_of(device=device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None):
    return torch.logspace(scalar(start), scalar(stop), int(scalar(num)),
                          base=float(base), dtype=float_dtype(dtype),
                          device=device_of(device=device))


def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns else n
    return torch.eye(n, m, dtype=float_dtype(dtype),
                     device=device_of(device=device))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x: the matrix with x on diagonal `offset` and
    `padding_value` elsewhere; else x's diagonal over its first two
    dims."""
    (x,) = _cast("diag", x)
    if x.dim() == 1:
        out = torch.diag(x, int(offset))
        if padding_value != 0:
            on = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
            out = torch.where(on, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, int(offset))


def diagflat(x, offset=0, name=None):
    (x,) = _cast("diagflat", x)
    return torch.diagflat(x, int(offset))


def tril(x, diagonal=0, name=None):
    (x,) = _cast("tril", x)
    return torch.tril(x, int(diagonal))


def triu(x, diagonal=0, name=None):
    (x,) = _cast("triu", x)
    return torch.triu(x, int(diagonal))


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    args = _cast("meshgrid", *args)
    return tuple(torch.meshgrid(*args, indexing="ij"))


def assign(x, output=None, *, device=None):
    """A copy of x (a tensor, or data `to_tensor` takes, on `device`);
    with `output`, written into it in place and returned."""
    if isinstance(x, torch.Tensor):
        (x,) = _cast("assign", x)
        out = x.clone()
    else:
        out = to_tensor(np.asarray(x), place=device)
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    (x,) = _cast("clone", x)
    return x.clone()


def complex(real, imag, name=None):
    real, imag = _cast("complex", real, imag)
    return torch.complex(real, imag)


def real(x, name=None):
    (x,) = _cast("real", x)
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    (x,) = _cast("imag", x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def as_real(x, name=None):
    (x,) = _cast("as_real", x)
    if not x.is_complex():
        return torch.stack([x, torch.zeros_like(x)], dim=-1)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def as_complex(x, name=None):
    (x,) = _cast("as_complex", x)
    return torch.complex(x[..., 0], x[..., 1])


def tril_indices(row, col=None, offset=0, dtype="int64", *, device=None):
    col = col if col is not None else row
    return torch.tril_indices(int(row), int(col), int(offset),
                              device=device_of(device=device))


def triu_indices(row, col=None, offset=0, dtype="int64", *, device=None):
    col = col if col is not None else row
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=device_of(device=device))


def one_hot(x, num_classes, name=None):
    (x,) = _cast("one_hot", x)
    n = int(num_classes)
    cls = torch.arange(n, device=x.device)
    return (as_tensor(x, cls).unsqueeze(-1) == cls).to(default_float_dtype())
