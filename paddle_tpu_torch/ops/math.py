"""Math ops: the port of `paddle_tpu/ops/math.py` (113 names):
elementwise unary and binary ops, reductions, cumulative ops and
statistics.

Each op hands its tensor inputs to `amp.maybe_cast_inputs` under its
JAX op name. A Python scalar operand is a 0-d tensor on the other
operand's device, which type promotion weighs below a dimensioned
tensor, as jnp weighs a weak-typed scalar. Semantics follow the JAX
package's kernels:

- `floor_divide` floors and `mod` / `remainder` / `floor_mod` take the
  divisor's sign (`jnp.floor_divide`, `jnp.mod`); `round` rounds half
  to even; `exponent` is floor(log2|x|);
- reductions take an int, a list or None for `axis`; `mean` of
  integers is a float mean; `max` / `min` are `amax` / `amin`, which
  share the gradient among ties as jnp does; `median` averages the two
  middle values of an even count (`jnp.median`); `cummax` / `cummin`
  keep the earlier index on a tie;
- integer and index outputs are int64 (x64 off, the JAX package gives
  int32); sums of integers are int64, of bools too.

`increment` adds in place and returns x, as the JAX op rebinds x's
value; torch refuses that on a leaf that requires grad.
"""
from __future__ import annotations

import builtins
import sys

import numpy as np
import torch

from ..core.dtype import convert_dtype, default_float_dtype, index_dtype
from ._common import _cast, dims, pair, register, scalar
from .linalg import promote

_this = sys.modules[__name__]

__all__ = []


def _export(name, fn):
    setattr(_this, name, fn)
    __all__.append(name)


def _exponent(x):
    return torch.floor(torch.log2(torch.abs(x)))


def _as_float(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(default_float_dtype())


def _angle(x):
    return torch.angle(x) if x.is_complex() else torch.angle(_as_float(x))


# -- unary ops ------------------------------------------------------------

_UNARY = {
    "abs": torch.abs,
    "acos": torch.acos,
    "acosh": torch.acosh,
    "angle": _angle,
    "asin": torch.asin,
    "asinh": torch.asinh,
    "atan": torch.atan,
    "atanh": torch.atanh,
    "ceil": torch.ceil,
    "conj": torch.conj_physical,
    "cos": torch.cos,
    "cosh": torch.cosh,
    "digamma": torch.digamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "floor": torch.floor,
    "frac": lambda x: x - torch.trunc(x),
    "i0": torch.special.i0,
    "i0e": torch.special.i0e,
    "i1": torch.special.i1,
    "i1e": torch.special.i1e,
    "lgamma": torch.lgamma,
    "log": torch.log,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "logit": torch.logit,
    "neg": torch.neg,
    "reciprocal": torch.reciprocal,
    "round": torch.round,
    "rsqrt": torch.rsqrt,
    "sigmoid": torch.sigmoid,
    "sign": torch.sign,
    "sgn": torch.sign,
    "sin": torch.sin,
    "sinh": torch.sinh,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "tan": torch.tan,
    "tanh": torch.tanh,
    "trunc": torch.trunc,
    "deg2rad": torch.deg2rad,
    "rad2deg": torch.rad2deg,
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
    "isneginf": torch.isneginf,
    "isposinf": torch.isposinf,
    "isreal": torch.isreal,
    "exponent": _exponent,
}


def _make_unary(op_name, fn):
    register(op_name)

    def op(x, name=None):
        (x,) = _cast(op_name, x)
        return fn(x)

    op.__name__ = op_name
    op.__qualname__ = op_name
    op.__doc__ = f"Elementwise {op_name}."
    return op


for _n, _f in _UNARY.items():
    _export(_n, _make_unary(_n, _f))


# -- binary ops -----------------------------------------------------------

def _heaviside(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


def _ldexp(x, y):
    return _as_float(x) * torch.pow(2.0, y).to(_as_float(x).dtype)


def _inner(x, y):
    return torch.inner(*promote(x, y))


def _kron(x, y):
    return torch.kron(*promote(x, y))


_BINARY = {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.multiply,
    "divide": torch.true_divide,
    "floor_divide": torch.floor_divide,
    "mod": torch.remainder,
    "remainder": torch.remainder,
    "floor_mod": torch.remainder,
    "pow": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "fmax": torch.fmax,
    "fmin": torch.fmin,
    "atan2": torch.atan2,
    "heaviside": _heaviside,
    "hypot": lambda x, y: torch.hypot(*promote(_as_float(x), y)),
    "copysign": torch.copysign,
    "nextafter": lambda x, y: torch.nextafter(*promote(x, y)),
    "logaddexp": torch.logaddexp,
    "ldexp": _ldexp,
    "gcd": torch.gcd,
    "lcm": torch.lcm,
    "inner": _inner,
    "kron": _kron,
}


def _make_binary(op_name, fn):
    register(op_name)

    def op(x, y, name=None):
        x, y = _cast(op_name, x, y)
        return fn(*pair(x, y))

    op.__name__ = op_name
    op.__qualname__ = op_name
    op.__doc__ = f"Elementwise {op_name} of x and y, broadcast."
    return op


for _n, _f in _BINARY.items():
    _export(_n, _make_binary(_n, _f))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x * scale + bias (or (x + bias) * scale), scale and bias in x's
    dtype."""
    (x,) = _cast("scale", x)
    s = torch.tensor(float(scalar(scale)), device=x.device).to(x.dtype)
    b = torch.tensor(float(bias), device=x.device).to(x.dtype)
    out = x * s + b if bias_after_scale else (x + b) * s
    if act:
        from . import activation

        out = getattr(activation, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """x += value in place (in x's dtype); returns x."""
    (x,) = _cast("increment", x)
    x.add_(torch.tensor(float(value), device=x.device).to(x.dtype))
    return x


def clip(x, min=None, max=None, name=None):
    (x,) = _cast("clip", x)
    return torch.clamp(x, scalar(min), scalar(max))


def lerp(x, y, weight, name=None):
    x, y, weight = _cast("lerp", x, y, weight)
    return x + weight * (y - x)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y)."""
    input, x, y = _cast("addmm", input, x, y)
    return float(beta) * input + float(alpha) * torch.matmul(*promote(x, y))


def outer(x, y, name=None):
    x, y = _cast("outer", x, y)
    return torch.outer(*promote(x.reshape(-1), y.reshape(-1)))


def multiplex(inputs, index, name=None):
    """Row i of the result is row i of inputs[index[i]]."""
    ins = _cast("multiplex", *inputs)
    (index,) = _cast("multiplex", index)
    stacked = torch.stack(list(ins), dim=0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(idx.numel(), device=idx.device)]


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = _cast("trace", x)
    return torch.diagonal(x, int(offset), int(axis1), int(axis2)).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    (x,) = _cast("diagonal", x)
    return torch.diagonal(x, int(offset), int(axis1), int(axis2))


# -- reductions -----------------------------------------------------------

def _reduce(x, axis, keepdim, fn):
    return fn(x, dim=dims(axis, x), keepdim=bool(keepdim))


def _sum(x, axis, keepdim, dtype):
    return torch.sum(x, dim=dims(axis, x), keepdim=keepdim, dtype=dtype)


def _mean(x, axis, keepdim, dtype):
    return torch.mean(_as_float(x), dim=dims(axis, x), keepdim=keepdim)


def _prod(x, axis, keepdim, dtype):
    out = x
    for d in sorted((a % builtins.max(x.dim(), 1) for a in dims(axis, x)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _nansum(x, axis, keepdim, dtype):
    return torch.nansum(x, dim=dims(axis, x), keepdim=keepdim)


def _nanmean(x, axis, keepdim, dtype):
    return torch.nanmean(_as_float(x), dim=dims(axis, x), keepdim=keepdim)


def _amax(x, axis, keepdim, dtype):
    return torch.amax(x, dim=dims(axis, x), keepdim=keepdim)


def _amin(x, axis, keepdim, dtype):
    return torch.amin(x, dim=dims(axis, x), keepdim=keepdim)


_REDUCE = {
    "sum": _sum,
    "mean": _mean,
    "prod": _prod,
    "amax": _amax,
    "amin": _amin,
    "nansum": _nansum,
    "nanmean": _nanmean,
}


def _make_reduce(op_name, fn):
    register(op_name)

    def op(x, axis=None, keepdim=False, dtype=None, name=None):
        (x,) = _cast(op_name, x)
        dt = convert_dtype(dtype)
        out = fn(x, axis, bool(keepdim), dt)
        return out.to(dt) if dt is not None else out

    op.__name__ = op_name
    op.__qualname__ = op_name
    op.__doc__ = f"{op_name} over `axis` (None: every axis)."
    return op


for _n, _f in _REDUCE.items():
    _export(_n, _make_reduce(_n, _f))


def max(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("max", x)
    return _reduce(x, axis, keepdim, torch.amax)


def min(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("min", x)
    return _reduce(x, axis, keepdim, torch.amin)


def all(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("all", x)
    return _reduce(x.bool(), axis, keepdim, torch.all)


def any(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("any", x)
    return _reduce(x.bool(), axis, keepdim, torch.any)


def logsumexp(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("logsumexp", x)
    return _reduce(x, axis, keepdim, torch.logsumexp)


def _keep(out, ds, keepdim, ndim):
    if keepdim:
        for d in sorted(a % builtins.max(ndim, 1) for a in ds):
            out = out.unsqueeze(d)
    return out


def count_nonzero(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("count_nonzero", x)
    ds = dims(axis, x)
    out = torch.count_nonzero(x, dim=ds) if ds else (x != 0).to(
        index_dtype())
    return _keep(out, ds, keepdim, x.dim()).to(index_dtype())


def cumsum(x, axis=None, dtype=None, name=None):
    (x,) = _cast("cumsum", x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, int(axis), dtype=convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = _cast("cumprod", x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, int(dim), dtype=convert_dtype(dtype))


def _cum_extreme(x, axis, dtype, is_max):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % builtins.max(x.dim(), 1)
    vals = (torch.cummax if is_max else torch.cummin)(x, axis).values
    # a record starts where x passes the running extreme strictly;
    # a tie keeps the earlier index, as the JAX scan does
    prev = vals.narrow(axis, 0, x.shape[axis] - 1)
    cur = x.narrow(axis, 1, x.shape[axis] - 1)
    new = (cur > prev) if is_max else (cur < prev)
    first = torch.ones_like(x.narrow(axis, 0, 1), dtype=torch.bool)
    new = torch.cat([first, new], dim=axis)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.where(new, pos, torch.zeros_like(pos))
    idx = torch.cummax(idx, axis).values
    return vals, idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    (x,) = _cast("cummax", x)
    return _cum_extreme(x, axis, dtype, True)


def cummin(x, axis=None, dtype="int64", name=None):
    (x,) = _cast("cummin", x)
    return _cum_extreme(x, axis, dtype, False)


def logcumsumexp(x, axis=None, name=None):
    (x,) = _cast("logcumsumexp", x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, int(axis))


# -- statistics -----------------------------------------------------------

def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    (x,) = _cast("std", x)
    return torch.std(_as_float(x), dim=dims(axis, x),
                     correction=1 if unbiased else 0, keepdim=bool(keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    (x,) = _cast("var", x)
    return torch.var(_as_float(x), dim=dims(axis, x),
                     correction=1 if unbiased else 0, keepdim=bool(keepdim))


def _over_axes(x, axis, keepdim, fn):
    """fn(v, dim=-1) on x with the `axis` dims moved last and merged;
    with keepdim the reduced dims come back as size 1 (after any
    leading dims fn adds, as a quantile list's)."""
    x = _as_float(x)
    ds = sorted(d % builtins.max(x.dim(), 1) for d in dims(axis, x))
    rest = [d for d in range(x.dim()) if d not in ds]
    v = x.permute(rest + ds).reshape([x.shape[d] for d in rest] + [-1])
    out = fn(v)
    if keepdim:
        lead = out.dim() - len(rest)
        for d in ds:
            out = out.unsqueeze(lead + d)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    (x,) = _cast("median", x)
    return _over_axes(x, axis, keepdim,
                      lambda v: torch.quantile(v, 0.5, dim=-1))


def nanmedian(x, axis=None, keepdim=False, name=None):
    (x,) = _cast("nanmedian", x)
    return _over_axes(x, axis, keepdim,
                      lambda v: torch.nanquantile(v, 0.5, dim=-1))


def _q(q, x):
    if isinstance(q, (list, tuple, np.ndarray, torch.Tensor)):
        return torch.as_tensor(np.asarray(
            q.tolist() if isinstance(q, torch.Tensor) else q),
            dtype=_as_float(x).dtype, device=x.device)
    return float(q)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    (x,) = _cast("quantile", x)
    qq = _q(q, x)
    return _over_axes(x, axis, keepdim, lambda v: torch.quantile(
        v, qq, dim=-1, interpolation=interpolation))


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    (x,) = _cast("nanquantile", x)
    qq = _q(q, x)
    return _over_axes(x, axis, keepdim,
                      lambda v: torch.nanquantile(v, qq, dim=-1))


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=index_dtype(), device=x.device)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    """The n-th forward difference along axis, prepend and append
    joined to x first."""
    x, prepend, append = _cast("diff", x, prepend, append)
    return torch.diff(x, int(n), int(axis), prepend, append)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along `axis` whose p-norm exceeds max_norm scaled
    down to max_norm; the others unchanged."""
    if p <= 0:
        raise ValueError("renorm: p must be positive")
    (x,) = _cast("renorm", x)
    ax = int(axis) % x.dim()
    red = tuple(i for i in range(x.dim()) if i != ax)
    if p == float("inf"):
        norms = torch.amax(torch.abs(x), dim=red, keepdim=True)
    else:
        norms = torch.sum(torch.abs(x) ** p, dim=red,
                          keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    return x * factor.to(x.dtype)


for _fn in (scale, increment, clip, lerp, addmm, outer, multiplex, trace,
            diagonal, max, min, all, any, logsumexp, count_nonzero, cumsum,
            cumprod, cummax, cummin, logcumsumexp, std, var, median,
            nanmedian, quantile, nanquantile, numel, broadcast_shape, diff,
            renorm):
    _export(_fn.__name__, _fn)
del _fn
