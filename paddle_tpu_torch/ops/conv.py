"""Convolution and pooling: the port of `paddle_tpu/ops/conv.py`
`conv1d` / `conv2d` / `conv3d` (`_conv_nd`, :66-121), `max_pool2d` /
`avg_pool2d` (`_pool`, :198-267) and `adaptive_avg_pool2d`
(`_adaptive_pool`, :281-321).

The JAX package leaves these to XLA (`lax.conv_general_dilated`,
`lax.reduce_window`), outside any Pallas kernel; here the product is
PyTorch's `F.conv*` (cuDNN on the card) and the pooling `F.max_pool2d`
/ `F.avg_pool2d`. Semantics are the JAX package's:

- padding is an int, one int a spatial dim, two a dim (`[lo0, hi0,
  lo1, hi1, ...]`), (lo, hi) pairs (the last n taken), or "SAME" /
  "VALID", as `_padding` reads it (:41-56); unequal sides are padded
  with `F.pad` (zeros for a convolution and an average, -inf for a max);
- weights are [out, in / groups, *kernel] whatever the layout; a
  channel-last input (NLC / NHWC / NDHWC) is viewed channel-first and
  the result viewed back, so the values do not depend on the layout;
- an input whose dtype differs from the weight's is cast to the
  weight's (an f32 BatchNorm output into a bf16 convolution under O2,
  :67-71); the bias is added after the product, promoting as jnp does;
- pooling: the stride defaults to the kernel; `exclusive` averages over
  the window's inputs and not its padding; `ceil_mode` is accepted and
  ignored, as in the JAX package;
- `adaptive_avg_pool2d` reduces axis by axis: a mean over equal windows
  where the output size divides the input's, else over the windows
  [floor(i * in / out), ceil((i + 1) * in / out)), concatenated.

Each op hands its tensor inputs to `amp.maybe_cast_inputs` under its
JAX op name first, so `amp.auto_cast` (O1) casts a convolution's
inputs to bf16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..amp import maybe_cast_inputs

__all__ = ["conv1d", "conv2d", "conv3d", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d"]


def _tup(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    if len(v) == 1:
        return v * n
    return v


def _padding(padding, n):
    """The padding spec as "SAME" / "VALID" or n (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        # possibly with the batch and channel dims: the last n entries
        return [tuple(int(x) for x in p) for p in padding][-n:]
    raise ValueError(f"bad padding {padding!r}")


def _pads(padding, sizes, kernel, stride, dilation):
    """(lo, hi) a spatial dim, "SAME" and "VALID" resolved as XLA
    resolves them (lo = total // 2)."""
    p = _padding(padding, len(sizes))
    if p == "VALID":
        return [(0, 0)] * len(sizes)
    if p == "SAME":
        out = []
        for size, k, s, d in zip(sizes, kernel, stride, dilation):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(p, str):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {p!r}")
    return p


def _pad_arg(pads):
    """`F.pad`'s argument: the last dim first."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _conv_nd(n, x, weight, bias, stride, padding, dilation, groups,
             channel_last):
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    if channel_last:
        x = x.movedim(-1, 1)
    stride, dilation = _tup(stride, n), _tup(dilation, n)
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    if all(lo == hi for lo, hi in pads):
        out = conv(x, weight, None, stride, [lo for lo, _ in pads],
                   dilation, int(groups))
    else:
        out = conv(F.pad(x, _pad_arg(pads)), weight, None, stride, 0,
                   dilation, int(groups))
    if channel_last:
        out = out.movedim(1, -1)
        shape = (1,) * (out.dim() - 1) + (-1,)
    else:
        shape = (1, -1) + (1,) * (out.dim() - 2)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    x, weight, bias = maybe_cast_inputs("conv1d", (x, weight, bias))
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    data_format == "NLC")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    x, weight, bias = maybe_cast_inputs("conv2d", (x, weight, bias))
    return _conv_nd(2, x, weight, bias, stride, padding, dilation, groups,
                    data_format == "NHWC")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    x, weight, bias = maybe_cast_inputs("conv3d", (x, weight, bias))
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    data_format == "NDHWC")


def _pool2d(x, kernel, stride, padding, kind, channel_last, exclusive):
    kernel = _tup(kernel, 2)
    stride = _tup(stride if stride is not None else kernel, 2)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _pads(padding, x.shape[2:], kernel, stride, (1, 1))
    # PyTorch pads both sides alike, by at most half the kernel
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads,
                                                                  kernel))
    pad = [lo for lo, _ in pads]
    if kind == "max":
        if native:
            out = F.max_pool2d(x, kernel, stride, pad)
        else:
            out = F.max_pool2d(F.pad(x, _pad_arg(pads), value=-float("inf")),
                               kernel, stride)
    elif native:
        out = F.avg_pool2d(x, kernel, stride, pad,
                           count_include_pad=not exclusive)
    else:
        s = F.avg_pool2d(F.pad(x, _pad_arg(pads)), kernel, stride,
                         divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = s / F.avg_pool2d(F.pad(ones, _pad_arg(pads)), kernel,
                                   stride, divisor_override=1)
        else:
            out = s / float(np.prod(kernel))
    return out.movedim(1, -1) if channel_last else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    (x,) = maybe_cast_inputs("max_pool2d", (x,))
    return _pool2d(x, kernel_size, stride, padding, "max",
                   data_format == "NHWC", True)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    (x,) = maybe_cast_inputs("avg_pool2d", (x,))
    return _pool2d(x, kernel_size, stride, padding, "avg",
                   data_format == "NHWC", exclusive)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    (x,) = maybe_cast_inputs("adaptive_avg_pool2d", (x,))
    out_size = _tup(output_size, 2)
    first = 1 if data_format == "NHWC" else 2
    out = x
    for i, osz in enumerate(out_size):
        ax = first + i
        isz = x.shape[ax]
        if isz % osz == 0:
            shape = list(out.shape)
            shape[ax:ax + 1] = [osz, isz // osz]
            out = out.reshape(shape).mean(dim=ax + 1)
        else:
            starts = (np.arange(osz) * isz) // osz
            ends = ((np.arange(osz) + 1) * isz + osz - 1) // osz
            out = torch.cat([out.narrow(ax, int(s), int(e - s)).mean(
                dim=ax, keepdim=True) for s, e in zip(starts, ends)], dim=ax)
    return out
