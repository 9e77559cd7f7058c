"""Search and sort ops: the port of `paddle_tpu/ops/search.py` (12
names).

Indices are int64 (x64 off, the JAX package gives int32) unless a
`dtype` asks otherwise. `argsort`, `sort` and `topk` order equal
values as `stable` says; with `stable=False` the order among ties is
the library's, as in JAX, so ties are compared only under
`stable=True`. `unique` gives numpy's sorted values, the first index
of each, the inverse (the input's shape for a whole-tensor unique, as
numpy 2 gives it) and the counts, all computed on the device.
`mode` is the smallest of the most frequent values, with its first
index, as the JAX kernel's run-length scan finds it.
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, index_dtype
from ._common import _cast, scalar

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "unique",
    "unique_consecutive", "searchsorted", "kthvalue", "mode", "index_sample",
    "bucketize",
]


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1), 0)
    else:
        out = fn(x, int(axis), keepdim=bool(keepdim))
    return out.to(convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    (x,) = _cast("argmax", x)
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    (x,) = _cast("argmin", x)
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    (x,) = _cast("argsort", x)
    return torch.argsort(x, dim=int(axis), descending=bool(descending),
                         stable=bool(stable))


def sort(x, axis=-1, descending=False, stable=False, name=None):
    (x,) = _cast("sort", x)
    return torch.sort(x, dim=int(axis), descending=bool(descending),
                      stable=bool(stable)).values


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    (x,) = _cast("topk", x)
    out = torch.topk(x, int(scalar(k)), dim=-1 if axis is None else int(axis),
                     largest=bool(largest), sorted=bool(sorted))
    return out.values, out.indices


def _first_index(inverse, n_unique, n):
    pos = torch.arange(n, device=inverse.device)
    first = torch.full((n_unique,), n, dtype=torch.long,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    (x,) = _cast("unique", x)
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True,
        dim=None if axis is None else int(axis))
    outs = [vals]
    if return_index:
        n = x.numel() if axis is None else x.shape[int(axis)]
        outs.append(_first_index(inverse, counts.numel(), n))
    if return_inverse:
        outs.append(inverse)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    (x,) = _cast("unique_consecutive", x)
    if axis is not None:
        raise NotImplementedError("axis for unique_consecutive")
    vals, inverse, counts = torch.unique_consecutive(
        x.reshape(-1), return_inverse=True, return_counts=True)
    outs = [vals]
    if return_inverse:
        outs.append(inverse)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    sorted_sequence, values = _cast("searchsorted", sorted_sequence, values)
    return torch.searchsorted(sorted_sequence, values,
                              out_int32=bool(out_int32), right=bool(right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    (x,) = _cast("kthvalue", x)
    out = torch.kthvalue(x, int(k), dim=int(axis), keepdim=bool(keepdim))
    return out.values, out.indices


def mode(x, axis=-1, keepdim=False, name=None):
    (x,) = _cast("mode", x)
    ax = int(axis) % x.dim()
    moved = x.movedim(ax, -1)
    srt = torch.sort(moved, dim=-1).values
    # each sorted entry's run length: its count of equal entries
    runs = (srt.unsqueeze(-1) == srt.unsqueeze(-2)).sum(-1)
    best = torch.argmax(runs, dim=-1, keepdim=True)
    vals = torch.gather(srt, -1, best)
    idx = torch.argmax((moved == vals).to(torch.int8), dim=-1)
    vals = vals.squeeze(-1)
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx.to(index_dtype())


def index_sample(x, index):
    from .manipulation import index_sample as _is

    return _is(x, index)
