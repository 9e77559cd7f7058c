"""Shape, layout and indexing ops: the port of
`paddle_tpu/ops/manipulation.py` (62 names).

Semantics are the JAX kernels': `split` by a count needs an even
split (`jnp.split`), sections may hold one -1; `squeeze` drops only
the listed axes of size 1; `gather` flattens an index of more than one
dim; `scatter` with `overwrite=False` zeroes the indexed rows, then
adds; `pad` with one (lo, hi) pair per dim pads every dim, else the
pairs pad the innermost spatial dims of `data_format`, the last first,
in the modes "constant", "reflect", "replicate" and "circular";
`strided_slice` takes negative strides; `atleast_3d` puts a 2-D input's
new axis last. Ops with a data-dependent size (`masked_select`,
`where(condition)`, `nonzero`) run on the device; `nonzero` and
`where(condition)` give int64 indices ([n, 1] each as a tuple).

The in-place ops (`reshape_`, `flatten_`, `squeeze_`, `unsqueeze_`,
`fill_diagonal_`) change x itself and return it, where the JAX package
rebinds x's value and tape node: `squeeze_` and `unsqueeze_` are
torch's in-place views, which autograd follows; `reshape_` and
`flatten_` re-point x at the reshaped storage, which torch refuses on
a tensor that requires grad (and raises there, as torch raises for any
in-place op on a leaf that requires grad); `fill_diagonal_` writes in
place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ._common import _cast, as_tensor, axes, pair, scalar, shape_list

__all__ = [
    "cast", "reshape", "reshape_", "transpose", "t", "flatten", "squeeze",
    "unsqueeze", "concat", "stack", "split", "chunk", "tile", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "flip", "rot90", "roll",
    "gather", "gather_nd", "scatter", "scatter_nd", "scatter_nd_add",
    "index_select", "index_sample", "index_add", "index_put", "masked_select",
    "masked_fill", "where", "slice", "strided_slice", "pad", "unstack",
    "unbind", "repeat_interleave", "take_along_axis", "put_along_axis",
    "getitem", "moveaxis", "swapaxes", "unfold", "as_strided", "view",
    "view_as", "tensor_split", "hsplit", "vsplit", "dsplit", "atleast_1d",
    "atleast_2d", "atleast_3d", "crop", "tolist", "flatten_", "squeeze_",
    "unsqueeze_", "fill_diagonal_", "diag_embed", "shard_index",
]

_py_slice = slice  # the builtin: the `slice` op below shadows it


def cast(x, dtype):
    (x,) = _cast("cast", x)
    return x.to(convert_dtype(dtype))


def reshape(x, shape, name=None):
    (x,) = _cast("reshape", x)
    return x.reshape(shape_list(shape))


def _rebind(x, out):
    """x re-pointed, in place, at out's storage, shape and strides."""
    if x.requires_grad:
        raise RuntimeError(
            "an in-place reshape of a tensor that requires grad: torch "
            "cannot rebind it (the JAX package rebinds its tape node); "
            "use the out-of-place op")
    with torch.no_grad():
        x.set_(out.untyped_storage(), out.storage_offset(), out.shape,
               out.stride())
    return x


def reshape_(x, shape, name=None):
    return _rebind(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    (x,) = _cast("view_dtype", x)
    return x.view(convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def transpose(x, perm=None, name=None):
    (x,) = _cast("transpose", x)
    if perm is None:
        return x.permute(tuple(reversed(range(x.dim()))))
    return x.permute(tuple(int(p) for p in perm))


def t(x, name=None):
    (x,) = _cast("t", x)
    if x.dim() < 2:
        return x
    return x.permute(tuple(reversed(range(x.dim()))))


def moveaxis(x, source, destination, name=None):
    (x,) = _cast("moveaxis", x)
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1, name=None):
    (x,) = _cast("swapaxes", x)
    return torch.swapaxes(x, int(axis0), int(axis1))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes start_axis..stop_axis merged into one; a 0-d tensor becomes
    shape [1]."""
    (x,) = _cast("flatten", x)
    n = x.dim()
    if n == 0:
        return x.reshape(1)
    start, stop = start_axis % n, stop_axis % n
    return x.reshape(tuple(x.shape[:start]) + (-1,)
                     + tuple(x.shape[stop + 1:]))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _rebind(x, flatten(x, start_axis, stop_axis))


def _sq_axes(axis, x):
    a = axes(axis)
    if a is None:
        return tuple(d for d in range(x.dim()) if x.shape[d] == 1)
    a = a if isinstance(a, tuple) else (a,)
    return tuple(sorted(d % x.dim() for d in a if x.shape[d] == 1))


def squeeze(x, axis=None, name=None):
    (x,) = _cast("squeeze", x)
    ds = _sq_axes(axis, x)
    return x.squeeze(ds) if ds else x


def squeeze_(x, axis=None, name=None):
    for d in reversed(_sq_axes(axis, x)):
        x.squeeze_(d)
    return x


def _unsq_axes(axis, x):
    a = axes(axis)
    a = a if isinstance(a, tuple) else (a,)
    nd = x.dim() + len(a)
    return sorted(d % nd for d in a)


def unsqueeze(x, axis, name=None):
    (x,) = _cast("unsqueeze", x)
    for d in _unsq_axes(axis, x):
        x = x.unsqueeze(d)
    return x


def unsqueeze_(x, axis, name=None):
    for d in _unsq_axes(axis, x):
        x.unsqueeze_(d)
    return x


def concat(x, axis=0, name=None):
    xs = _cast("concat", *x)
    return torch.cat(list(xs), dim=int(scalar(axis)))


def stack(x, axis=0, name=None):
    xs = _cast("stack", *x)
    dt = xs[0].dtype
    for v in xs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return torch.stack([v.to(dt) for v in xs], dim=int(axis))


def _sections(dim, num_or_sections):
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(
                f"split: {num_or_sections} sections do not divide {dim}")
        return [dim // num_or_sections] * num_or_sections
    sections = [int(scalar(s)) for s in num_or_sections]
    if -1 in sections:
        rest = dim - sum(s for s in sections if s != -1)
        sections = [rest if s == -1 else s for s in sections]
    return sections


def split(x, num_or_sections, axis=0, name=None):
    (x,) = _cast("split", x)
    axis = int(scalar(axis))
    return list(torch.split(x, _sections(x.shape[axis], num_or_sections),
                            dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    (x,) = _cast("tensor_split", x)
    spec = num_or_indices if isinstance(num_or_indices, int) else \
        [int(i) for i in num_or_indices]
    return list(torch.tensor_split(x, spec, dim=int(axis)))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if x.dim() > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def tile(x, repeat_times, name=None):
    (x,) = _cast("tile", x)
    return torch.tile(x, tuple(shape_list(repeat_times)))


def _expand_shape(x, shape):
    out = shape_list(shape)
    offset = len(out) - x.dim()
    return [x.shape[i - offset] if s == -1 else s for i, s in enumerate(out)]


def expand(x, shape, name=None):
    (x,) = _cast("expand", x)
    return x.expand(_expand_shape(x, shape))


def expand_as(x, y, name=None):
    (x,) = _cast("expand_as", x)
    return x.expand(tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape, name)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, shape) for t in inputs]


def atleast_1d(*inputs, name=None):
    outs = [reshape(x, [1]) if x.dim() == 0 else x for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    def fix(x):
        if x.dim() == 0:
            return reshape(x, [1, 1])
        if x.dim() == 1:
            return unsqueeze(x, 0)
        return x

    outs = [fix(x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    def fix(x):
        y = atleast_2d(x)
        return unsqueeze(y, -1) if y.dim() == 2 else y

    outs = [fix(x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def flip(x, axis, name=None):
    (x,) = _cast("flip", x)
    a = axes(axis)
    return torch.flip(x, a if isinstance(a, tuple) else (a,))


def rot90(x, k=1, axes=(0, 1), name=None):
    (x,) = _cast("rot90", x)
    return torch.rot90(x, int(k), [int(a) for a in axes])


def roll(x, shifts, axis=None, name=None):
    (x,) = _cast("roll", x)
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.reshape(-1).tolist()
    if isinstance(shifts, (list, tuple)):
        shifts = tuple(int(s) for s in shifts)
    else:
        shifts = int(shifts)
    a = axes(axis)
    if a is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, a)


def gather(x, index, axis=0, name=None):
    """x's entries at `index` along `axis` (a 0-d index drops the
    axis)."""
    x, index = _cast("gather", x, index)
    axis = int(scalar(axis))
    if index.dim() == 0:
        return torch.index_select(x, axis, index.reshape(1).long()
                                  ).squeeze(axis)
    return torch.index_select(x, axis, index.reshape(-1).long())


def gather_nd(x, index, name=None):
    x, index = _cast("gather_nd", x, index)
    return x[tuple(index.long().movedim(-1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    x, index, updates = _cast("scatter", x, index, updates)
    idx = (index.reshape(-1).long(),)
    if overwrite:
        return x.index_put(idx, updates)
    return x.index_put(idx, torch.zeros_like(updates)).index_put(
        idx, updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = _cast("scatter_nd_add", x, index, updates)
    return x.index_put(tuple(index.long().movedim(-1, 0)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zero = torch.zeros(shape_list(shape), dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(zero, index, updates)


def index_select(x, index, axis=0, name=None):
    x, index = _cast("index_select", x, index)
    return torch.index_select(x, int(axis), index.reshape(-1).long())


def index_sample(x, index):
    x, index = _cast("index_sample", x, index)
    return torch.gather(x, 1, index.long())


def index_add(x, index, axis, value, name=None):
    x, index, value = _cast("index_add", x, index, value)
    return x.index_add(int(axis), index.long(), value)


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = _cast("index_put", x, value)
    idx = tuple(i.long() if not i.dtype == torch.bool else i
                for i in indices)
    return x.index_put(idx, as_tensor(value, x).to(x.dtype),
                       accumulate=bool(accumulate))


def masked_select(x, mask, name=None):
    x, mask = _cast("masked_select", x, mask)
    return torch.masked_select(x, mask.expand(x.shape))


def masked_fill(x, mask, value, name=None):
    x, mask, value = _cast("masked_fill", x, mask, value)
    return torch.where(mask, as_tensor(value, x).to(x.dtype), x)


def nonzero(x, as_tuple=False):
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, i].reshape(-1, 1) for i in range(idx.shape[1]))
    return idx


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    condition, x, y = _cast("where", condition, x, y)
    x, y = pair(x, y)
    return torch.where(condition, x, y)


def slice(x, axes, starts, ends):
    (x,) = _cast("slice", x)
    idx = [_py_slice(None)] * x.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[int(ax)] = _py_slice(int(scalar(s)), int(scalar(e)))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis, negative strides included."""
    (x,) = _cast("strided_slice", x)
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax = int(ax)
        sl = _py_slice(int(s), int(e), int(st))
        if int(st) > 0:
            idx = [_py_slice(None)] * out.dim()
            idx[ax] = sl
            out = out[tuple(idx)]
        else:
            pos = list(range(*sl.indices(out.shape[ax])))
            out = torch.index_select(out, ax, torch.tensor(
                pos, dtype=torch.long, device=out.device))
    return out


def crop(x, shape=None, offsets=None, name=None):
    (x,) = _cast("crop", x)
    shape = shape_list(shape)
    offsets = [int(o) for o in (offsets or [0] * x.dim())]
    return x[tuple(_py_slice(o, o + s) for o, s in zip(offsets, shape))]


def _pad_index(n, lo, hi, mode, device):
    i = np.arange(-lo, n + hi)
    if mode == "reflect":
        period = 2 * (n - 1)
        i = np.abs(i) % period if period else np.zeros_like(i)
        i = np.where(i >= n, period - i, i)
    elif mode == "edge":
        i = np.clip(i, 0, n - 1)
    else:                               # wrap
        i = i % n
    return torch.as_tensor(i, dtype=torch.long, device=device)


_PAD_MODE = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    (x,) = _cast("pad", x)
    pad = shape_list(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        npairs = len(pad) // 2
        width = [(0, 0)] * nd
        if data_format.endswith("HWC") or data_format in ("NLC", "NHWC",
                                                          "NDHWC"):
            spatial = list(range(1, 1 + npairs))
        else:
            spatial = list(range(nd - npairs, nd))
        for i, ax in enumerate(reversed(spatial)):
            width[ax] = (pad[2 * i], pad[2 * i + 1])
    mode = _PAD_MODE.get(mode, mode)
    if mode == "constant":
        return torch.nn.functional.pad(
            x, [v for lo_hi in reversed(width) for v in lo_hi],
            value=float(value))
    out = x
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            out = torch.index_select(out, ax, _pad_index(
                out.shape[ax], lo, hi, mode, out.device))
    return out


def unstack(x, axis=0, num=None, name=None):
    (x,) = _cast("unstack", x)
    return list(torch.unbind(x, int(axis)))


def unbind(input, axis=0):
    return unstack(input, axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    (x,) = _cast("repeat_interleave", x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    else:
        repeats = int(repeats)
    return torch.repeat_interleave(x, repeats,
                                   dim=None if axis is None else int(axis))


def take_along_axis(arr, indices, axis, broadcast=True):
    arr, indices = _cast("take_along_axis", arr, indices)
    return torch.take_along_dim(arr, indices.long(), dim=int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    """arr with `values` put (assigned, added or multiplied) at
    `indices` along `axis`; a scalar value fills every index."""
    arr, indices, values = _cast("put_along_axis", arr, indices, values)
    idx = indices.long()
    src = as_tensor(values, arr).to(arr.dtype).expand(idx.shape)
    axis = int(axis)
    if reduce == "assign":
        return arr.scatter(axis, idx, src)
    if reduce == "add":
        return arr.scatter_add(axis, idx, src)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, idx, src, "prod")
    raise ValueError(f"unknown reduce {reduce}")


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C * kh * kw, L], channel-major."""
    def _pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    (x,) = _cast("unfold", x)
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        pads = (paddings[0], paddings[1])
    else:
        pads = _pair(paddings)
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      _pair(dilations), pads, _pair(strides))


def as_strided(x, shape, stride, offset=0, name=None):
    """x's row-major entries at offset + sum(i_d * stride_d)."""
    (x,) = _cast("as_strided", x)
    shape = [int(s) for s in shape]
    idx = np.zeros(shape, dtype=np.int64) + int(offset)
    for dim, (s, st) in enumerate(zip(shape, stride)):
        idx = idx + (np.arange(s) * int(st)).reshape(
            [-1 if i == dim else 1 for i in range(len(shape))])
    return x.reshape(-1)[torch.as_tensor(idx, device=x.device)]


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """x's diagonal `offset` over its last two dims set to value, in
    place."""
    n = min(x.shape[-2], x.shape[-1])
    i = torch.arange(n - abs(int(offset)), device=x.device)
    r, c = (i, i + offset) if offset >= 0 else (i - offset, i)
    x[..., r, c] = value
    return x


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    (input,) = _cast("diag_embed", input)
    return torch.diag_embed(input, int(offset), int(dim1), int(dim2))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    (input,) = _cast("shard_index", input)
    size = (int(index_num) + int(nshards) - 1) // int(nshards)
    lo = int(shard_id) * size
    inside = (input >= lo) & (input < lo + size)
    return torch.where(inside, input - lo,
                       torch.full_like(input, int(ignore_value)))


def tolist(x):
    return x.tolist()


def _index(i):
    if isinstance(i, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(i))
    return i


def getitem(x, idx):
    (x,) = _cast("getitem", x)
    if isinstance(idx, tuple):
        idx = tuple(_index(i) for i in idx)
    else:
        idx = _index(idx)
    return x[idx]
