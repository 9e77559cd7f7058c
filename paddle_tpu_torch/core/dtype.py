"""Dtypes: the port of `paddle_tpu/core/dtype.py` (:22-120).

The public names (`float32`, `int64`, `bool_`, ...) are torch dtypes,
and `convert_dtype` takes a name of the JAX package's string map
(:32-49), a torch dtype, or anything `numpy.dtype` takes.

Widths are torch's. The JAX package runs with x64 off, so there an
`int64` request resolves to int32 (`convert_dtype`, `index_dtype`) and
a float64 array to float32; the port keeps int64 and float64 as asked,
and `index_dtype()` is int64, as ROADMAP queue 3 #19 records for
batches. `default_float_dtype()` reads the `default_dtype` flag
(`framework.set_default_dtype`), float32 unless changed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bfloat16", "float16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating_point", "is_integer",
           "is_complex", "default_float_dtype", "promote", "index_dtype",
           "FLOATING", "INTEGER", "COMPLEX"]

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_TO_DTYPE = {
    "bfloat16": bfloat16,
    "float16": float16,
    "half": float16,
    "float32": float32,
    "float": float32,
    "float64": float64,
    "double": float64,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int": int32,
    "int64": int64,
    "uint8": uint8,
    "bool": bool_,
    "complex64": complex64,
    "complex128": complex128,
}

_NAMES = {dt: name for name, dt in _STR_TO_DTYPE.items()
          if name not in ("half", "float", "double", "int")}

FLOATING = {bfloat16, float16, float32, float64}
INTEGER = {int8, int16, int32, int64, uint8}
COMPLEX = {complex64, complex128}


def convert_dtype(dtype):
    """A torch dtype for a dtype spec: a name of the string map, a torch
    dtype, or a numpy dtype or type (numpy's `bool` is `bool`). None
    stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR_TO_DTYPE:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _STR_TO_DTYPE[key]
    name = np.dtype(dtype).name
    if name not in _STR_TO_DTYPE:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _STR_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    return _NAMES[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in INTEGER


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in COMPLEX


def default_float_dtype():
    from . import flags

    return convert_dtype(flags.get_flag("default_dtype"))


def promote(*dtypes):
    out = convert_dtype(dtypes[0])
    for d in dtypes[1:]:
        out = torch.promote_types(out, convert_dtype(d))
    return out


def index_dtype():
    """The dtype of index and length outputs (`arange`'s default,
    `argmax`, `topk`'s indices): int64, the width Paddle declares; the
    JAX package gives int32 with x64 off."""
    return int64
