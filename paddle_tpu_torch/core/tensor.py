"""`to_tensor`: the port of `paddle_tpu/core/tensor.py` `to_tensor`
(:416).

The port's tensor is `torch.Tensor`; there is no wrapper class (the
`Tensor` method surface in Paddle's signatures is ROADMAP queue 1 item
7). `to_tensor(data, dtype, place, stop_gradient=True)` copies `data`
(a tensor, a numpy array, a scalar or nested lists) to a new tensor on
`place`: None is the card, as for every entry point of the port; "cpu"
is the CPU; "gpu", "gpu:N", "cuda" and "cuda:N" a card;
a `torch.device` is taken as it is. Float data given no dtype takes
the default float dtype (`framework.set_default_dtype`, float32), as
the JAX package's does; integers keep torch's widths (int64 stays
int64, where the JAX package, x64 off, gives int32).
`stop_gradient=False` means `requires_grad` (of a float or complex
tensor: torch lets no integer tensor require grad, where Paddle keeps
the flag on one through which no gradient flows).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .dtype import convert_dtype, default_float_dtype

__all__ = ["to_tensor", "place_device"]


def place_device(place=None):
    """The `torch.device` of a Paddle place: None is the card."""
    if place is None or isinstance(place, torch.device):
        return resolve_device(place)
    name = str(place).lower()
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return resolve_device(name)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor holding `data` on `place`."""
    dev = place_device(place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=dt, copy=True)
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype.kind == "f":
            dt = default_float_dtype()
        if arr.dtype.kind == "c" and dt is None:
            dt = torch.complex64 if arr.dtype == np.complex64 else \
                torch.complex128
        t = torch.from_numpy(np.array(arr)).to(device=dev, dtype=dt)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t
