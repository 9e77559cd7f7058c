"""Activations: the port of `paddle_tpu/ops/activation.py` `gelu`
(:70), `relu` and `tanh`. `gelu` defaults to the exact erf form
(`approximate=False`), as `jax.nn.gelu` is called there; GPT's blocks
use the tanh form."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp import maybe_cast_inputs

__all__ = ["gelu", "relu", "tanh"]


def gelu(x, approximate=False):
    (x,) = maybe_cast_inputs("gelu", (x,))
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    (x,) = maybe_cast_inputs("relu", (x,))
    return torch.relu(x)


def tanh(x):
    (x,) = maybe_cast_inputs("tanh", (x,))
    return torch.tanh(x)
