"""Matrix products: the port of `paddle_tpu/ops/linalg.py` `matmul`
(:26-38). The JAX package leaves the product to XLA; here it is
`torch.matmul`, outside any kernel of the port."""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs

__all__ = ["matmul", "promote"]


def promote(*tensors):
    """The tensors cast to their common result type, as jnp promotes
    mixed operands (an f32 activation against a bf16 weight under O2
    gives an f32 product); `torch.matmul` refuses mixed dtypes."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


def matmul(x, y, transpose_x=False, transpose_y=False):
    """x @ y over the last two dims, with either side transposed first
    (a 1-d operand is not transposed). Mixed dtypes promote."""
    x, y = maybe_cast_inputs("matmul", (x, y))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(*promote(x, y))
