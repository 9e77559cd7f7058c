"""Normalisation: the port of `paddle_tpu/ops/norm_ops.py` `layer_norm`
(`_k_layer_norm`, :21-32), the plain composition the `nn.LayerNorm`
layer runs (the fused kernel is `incubate.nn.functional`'s).

Statistics are f32 (population variance); the normalised value is
rounded to x's dtype BEFORE `* weight + bias`, as the JAX op does, and
the affine step then promotes as jnp would (a bf16 row times an f32
weight is f32). `torch.nn.functional.layer_norm` rounds once at the
end, which gives other bits in bf16."""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-05):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n_norm = len(normalized_shape) if normalized_shape is not None else 1
    x, weight, bias = maybe_cast_inputs("layer_norm", (x, weight, bias))
    dims = tuple(range(x.dim() - n_norm, x.dim()))
    shape = x.shape[x.dim() - n_norm:]
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out
