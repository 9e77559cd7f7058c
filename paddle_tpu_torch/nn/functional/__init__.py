"""paddle_tpu_torch.nn.functional — the port of the part of
`paddle_tpu/nn/functional/__init__.py` the BERT and vision paths use:
`linear` (W is [in, out], y = x @ W + b), `embedding`, `dropout` and
`scaled_dot_product_attention` (routed in `incubate.nn.attention`),
plus the ops of `paddle_tpu_torch.ops` it re-exports: every activation
of `ops.activation` (`softmax`, `log_softmax`, `sigmoid`, `gelu`, ...),
`one_hot`, `pad`, `cross_entropy`, `layer_norm`, `batch_norm`,
`conv1d`, `conv2d`, `conv3d`, `max_pool2d`, `avg_pool2d`,
`adaptive_avg_pool2d` and `flatten`.

Each op hands its tensor inputs to `amp.maybe_cast_inputs` under its
JAX op name. Mixed dtypes promote as jnp promotes them. Dropout is
"upscale_in_train" and draws its keep mask from the `torch.Generator`
it is given (the package generator of the tensor's device, torch's
default one, when none is: `ops.random`); the masks are not JAX's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import maybe_cast_inputs
from ...ops import activation as _activation
from ...ops.activation import *  # noqa: F401,F403
from ...ops.creation import one_hot
from ...ops.conv import (adaptive_avg_pool2d, avg_pool2d, conv1d, conv2d,
                         conv3d, max_pool2d)
from ...ops.linalg import promote
from ...ops.loss_ops import cross_entropy
from ...ops.manipulation import flatten, pad
from ...ops.norm_ops import batch_norm, layer_norm

__all__ = ["linear", "embedding", "dropout", "scaled_dot_product_attention",
           "cross_entropy", "layer_norm", "batch_norm", "conv1d", "conv2d",
           "conv3d", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "flatten", "one_hot", "pad"] + list(_activation.__all__)


def linear(x, weight, bias=None):
    """y = x @ W + b, W [in, out] (nn/functional/__init__.py:23-33)."""
    x, weight, bias = maybe_cast_inputs("linear", (x, weight, bias))
    y = torch.matmul(*promote(x, weight))
    if bias is not None:
        y = y + bias
    return y


class _Embedding(torch.autograd.Function):
    """`F.embedding` whose weight gradient sums each id's rows in a
    fixed order, so that a step gives the same bits in every process:
    the ids sorted stably, each id's rows reduced by
    `torch.segment_reduce` (one thread an output element, in row
    order), accumulated in f32 and cast to the weight's dtype.
    PyTorch's own CUDA backward gave BERT-base's token-type gradient (16384
    rows of one id) other low bits in another process, which broke
    bit-identical resume. No host synchronisation: the segment lengths
    are counted on the device."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        rows = grad.reshape(flat.numel(), -1)
        order = torch.sort(flat, stable=True).indices
        lengths = torch.zeros(ctx.num_rows, dtype=torch.long,
                              device=flat.device).index_add_(
            0, flat, torch.ones_like(flat))
        dw = torch.segment_reduce(rows.index_select(0, order).float(), "sum",
                                  lengths=lengths, axis=0, unsafe=True,
                                  initial=0.0)
        return None, dw.to(grad.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids `x`; an id equal to `padding_idx`
    gives a zero row and no gradient."""
    if sparse:
        raise NotImplementedError("embedding: sparse=True is not ported")
    x, weight = maybe_cast_inputs("embedding", (x, weight))
    out = _Embedding.apply(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != int(padding_idx)).unsqueeze(-1).to(out.dtype)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Keep each element with probability 1 - p and scale what it keeps
    by 1 / (1 - p); the identity outside training or at p = 0."""
    if axis is not None:
        raise NotImplementedError("dropout: axis is not ported")
    if mode != "upscale_in_train":
        raise NotImplementedError(f"dropout: mode={mode!r} is not ported")
    if not training or p == 0.0:
        return x
    (x,) = maybe_cast_inputs("dropout", (x,))
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None, use_kernel=True):
    """Attention over [B, H, S, D]: the flash kernels where the JAX
    package would take its Pallas kernel, else the plain composition
    (`incubate.nn.attention`; `use_kernel=False` takes the flash
    kernels' plain versions on the same route)."""
    from ...incubate.nn import attention as _attn

    return _attn.scaled_dot_product_attention(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training, generator=generator,
        use_kernel=use_kernel)
