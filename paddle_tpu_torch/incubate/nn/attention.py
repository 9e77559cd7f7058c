"""Scaled-dot-product attention with its routing: the port of
`paddle_tpu/incubate/nn/attention.py` (:24-77).

q, k, v are [B, H, S, D]. The JAX package takes its Pallas flash
kernel when `_use_pallas` allows (:43-53: no mask, no live dropout,
head_dim 64, 128 or 256), else `_xla_attention`. The port routes the
same way onto its flash kernels (#1-3, `kernels.flash_attention`):
no mask, no live dropout, head_dim 64 or 128 (`flash_supported`; the
CUDA kernels take no head_dim 256 and mask a ragged sequence
themselves, so the JAX gate's S % 128 condition is not needed), and a
causal call only with sq == sk (the kernels' top-left mask). Everything
else takes `_dense_attention`, the counterpart of `_xla_attention`: f32
logits, the additive mask in f32, the bottom-right causal mask, an f32
softmax, dropout on the probabilities, probabilities cast to q's dtype
before P.V.

There is no fallback: a flash kernel that fails to build or launch
raises (the JAX `_k_sdpa`'s `try/except` around its kernel, :56-64, is
not carried over). `use_kernel=False` takes the flash kernels' plain
versions on the same route: the comparison path. Under `amp.auto_cast`
(O1) every f32 input is cast first, the additive mask included, as the
JAX dispatcher casts every array input of the op (-1e4 becomes -9984
in bf16).
"""
from __future__ import annotations

import math

import torch

from ...amp import maybe_cast_inputs
from ...ops.linalg import promote
from .kernels import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "uses_flash"]


def uses_flash(q_shape, k_shape, has_mask, dropout_p, causal):
    """Does the routing send this call to the flash kernels?"""
    return (not has_mask and dropout_p == 0.0
            and _fa.flash_supported(q_shape[-1])
            and (not causal or q_shape[-2] == k_shape[-2]))


def _dense_attention(q, k, v, mask, scale, causal, dropout_p, generator):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril(diagonal=sk - sq)
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    probs = probs.to(q.dtype)
    return torch.matmul(*promote(probs, v))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None,
                                 *, generator=None, use_kernel=True):
    """softmax(q k^T * scale + mask) v over [B, H, S, D]; `scale`
    defaults to 1 / sqrt(D). Dropout on the probabilities only in
    training, its masks from `generator`."""
    query, key, value, attn_mask = maybe_cast_inputs(
        "scaled_dot_product_attention", (query, key, value, attn_mask))
    d = query.shape[-1]
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dp = dropout_p if training else 0.0
    if uses_flash(query.shape, key.shape, attn_mask is not None, dp,
                  is_causal):
        q, k, v = (t.contiguous() for t in promote(query, key, value))
        return _fa.flash_attention(q, k, v, bool(is_causal), sm_scale,
                                   use_kernel=use_kernel)
    return _dense_attention(query, key, value, attn_mask, sm_scale,
                            bool(is_causal), dp, generator)
