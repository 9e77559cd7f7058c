"""Normalisation: the port of `paddle_tpu/ops/norm_ops.py` `layer_norm`
(`_k_layer_norm`, :21-32), the plain composition the `nn.LayerNorm`
layer runs (the fused kernel is `incubate.nn.functional`'s), and
`batch_norm` (`_k_batch_norm`, :57-128).

Statistics are f32 (population variance); the normalised value is
rounded to x's dtype BEFORE `* weight + bias`, as the JAX op does, and
the affine step then promotes as jnp would (a bf16 row times an f32
weight is f32). `torch.nn.functional.layer_norm` rounds once at the
end, which gives other bits in bf16."""
from __future__ import annotations

import torch

from ..amp import maybe_cast_inputs
from ..core import flags as _flags

__all__ = ["layer_norm", "batch_norm"]


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


def _bn_shape(x, channel_axis):
    axes = tuple(a for a in range(x.dim()) if a != channel_axis)
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    return axes, shape


def _bn_affine(x, scale, shift, shape):
    """x * scale + shift per channel, in x's dtype. Below f32 the product
    and the sum are rounded each (two ops), as the JAX op rounds them;
    one fused rounding gives other bits in bf16."""
    if x.dtype == torch.float32:
        return x * scale.reshape(shape) + shift.reshape(shape)
    return (x * scale.reshape(shape).to(x.dtype)
            + shift.reshape(shape).to(x.dtype))


def _bn_scale_shift(mean, var, weight, bias, eps):
    inv = torch.rsqrt(var + eps)
    scale = inv if weight is None else inv * weight.float()
    shift = -mean * scale
    if bias is not None:
        shift = shift + bias.float()
    return inv, scale, shift


class _BatchNormTrain(torch.autograd.Function):
    """Training BatchNorm: the batch statistics in f32 (one pass,
    E[x^2] - E[x]^2 clamped at 0; two passes with `stable`), then
    `_bn_affine`. Returns (out, batch mean, batch variance). It saves x
    in its own dtype and the f32 per-channel statistics, not an f32 copy
    of x, and its backward is the gradient of the same formula in f32."""

    @staticmethod
    def forward(ctx, x, weight, bias, channel_axis, eps, stable):
        axes, shape = _bn_shape(x, channel_axis)
        xf = x.float()
        mean = xf.mean(dim=axes)
        if stable:
            raw = (xf - mean.reshape(shape)).square().mean(dim=axes)
        else:
            raw = xf.square().mean(dim=axes) - mean.square()
        del xf
        var = raw.clamp_min(0.0)
        inv, scale, shift = _bn_scale_shift(mean, var, weight, bias, eps)
        out = _bn_affine(x, scale, shift, shape)
        ctx.save_for_backward(x, weight, mean, inv, raw)
        ctx.channel_axis, ctx.stable = channel_axis, stable
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, weight, mean, inv, raw = ctx.saved_tensors
        axes, shape = _bn_shape(x, ctx.channel_axis)
        n = x.numel() // x.shape[ctx.channel_axis]
        gf, xf = g.float(), x.float()
        g_sum = gf.sum(dim=axes)
        gx_sum = (gf * xf).sum(dim=axes)
        w = None if weight is None else weight.float()
        scale = inv if w is None else inv * w
        # out = x * scale + shift, shift = bias - mean * scale
        d_scale = gx_sum - mean * g_sum
        d_inv = d_scale if w is None else d_scale * w
        # d var: inv = (var + eps)^-1/2 and var = max(raw, 0), whose
        # gradient splits evenly at a tie, as jnp.maximum's does
        tie = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        d_var = d_inv * (-0.5) * inv * inv * inv * tie
        if ctx.stable:
            centered = xf - mean.reshape(shape)
            d_mean = -scale * g_sum - 2.0 * d_var * centered.sum(
                dim=axes) / n
            dx = (gf * scale.reshape(shape)
                  + (2.0 / n) * centered * d_var.reshape(shape))
        else:
            d_mean = -scale * g_sum - 2.0 * mean * d_var
            dx = (gf * scale.reshape(shape)
                  + (2.0 / n) * xf * d_var.reshape(shape))
        dx = dx + (d_mean / n).reshape(shape)
        d_w = None if weight is None else (d_scale * inv).to(weight.dtype)
        d_b = None if ctx.bias_dtype is None else g_sum.to(ctx.bias_dtype)
        return dx.to(x.dtype), d_w, d_b, None, None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """(out, new running mean, new running variance). Training
    normalises by the batch statistics and updates the running ones in
    Paddle's convention, `momentum * old + (1 - momentum) * batch`, with
    the unbiased batch variance; otherwise (or with `use_global_stats`)
    it normalises by the running statistics and returns them as they
    are. The statistics are f32 and the output is in x's dtype; the
    `stable_bn_stats` flag picks the two-pass variance. The caller (the
    BatchNorm layer) commits the new running statistics."""
    if use_global_stats:
        training = False
    x, running_mean, running_var, weight, bias = maybe_cast_inputs(
        "batch_norm", (x, running_mean, running_var, weight, bias))
    ca = x.dim() - 1 if data_format in ("NHWC", "NLC", "NDHWC") else (
        1 if x.dim() > 1 else 0)
    if not training:
        _, shape = _bn_shape(x, ca)
        _, scale, shift = _bn_scale_shift(running_mean, running_var, weight,
                                          bias, float(epsilon))
        return (_bn_affine(x, scale, shift, shape), running_mean,
                running_var)
    out, mean, var = _BatchNormTrain.apply(
        x, weight, bias, ca, float(epsilon),
        bool(_flags.get_flag("stable_bn_stats")))
    n = x.numel() // x.shape[ca]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * unbiased
    return out, new_mean, new_var
