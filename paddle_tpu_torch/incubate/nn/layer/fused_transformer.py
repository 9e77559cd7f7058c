"""Fused transformer layers: the port of
`paddle_tpu/incubate/nn/layer/fused_transformer.py` (:25-177).

`FusedMultiHeadAttention` keeps the JAX layout: one [E, 3E] qkv weight
(one product), heads split as [B, S, 3, H, D] -> [3, B, H, S, D], the
output projection [E, E], attention through
`incubate.nn.functional.scaled_dot_product_attention` (the flash
kernels #1-3 when there is no mask and no live dropout, else the plain
composition). `FusedFeedForward` is linear1 -> activation -> linear2.
Both end post-LN in a residual-add LayerNorm epilogue through
`fused_layer_norm` (kernels #4-5) or, with `normalize_before`, open
with a pre-LN prologue and end in a plain residual add.

Parameters keep the JAX names and shapes, so a state dict loads name
for name; the LayerNorm scales and shifts are plain parameters without
`no_amp_cast`, as in the JAX package, so `amp.decorate` casts them to
bf16 (the LayerNorm wrappers take bf16 scales). The unused prologue or
epilogue LayerNorm's parameters exist, as there, and get zero
gradients from the train step. Weights are drawn from `generator` on
`device` (None: the card, seed 0); dropout masks come from
`dropout_generator` (None: the device's default generator). Each
layer that runs a kernel has a `use_kernel` attribute, True when built;
`set_use_kernel(model, False)` switches every such layer of a model to
the kernels' plain versions: the comparison path.
"""
from __future__ import annotations

import torch.nn as nn

from ....nn import functional as F
from ....nn.initializer import Constant, create_parameter, init_source
from ....ops import activation as A
from .. import functional as IF

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "set_use_kernel"]


def set_use_kernel(model, use_kernel):
    """Switch every layer of `model` that runs a kernel to the kernel
    (True) or to its plain version (False)."""
    for m in model.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = use_kernel
    return model


class FusedMultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, *, epsilon=1e-5, device=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        for nm, dim in (("kdim", kdim), ("vdim", vdim)):
            if dim not in (None, embed_dim):
                raise NotImplementedError(
                    f"FusedMultiHeadAttention: {nm}={dim} != embed_dim is "
                    "not ported")
        dev, gen = init_source(device, generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        self.dropout_generator = dropout_generator
        self.use_kernel = True

        def param(shape, init=None, is_bias=False):
            return create_parameter(shape, dev, gen, init, is_bias)

        self.qkv_weight = param([embed_dim, 3 * embed_dim])
        self.qkv_bias = param([3 * embed_dim], is_bias=True)
        self.linear_weight = param([embed_dim, embed_dim])
        self.linear_bias = param([embed_dim], is_bias=True)
        self.pre_ln_scale = param([embed_dim], Constant(1.0))
        self.pre_ln_bias = param([embed_dim], is_bias=True)
        self.ln_scale = param([embed_dim], Constant(1.0))
        self.ln_bias = param([embed_dim], is_bias=True)

    def forward(self, query, attn_mask=None):
        residual = x = query
        if self.normalize_before:
            x = IF.fused_layer_norm(x, self.pre_ln_scale, self.pre_ln_bias,
                                    self._epsilon, use_kernel=self.use_kernel)
        qkv = F.linear(x, self.qkv_weight, self.qkv_bias)
        b, s = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # [3, B, H, S, D]
        out = IF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            training=self.training, generator=self.dropout_generator,
            use_kernel=self.use_kernel)
        out = out.transpose(1, 2).reshape(b, s, self.embed_dim)
        out = F.linear(out, self.linear_weight, self.linear_bias)
        out = F.dropout(out, self.dropout_rate, training=self.training,
                        generator=self.dropout_generator)
        if not self.normalize_before:
            # residual add -> LayerNorm in one fused pass
            return IF.fused_layer_norm(out, self.ln_scale, self.ln_bias,
                                       self._epsilon, residual=residual,
                                       use_kernel=self.use_kernel)
        return residual + out


class FusedFeedForward(nn.Module):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, *, device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        self._d_model = d_model
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        if activation not in ("relu", "gelu"):
            raise ValueError(f"FusedFeedForward: activation {activation!r} "
                             "is not ported (relu, gelu)")
        self._act = activation
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        self.dropout_generator = dropout_generator
        self.use_kernel = True

        def param(shape, init=None, is_bias=False):
            return create_parameter(shape, dev, gen, init, is_bias)

        self.linear1_weight = param([d_model, dim_feedforward])
        self.linear1_bias = param([dim_feedforward], is_bias=True)
        self.linear2_weight = param([dim_feedforward, d_model])
        self.linear2_bias = param([d_model], is_bias=True)
        self.ln1_scale = param([d_model], Constant(1.0))
        self.ln1_bias = param([d_model], is_bias=True)
        self.ln2_scale = param([d_model], Constant(1.0))
        self.ln2_bias = param([d_model], is_bias=True)

    def forward(self, src):
        residual = src
        if self._normalize_before:
            src = IF.fused_layer_norm(src, self.ln1_scale, self.ln1_bias,
                                      self._epsilon,
                                      use_kernel=self.use_kernel)
        out = F.linear(src, self.linear1_weight, self.linear1_bias)
        out = F.dropout(getattr(A, self._act)(out), self._act_dropout_rate,
                        training=self.training,
                        generator=self.dropout_generator)
        out = F.linear(out, self.linear2_weight, self.linear2_bias)
        out = F.dropout(out, self._dropout_rate, training=self.training,
                        generator=self.dropout_generator)
        if not self._normalize_before:
            return IF.fused_layer_norm(out, self.ln2_scale, self.ln2_bias,
                                       self._epsilon, residual=residual,
                                       use_kernel=self.use_kernel)
        return residual + out


class FusedTransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, generator=None, dropout_generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        act_dropout_rate = (dropout_rate if act_dropout_rate is None
                            else act_dropout_rate)
        kw = dict(device=dev, generator=gen,
                  dropout_generator=dropout_generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None):
        out = self.fused_attn(src, attn_mask=src_mask)
        return self.ffn(out)
