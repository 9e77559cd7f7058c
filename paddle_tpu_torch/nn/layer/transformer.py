"""Transformer layers: the port of `paddle_tpu/nn/layer/transformer.py`
(:31-302): `MultiHeadAttention`, `TransformerEncoderLayer` /
`TransformerEncoder`, `TransformerDecoderLayer` / `TransformerDecoder`
and `Transformer`, as `Layer`s with the JAX layers' parameter names
and order, so a JAX `nn.Transformer`'s state dict carries over name for
name (`convert.load_reference_state_dict`).

The attention core is `F.scaled_dot_product_attention`, which takes the
flash kernels (#1-3) where the JAX package takes its Pallas kernel (no
mask, no live dropout: an encoder's unmasked self-attention, a
cross-attention, a cached decoder step) and the dense route otherwise
(`incubate.nn.attention`). A mask is added to the logits in their
dtype, as the JAX route adds it: a bool mask adds 0 / 1 and masks
nothing (ROADMAP queue 3 #30). Every op goes through
`amp.maybe_cast_inputs` under its JAX name (`linear`, `reshape`,
`transpose`, `concat`, `scaled_dot_product_attention`, ...).

`MultiHeadAttention.gen_cache` gives an empty (k, v) cache [B, H, 0, D];
a call with a cache appends this step's keys and values to it and
returns (out, new cache). The encoder and the decoder deep-copy their
first layer, so every layer starts with the same weights, as in JAX
and Paddle. Dropout draws from the package generator of the input's
device (`ops.random`), which a deep copy does not clone, so each layer
drops other positions.

Parameters are made on the keyword-only `device` (None: the card),
drawn in order from one `generator` (None: a fresh one seeded 0 there)
shared by the sublayers.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import to_tensor
from ...ops import activation as A
from ...ops.manipulation import concat, reshape, transpose
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


def _convert_param_attr_to_list(attr, n):
    if isinstance(attr, (list, tuple)):
        return list(attr)
    return [attr] * n


class MultiHeadAttention(Layer):
    Cache = tuple
    StaticCache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        dev, gen = self._init_source()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=dev, generator=gen)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _reshape_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        x = reshape(x, [b, s, self.num_heads, self.head_dim])
        return transpose(x, [0, 2, 1, 3])  # [B, H, S, D]

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._reshape_heads(self.q_proj(query))
        k = self._reshape_heads(self.k_proj(key))
        v = self._reshape_heads(self.v_proj(value))
        if cache is not None:
            ck, cv = cache
            k = concat([ck, k], axis=2)
            v = concat([cv, v], axis=2)
            cache = (k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        b, _, s, _ = out.shape
        out = transpose(out, [0, 2, 1, 3])
        out = reshape(out, [b, s, self.embed_dim])
        out = self.out_proj(out)
        if cache is not None:
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):
        b = key.shape[0]
        shape = (b, self.num_heads, 0, self.head_dim)
        k = torch.zeros(shape, dtype=key.dtype, device=key.device)
        v = torch.zeros(shape, dtype=key.dtype, device=key.device)
        return (k, v)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        dev, gen = self._init_source()
        kw = dict(device=dev, generator=gen)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        wattrs = _convert_param_attr_to_list(weight_attr, 2)
        battrs = _convert_param_attr_to_list(bias_attr, 2)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=wattrs[0],
                                            bias_attr=battrs[0], **kw)
        self.linear1 = Linear(d_model, dim_feedforward, wattrs[1], battrs[1],
                              **kw)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, wattrs[1], battrs[1],
                              **kw)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(A, self.activation)
        src = self.linear2(self.dropout(act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        import copy

        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [lay.gen_cache(src) for lay in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        dev, gen = self._init_source()
        kw = dict(device=dev, generator=gen)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        wattrs = _convert_param_attr_to_list(weight_attr, 3)
        battrs = _convert_param_attr_to_list(bias_attr, 3)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=wattrs[0],
                                            bias_attr=battrs[0], **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=wattrs[1],
                                             bias_attr=battrs[1], **kw)
        self.linear1 = Linear(d_model, dim_feedforward, wattrs[2], battrs[2],
                              **kw)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, wattrs[2], battrs[2],
                              **kw)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.norm3 = LayerNorm(d_model, device=dev)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.dropout3 = Dropout(dropout, mode="upscale_in_train")
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, sc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(A, self.activation)
        tgt = self.linear2(self.dropout(act(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (sc,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        import copy

        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [lay.gen_cache(memory) for lay in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        dev, gen = self._init_source()
        kw = dict(device=dev, generator=gen)
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            norm = LayerNorm(d_model, device=dev) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            norm = LayerNorm(d_model, device=dev) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] f32: 0 on and below the diagonal, -inf above,
        on the layer's device."""
        m = np.triu(np.full((length, length), -np.inf, np.float32), 1)
        return to_tensor(m, place=self._init_source()[0])
