"""BERT pretraining: the port of `paddle_tpu/text/models/bert.py`
(:1-129), BASELINE.md's config 3 (BERT-base).

Built as the JAX package builds it: `BertEmbeddings` (word, position
and token-type embeddings summed, then the fused LayerNorm at eps 1e-12
and dropout), `BertModel` (the post-LN `FusedTransformerEncoderLayer`
blocks with the erf GeLU, the additive mask (1 - m) * -1e4, the tanh
pooler over token 0) and `BertForPretraining` (the MLM head tied to
`word_embeddings`, with its own bias, and the NSP head; the loss is
the MLM cross-entropy with ignore_index -1, plus NSP's when its label
is given). The attention runs on the flash kernels (#1-3) when there is
no mask and no live dropout, and every block's residual epilogues and
the embedding LayerNorm on the LayerNorm kernels (#4-5); `mlm_norm` is
a plain `nn.LayerNorm`, as in the JAX model.

Parameter names are the JAX package's structured names
(`bert.encoder.0.fused_attn.qkv_weight`, ...), so a JAX state dict
loads name for name (`convert.load_reference_state_dict`). `device=None`
means the card; weights come from `generator` (default: seed 0 on the
device), and one more draw from it seeds `dropout_generator`, the
source of every dropout mask. `incubate.nn.set_use_kernel(model,
False)` switches a built model to the comparison path, the kernels'
plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from ...incubate.nn import FusedTransformerEncoderLayer
from ...incubate.nn import functional as IF
from ...nn import Dropout, Embedding, LayerList, LayerNorm, Linear, Tanh
from ...nn import functional as F
from ...nn.initializer import create_parameter, init_source
from ...ops.linalg import matmul

__all__ = ["BertConfig", "BertEmbeddings", "BertModel",
           "BertForPretraining", "bert_base"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, *, device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        device, generator = init_source(device, generator)
        kw = dict(device=device, generator=generator)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_seq_len, c.hidden_size,
                                             **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(c.dropout, generator=dropout_generator)
        self.use_kernel = True

    def forward(self, input_ids, token_type_ids=None):
        seq = input_ids.shape[1]
        pos = torch.arange(seq, device=input_ids.device).unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(pos)
               + self.token_type_embeddings(token_type_ids))
        normed = IF.fused_layer_norm(emb, self.layer_norm.weight,
                                     self.layer_norm.bias,
                                     self.layer_norm._epsilon,
                                     use_kernel=self.use_kernel)
        return self.dropout(normed)


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        dev, generator = init_source(device, generator)
        self.config = c = config
        # the dropout masks' source, created first and seeded after the
        # weights are drawn
        self.dropout_generator = torch.Generator(device=dev)
        kw = dict(device=dev, generator=generator)
        self.embeddings = BertEmbeddings(
            c, dropout_generator=self.dropout_generator, **kw)
        self.encoder = LayerList([
            FusedTransformerEncoderLayer(
                c.hidden_size, c.num_heads, c.ffn_hidden,
                dropout_rate=c.dropout, activation="gelu",
                dropout_generator=self.dropout_generator, **kw)
            for _ in range(c.num_layers)])
        self.pooler = Linear(c.hidden_size, c.hidden_size, **kw)
        self.pooler_act = Tanh()
        seed = torch.randint(0, 2 ** 62, (), generator=generator, device=dev)
        self.dropout_generator.manual_seed(int(seed))

    @property
    def device(self):
        return self.pooler.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(sequence output [B, S, E], pooled [B, E])."""
        dev = self.device
        input_ids = torch.as_tensor(input_ids, device=dev)
        if token_type_ids is not None:
            token_type_ids = torch.as_tensor(token_type_ids, device=dev)
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            m = torch.as_tensor(attention_mask, device=dev)
            b, s = m.shape[0], m.shape[-1]
            mask = (1.0 - m.reshape(b, 1, 1, s).float()) * -1e4
        for layer in self.encoder:
            x = layer(x, src_mask=mask)
        pooled = self.pooler_act(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Module):
    """MLM + NSP heads (the reference's pretraining objective)."""

    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        dev, generator = init_source(device, generator)
        kw = dict(device=dev, generator=generator)
        self.bert = BertModel(config, **kw)
        self.config = config
        self.mlm_transform = Linear(config.hidden_size, config.hidden_size,
                                    **kw)
        self.mlm_norm = LayerNorm(config.hidden_size, device=dev)
        self.mlm_bias = create_parameter([config.vocab_size], dev,
                                         is_bias=True)
        self.nsp = Linear(config.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        """(MLM logits [B, S, V], NSP logits [B, 2]), or with
        `masked_lm_labels` the pretraining loss (a 0-d f32 tensor)."""
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq_out)))
        # the decoder is tied to the word embeddings
        wte = self.bert.embeddings.word_embeddings.weight
        logits = matmul(h, wte, transpose_y=True) + self.mlm_bias
        nsp_logits = self.nsp(pooled)
        if masked_lm_labels is None:
            return logits, nsp_logits
        dev = self.mlm_bias.device
        loss = F.cross_entropy(
            logits, torch.as_tensor(masked_lm_labels, device=dev),
            ignore_index=-1)
        if next_sentence_label is not None:
            loss = loss + F.cross_entropy(
                nsp_logits, torch.as_tensor(next_sentence_label, device=dev))
        return loss


def bert_base(**kw):
    return BertConfig(**kw)
