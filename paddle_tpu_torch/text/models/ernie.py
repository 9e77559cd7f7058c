"""ERNIE pretraining: the port of `paddle_tpu/text/models/ernie.py`,
BASELINE.md's config 5 (hybrid mp + pp pretraining).

Built line for line as the JAX package builds it: a `PipelineLayer` of
`ErnieEmbedding` (vocab-parallel word and position embeddings summed,
a plain `nn.LayerNorm`, dropout), `num_layers` `ErnieBlock`s and
`ErnieHead` (a plain LayerNorm and a column-parallel projection to the
vocabulary, gathered), with `ParallelCrossEntropy` as the loss;
`ErnieForPretraining`'s loss is the mean of the per-token
cross-entropy. An `ErnieBlock` is the Megatron split: column-parallel
qkv and fc1, row-parallel proj and fc2, the fused LayerNorm before the
attention and the fused residual LayerNorm after it (kernels #4-5), the
attention through SDPA's routing (the flash kernels #1-3: no mask, no
dropout), an erf GeLU between fc1 and fc2. The block's dropout rate is
stored and not applied, as in the JAX block.

At mp > 1 (`mp_group`, or fleet's) every mp layer holds its shard. The
qkv product is cut per head (`column_blocks=3`), so each rank computes
its own heads' q, k and v and attends over `num_heads / mp` heads. The
weights come from `generator` (default: seed 0 on the device) as full
logical tensors, each rank keeping its slice, so a model built from one
seed is the same logical model at every mp degree; one more draw seeds
`dropout_generator`, the embedding dropout's source, the same on every
mp rank.

Under O2 (`amp.decorate`) the LayerNorm parameters stay f32, and the
embedding LayerNorm's f32 scale promotes the bf16 embedding sum to f32:
the residual stream, the products (bf16 weights promoted) and the
attention run in f32, as in the JAX package.

Under a live pp group (`fleet.init` with pp_degree > 1 before the model
is built) `ErnieModel`, a `PipelineLayer`, keeps only this rank's stage
(Paddle's segmentation of the 14 layer entries; the embedding and 6
blocks, then 6 blocks and the head, at pp 2), built from the same draws
as at pp 1; `fleet.distributed_model(model.ernie)` trains it through
`PipelineParallel.train_batch`.

Parameter names are the JAX package's structured names
(`ernie._layers.1.qkv.weight`, ...), so a JAX state dict loads name for
name at mp 1 (`convert.load_reference_state_dict`) and cut to a rank's
shards at mp > 1, or to a stage's names at pp > 1
(`convert.load_sharded_state_dict`).
`incubate.nn.set_use_kernel(model, False)` switches a built model to
the kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from ...distributed.fleet.meta_parallel import (
    ColumnParallelLinear, LayerDesc, ParallelCrossEntropy, PipelineLayer,
    RowParallelLinear, VocabParallelEmbedding)
from ...distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    model_parallel_group)
from ...incubate.nn import functional as IF
from ...nn import Dropout, LayerNorm
from ...nn import functional as F
from ...nn.initializer import init_source

__all__ = ["ErnieConfig", "ErnieEmbedding", "ErnieBlock", "ErnieHead",
           "ErnieModel", "ErnieForPretraining"]


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: int = 3072
    max_seq_len: int = 512
    dropout: float = 0.1
    num_stages: int = 1


class ErnieEmbedding(nn.Module):
    def __init__(self, c: ErnieConfig, *, device=None, generator=None,
                 mp_group=None, dropout_generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        kw = dict(device=dev, generator=gen, mp_group=mp_group)
        self.word_emb = VocabParallelEmbedding(c.vocab_size, c.hidden_size,
                                               **kw)
        self.pos_emb = VocabParallelEmbedding(c.max_seq_len, c.hidden_size,
                                              **kw)
        self.norm = LayerNorm(c.hidden_size, device=dev)
        self.dropout = Dropout(c.dropout, generator=dropout_generator)

    def forward(self, input_ids):
        ids = torch.as_tensor(input_ids, device=self.norm.weight.device)
        pos = torch.arange(ids.shape[1], device=ids.device).unsqueeze(0)
        return self.dropout(self.norm(self.word_emb(ids)
                                      + self.pos_emb(pos)))


class ErnieBlock(nn.Module):
    """TP transformer block: column-parallel QKV/FC1, row-parallel
    proj/FC2."""

    def __init__(self, c: ErnieConfig, *, device=None, generator=None,
                 mp_group=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        kw = dict(device=dev, generator=gen, mp_group=mp_group)
        h = c.hidden_size
        self.ln1 = LayerNorm(h, device=dev)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                        column_blocks=3, **kw)
        self.proj = RowParallelLinear(h, h, input_is_parallel=True, **kw)
        self.ln2 = LayerNorm(h, device=dev)
        self.fc1 = ColumnParallelLinear(h, c.ffn_hidden,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(c.ffn_hidden, h,
                                     input_is_parallel=True, **kw)
        group = model_parallel_group(mp_group)
        mp = 1 if group is None else group.nranks
        if c.num_heads % mp:
            raise ValueError(f"{c.num_heads} heads do not split over mp "
                             f"{mp}")
        self.n_head = c.num_heads // mp
        self.dropout = c.dropout
        self.use_kernel = True

    def forward(self, x):
        residual = x
        h = IF.fused_layer_norm(x, self.ln1.weight, self.ln1.bias,
                                self.ln1._epsilon,
                                use_kernel=self.use_kernel)
        qkv = self.qkv(h)
        b, s = qkv.shape[0], qkv.shape[1]
        q, k, v = torch.split(qkv, qkv.shape[2] // 3, dim=2)

        def heads(t):
            return t.reshape(b, s, self.n_head, -1).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        attn = IF.scaled_dot_product_attention(
            q, k, v, is_causal=False, training=self.training,
            use_kernel=self.use_kernel)
        attn = attn.transpose(1, 2).reshape(b, s, -1)
        # residual-add -> LayerNorm fused into one pass; the sum comes
        # back as the next residual
        h, x = IF.fused_layer_norm(
            self.proj(attn), self.ln2.weight, self.ln2.bias,
            self.ln2._epsilon, residual=residual, return_residual_sum=True,
            use_kernel=self.use_kernel)
        residual = x
        return residual + self.fc2(F.gelu(self.fc1(h)))


class ErnieHead(nn.Module):
    def __init__(self, c: ErnieConfig, *, device=None, generator=None,
                 mp_group=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        self.norm = LayerNorm(c.hidden_size, device=dev)
        self.out = ColumnParallelLinear(c.hidden_size, c.vocab_size,
                                        gather_output=True, device=dev,
                                        generator=gen, mp_group=mp_group)

    def forward(self, x):
        return self.out(self.norm(x))


class ErnieModel(PipelineLayer):
    """Pipeline-segmented ERNIE: embedding | blocks... | head."""

    def __init__(self, config: ErnieConfig, topology=None, *, device=None,
                 generator=None, mp_group=None):
        dev, gen = init_source(device, generator)
        dropout_generator = torch.Generator(device=dev)
        kw = dict(device=dev, generator=gen, mp_group=mp_group)
        descs = [LayerDesc(ErnieEmbedding, config,
                           dropout_generator=dropout_generator, **kw)]
        descs += [LayerDesc(ErnieBlock, config, **kw)
                  for _ in range(config.num_layers)]
        descs += [LayerDesc(ErnieHead, config, **kw)]
        loss = ParallelCrossEntropy()
        super().__init__(descs, num_stages=config.num_stages,
                         topology=topology,
                         loss_fn=lambda logits, label: loss(logits, label))
        self.config = config
        self.dropout_generator = dropout_generator
        seed = torch.randint(0, 2 ** 62, (), generator=gen, device=dev)
        dropout_generator.manual_seed(int(seed))


class ErnieForPretraining(nn.Module):
    def __init__(self, config: ErnieConfig, topology=None, *, device=None,
                 generator=None, mp_group=None):
        super().__init__()
        self.ernie = ErnieModel(config, topology, device=device,
                                generator=generator, mp_group=mp_group)
        self.loss = ParallelCrossEntropy()
        self.config = config

    def forward(self, input_ids, labels=None):
        """The logits [B, S, V], or with `labels` the mean per-token
        cross-entropy (a 0-d f32 tensor)."""
        logits = self.ernie(input_ids)
        if labels is None:
            return logits
        return self.loss(logits, labels).mean()
