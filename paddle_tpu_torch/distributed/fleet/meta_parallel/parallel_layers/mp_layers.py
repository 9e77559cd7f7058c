"""Megatron tensor-parallel layers, the port of
`paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/mp_layers.py`:
`VocabParallelEmbedding` (:50), `ColumnParallelLinear` (:65),
`RowParallelLinear` (:92) and `ParallelCrossEntropy` (:119).

The JAX layers keep the full logical weight, tagged with a
PartitionSpec over the mesh's "mp" axis (`dist_spec`), and GSPMD
inserts the collectives. Here each model-parallel rank is a process,
so at mp > 1 a layer holds its shard and runs Megatron's collectives
itself, as `torch.autograd.Function`s over its mp group:

- column-parallel: the input's identity forward and all-reduce
  backward; with `gather_output`, the output all-gathered along its
  last axis (the backward takes this rank's slice);
- row-parallel: this rank's slice of the input (unless
  `input_is_parallel`), the partial product all-reduced forward
  (identity backward), then the replicated bias;
- vocab-parallel embedding: ids outside this rank's rows read row 0
  and are zeroed, then the all-reduce.

At mp 1 each layer is its plain op on the full weight through the
port's `nn.functional` (`linear`; `embedding`, whose backward sums each
id's rows in a fixed order).

The mp group is the layer's `mp_group` (a `distributed.mesh.Group`),
else fleet's when `fleet.init` ran, else none (mp 1). Every layer draws
the full logical weight from its `generator` (Xavier-normal over the
full shape, as the JAX layer draws it; biases zeros) and keeps its
slice, so a model built from one seed is the same logical model at
every mp degree. A weight cut along an axis is cut in `blocks` equal
blocks, each split across the ranks, a rank keeping its piece of every
block side by side (`shard`): a fused qkv product (`column_blocks=3`)
then gives each rank its own heads' q, k and v. Each parameter carries
the JAX layer's `dist_spec` (as a tuple of axis names), so the
compressed data-parallel wire refuses it as the JAX one does; a
sharded one also carries `mp_split` (axis, blocks), which
`convert.shard_state_dict` reads, and, at mp > 1, its `mp_group`, which
`nn.ClipGradByGlobalNorm` and `convert.gather_state_dict` read.

`ParallelCrossEntropy` is the JAX layer's softmax cross-entropy of each
entry over the logits it is given: the full vocabulary, which ERNIE's
head gathers. Vocabulary-sharded logits are not handled.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .....amp import maybe_cast_inputs
from .....nn import functional as F
from .....nn.initializer import create_parameter, init_source
from .....ops.loss_ops import softmax_with_cross_entropy
from .... import collective

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "shard", "unshard",
           "model_parallel_group"]


def model_parallel_group(mp_group=None):
    """The Group a model-parallel layer shards over: `mp_group`, else
    fleet's model-parallel group when `fleet.init` ran, else None."""
    if mp_group is not None:
        return mp_group
    from ... import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def shard(full, axis, blocks, nranks, rank):
    """Rank `rank`'s piece of `full` (a tensor or ndarray): along `axis`
    in `blocks` equal blocks, each cut in `nranks` pieces, this rank's
    piece of every block side by side."""
    shape = tuple(full.shape)
    n = shape[axis]
    if n % (blocks * nranks):
        raise ValueError(f"axis {axis} of {shape} does not split in "
                         f"{blocks} blocks over {nranks} ranks")
    split = shape[:axis] + (blocks, nranks, n // (blocks * nranks))
    piece = full.reshape(split + shape[axis + 1:])
    if isinstance(piece, torch.Tensor):
        piece = piece.select(axis + 1, rank)
    else:
        piece = piece.take(rank, axis=axis + 1)
    return piece.reshape(shape[:axis] + (n // nranks,) + shape[axis + 1:])


def unshard(pieces, axis, blocks):
    """The inverse of `shard`: the full array of every rank's piece (a
    list in rank order; tensors or ndarrays)."""
    first = pieces[0]
    shape = tuple(first.shape)
    w = shape[axis] // blocks
    split = [p.reshape(shape[:axis] + (blocks, 1, w) + shape[axis + 1:])
             for p in pieces]
    if isinstance(first, torch.Tensor):
        joined = torch.cat(split, dim=axis + 1)
    else:
        joined = np.concatenate(split, axis=axis + 1)
    n = shape[axis] * len(pieces)
    return joined.reshape(shape[:axis] + (n,) + shape[axis + 1:])


def _pg(group):
    return group.process_group


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        collective.all_reduce(grad, group=_pg(ctx.group))
        return grad, None


class _ReduceFromMP(torch.autograd.Function):
    """The all-reduce (sum) over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        collective.all_reduce(out, group=_pg(group))
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromMP(torch.autograd.Function):
    """Every rank's last-axis piece, gathered in `blocks` order (the
    inverse of `shard` along the last axis); the backward keeps this
    rank's piece of the gradient."""

    @staticmethod
    def forward(ctx, x, group, blocks):
        ctx.group, ctx.blocks = group, blocks
        parts = collective.all_gather([], x.contiguous(), group=_pg(group))
        return unshard(parts, x.dim() - 1, blocks)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return (shard(grad, grad.dim() - 1, ctx.blocks, g.nranks,
                      g.rank).contiguous(), None, None)


class _ScatterToMP(torch.autograd.Function):
    """This rank's last-axis piece forward; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shard(x, x.dim() - 1, 1, group.nranks,
                     group.rank).contiguous()

    @staticmethod
    def backward(ctx, grad):
        parts = collective.all_gather([], grad.contiguous(),
                                      group=_pg(ctx.group))
        return torch.cat(parts, dim=-1), None


def _no_attr(weight_attr):
    if weight_attr is not None:
        raise NotImplementedError("weight_attr: the port's layers take "
                                  "no ParamAttr")


class _MPLayer(nn.Module):
    def __init__(self, mp_group, device, generator):
        super().__init__()
        self._device, self._generator = init_source(device, generator)
        self._group = model_parallel_group(mp_group)
        self._nranks = 1 if self._group is None else self._group.nranks
        self._rank = 0 if self._group is None else self._group.rank

    @property
    def is_mp(self):
        return self._nranks > 1

    def _param(self, shape, dist_spec, split=None, is_bias=False):
        """A parameter drawn over the full `shape`, kept whole at mp 1
        and as this rank's piece (`split` = (axis, blocks)) at mp > 1."""
        p = create_parameter(shape, self._device, self._generator,
                             is_bias=is_bias)
        if split is not None and self.is_mp:
            p = nn.Parameter(shard(p.data, *split, self._nranks,
                                   self._rank).contiguous())
        p.dist_spec = dist_spec
        if split is not None:
            p.mp_split = split
            if self.is_mp:
                p.mp_group = self._group
        return p


class VocabParallelEmbedding(_MPLayer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, generator=None):
        super().__init__(mp_group, device, generator)
        _no_attr(weight_attr)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = self._param([num_embeddings, embedding_dim],
                                  ("mp", None), split=(0, 1))

    def forward(self, x):
        if not self.is_mp:
            return F.embedding(x, self.weight)
        rows = self.weight.shape[0]
        start = self._rank * rows
        ids = torch.as_tensor(x, device=self.weight.device).long()
        mine = (ids >= start) & (ids < start + rows)
        local = torch.where(mine, ids - start, torch.zeros_like(ids))
        out = F.embedding(local, self.weight)
        out = out.masked_fill(~mine.unsqueeze(-1), 0)
        return _ReduceFromMP.apply(out, self._group)

    def extra_repr(self):
        return (f"{self._num_embeddings}, {self._embedding_dim}, "
                f"mp={self._nranks}")


class ColumnParallelLinear(_MPLayer):
    """y = x W + b with W [in, out] cut along out; `column_blocks` > 1
    cuts each of that many output blocks across the ranks."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, column_blocks=1, device=None,
                 generator=None):
        super().__init__(mp_group, device, generator)
        _no_attr(weight_attr)
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        self.column_blocks = column_blocks
        self.weight = self._param([in_features, out_features],
                                  (None, "mp"), split=(1, column_blocks))
        if has_bias is False:
            self.bias = None
        else:
            self.bias = self._param([out_features], ("mp",),
                                    split=(0, column_blocks), is_bias=True)

    def forward(self, x):
        if not self.is_mp:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(_CopyToMP.apply(x, self._group), self.weight,
                       self.bias)
        if self.gather_output:
            return _GatherFromMP.apply(out, self._group, self.column_blocks)
        return out

    def extra_repr(self):
        return (f"in_features={self._in_features}, out_features="
                f"{self._out_features}, mp={self._nranks}")


class RowParallelLinear(_MPLayer):
    """y = x W + b with W [in, out] cut along in; b replicated."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 *, device=None, generator=None):
        super().__init__(mp_group, device, generator)
        _no_attr(weight_attr)
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self._param([in_features, out_features],
                                  ("mp", None), split=(0, 1))
        self.bias = (self._param([out_features], None, is_bias=True)
                     if has_bias else None)

    def forward(self, x):
        if not self.is_mp:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _ScatterToMP.apply(x, self._group)
        out = _ReduceFromMP.apply(F.linear(x, self.weight), self._group)
        if self.bias is None:
            return out
        # the bias as F.linear would take it (cast under O1)
        out, bias = maybe_cast_inputs("linear", (out, self.bias))
        return out + bias

    def extra_repr(self):
        return (f"in_features={self._in_features}, out_features="
                f"{self._out_features}, mp={self._nranks}")


class ParallelCrossEntropy(nn.Module):
    """Softmax cross-entropy of each entry (a size-1 last axis), 0 where
    the label is `ignore_index`."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        label = torch.as_tensor(label, device=input.device)
        return softmax_with_cross_entropy(input, label,
                                          ignore_index=self.ignore_index)
