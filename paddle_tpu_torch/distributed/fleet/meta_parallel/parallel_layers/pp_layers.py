"""Pipeline layer description, the port of
`paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py`:
`LayerDesc`, `SharedLayerDesc`, `SegmentLayers` (uniform, `layer:<regex>`
and weighted, the JAX package's algorithm) and `PipelineLayer`.

With no pp group live (no mesh, or a mesh whose "pp" size is 1, or a
one-process dry run of a larger one), `PipelineLayer` builds every
layer of its description in this process, in order, tags each
parameter with its stage (`pp_stage`) and runs them one after the
other in `forward`: the JAX package's single-controller layout and its
forward. `can_pipeline` and `pipelined_forward` are the JAX package's:
the longest run of blocks of one class (the uniform middle) is cut
into `num_stages` stages and run micro-batch by micro-batch, the
layers before and after it on the whole batch (:175-245), here through
autograd in one process.

Under a live pp group of P ranks (the current mesh's "pp" axis, which
`fleet.init` sets) the layer is one stage of a pipeline over processes
(Paddle's rule): the description is cut by `SegmentLayers(layers, P,
seg_method)` and this rank keeps only its stage's layers, `forward`
runs only them, and `distributed.pipeline` carries the activations and
gradients between the ranks (`PipelineParallel.train_batch`). The JAX
package's pipelined path cuts only the uniform middle into P parts
(:187-245), so which rank runs which layer differs from JAX's; the
numbers do not. Every layer is still built, in order, and the other
stages' dropped, so a model built from one seed is the same at every
pp degree; the parameters keep their global layer indices
(`_layers.<i>.…`), so a stage's names are a subset of the whole
model's and the stages' union is the whole. A `SharedLayerDesc` key
that two stages hold (a tied embedding) is built on each from the same
draw; `allreduce_shared_weight_gradients` sums its gradient over the
ranks that hold it (Paddle's `allreduce_shared_weight_gradients`), and
each parameter carries `pp_group` (the pp `Group`), and, on every
holder of a shared layer but the first, `pp_shared_copy`, which
`nn.ClipGradByGlobalNorm` reads to count it once.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist
import torch.nn as nn

from .... import mesh as mesh_mod

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "pipe_group", "stages_subgroup", "allreduce_gradients"]


def pipe_group():
    """The current mesh's pp `Group` when its "pp" size is above 1 and
    a process group joins its ranks; else None."""
    mesh = mesh_mod.get_mesh()
    if mesh is None or mesh.shape.get("pp", 1) < 2:
        return None
    group = mesh.group(("pp",))
    return group if group.process_group is not None else None


def stages_subgroup(group, stages):
    """The torch.distributed group joining `stages` of this rank's line
    of pp `group` (None when this rank is not at one of them). Every
    line's group is created, in the same order, on every rank
    (collective); all the stages: the pp group's own."""
    if len(stages) == group.nranks:
        return group.process_group
    out = None
    for line in group.mesh.lines(("pp",)):
        pg = dist.new_group([line[s] for s in stages])
        if line == group.ranks and group.rank in stages:
            out = pg
    return out


def allreduce_gradients(params, process_group):
    """Sum each parameter's gradient over `process_group`, in place."""
    from .... import collective

    for p in params:
        if p.grad is not None:
            collective.all_reduce(p.grad, group=process_group)


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return self.layer_func.__name__


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Uniform, `layer:<regex>` or weighted segmentation of a layer
    list into `num_parts` stages: the boundaries, `num_parts + 1` of
    them."""

    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self.layers_desc = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError(f"{len(layers_desc)} layers cannot fill "
                             f"{num_parts} stages")

    def do_segment(self):
        n = len(self.layers_desc)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            pat = self.method.split(":", 1)[1]
            weights = [1 if re.search(pat, str(d)) else 0
                       for d in self.layers_desc]
            return self._by_weights(weights)
        # parameter-weighted, every layer weighing 1 as in the JAX package
        return self._by_weights([1] * n)

    def uniform(self, num_items, num_parts):
        return [(num_items * p) // num_parts for p in range(num_parts + 1)]

    def _by_weights(self, weights):
        total = sum(weights) or 1
        target = total / self.num_parts
        result = [0]
        acc = 0
        for i, w in enumerate(weights):
            acc += w
            if acc >= target * len(result) and len(result) < self.num_parts:
                result.append(i + 1)
        while len(result) < self.num_parts + 1:
            result.append(len(weights))
        result[-1] = len(weights)
        return result


class _LayerDict(nn.ModuleDict):
    """The layers this rank holds under their global indices,
    `_layers.<i>`: every layer, or under a pp group its stage's."""

    def __getitem__(self, key):
        return super().__getitem__(str(key))


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._pp_group = group = pipe_group()
        if group is not None:
            num_stages = group.nranks       # Paddle's rule: a stage a rank
        self._num_stages = num_stages or 1
        self._layers_desc = list(layers)
        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()
        built = []
        self._shared_layers = {}
        shared_stages = {}
        for i, d in enumerate(self._layers_desc):
            stage = self._stage_of(i)
            if isinstance(d, SharedLayerDesc):
                lay = self._shared_layers.get(d.layer_name)
                if lay is None:
                    lay = self._shared_layers[d.layer_name] = d.build_layer()
                shared_stages.setdefault(d.layer_name, []).append(stage)
                built.append((lay, stage, d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), stage, None))
            elif isinstance(d, nn.Module) or callable(d):
                built.append((d, stage, None))
            else:
                raise TypeError(f"bad layer desc {d!r}")
        self._middle = _uniform_middle(built)
        self._middle_buffers = any(
            len(list(lay.buffers())) for lay, _, _ in
            built[self._middle[0]:self._middle[1]])
        me = None if group is None else group.rank
        self.run_function = [e for e in built if me is None or e[1] == me]
        layer_objs = {}      # global index among the built modules
        modules = [(lay, stage) for lay, stage, _ in built
                   if isinstance(lay, nn.Module)]
        for n, (lay, stage) in enumerate(modules):
            if me is None or stage == me:
                layer_objs[n] = lay
            for p in lay.parameters():
                p.pp_stage = stage
        self._layers = _LayerDict({str(i): lay for i, lay
                                   in layer_objs.items()})
        if group is not None:
            for p in self._layers.parameters():
                p.pp_group = group
        self._shared_groups = self._shared_weight_groups(shared_stages)

    def _shared_weight_groups(self, shared_stages):
        """{key: the torch.distributed group of this rank's pp line at
        the stages holding shared layer `key`} for each key two or more
        stages hold and this rank holds, marking the copies on all but
        the first holder `pp_shared_copy`. Every rank creates every
        line's group, in the same order (collective)."""
        group = self._pp_group
        out = {}
        if group is None:
            return out
        for key in sorted(shared_stages):
            stages = sorted(set(shared_stages[key]))
            if len(stages) < 2:
                continue
            pg = stages_subgroup(group, stages)
            if pg is None:
                continue
            out[key] = pg
            if group.rank != stages[0]:
                for p in self._shared_layers[key].parameters():
                    p.pp_shared_copy = True
        return out

    def allreduce_shared_weight_gradients(self):
        """Sum the gradient of each layer two or more stages hold over
        the ranks that hold it (after the schedule, before the clip)."""
        for key, pg in self._shared_groups.items():
            allreduce_gradients(self._shared_layers[key].parameters(), pg)

    @property
    def pipe_group(self):
        """The pp Group this layer is a stage of; None when it holds
        every stage."""
        return self._pp_group

    def _stage_of(self, layer_idx):
        for s in range(self._num_stages):
            if self.segment_parts[s] <= layer_idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def get_stage_from_index(self, layer_idx):
        return self._stage_of(layer_idx)

    def _run(self, entries, x):
        for lay, _, fwd in entries:
            x = fwd(lay, x) if fwd is not None else lay(x)
        return x

    def forward(self, input):
        """Every layer this rank holds, in order: the whole model, or
        under a pp group this rank's stage."""
        return self._run(self.run_function, input)

    def can_pipeline(self, num_stages):
        """Whether the uniform middle cuts into `num_stages` equal
        stages of blocks without buffers (the JAX package's rule)."""
        start, end = self._middle
        n = end - start
        if n < num_stages or n % num_stages:
            return False
        return not self._middle_buffers

    def pipelined_forward(self, x, num_micro, num_stages):
        """The JAX package's pipelined forward (:187-245), in one
        process: the layers before the uniform middle on the whole
        batch, the middle micro-batch by micro-batch through its
        `num_stages` stages, the layers after it on the whole batch; the
        plain forward when the middle does not cut or `num_micro` < 2.
        A stage of a pipeline over processes trains through
        `PipelineParallel.train_batch` instead, and raises here."""
        from ....pipeline import microbatch

        if self._pp_group is not None:
            raise RuntimeError(
                "PipelineLayer.pipelined_forward: this layer is one stage "
                f"of a pipeline over {self._pp_group.nranks} ranks; run "
                "it through PipelineParallel.train_batch")
        if not self.can_pipeline(num_stages) or num_micro < 2:
            return self.forward(x)
        start, end = self._middle
        x = self._run(self.run_function[:start], x)
        middle = self.run_function[start:end]
        outs = [self._run(middle, xm) for xm in microbatch(x, num_micro)]
        x = torch.cat(outs, 0)
        return self._run(self.run_function[end:], x)

    @property
    def parameters_by_stage(self):
        out = {}
        for lay, stage, _ in self.run_function:
            if isinstance(lay, nn.Module):
                out.setdefault(stage, []).extend(lay.parameters())
        return out


def _uniform_middle(entries):
    """(start, end) of the longest run of layers of one class with no
    forward function (the transformer blocks), JAX's
    `_find_uniform_middle`."""
    best = (0, 0)
    i, n = 0, len(entries)
    while i < n:
        lay = entries[i][0]
        if not isinstance(lay, nn.Module) or entries[i][2] is not None:
            i += 1
            continue
        j = i
        t = type(lay)
        while j < n and type(entries[j][0]) is t and entries[j][2] is None:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best
