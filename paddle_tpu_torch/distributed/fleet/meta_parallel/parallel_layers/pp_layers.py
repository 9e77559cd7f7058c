"""Pipeline layer description, the port of
`paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py`:
`LayerDesc`, `SharedLayerDesc`, `SegmentLayers` (uniform, `layer:<regex>`
and weighted, the JAX package's algorithm) and `PipelineLayer`.

`PipelineLayer` builds every layer of its description in this process,
in order, tags each parameter with its stage (`pp_stage`) and runs them
one after the other in `forward`: the JAX package's single-controller
layout and its forward. The JAX package also pipelines the uniform
middle of the layer list over a pp mesh axis (`can_pipeline`,
`pipelined_forward`: a vectorised GPipe inside its compiled step). Over
processes that needs a schedule with point-to-point sends between the
stages' ranks, which is not ported: both raise NotImplementedError
(ROADMAP queue 1 item 2).
"""
from __future__ import annotations

import re

import torch.nn as nn

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]

_NO_PP = ("the multi-process pipeline schedule (pp > 1, point-to-point "
          "sends between stages) is not ported (ROADMAP queue 1 item 2)")


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


class PipelineLayer(nn.Module):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._layers_desc = list(layers)
        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()
        built = []
        self._shared_layers = {}
        for i, d in enumerate(self._layers_desc):
            stage = self._stage_of(i)
            if isinstance(d, SharedLayerDesc):
                lay = self._shared_layers.get(d.layer_name)
                if lay is None:
                    lay = self._shared_layers[d.layer_name] = d.build_layer()
                built.append((lay, stage, d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), stage, None))
            elif isinstance(d, nn.Module) or callable(d):
                built.append((d, stage, None))
            else:
                raise TypeError(f"bad layer desc {d!r}")
        self.run_function = built
        layer_objs = []
        for lay, stage, _ in built:
            if isinstance(lay, nn.Module):
                layer_objs.append(lay)
                for p in lay.parameters():
                    p.pp_stage = stage
        self._layers = nn.ModuleList(layer_objs)

    def _stage_of(self, layer_idx):
        for s in range(self._num_stages):
            if self.segment_parts[s] <= layer_idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def get_stage_from_index(self, layer_idx):
        return self._stage_of(layer_idx)

    def forward(self, input):
        x = input
        for lay, _, fwd in self.run_function:
            x = fwd(lay, x) if fwd is not None else lay(x)
        return x

    def can_pipeline(self, num_stages):
        raise NotImplementedError(f"PipelineLayer.can_pipeline: {_NO_PP}")

    def pipelined_forward(self, x, num_micro, num_stages):
        raise NotImplementedError(
            f"PipelineLayer.pipelined_forward: {_NO_PP}")

    @property
    def parameters_by_stage(self):
        out = {}
        for lay, stage, _ in self.run_function:
            if isinstance(lay, nn.Module):
                out.setdefault(stage, []).extend(lay.parameters())
        return out
