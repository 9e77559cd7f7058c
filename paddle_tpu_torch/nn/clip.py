"""Gradient clipping, the port of `paddle_tpu/nn/clip.py` (reference:
python/paddle/fluid/clip.py — ClipGradByValue, ClipGradByNorm,
ClipGradByGlobalNorm).

Each clip takes a list of (param, grad) pairs and returns a new list,
as the JAX package's dygraph clips do; an optimizer's `step()` applies
its `grad_clip` before the rule. Plain tensor code (the JAX package
computes the clips in XLA, outside any Pallas kernel):

- a clipped grad keeps its dtype: a bf16 grad is scaled in f32 and
  rounded back to bf16, `(g.float() * scale).to(g.dtype)` (clip.py:96-97),
  before the optimizer casts it to f32;
- the global norm sums the per-grad squared norms in list order, as
  `sum(sq)` does (clip.py:87);
- divisions by a norm are true divisions of tensors (in PyTorch a
  Python float over a tensor is the tensor's reciprocal times the
  float).

`need_clip=False` on a parameter keeps its grad out of the global norm
and unclipped, in `ClipGradByGlobalNorm` only, as in the JAX package
(ROADMAP.md queue 3: Paddle's other two clips honour it as well).

Under model parallelism (`fleet`'s mp layers at mp > 1) a parameter
with an `mp_group` holds one rank's shard of a logical tensor.
The JAX package takes the global norm over the logical tensors; here
the squared norms of the sharded gradients are summed, all-reduced
over their `mp_group` and added to those of the replicated ones, which
every rank holds whole and counts once: the same norm on every rank.
Under pipeline parallelism a parameter of a pipeline stage carries its
`pp_group` (`fleet`'s `PipelineLayer`, GPT's pp stages): each stage's
sum, its mp shards' included, is then summed over the pp group, so
every stage clips by the whole model's norm, and the copy of a layer
that two stages share (`pp_shared_copy`) is left out of the sum, so it
counts once; it is still clipped.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g):
        g32 = g.float()
        norm = torch.sqrt(torch.sum(torch.square(g32)))
        clip = torch.full_like(norm, self.clip_norm)
        scale = torch.where(norm > clip, clip / norm,
                            torch.ones_like(norm))
        return (g32 * scale).to(g.dtype)

    def __call__(self, params_grads):
        return [(p, g if g is None else self._clip_one(g))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Global-norm clip: every grad scaled by min(clip_norm / max(norm,
    1e-12), 1), norm over all grads of parameters that `need_clip`."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        def clipped(p, g):
            return g is not None and getattr(p, "need_clip", True)

        from ..distributed import collective

        sq, shards, group, pp, dev = [], [], None, None, None
        for p, g in params_grads:
            if not clipped(p, g):
                continue
            pp = getattr(p, "pp_group", pp)
            dev = g.device
            if getattr(p, "pp_shared_copy", False):
                continue
            s = torch.sum(torch.square(g.float()))
            if getattr(p, "mp_group", None) is not None:
                shards.append(s)
                group = p.mp_group
            else:
                sq.append(s)
        if shards:
            part = sum(shards)
            collective.all_reduce(part, group=group.process_group)
            sq.append(part)
        if pp is not None:
            total = (sum(sq) if sq else
                     torch.zeros((), dtype=torch.float32, device=dev))
            collective.all_reduce(total, group=pp.process_group)
            sq = [total]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        clip = torch.full_like(global_norm, self.clip_norm)
        scale = torch.clamp_max(clip / torch.clamp_min(global_norm, 1e-12),
                                1.0)
        return [(p, (g.float() * scale).to(g.dtype) if clipped(p, g) else g)
                for p, g in params_grads]
