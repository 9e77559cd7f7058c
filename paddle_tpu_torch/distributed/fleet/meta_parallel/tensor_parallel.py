"""`TensorParallel`, the port of
`paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py`: a
wrapper whose forward is the model's. The JAX package holds one copy of
every parameter; here each rank holds its own, so at construction the
wrapper makes the copies agree as the reference's does: the parameters
the mp layers replicate (`dist_spec` None) are broadcast from the mp
group's first rank, and every parameter from the dp group's first rank
(each dp rank holds the same shards). Collective: every rank wraps its
model."""
from __future__ import annotations

import torch
import torch.nn as nn

from ... import collective

__all__ = ["TensorParallel"]


def _broadcast(params, group):
    if group is None or group.nranks < 2:
        return
    with torch.no_grad():
        for p in params:
            collective.broadcast(p.data, group.ranks[0],
                                 group=group.process_group)


class TensorParallel(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        if hcg is not None:
            params = list(layers.parameters())
            _broadcast([p for p in params
                        if getattr(p, "dist_spec", None) is None],
                       hcg.get_model_parallel_group())
            _broadcast(params, hcg.get_data_parallel_group())

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, sd, *args, **kwargs):
        return self._layers.load_state_dict(sd, *args, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)
