"""`Sequential` and `LayerList`: the port of
`paddle_tpu/nn/layer/container.py` (:14-60). `Sequential` takes layers
(named "0", "1", ...), (name, layer) pairs or an `OrderedDict`;
indexing by an int or a name gives a sublayer, a slice a new
`Sequential` of those layers, renumbered from "0", as in the JAX
package. `LayerList` is torch's `ModuleList` under the JAX
constructor's parameter name."""
from __future__ import annotations

import collections

import torch.nn as nn

__all__ = ["Sequential", "LayerList"]


class Sequential(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            items = list(layers[0].items())
        elif layers and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) == 2 and isinstance(layers[0][0], str):
            items = list(layers)
        else:
            items = [(str(i), lay) for i, lay in enumerate(layers)]
        for name, lay in items:
            self.add_module(name, lay)

    def forward(self, x):
        for lay in self._modules.values():
            x = lay(x)
        return x

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        if isinstance(idx, str):
            return self._modules[idx]
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)
