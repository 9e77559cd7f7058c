"""LeNet: the port of `paddle_tpu/vision/models/lenet.py`, BASELINE.md's
config 1. Layer names and shapes are the JAX model's
(`features.0.weight`, ..., `fc.2.bias`), so a JAX state dict loads name
for name. Weights are f32 on `device` (None: the card), drawn from
`generator` (None: seed 0 there) in construction order."""
from __future__ import annotations

import torch.nn as nn

from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn.initializer import init_source
from ...ops.manipulation import flatten

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, *, device=None, generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, **kw),
                Linear(120, 84, **kw),
                Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x
