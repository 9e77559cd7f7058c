"""The ResNet family: the port of `paddle_tpu/vision/models/resnet.py`;
`resnet50()` is BASELINE.md's config 2.

`BasicBlock` (ResNet-18/34), `BottleneckBlock` (50 and deeper, ResNeXt
through `groups` and `width`, the wide variants through `width`) and
`ResNet` are built as the JAX package builds them, BatchNorm momentum
0.9. `data_format="NHWC"` runs the network channel-last (the input and
every activation [N, H, W, C]); the weights stay [out, in, kh, kw]
either way. Layer names are the JAX model's, so its state dict (the
parameters and the BatchNorms' `_mean` / `_variance`) loads key for
key. Weights are f32 on `device` (None: the card), drawn from
`generator` (None: seed 0 there) in construction order.
`pretrained=True` raises: no weights are downloaded."""
from __future__ import annotations

import functools

import torch.nn as nn

from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...nn.initializer import init_source
from ...ops.manipulation import flatten

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext101_32x8d",
           "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None, generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        norm_layer = norm_layer or functools.partial(
            BatchNorm2D, data_format=data_format, device=dev)
        conv = functools.partial(Conv2D, data_format=data_format,
                                 device=dev, generator=gen)
        self.conv1 = conv(inplanes, planes, 3, stride=stride, padding=1,
                          bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = conv(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None, generator=None):
        super().__init__()
        dev, gen = init_source(device, generator)
        norm_layer = norm_layer or functools.partial(
            BatchNorm2D, data_format=data_format, device=dev)
        conv = functools.partial(Conv2D, data_format=data_format,
                                 device=dev, generator=gen)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = conv(width, width, 3, stride=stride, padding=dilation,
                          groups=groups, dilation=dilation,
                          bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = conv(width, planes * self.expansion, 1,
                          bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *, device=None,
                 generator=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev, gen = init_source(device, generator)
        self._device, self._generator = dev, gen
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        self._norm_layer = functools.partial(
            BatchNorm2D, data_format=data_format, device=dev)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, data_format=data_format,
                            device=dev, generator=gen)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1),
                                             data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, device=dev,
                             generator=gen)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        kw = dict(data_format=self.data_format, device=self._device,
                  generator=self._generator)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **kw),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(arch, Block, depth, pretrained, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (no egress); "
                           "load a local checkpoint via load_state_dict")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet("resnext50_32x4d", BottleneckBlock, 50, pretrained,
                   **kwargs)


def resnext101_32x8d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 8
    return _resnet("resnext101_32x8d", BottleneckBlock, 101, pretrained,
                   **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained,
                   **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained,
                   **kwargs)
