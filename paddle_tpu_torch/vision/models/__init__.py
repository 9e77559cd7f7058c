"""paddle_tpu_torch.vision.models — the port of
`paddle_tpu/vision/models/__init__.py`'s LeNet and ResNet family
(`lenet.py`, `resnet.py`)."""
from .lenet import LeNet
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnext50_32x4d, resnext101_32x8d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
    "wide_resnet101_2",
]
