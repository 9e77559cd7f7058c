"""paddle_tpu_torch.vision — the port of `paddle_tpu/vision`: the
models LeNet and the ResNet family (`vision.models`). The datasets,
transforms, vision ops and the other models are not ported."""
from . import models
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["models", *_models_all]
