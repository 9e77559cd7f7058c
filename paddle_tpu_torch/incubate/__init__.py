"""paddle_tpu_torch.incubate — counterpart of paddle_tpu.incubate."""
from . import optimizer
from .optimizer import LookAhead, ModelAverage

__all__ = ["optimizer", "LookAhead", "ModelAverage"]
