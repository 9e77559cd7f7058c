"""paddle_tpu_torch.hapi: `Model` (prepare / fit / evaluate / predict,
elastic resume) and its `callbacks`."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
