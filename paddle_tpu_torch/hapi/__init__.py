"""paddle_tpu_torch.hapi: `Model` (prepare / fit / evaluate / predict,
elastic resume, summary), `summary`, `flops` and the `callbacks`."""
from . import callbacks
from .model import Model, flops, summary

__all__ = ["Model", "callbacks", "flops", "summary"]
