"""paddle_tpu_torch.nn — the part of `paddle_tpu.nn` the training path
uses: the gradient clips (`nn/clip.py`)."""
from __future__ import annotations

from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
