"""paddle_tpu_torch.amp — mixed precision, the port of
`paddle_tpu/amp/__init__.py` (level O2).

`decorate(models, optimizers=None, level="O2", dtype="bfloat16")` casts
every floating parameter and buffer of the models to the amp dtype in
place, except those of normalisation layers and those marked
`no_amp_cast` (GPT's LayerNorm scales and shifts), which stay f32 —
the reference's `pure_fp16_initialize`. Parameters keep their identity
(only `.data` changes), so an optimizer built before or after holds
the same tensors. f32 master weights are the optimizer's business
(`multi_precision=True`).

Queued: `auto_cast` (O1) and `GradScaler`.
"""
from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# the reference's pure_fp16_initialize skips these layer types
_NORM_LAYERS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm,
                nn.RMSNorm)


def _cast(t, dtype):
    return (t is not None and t.is_floating_point()
            and not getattr(t, "no_amp_cast", False)
            and t.dtype != dtype)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """O2: cast the models' parameters and buffers to `dtype` in place,
    norm layers and `no_amp_cast` tensors excepted. Returns the models
    (and the optimizers, when given), as the reference does."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported amp dtype {dtype!r}")
        dtype = _DTYPES[dtype]
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, _NORM_LAYERS):
                    continue
                for p in layer._parameters.values():
                    if _cast(p, dtype):
                        p.data = p.data.to(dtype)
                for name, b in layer._buffers.items():
                    if _cast(b, dtype):
                        layer._buffers[name] = b.to(dtype)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
