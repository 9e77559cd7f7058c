"""paddle_tpu_torch.amp — mixed precision, the port of
`paddle_tpu/amp/__init__.py` (level O2 and `GradScaler`).

`decorate(models, optimizers=None, level="O2", dtype="bfloat16")` casts
every floating parameter and buffer of the models to the amp dtype in
place, except those of normalisation layers and those marked
`no_amp_cast` (GPT's LayerNorm scales and shifts), which stay f32 —
the reference's `pure_fp16_initialize`. Parameters keep their identity
(only `.data` changes), so an optimizer built before or after holds
the same tensors. f32 master weights are the optimizer's business
(`multi_precision=True`).

`GradScaler` is dynamic loss scaling (amp/__init__.py:220-345):
`scale`, `unscale_`, `step`, `update`, `minimize`, the state dict, and
`_record_step`, through which `jit.TrainStepCompiler(grad_scaler=...)`
feeds it one finite / non-finite verdict per microstep. The eager
`unscale_` leaves f32 gradients, as the JAX package's does (:254-257),
and takes the finiteness verdict of all of them with one host sync.

Queued: `auto_cast` (O1): it needs an op-level cast hook in the port's
functional model code (the JAX dispatcher's `maybe_cast_inputs`).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core import monitor as _monitor

__all__ = ["decorate", "GradScaler"]

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


class GradScaler:
    """Dynamic loss scaling (reference: amp/grad_scaler.py:26,
    check_finite_and_unscale + update_loss_scaling ops)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Every gradient of the optimizer's parameters times 1/scale, as
        f32; one host sync for the finiteness of all of them."""
        if not self._enable or self._already_unscaled:
            return
        inv = 1.0 / self._scale
        finite = []
        for _, p in optimizer._named:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            finite.append(torch.isfinite(g).all())
            # an f32 gradient for any parameter dtype, as the JAX
            # package leaves it (the `.grad` setter refuses a dtype
            # other than the parameter's)
            p.grad.data = g
        self._found_inf = bool(finite) and not bool(torch.stack(finite).all())
        self._already_unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)  # no-op if the user already unscaled
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        self._already_unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
                _monitor.stat_add("amp/scale/backoffs", 1)
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
                _monitor.stat_add("amp/scale/growths", 1)
        self._found_inf = False

    def _record_step(self, found_inf):
        """The train step's hook (`TrainStepCompiler(grad_scaler=...)`):
        it has unscaled the grads and decided apply or skip itself; this
        applies ONE microstep's verdict to the backoff / growth
        accounting, without the eager unscale_ pass."""
        if not self._enable:
            return
        self._found_inf = bool(found_inf)
        self._already_unscaled = False
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d.get("scale", self._scale)
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)
