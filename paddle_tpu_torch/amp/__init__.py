"""paddle_tpu_torch.amp — mixed precision, the port of
`paddle_tpu/amp/__init__.py`: `auto_cast` (O1), `decorate` (O2) and
`GradScaler`.

`auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
level="O1", dtype="bfloat16")` (alias `amp_guard`) is a context manager
over a thread-local state (`amp_state()`). Inside it, every op of the
port's functional layer (`nn.functional`, `ops`, `incubate.nn`) first
hands its inputs to `maybe_cast_inputs(op_name, vals)` under its JAX
op name, as the JAX dispatcher does (amp/__init__.py:108-130): for a
name in `WHITE_LIST` plus the custom white list minus the custom black
list, every f32 tensor among the inputs, an additive attention mask
included, becomes the amp dtype; any other tensor and any other op is
left alone. The black list upcasts nothing. The lists are the JAX
package's, verbatim. This is not `torch.autocast`: that one has its own
op lists, runs `layer_norm` and `softmax` in f32 and caches casts.
`audit_op_lists()` names the list entries no op of the port dispatches
(`known_op_names()` scans the port's sources for the names it hands to
`maybe_cast_inputs`, and adds the names the op factories pass to
`register_op`). `auto_cast.__enter__` runs the PTA092 precision audit
(`analysis.precision.audit_autocast`: a float16 autocast whose custom
white list force-lowers range-sensitive ops raises under
PADDLE_SANITIZE=numerics and reports under PADDLE_ANALYSIS=1), and
`GradScaler` records `amp_scale_growth` / `amp_scale_backoff` flight
events, as in the JAX package (:145-152, 290-310).

`decorate(models, optimizers=None, level="O2", dtype="bfloat16")` casts
every floating parameter and buffer of the models to the amp dtype in
place, except those of normalisation layers (torch's, the port's
`nn.LayerNorm` and its BatchNorm family, whose running statistics stay
f32 too) and those marked `no_amp_cast` (GPT's LayerNorm scales
and shifts), which stay f32 — the reference's `pure_fp16_initialize`.
Parameters keep their identity (only `.data` changes), so an optimizer
built before or after holds the same tensors. f32 master weights are
the optimizer's business (`multi_precision=True`).

`GradScaler` is dynamic loss scaling (amp/__init__.py:220-345):
`scale`, `unscale_`, `step`, `update`, `minimize`, the state dict, and
`_record_step`, through which `jit.TrainStepCompiler(grad_scaler=...)`
feeds it one finite / non-finite verdict per microstep. The eager
`unscale_` leaves f32 gradients, as the JAX package's does (:254-257),
and takes the finiteness verdict of all of them with one host sync.
"""
from __future__ import annotations

import os
import re
import threading

import torch
import torch.nn as nn

from ..core import monitor as _monitor

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "white_list", "black_list", "amp_state", "maybe_cast_inputs",
           "audit_op_lists", "known_op_names", "register_op", "WHITE_LIST",
           "BLACK_LIST"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# reference: imperative/amp_auto_cast.cc AmpOperators default lists, as
# the JAX package keeps them (amp/__init__.py:29-35): names of ops as
# dispatched
WHITE_LIST = {"matmul", "mv", "conv2d", "conv1d", "conv3d",
              "linear", "einsum", "addmm",
              "scaled_dot_product_attention"}
BLACK_LIST = {"exp", "log", "log2", "log10", "log1p", "mean", "sum", "softmax",
              "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
              "layer_norm", "batch_norm", "norm", "cumsum", "pow",
              "logsumexp"}


def _norm_layers():
    """The layer types the reference's pure_fp16_initialize skips:
    torch's norm layers, the port's `nn.LayerNorm` and its BatchNorm
    family."""
    from ..nn.layer.norm import LayerNorm, _BatchNormBase

    return (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm,
            nn.RMSNorm, LayerNorm, _BatchNormBase)


def _amp_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported amp dtype {dtype!r}")
    return _DTYPES[dtype]


def white_list():
    return {"float16": {"O1": WHITE_LIST, "O2": WHITE_LIST},
            "bfloat16": {"O1": WHITE_LIST, "O2": WHITE_LIST}}


def black_list():
    return {"float16": {"O1": BLACK_LIST, "O2": BLACK_LIST},
            "bfloat16": {"O1": BLACK_LIST, "O2": BLACK_LIST}}


_CAST_CALL = re.compile(
    r"""(?:maybe_cast_inputs|_cast)\(\s*['"](\w+)['"]""")

# op names handed to maybe_cast_inputs from a variable, which the source
# scan cannot read: the op factories register them here
_REGISTERED = set()


def register_op(name):
    """Make `name` known to `known_op_names()`."""
    _REGISTERED.add(name)


def known_op_names():
    """Every op name the port's functional layer hands to
    `maybe_cast_inputs`: the literal first arguments of its calls (and
    of `ops._common._cast`'s) in the package's sources, plus the names
    passed to `register_op`."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = set(_REGISTERED)
    for root, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn), encoding="utf-8") as f:
                    names.update(_CAST_CALL.findall(f.read()))
    return names


def audit_op_lists():
    """{"white": [...], "black": [...]}: the entries of WHITE_LIST and
    BLACK_LIST that no op of the port dispatches — ops not ported yet,
    which auto_cast can therefore never see."""
    known = known_op_names()
    return {"white": sorted(n for n in WHITE_LIST if n not in known),
            "black": sorted(n for n in BLACK_LIST if n not in known)}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_amp = _AmpState()


def amp_state():
    return _amp


def _cast_tree(v, dtype):
    if isinstance(v, torch.Tensor):
        return v.to(dtype) if v.dtype == torch.float32 else v
    if isinstance(v, (list, tuple)):
        return type(v)(_cast_tree(x, dtype) for x in v)
    return v


def maybe_cast_inputs(op_name, vals):
    """`vals` with every f32 tensor cast to the amp dtype when auto_cast
    is on and `op_name` is white-listed (the default list plus the
    custom white list, minus the custom black list); else `vals` as
    given. Called by each op of the functional layer on its tensor
    inputs, under the op's JAX name."""
    if not _amp.enabled:
        return vals
    if op_name not in (WHITE_LIST | _amp.custom_white) - _amp.custom_black:
        return vals
    return _cast_tree(vals, _amp.dtype)


class auto_cast:
    """Context manager (paddle.amp.auto_cast): O1 casts the inputs of
    white-listed ops; on exit the outer state comes back."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self._enable = enable
        self._white = set(custom_white_list or [])
        self._black = set(custom_black_list or [])
        self._level = level
        self._dtype = _amp_dtype(dtype)

    def __enter__(self):
        if self._enable and self._white:
            from ..analysis.precision import audit_autocast

            audit_autocast(str(self._dtype).replace("torch.", ""),
                           self._white, where="auto_cast")
        self._prev = (_amp.enabled, _amp.dtype, _amp.level,
                      _amp.custom_white, _amp.custom_black)
        _amp.enabled = self._enable
        _amp.dtype = self._dtype
        _amp.level = self._level
        _amp.custom_white = self._white
        _amp.custom_black = self._black
        return self

    def __exit__(self, *exc):
        (_amp.enabled, _amp.dtype, _amp.level, _amp.custom_white,
         _amp.custom_black) = self._prev
        return False


amp_guard = auto_cast


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
    dtype = _amp_dtype(dtype)
    norm_layers = _norm_layers()
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for model in model_list:
            for layer in model.modules():
                if isinstance(layer, norm_layers):
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
                self._record_scale_event("amp_scale_backoff")
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
                _monitor.stat_add("amp/scale/growths", 1)
                self._record_scale_event("amp_scale_growth")
        self._found_inf = False

    def _record_scale_event(self, kind):
        try:
            from ..monitor import flight as _flight

            _flight.record(kind, scale=float(self._scale))
        except Exception:
            pass  # telemetry must never break the step

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
