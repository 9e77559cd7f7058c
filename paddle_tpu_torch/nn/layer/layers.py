"""`Layer`: the port of `paddle_tpu/nn/layer/layers.py` (:28-352), a
`torch.nn.Module` with Paddle's methods.

Paddle's own methods are here: `create_parameter` (its `attr` read as
`nn.ParamAttr` says, drawn from the layer's generator),
`add_parameter`, `add_sublayer`, `register_buffer(name, tensor,
persistable)`, `sublayers`, `named_sublayers`, `full_name`,
`clear_gradients`, `set_state_dict` (alias `set_dict`, `load_dict`:
values copied in place, shapes checked, (missing, unexpected)
returned), `register_forward_post_hook` (torch's forward hook) and
`astype`. Where a name is also `nn.Module`'s (`parameters`,
`named_parameters`, `buffers`, `named_buffers`, `state_dict`, `to`,
`train`, `eval`, `apply`, `register_forward_pre_hook`), torch's
behaviour is kept: iterators where the JAX package returns lists,
`apply` children first, `state_dict` of detached tensors. Paddle's
parameter names are taken at the reference's positions:
`include_sublayers` is torch's `recurse`, `structured_name_prefix`
its `prefix`, and `to` takes a dtype by its Paddle name. The
parameter and sublayer order is the JAX `Layer`'s (registration order,
sublayers depth first), so a state dict carries over name for name.

A layer's parameters are made on its keyword-only `device` (None: the
card) and drawn from its `generator` (None: a fresh one seeded 0 on
that device), created at the first `create_parameter`.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn as nn

from ...core.dtype import _STR_TO_DTYPE, convert_dtype
from ..initializer import create_parameter as _create_parameter
from ..initializer import init_source

__all__ = ["Layer"]


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32", *, device=None,
                 generator=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) if dtype else None
        self._name_scope = name_scope or type(self).__name__.lower()
        self._init_device = device
        self._param_generator = generator

    def _init_source(self):
        """(device, generator) the layer's parameters are drawn on."""
        dev, gen = init_source(self._init_device, self._param_generator)
        self._init_device, self._param_generator = dev, gen
        return dev, gen

    # -- parameter creation ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        dev, gen = self._init_source()
        return _create_parameter(
            shape, dev, gen, default_initializer, is_bias,
            dtype=convert_dtype(dtype) or self._dtype, attr=attr)

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            parameter = nn.Parameter(parameter,
                                     requires_grad=parameter.requires_grad)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)
        return tensor

    # -- iteration ----------------------------------------------------------
    def parameters(self, include_sublayers=True, *, recurse=None):
        return super().parameters(
            include_sublayers if recurse is None else recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return super().buffers(
            include_sublayers if recurse is None else recurse)

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self=False):
        return [lay for _, lay in self.named_sublayers(
            include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, lay in self.named_modules(memo=layers_set, prefix=prefix):
            if lay is self and not include_self:
                continue
            yield name, lay

    def full_name(self):
        return self._name_scope

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        prefix = prefix or structured_name_prefix
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        out = destination if destination is not None else \
            collections.OrderedDict()
        self._save_to_state_dict(out, prefix, keep_vars)
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value (a tensor or an array) into the parameter or
        persistent buffer of its name, in that tensor's dtype; returns
        (missing names, unexpected names)."""
        own = dict(self.named_parameters())
        keys = set(self.state_dict())
        own.update((n, b) for n, b in self.named_buffers() if n in keys)
        unexpected = []
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            tgt = own.pop(name)
            v = value if isinstance(value, torch.Tensor) else \
                torch.as_tensor(np.asarray(value))
            if tuple(v.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(v.shape)} vs {tuple(tgt.shape)}")
            tgt.copy_(v.to(device=tgt.device, dtype=tgt.dtype))
        return list(own), unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- conversion ---------------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's `to`, a dtype also by its Paddle name ("float32",
        "bfloat16", ...), positionally or as `dtype=`."""
        args = tuple(convert_dtype(a) if isinstance(a, str)
                     and a.lower() in _STR_TO_DTYPE else a for a in args)
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = convert_dtype(kwargs["dtype"])
        kwargs.pop("blocking", None)
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=convert_dtype(dtype))

    # -- hooks --------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs); a result other than None
        replaces the outputs. Returns a handle with `remove()`."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
