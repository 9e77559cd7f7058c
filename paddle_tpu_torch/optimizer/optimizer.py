"""Optimizer base, the port of `paddle_tpu/optimizer/optimizer.py`.

Every optimizer defines ONE update rule `_update(param, grad, slots, lr)
-> (new_param, new_slots)` in plain tensor ops, the JAX package's pure
rule; `step()` runs it per parameter, the dygraph loop of
optimizer.py:101-134:

- the gradient is cast to f32;
- with `multi_precision`, a bf16 or f16 parameter gets an f32
  `master_weight` slot; the rule updates the master weight and the
  parameter is re-derived from it (rounded once to its dtype);
- without `weight_decay`'s decoupled form (AdamW), a weight decay is
  L2 added to the gradient.

The rule returns new tensors, as the JAX rule does; `step()` then
writes the parameter in place (`copy_`) and keeps the new slots, so
the model's parameter tensors never change identity.

Slots are keyed by parameter name: `parameters` may be an iterable of
tensors (named `param_0`, `param_1`, ...) or of (name, tensor) pairs,
as `model.named_parameters()` gives them. `state_dict()` keys are
`"<name>.<slot>"` plus `"@step"`.

Queued: `LRScheduler` learning rates, `grad_clip` and parameter groups
raise NotImplementedError.
"""
from __future__ import annotations

import numbers

import torch

__all__ = ["Optimizer"]


class Optimizer:
    _slot_names = ()  # e.g. ("moment1", "moment2")
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "only a float learning rate is ported; LRScheduler is "
                "queued")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is queued")
        named = []
        for i, item in enumerate(parameters or ()):
            if isinstance(item, dict):
                raise NotImplementedError("parameter groups are queued")
            if isinstance(item, tuple):
                named.append(item)
            else:
                named.append((f"param_{i}", item))
        if len({n for n, _ in named}) != len(named):
            raise ValueError("parameter names must be unique")
        self._named = named
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._accumulators = {}  # param name -> {slot: tensor}
        self._step_count = 0
        self._current_param_name = None  # set per parameter in step()

    # -- lr ---------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- slots ------------------------------------------------------------
    def _create_slots(self, p):
        slots = {name: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                 for name in self._slot_names}
        if self._multi_precision and p.dtype in (torch.bfloat16,
                                                 torch.float16):
            # O2 master weights: f32 copy updated each step, the half-
            # precision parameter re-derived from it
            slots["master_weight"] = p.detach().float().clone()
        return slots

    def _get_slots(self, name, p):
        slots = self._accumulators.get(name)
        if slots is None:
            slots = self._accumulators[name] = self._create_slots(p)
        return slots

    # -- core rule (override) ---------------------------------------------
    def _update(self, param, grad, slots, lr):
        raise NotImplementedError

    def _wd_coeff(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    # -- dygraph step -----------------------------------------------------
    @torch.no_grad()
    def step(self):
        lr = self.get_lr()
        wd = self._wd_coeff()
        for name, p in self._named:
            if p.grad is None or not p.requires_grad:
                continue
            g = p.grad.float()
            slots = self._get_slots(name, p)
            mw = slots.get("master_weight")
            base = mw if mw is not None else p
            if wd and not self._decoupled_wd:
                g = g + wd * base.float()
            self._current_param_name = name
            if mw is not None:
                sub = {k: v for k, v in slots.items()
                       if k != "master_weight"}
                new_master, new_slots = self._update(mw, g, sub, lr)
                new_slots["master_weight"] = new_master
                p.copy_(new_master)
            else:
                new_p, new_slots = self._update(p, g, slots, lr)
                p.copy_(new_p)
            self._accumulators[name] = new_slots
        self._current_param_name = None
        self._step_count += 1

    def clear_grad(self, set_to_zero=False):
        for _, p in self._named:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- state dict -------------------------------------------------------
    def state_dict(self):
        out = {f"{pname}.{sname}": v.detach().clone()
               for pname, slots in self._accumulators.items()
               for sname, v in slots.items()}
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("@step", 0))
        devices = {name: p.device for name, p in self._named}
        self._accumulators = {}
        for key, v in state_dict.items():
            if key == "@step":
                continue
            pname, _, sname = key.rpartition(".")
            t = torch.as_tensor(v, dtype=torch.float32,
                                device=devices.get(pname))
            self._accumulators.setdefault(pname, {})[sname] = t.clone()
