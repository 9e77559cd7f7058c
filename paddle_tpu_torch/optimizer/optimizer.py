"""Optimizer base, the port of `paddle_tpu/optimizer/optimizer.py`.

Every optimizer defines ONE update rule `_update(param, grad, slots, lr)
-> (new_param, new_slots)` in plain tensor ops, the JAX package's pure
rule. `step()` keeps the dygraph order of optimizer.py:101-134:

- the gradients of the parameters that have one are clipped
  (`grad_clip`, a `paddle_tpu_torch.nn.ClipGrad*`), then cast to f32;
- with `multi_precision`, a bf16 or f16 parameter gets an f32
  `master_weight` slot; the rule updates the master weight and the
  parameter is re-derived from it (rounded once to its dtype);
- without `weight_decay`'s decoupled form (AdamW), a weight decay is
  L2 added to the gradient;
- then the rule.

An optimizer whose rule has a multi-tensor kernel (`_fused_kind`:
"sgd", "momentum", "adam", "adamw", as `_pallas_fused_kind` in the JAX
package) makes ONE call of `incubate.nn.kernels.optim.fused_*` for all
its CUDA parameters: one kernel launch. There is no switch that turns
the kernel off on the card: `use_kernel=False`, a constructor argument,
asks for the per-parameter `_update` loop, the comparison path, which
CPU parameters always take. Both paths update the parameters and the
slots in place, so the model's parameter tensors and the tensors in
`_accumulators` never change identity.

The learning rate is a float or an `LRScheduler` (`get_lr()` reads the
scheduler, `set_lr` refuses one, `set_lr_scheduler` installs one).
Parameter groups are flattened, as in the JAX package: group-specific
settings are ignored there too.

Slots are keyed by parameter name: `parameters` may be an iterable of
tensors (named `param_0`, `param_1`, ...) or of (name, tensor) pairs,
as `model.named_parameters()` gives them. `state_dict()` keys are
`"<name>.<slot>"`, `"@step"` and, with a scheduler, `"LR_Scheduler"`.
`_slot_state` / `_load_slot_state` re-key the slots by a model's
structured names, for training-state snapshots (`hapi.Model`).
"""
from __future__ import annotations

import numbers

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    _slot_names = ()  # e.g. ("moment1", "moment2")
    _decoupled_wd = False
    # the multi-tensor kernel this rule has a twin in, or None
    _fused_kind = None

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, *, use_kernel=True):
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        items = list(parameters or ())
        if items and isinstance(items[0], dict):
            # parameter groups: flattened (group-specific settings are
            # unsupported, as in the JAX package)
            items = [p for group in items for p in group["params"]]
        named = [item if isinstance(item, tuple) else (f"param_{i}", item)
                 for i, item in enumerate(items)]
        if len({n for n, _ in named}) != len(named):
            raise ValueError("parameter names must be unique")
        self._named = named
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._use_kernel = use_kernel
        self._accumulators = {}  # param name -> {slot: tensor}
        self._step_count = 0
        self._current_param_name = None  # set per parameter in the loop

    # -- lr ---------------------------------------------------------------
    def get_lr(self):
        lr = self._learning_rate
        if isinstance(lr, LRScheduler):
            return float(lr())
        return float(lr)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "can't set_lr when the lr is an LRScheduler; call "
                "scheduler.step() instead")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

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

    def _fused_update(self, items, lr):
        """One call of this rule's multi-tensor kernel over `items`,
        (name, param, grad) triples of CUDA tensors (`_fused_kind`)."""
        raise NotImplementedError

    def _wd_coeff(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    # -- dygraph step -----------------------------------------------------
    @torch.no_grad()
    def step(self):
        self._apply(self.get_lr())
        self._step_count += 1

    @torch.no_grad()
    def _apply(self, lr):
        """Clip, then the rule over every parameter with a gradient, at
        learning rate `lr`; the step count is the caller's."""
        name_of = {id(p): name for name, p in self._named}
        pairs = [(p, p.grad) for _, p in self._named
                 if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        items = [(name_of[id(p)], p, g) for p, g in pairs if g is not None]
        if not items:
            return
        if (self._fused_kind is not None and self._use_kernel
                and items[0][1].device.type == "cuda"):
            self._fused_update(items, lr)
            return
        wd = self._wd_coeff()
        for name, p, g in items:
            g = g.float()
            slots = self._get_slots(name, p)
            mw = slots.get("master_weight")
            base = mw if mw is not None else p
            if wd and not self._decoupled_wd:
                g = g + wd * base.float()
            self._current_param_name = name
            rest = {k: v for k, v in slots.items() if k != "master_weight"}
            new_base, new_slots = self._update(base, g, rest, lr)
            for k, v in new_slots.items():
                slots[k].copy_(v)
            base.copy_(new_base)
            if mw is not None:
                p.copy_(new_base)
        self._current_param_name = None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        for _, p in self._named:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict -------------------------------------------------------
    def state_dict(self):
        out = {f"{pname}.{sname}": v.detach().clone()
               for pname, slots in self._accumulators.items()
               for sname, v in slots.items()}
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        devices = {name: p.device for name, p in self._named}
        self._accumulators = {}
        for key, v in state_dict.items():
            if key in ("@step", "LR_Scheduler"):
                continue
            pname, _, sname = key.rpartition(".")
            t = torch.as_tensor(v, dtype=torch.float32,
                                device=devices.get(pname))
            self._accumulators.setdefault(pname, {})[sname] = t.clone()

    set_dict = set_state_dict

    # -- elastic checkpoint slot state ------------------------------------
    def _slot_state(self, named_params):
        """The live slots keyed by structured parameter name (the
        `named_parameters()` keys of `named_params`), the key space a
        training-state snapshot stores them under: the optimizer's own
        names (`param_<i>` for unnamed parameters) depend on how it was
        built, the structured names survive a relaunch. The tensors are
        the live ones, not copies."""
        rev = {id(p): sname for sname, p in named_params}
        own = dict(self._named)
        return {rev.get(id(own.get(pn)), pn): dict(sl)
                for pn, sl in self._accumulators.items()}

    @torch.no_grad()
    def _load_slot_state(self, slots, named_params):
        """Inverse of `_slot_state`: install a structured-name slot tree
        as the live slots, each on its parameter's device in the dtype
        it was saved in (a master weight stays f32). A slot that exists
        already is overwritten in place."""
        fwd = {sname: id(p) for sname, p in named_params}
        own = {id(p): (name, p) for name, p in self._named}
        for sname, sl in slots.items():
            name, p = own.get(fwd.get(sname), (sname, None))
            cur = self._accumulators.setdefault(name, {})
            for k, v in sl.items():
                v = torch.as_tensor(v)
                dev = p.device if p is not None else v.device
                t = cur.get(k)
                if (t is not None and t.shape == v.shape
                        and t.dtype == v.dtype and t.device == dev):
                    t.copy_(v)
                else:
                    cur[k] = v.to(dev, copy=True)
