"""paddle_tpu_torch.optimizer — the port of `paddle_tpu/optimizer`.

The update rules are the JAX package's, in its order of operations
(optimizer/__init__.py). Adam: m, then v, then the beta powers, then
mhat = m / (1 - b1p), vhat = v / (1 - b2p) and p - lr * mhat /
(sqrt(vhat) + eps); AdamW first scales p by (1 - lr * wd). This is not
`torch.optim.AdamW`, whose bias correction rounds differently.

`SGD`, `Momentum`, `Adam` and `AdamW` have a multi-tensor CUDA kernel
(`incubate.nn.kernels.optim`): on the card their `step()` is one kernel
launch over all their parameters, bit-identical to the per-parameter
rule (`use_kernel=False`). `Adamax`, `Adagrad`, `Adadelta`, `RMSProp`,
`Lamb` and `LarsMomentum` have no kernel, in the JAX package either
(XLA computes them there): they run per parameter on every device.
`ExponentialMovingAverage`, `LookAhead` and `ModelAverage`
(`averaging.py`) wrap an optimizer or a parameter list.
"""
from __future__ import annotations

import numpy as np
import torch

from ..incubate.nn.kernels.optim import (adam_rule, fused_adam,
                                         fused_momentum, fused_sgd,
                                         momentum_rule, sgd_rule)
from . import lr
from .averaging import ExponentialMovingAverage, LookAhead, ModelAverage
from .lr import LRScheduler
from .optimizer import Optimizer

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
    "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "lr", "LRScheduler",
    "ExponentialMovingAverage", "LookAhead", "ModelAverage",
]


def _fused_lists(opt, items):
    """(params, grads, masters, slot dicts) of (name, param, grad)
    items, slots created on first use."""
    params, grads, masters, slots = [], [], [], []
    for name, p, g in items:
        s = opt._get_slots(name, p)
        params.append(p)
        grads.append(g)
        masters.append(s.get("master_weight"))
        slots.append(s)
    return params, grads, masters, slots


def _l2(opt, n):
    """Coupled L2 coefficients: the weight decay of a rule without a
    decoupled form."""
    return [0.0 if opt._decoupled_wd else opt._wd_coeff()] * n


class SGD(Optimizer):
    """reference: optimizer.py SGD / phi sgd kernel."""

    _slot_names = ()
    _fused_kind = "sgd"

    def _update(self, param, grad, slots, lr):
        return sgd_rule(param.float(), grad, lr).to(param.dtype), slots

    def _fused_update(self, items, lr):
        params, grads, masters, _ = _fused_lists(self, items)
        fused_sgd(params, grads, masters, lr=lr, l2=_l2(self, len(items)))


class Momentum(Optimizer):
    """reference: Momentum (use_nesterov option, momentum_op)."""

    _slot_names = ("velocity",)
    _fused_kind = "momentum"

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, *, use_kernel=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, use_kernel=use_kernel)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update(self, param, grad, slots, lr):
        new_p, v = momentum_rule(param.float(), grad, slots["velocity"], lr,
                                 self._momentum, self._use_nesterov)
        return new_p.to(param.dtype), {"velocity": v}

    def _fused_update(self, items, lr):
        params, grads, masters, slots = _fused_lists(self, items)
        fused_momentum(params, grads, masters,
                       [s["velocity"] for s in slots], lr=lr,
                       momentum=self._momentum, nesterov=self._use_nesterov,
                       l2=_l2(self, len(items)))


class Adam(Optimizer):
    """reference: Adam (adam_op; beta powers as per-parameter slots)."""

    _slot_names = ("moment1", "moment2")
    _fused_kind = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, *, use_kernel=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, use_kernel=use_kernel)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        for name in ("beta1_pow", "beta2_pow"):
            slots[name] = torch.ones((), dtype=torch.float32,
                                     device=p.device)
        return slots

    def _update(self, param, grad, slots, lr):
        new_p, m, v, b1p, b2p = adam_rule(
            param.float(), grad, slots["moment1"], slots["moment2"],
            slots["beta1_pow"], slots["beta2_pow"], lr, self._beta1,
            self._beta2, self._epsilon)
        return new_p.to(param.dtype), {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}

    def _decay_factor(self, name, lr):
        """The factor p is scaled by before the rule: 1 for Adam."""
        return 1.0

    def _fused_update(self, items, lr):
        params, grads, masters, slots = _fused_lists(self, items)
        fused_adam(params, grads, masters, [s["moment1"] for s in slots],
                   [s["moment2"] for s in slots],
                   [s["beta1_pow"] for s in slots],
                   [s["beta2_pow"] for s in slots], lr=lr, beta1=self._beta1,
                   beta2=self._beta2, eps=self._epsilon,
                   decay=[self._decay_factor(n, lr) for n, _, _ in items],
                   l2=_l2(self, len(items)))


class AdamW(Adam):
    """Adam with decoupled weight decay; `apply_decay_param_fun(name)`
    picks the parameters it applies to. `lr_ratio` is taken and ignored,
    as the JAX package's AdamW ignores it (ROADMAP.md, queue 3)."""

    _decoupled_wd = True
    _fused_kind = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 *, use_kernel=True):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, use_kernel=use_kernel)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_factor(self, name, lr):
        """1 - lr * wd in f32, as the compiled step forms it from its f32
        lr; 1 where the decay does not apply."""
        wd = self._wd_coeff()
        fun = self._apply_decay_param_fun
        if not wd or (fun is not None and name is not None and not fun(name)):
            return 1.0
        return float(np.float32(1.0) - np.float32(lr) * np.float32(wd))

    def _update(self, param, grad, slots, lr):
        p32 = param.float()
        decay = self._decay_factor(self._current_param_name, lr)
        if decay != 1.0:
            p32 = p32 * decay
        new_p, new_slots = Adam._update(self, p32, grad, slots, lr)
        return new_p.to(param.dtype), new_slots


class Adamax(Optimizer):
    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["beta1_pow"] = torch.ones((), dtype=torch.float32,
                                        device=p.device)
        return slots

    def _update(self, param, grad, slots, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["moment"] + (1 - b1) * grad
        u = torch.maximum(b2 * slots["inf_norm"], torch.abs(grad) + eps)
        b1p = slots["beta1_pow"] * b1
        # a true division: a Python float over a tensor is the tensor's
        # reciprocal times the float in PyTorch
        step = torch.full_like(b1p, lr) / (1 - b1p)
        new_p = param.float() - step * m / u
        return new_p.to(param.dtype), {
            "moment": m, "inf_norm": u, "beta1_pow": b1p}


class Adagrad(Optimizer):
    _slot_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_slots(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=torch.float32, device=p.device)}

    def _update(self, param, grad, slots, lr):
        m = slots["moment"] + grad * grad
        new_p = param.float() - lr * grad / (torch.sqrt(m) + self._epsilon)
        return new_p.to(param.dtype), {"moment": m}


class Adadelta(Optimizer):
    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, param, grad, slots, lr):
        rho, eps = self._rho, self._epsilon
        ag = rho * slots["avg_squared_grad"] + (1 - rho) * grad * grad
        update = -torch.sqrt((slots["avg_squared_update"] + eps)
                             / (ag + eps)) * grad
        au = rho * slots["avg_squared_update"] + (1 - rho) * update * update
        new_p = param.float() + lr * update
        return new_p.to(param.dtype), {
            "avg_squared_grad": ag, "avg_squared_update": au}


class RMSProp(Optimizer):
    _slot_names = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, param, grad, slots, lr):
        rho, eps = self._rho, self._epsilon
        ms = rho * slots["mean_square"] + (1 - rho) * grad * grad
        if self._centered:
            mg = rho * slots["mean_grad"] + (1 - rho) * grad
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            mg = slots["mean_grad"]
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * slots["momentum_acc"] + lr * grad / denom
        new_p = param.float() - mom
        return new_p.to(param.dtype), {
            "mean_square": ms, "mean_grad": mg, "momentum_acc": mom}


class Lamb(Optimizer):
    """reference: Lamb (lamb_op) — layerwise adaptive large-batch."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        for name in ("beta1_pow", "beta2_pow"):
            slots[name] = torch.ones((), dtype=torch.float32,
                                     device=p.device)
        return slots

    def _update(self, param, grad, slots, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["moment1"] + (1 - b1) * grad
        v = b2 * slots["moment2"] + (1 - b2) * grad * grad
        b1p = slots["beta1_pow"] * b1
        b2p = slots["beta2_pow"] * b2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        p32 = param.float()
        r = mhat / (torch.sqrt(vhat) + eps) + self._lamb_wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = p32 - lr * trust * r
        return new_p.to(param.dtype), {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}


class LarsMomentum(Optimizer):
    """reference: fluid LarsMomentumOptimizer (lars_momentum_op)."""

    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, name=None, epsilon=0):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def _update(self, param, grad, slots, lr):
        p32 = param.float()
        w_norm = torch.linalg.vector_norm(p32)
        g_norm = torch.linalg.vector_norm(grad)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._eps),
            torch.full_like(w_norm, lr))
        v = self._momentum * slots["velocity"] + local_lr * (
            grad + self._lars_wd * p32)
        new_p = p32 - v
        return new_p.to(param.dtype), {"velocity": v}
