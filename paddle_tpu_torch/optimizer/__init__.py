"""paddle_tpu_torch.optimizer — the port of `paddle_tpu/optimizer`
(Adam and AdamW).

The update rules are the JAX package's, in its order of operations
(optimizer/__init__.py:82-122): m, then v, then the beta powers, then
mhat = m / (1 - b1p), vhat = v / (1 - b2p) and p - lr * mhat /
(sqrt(vhat) + eps); AdamW first scales p by (1 - lr * wd). This is not
`torch.optim.AdamW`, whose bias correction rounds differently. The
multi-tensor fused kernels of the JAX package (`PADDLE_PALLAS_FUSION`)
are queued; the rule here is the reference configuration's plain
update.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]


class Adam(Optimizer):
    """Adam with the beta powers as per-parameter slots (adam_op)."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
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
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * slots["moment1"] + (1 - b1) * grad
        v = b2 * slots["moment2"] + (1 - b2) * grad * grad
        b1p = slots["beta1_pow"] * b1
        b2p = slots["beta2_pow"] * b2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        new_p = param.float() - lr * mhat / (torch.sqrt(vhat) + eps)
        return new_p.to(param.dtype), {
            "moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Adam with decoupled weight decay; `apply_decay_param_fun(name)`
    picks the parameters it applies to."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, param, grad, slots, lr):
        wd = self._wd_coeff()
        apply_decay = True
        if (self._apply_decay_param_fun is not None
                and self._current_param_name is not None):
            apply_decay = self._apply_decay_param_fun(
                self._current_param_name)
        p32 = param.float()
        if wd and apply_decay:
            # 1 - lr * wd in f32, as the compiled step forms it from its
            # f32 lr
            p32 = p32 * float(np.float32(1.0)
                              - np.float32(lr) * np.float32(wd))
        new_p, new_slots = Adam._update(self, p32, grad, slots, lr)
        return new_p.to(param.dtype), new_slots
