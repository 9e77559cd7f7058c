"""Fused multi-tensor optimizer updates: the CUDA kernel's wrappers and
their plain PyTorch versions.

Counterpart of `paddle_tpu/incubate/nn/pallas/optim.py`. One kernel
(`csrc/optim.cu`) applies a rule to a whole list of tensors in one
launch:

- `fused_adam`: Adam / AdamW, with per-tensor decoupled weight decay
  (`decay`, the factor 1 - lr*wd) and coupled L2 (`l2`), and per-tensor
  beta powers advanced in place;
- `fused_momentum`: Momentum, or Nesterov with `nesterov=True`;
- `fused_sgd`: SGD.

Each takes parallel lists: `params` (f32 or bf16), `grads` (f32 or
bf16), `masters` (an f32 master weight per parameter, or None) and the
rule's f32 slots. The update base is the master when there is one, else
the parameter itself; a parameter with a master is re-derived from it,
rounded once to its dtype. Everything is updated in place, so the slot
tensors keep their identity.

For CUDA tensors the wrappers launch the kernel (one launch per
`MAX_TENSORS` tensors, counted in `kernels.launches()`); for CPU tensors
they run the `*_reference` versions, which apply the same rule tensor by
tensor in plain PyTorch, in the JAX rule's order of operations
(`adam_rule`, `momentum_rule`, `sgd_rule`, which the optimizers'
per-parameter path shares). On the card the kernel and the plain
version agree bit for bit: the kernel rounds every operation as PyTorch
does and never contracts a multiply and an add into an FMA.

A zero-size tensor is no work for the kernel; Adam keeps it in the
table all the same, so that its beta powers advance as the per-tensor
rule advances them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import check, count, load

__all__ = ["fused_adam", "fused_sgd", "fused_momentum",
           "fused_adam_reference", "fused_sgd_reference",
           "fused_momentum_reference", "adam_rule", "momentum_rule",
           "sgd_rule", "MAX_TENSORS", "CHUNK"]

MAX_TENSORS = 384  # kMaxTensors in csrc/optim.cu: table entries a launch
CHUNK = 8192       # kChunk: elements a CUDA block updates
_SGD, _MOMENTUM, _NESTEROV, _ADAM = 0, 1, 2, 3
_BASE_BF16, _GRAD_BF16, _ALIGNED = 1, 2, 4
_DTYPES = (torch.float32, torch.bfloat16)


class _Entry(ctypes.Structure):
    """One tensor of the kernel's table (`Entry` in csrc/optim.cu)."""
    _fields_ = [("base", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("half", ctypes.c_void_p), ("pow1", ctypes.c_void_p),
                ("pow2", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("decay", ctypes.c_float), ("l2", ctypes.c_float),
                ("flags", ctypes.c_int), ("chunk0", ctypes.c_int)]


class _Scalars(ctypes.Structure):
    """The rule's constants, rounded to f32 (`Scalars`)."""
    _fields_ = [("lr", ctypes.c_float), ("b1", ctypes.c_float),
                ("b2", ctypes.c_float), ("c1", ctypes.c_float),
                ("c2", ctypes.c_float), ("eps", ctypes.c_float),
                ("mu", ctypes.c_float), ("kind", ctypes.c_int)]


# -- the rules (plain PyTorch, f32 tensors) ------------------------------
def adam_rule(p, g, m, v, beta1_pow, beta2_pow, lr, beta1, beta2, eps):
    """One Adam step in the JAX rule's order (optimizer/__init__.py:
    82-93): (new p, m, v, beta1^t, beta2^t). The bias corrections are
    divided by device tensors: on the card PyTorch turns a division by
    a host scalar into a multiplication by its reciprocal."""
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    mhat = m / (1 - b1p)
    vhat = v / (1 - b2p)
    return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v, b1p, b2p


def momentum_rule(p, g, velocity, lr, momentum, nesterov=False):
    """(new p, velocity): v = v*mu + g; p -= lr * (g + mu*v if nesterov
    else v)."""
    v = velocity * momentum + g
    step = g + momentum * v if nesterov else v
    return p - lr * step, v


def sgd_rule(p, g, lr):
    return p - lr * g


# -- plain versions of the kernel ------------------------------------------
def _lists(n, decay, l2):
    decay = [1.0] * n if decay is None else [float(d) for d in decay]
    l2 = [0.0] * n if l2 is None else [float(c) for c in l2]
    if len(decay) != n or len(l2) != n:
        raise ValueError("decay and l2 need one value per tensor")
    return decay, l2


def _base_and_grad(param, grad, master, l2):
    base = master if master is not None else param
    p = base.float()
    g = grad.float()
    if l2:
        g = g + l2 * p                     # coupled L2 (step() order)
    return base, p, g


def _write(param, master, base, new_p):
    base.copy_(new_p)
    if master is not None:
        param.copy_(new_p)                 # rounded once to its dtype


@torch.no_grad()
def fused_adam_reference(params, grads, masters, moment1, moment2,
                         beta1_pows, beta2_pows, *, lr, beta1, beta2, eps,
                         decay=None, l2=None):
    """`fused_adam`'s rule, tensor by tensor, in place."""
    decay, l2 = _lists(len(params), decay, l2)
    for i, param in enumerate(params):
        base, p, g = _base_and_grad(param, grads[i], masters[i], l2[i])
        if decay[i] != 1.0:
            p = p * decay[i]                # decoupled weight decay
        new_p, m, v, b1p, b2p = adam_rule(p, g, moment1[i], moment2[i],
                                          beta1_pows[i], beta2_pows[i], lr,
                                          beta1, beta2, eps)
        moment1[i].copy_(m)
        moment2[i].copy_(v)
        beta1_pows[i].copy_(b1p)
        beta2_pows[i].copy_(b2p)
        _write(param, masters[i], base, new_p)


@torch.no_grad()
def fused_momentum_reference(params, grads, masters, velocity, *, lr,
                             momentum, nesterov=False, l2=None):
    """`fused_momentum`'s rule, tensor by tensor, in place."""
    _, l2 = _lists(len(params), None, l2)
    for i, param in enumerate(params):
        base, p, g = _base_and_grad(param, grads[i], masters[i], l2[i])
        new_p, v = momentum_rule(p, g, velocity[i], lr, momentum, nesterov)
        velocity[i].copy_(v)
        _write(param, masters[i], base, new_p)


@torch.no_grad()
def fused_sgd_reference(params, grads, masters, *, lr, l2=None):
    """`fused_sgd`'s rule, tensor by tensor, in place."""
    _, l2 = _lists(len(params), None, l2)
    for i, param in enumerate(params):
        base, p, g = _base_and_grad(param, grads[i], masters[i], l2[i])
        _write(param, masters[i], base, sgd_rule(p, g, lr))


# -- the kernel ------------------------------------------------------------
def _device(tensors):
    """The one device of the lists: "cpu" takes the plain version, one
    CUDA device the kernel; anything else raises."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) > 1:
        raise ValueError(
            f"fused optimizer: tensors on {sorted(map(str, devs))}")
    dev = devs.pop() if devs else torch.device("cpu")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused optimizers run on CUDA (kernel) or CPU "
                         f"(plain version), got {dev}")
    return dev


def _library():
    lib = load()
    if (lib.ptt_optim_entry_size() != ctypes.sizeof(_Entry)
            or lib.ptt_optim_max_tensors() != MAX_TENSORS
            or lib.ptt_optim_chunk() != CHUNK):
        raise RuntimeError("csrc/optim.cu and kernels/optim.py disagree on "
                           "the table layout")
    return lib


def _entry(param, grad, master, slots, decay, l2):
    """The table entry of one tensor, after the kernel's checks. `slots`
    are (name, tensor) pairs: "m", "v" (f32, the parameter's shape),
    "pow1", "pow2" (one-element f32)."""
    if param.dtype not in _DTYPES or grad.dtype not in _DTYPES:
        raise TypeError(f"fused optimizers take f32 or bf16 parameters and "
                        f"gradients, got {param.dtype} and {grad.dtype}")
    if master is not None and (param.dtype != torch.bfloat16
                               or master.dtype != torch.float32):
        raise TypeError("a master weight is f32 and belongs to a bf16 "
                        "parameter")
    half = param if master is not None else None
    base = master if master is not None else param
    slot = dict(slots)
    full = [("grad", grad), ("master", master), ("m", slot.get("m")),
            ("v", slot.get("v"))]
    for name, t in full:
        if t is not None and t.shape != param.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match the "
                             f"parameter's {tuple(param.shape)}")
    for name, t in slots:
        if t.dtype != torch.float32 or (name.startswith("pow")
                                        and t.numel() != 1):
            raise TypeError(f"{name} must be f32 (beta powers one element), "
                            f"got {t.dtype} {tuple(t.shape)}")
    vec = [t for _, t in full if t is not None] + [param]
    if not all(t.is_contiguous() for t in vec):
        raise ValueError("fused optimizers need contiguous tensors")
    # vector accesses: 4 elements, 16 bytes of f32 or 8 of bf16
    aligned = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in vec)

    def ptr(t):
        return None if t is None else t.data_ptr()

    return _Entry(
        base=base.data_ptr(), grad=grad.data_ptr(), m=ptr(slot.get("m")),
        v=ptr(slot.get("v")), half=ptr(half), pow1=ptr(slot.get("pow1")),
        pow2=ptr(slot.get("pow2")), n=param.numel(), decay=decay, l2=l2,
        flags=((_BASE_BF16 if base.dtype == torch.bfloat16 else 0)
               | (_GRAD_BF16 if grad.dtype == torch.bfloat16 else 0)
               | (_ALIGNED if aligned else 0)),
        chunk0=0)


def _launch(name, dev, scalars, entries):
    """One kernel launch per MAX_TENSORS entries; counts each."""
    if not entries:
        return
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(0, len(entries), MAX_TENSORS):
        group = entries[i:i + MAX_TENSORS]
        table = (_Entry * len(group))(*group)
        rc = lib.ptt_fused_optim(ctypes.byref(scalars), table, len(group),
                                 stream)
        check(rc, name)
        count(name)


def _f32(x):
    return float(np.float32(x))


def fused_adam(params, grads, masters, moment1, moment2, beta1_pows,
               beta2_pows, *, lr, beta1, beta2, eps, decay=None, l2=None):
    """Adam / AdamW over a list of tensors, in place; see the module
    docstring. `decay[i]` is AdamW's factor 1 - lr*wd (1 for no decay),
    `l2[i]` the coupled L2 coefficient (0 for none)."""
    dev = _device([*params, *grads, *masters, *moment1, *moment2,
                   *beta1_pows, *beta2_pows])
    if dev.type == "cpu":
        return fused_adam_reference(
            params, grads, masters, moment1, moment2, beta1_pows, beta2_pows,
            lr=lr, beta1=beta1, beta2=beta2, eps=eps, decay=decay, l2=l2)
    decay, l2 = _lists(len(params), decay, l2)
    entries = [_entry(p, grads[i], masters[i],
                      (("m", moment1[i]), ("v", moment2[i]),
                       ("pow1", beta1_pows[i]), ("pow2", beta2_pows[i])),
                      decay[i], l2[i])
               for i, p in enumerate(params)]
    scalars = _Scalars(lr=lr, b1=beta1, b2=beta2, c1=_f32(1 - beta1),
                       c2=_f32(1 - beta2), eps=eps, mu=0.0, kind=_ADAM)
    _launch("fused_adam", dev, scalars, entries)


def fused_momentum(params, grads, masters, velocity, *, lr, momentum,
                   nesterov=False, l2=None):
    """Momentum (Nesterov with `nesterov=True`) over a list of tensors,
    in place."""
    dev = _device([*params, *grads, *masters, *velocity])
    if dev.type == "cpu":
        return fused_momentum_reference(params, grads, masters, velocity,
                                        lr=lr, momentum=momentum,
                                        nesterov=nesterov, l2=l2)
    _, l2 = _lists(len(params), None, l2)
    entries = [_entry(p, grads[i], masters[i], (("m", velocity[i]),), 1.0,
                      l2[i])
               for i, p in enumerate(params) if p.numel()]
    scalars = _Scalars(lr=lr, mu=momentum,
                       kind=_NESTEROV if nesterov else _MOMENTUM)
    _launch("fused_momentum", dev, scalars, entries)


def fused_sgd(params, grads, masters, *, lr, l2=None):
    """SGD over a list of tensors, in place."""
    dev = _device([*params, *grads, *masters])
    if dev.type == "cpu":
        return fused_sgd_reference(params, grads, masters, lr=lr, l2=l2)
    _, l2 = _lists(len(params), None, l2)
    entries = [_entry(p, grads[i], masters[i], (), 1.0, l2[i])
               for i, p in enumerate(params) if p.numel()]
    _launch("fused_sgd", dev, _Scalars(lr=lr, kind=_SGD), entries)
