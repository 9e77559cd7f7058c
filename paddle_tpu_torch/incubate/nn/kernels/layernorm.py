"""Fused LayerNorm, forward and backward: the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd Functions that join
them.

Counterpart of `paddle_tpu/incubate/nn/pallas/layernorm.py`. One
forward kernel and one backward kernel (`csrc/layernorm.cu`) cover
both public functions:

- `fused_layer_norm(x, w, b)`: y = [gelu](LayerNorm(x) * w + b) over
  the last dim.
- `fused_residual_layer_norm(x, residual, w, b)`: s = x + residual in
  the input dtype, then y = [gelu](LayerNorm(s) * w + b); returns
  (y, s) — the normalised activation and the next block's residual
  from one pass.

Both are `torch.autograd.Function`s (`FusedLayerNormFn`,
`FusedResidualLayerNormFn`, the JAX package's `custom_vjp`s): the
forward saves s, mean and rstd, the backward is `layer_norm_bwd`. The
residual variant hands the same dx to x and to the residual.

`layer_norm_fwd` returns every output of the forward kernel, (y, s,
mean, rstd), with mean and rstd f32 of shape [rows]; `layer_norm_bwd`
returns (dx, dw, db). For CUDA tensors they launch the kernels; for CPU
tensors they run `layer_norm_fwd_reference` / `layer_norm_bwd_reference`,
the same arithmetic in plain PyTorch. The `*_reference` public
functions go through the plain versions on any device: the comparison
path.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import DTYPE_BF16, DTYPE_F32, check, count, load

__all__ = ["fused_layer_norm", "fused_residual_layer_norm",
           "fused_layer_norm_reference",
           "fused_residual_layer_norm_reference", "layer_norm_fwd",
           "layer_norm_fwd_reference", "layer_norm_bwd",
           "layer_norm_bwd_reference", "FusedLayerNormFn",
           "FusedResidualLayerNormFn", "MAX_HIDDEN"]

MAX_HIDDEN = 4096  # kMaxHidden in csrc/layernorm.cu
_DTYPES = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}
# (library, h, act, dtype code, residual, vec) -> (rows a CTA, CTAs
# resident at once): the forward and backward kernels' persistent grids
_FWD_PLANS = {}
_BWD_PLANS = {}


def _act_code(activation, approximate):
    if activation is None:
        return 0
    if activation == "gelu":
        return 1 if approximate else 2
    raise ValueError(
        f"activation must be None or 'gelu', got {activation!r}")


def layer_norm_fwd_reference(x, residual, weight, bias, eps=1e-5,
                             activation=None, approximate=True):
    """Plain PyTorch (y, s, mean, rstd): the kernel's arithmetic.

    The sum is formed in the input dtype; statistics are f32 with the
    population variance (`jnp.var`'s, `correction=0`); the GeLU is the
    tanh form when `approximate` (jax.nn.gelu's default), else erf."""
    _act_code(activation, approximate)
    s = x if residual is None else x + residual
    sf = s.float()
    mu = sf.mean(dim=-1, keepdim=True)
    var = (sf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (sf - mu) * rstd * weight.float() + bias.float()
    if activation == "gelu":
        y = F.gelu(y, approximate="tanh" if approximate else "none")
    return (y.to(x.dtype), None if residual is None else s,
            mu.reshape(-1), rstd.reshape(-1))


def _check(x, residual, weight, bias):
    h = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_layer_norm takes f32 or bf16, got "
                        f"{x.dtype}")
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"hidden size {h} outside 1..{MAX_HIDDEN}")
    tensors = [x, weight, bias] + ([] if residual is None else [residual])
    for t in tensors:
        if t.device != x.device:
            raise ValueError(
                f"fused_layer_norm: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("fused_layer_norm needs contiguous tensors")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(
            f"residual {tuple(residual.shape)} {residual.dtype} does not "
            f"match x {tuple(x.shape)} {x.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (h,):
            raise ValueError(f"{name} must be f32 of shape ({h},), got "
                             f"{t.dtype} {tuple(t.shape)}")


def layer_norm_fwd(x, residual, weight, bias, eps=1e-5, activation=None,
                   approximate=True):
    """(y, s, mean, rstd) of the fused LayerNorm; s is None without a
    residual. CUDA tensors launch the kernel, CPU tensors take
    `layer_norm_fwd_reference`; any other device raises."""
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, residual, weight, bias, eps,
                                        activation, approximate)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_layer_norm runs on CUDA (kernel) or CPU (plain "
            f"version), got {x.device}")
    act = _act_code(activation, approximate)
    _check(x, residual, weight, bias)
    h = x.shape[-1]
    n = x.numel() // h
    y = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:                     # no rows: nothing to launch
        return y, s, mean, rstd
    lib = load()
    rows = [t for t in (x, residual, y, s) if t is not None]
    vec = _vec(h, x, rows)
    groups, ctas = _fwd_plan(lib, h, act, _DTYPES[x.dtype],
                             residual is not None, vec)
    rc = lib.ptt_layer_norm_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if s is None else s.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, h, min(-(-n // groups), ctas), float(eps), act,
        _DTYPES[x.dtype], vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "fused_layer_norm")
    count("fused_layer_norm")
    return y, s, mean, rstd


def _gelu_grad(x, approximate):
    """d gelu(x) / dx, `_gelu_grad`'s formulas (layernorm.py:67-76)."""
    if approximate:
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (x + 0.044715 * x * x * x))
        du = c * (1.0 + 3.0 * 0.044715 * x * x)
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    return cdf + x * pdf


def layer_norm_bwd_reference(dy, ds, s, weight, bias, mean, rstd,
                             activation=None, approximate=True):
    """Plain PyTorch (dx, dw, db): the backward kernel's arithmetic
    (`_ln_bwd_kernel`, layernorm.py:156-179). dx is in dy's dtype; dw
    and db are f32. With a residual, ds (the cotangent of the sum s)
    joins dx in f32 before the cast."""
    _act_code(activation, approximate)
    h = s.shape[-1]
    rows = s.numel() // h
    mu = mean.reshape(rows, 1)
    rs = rstd.reshape(rows, 1)
    xhat = (s.reshape(rows, h).float() - mu) * rs
    w = weight.float()
    g = dy.reshape(rows, h).float()
    if activation == "gelu":
        g = g * _gelu_grad(xhat * w + bias.float(), approximate)
    dw = (g * xhat).sum(dim=0)
    db = g.sum(dim=0)
    dxhat = g * w
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rs * (dxhat - m1 - xhat * m2)
    if ds is not None:
        dx = dx + ds.reshape(rows, h).float()
    return dx.to(dy.dtype).reshape(dy.shape), dw, db


def layer_norm_bwd(dy, ds, s, weight, bias, mean, rstd, activation=None,
                   approximate=True):
    """(dx, dw, db) of the fused LayerNorm from the forward's s, mean
    and rstd; ds is None without a residual. CUDA tensors launch the
    kernel, CPU tensors take `layer_norm_bwd_reference`; any other
    device raises."""
    if s.device.type == "cpu":
        return layer_norm_bwd_reference(dy, ds, s, weight, bias, mean,
                                        rstd, activation, approximate)
    if s.device.type != "cuda":
        raise ValueError(
            f"fused_layer_norm runs on CUDA (kernel) or CPU (plain "
            f"version), got {s.device}")
    act = _act_code(activation, approximate)
    _check(s, None, weight, bias)
    h = s.shape[-1]
    n = s.numel() // h
    for name, t in (("dy", dy), ("ds", ds)):
        if t is None:
            continue
        if t.shape != s.shape or t.dtype != s.dtype \
                or t.device != s.device or not t.is_contiguous():
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} must be contiguous "
                f"and match s {tuple(s.shape)} {s.dtype}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (n,) \
                or t.device != s.device or not t.is_contiguous():
            raise ValueError(f"{name} must be f32 of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    dx = torch.empty_like(dy)
    if n == 0:                     # no rows: nothing to launch
        zeros = torch.zeros(h, dtype=torch.float32, device=s.device)
        return dx, zeros, zeros.clone()
    lib = load()
    vec = _vec(h, s, [t for t in (dy, ds, s, dx) if t is not None])
    groups, ctas = _bwd_plan(lib, h, act, _DTYPES[s.dtype], ds is not None,
                             vec)
    grid = min(-(-n // groups), ctas)
    part = torch.empty(grid, 2 * h, dtype=torch.float32, device=s.device)
    dwdb = torch.empty(2 * h, dtype=torch.float32, device=s.device)
    rc = lib.ptt_layer_norm_bwd(
        dy.data_ptr(), None if ds is None else ds.data_ptr(), s.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), part.data_ptr(), dwdb.data_ptr(), n,
        h, grid, act, _DTYPES[s.dtype], vec,
        torch.cuda.current_stream(s.device).cuda_stream)
    check(rc, "fused_layer_norm_bwd")
    count("fused_layer_norm_bwd")
    return dx, dwdb[:h], dwdb[h:]


def _vec(h, x, rows):
    """1 for the kernels' 16-byte path: whole vectors in every row
    (h a multiple of 4 f32 or 8 bf16 values) and 16-byte aligned row
    tensors; else 0, one element at a time."""
    return int(h % (16 // x.element_size()) == 0
               and all(t.data_ptr() % 16 == 0 for t in rows))


def _plan(plans, plan_fn, name, lib, h, act, dtype, residual, vec):
    """(rows a CTA works on at once, CTAs resident on the card at once)
    of a kernel's instantiation for these arguments, from `plan_fn`
    once and then from `plans`."""
    key = (id(lib), h, act, dtype, residual, vec)
    if key not in plans:
        groups, ctas = ctypes.c_int(), ctypes.c_int()
        rc = plan_fn(h, act, dtype, int(residual), vec, ctypes.byref(groups),
                     ctypes.byref(ctas))
        check(rc, f"{name} plan")
        plans[key] = (groups.value, ctas.value)
    return plans[key]


def _fwd_plan(lib, h, act, dtype, residual, vec):
    """The forward kernel's (rows a CTA, CTAs at once)."""
    return _plan(_FWD_PLANS, lib.ptt_layer_norm_fwd_plan, "fused_layer_norm",
                 lib, h, act, dtype, residual, vec)


def _bwd_plan(lib, h, act, dtype, residual, vec):
    """The backward kernel's (rows a CTA, CTAs at once)."""
    return _plan(_BWD_PLANS, lib.ptt_layer_norm_bwd_plan,
                 "fused_layer_norm_bwd", lib, h, act, dtype, residual, vec)


def _fwd_bwd(use_kernel):
    if use_kernel:
        return layer_norm_fwd, layer_norm_bwd
    return layer_norm_fwd_reference, layer_norm_bwd_reference


class FusedLayerNormFn(torch.autograd.Function):
    """y = [gelu](LayerNorm(x) * w + b), with the backward kernel as
    its gradient (`use_kernel=False`: the plain versions both ways)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, activation, approximate,
                use_kernel):
        fwd, _ = _fwd_bwd(use_kernel)
        y, _, mean, rstd = fwd(x, None, weight, bias, eps, activation,
                               approximate)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.cfg = (activation, approximate, use_kernel)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        activation, approximate, use_kernel = ctx.cfg
        _, bwd = _fwd_bwd(use_kernel)
        dx, dw, db = bwd(dy.contiguous(), None, x, weight, bias, mean, rstd,
                         activation, approximate)
        return dx, dw, db, None, None, None, None


class FusedResidualLayerNormFn(torch.autograd.Function):
    """(y, s): s = x + residual, y = [gelu](LayerNorm(s) * w + b). Both
    outputs carry cotangents; x and the residual get the same dx
    (layernorm.py:300-310)."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps, activation,
                approximate, use_kernel):
        fwd, _ = _fwd_bwd(use_kernel)
        y, s, mean, rstd = fwd(x, residual, weight, bias, eps, activation,
                               approximate)
        ctx.save_for_backward(s, weight, bias, mean, rstd)
        ctx.cfg = (activation, approximate, use_kernel)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, weight, bias, mean, rstd = ctx.saved_tensors
        activation, approximate, use_kernel = ctx.cfg
        _, bwd = _fwd_bwd(use_kernel)
        dx, dw, db = bwd(dy.contiguous(), ds.contiguous(), s, weight, bias,
                         mean, rstd, activation, approximate)
        return dx, dx, dw, db, None, None, None, None


def fused_layer_norm(x, weight, bias, eps=1e-5, activation=None,
                     approximate=True):
    """y = [gelu](LayerNorm(x) * weight + bias) over the last dim."""
    return FusedLayerNormFn.apply(x, weight, bias, eps, activation,
                                  approximate, True)


def fused_residual_layer_norm(x, residual, weight, bias, eps=1e-5,
                              activation=None, approximate=True):
    """(y, s): s = x + residual; y = [gelu](LayerNorm(s) * w + b)."""
    return FusedResidualLayerNormFn.apply(x, residual, weight, bias, eps,
                                          activation, approximate, True)


def fused_layer_norm_reference(x, weight, bias, eps=1e-5,
                               activation=None, approximate=True):
    return FusedLayerNormFn.apply(x, weight, bias, eps, activation,
                                  approximate, False)


def fused_residual_layer_norm_reference(x, residual, weight, bias,
                                        eps=1e-5, activation=None,
                                        approximate=True):
    return FusedResidualLayerNormFn.apply(x, residual, weight, bias, eps,
                                          activation, approximate, False)
