"""paddle_tpu_torch.incubate.nn.functional — the port of
`paddle_tpu/incubate/nn/functional/__init__.py`'s fused LayerNorm
entry points (:35-110) and its SDPA export.

`fused_layer_norm(x, weight, bias, epsilon, activation=None,
approximate=True, residual=None, return_residual_sum=False)` runs the
fused LayerNorm autograd Functions (kernels #4-5,
`kernels.layernorm`): y = [gelu](LayerNorm(x [+ residual]) * w + b),
and with `residual` the sum s too (the next block's residual). The JAX
package takes its Pallas kernel only under `PADDLE_PALLAS_FUSION=1` and
the unfused composition otherwise; the port has no such switch: on the
card it always launches the kernel, as GPT's path does, and on the CPU
the kernel's plain version runs. `use_kernel=False` takes the plain
versions on any device: the comparison path.

With a bf16 x and an f32 residual (block 0's attention epilogue under
O1) the port follows the Pallas kernel (`pallas/layernorm.py:85-110`):
s = x + residual in f32, statistics and y from that unrounded sum, s
and y stored in x's dtype.
"""
from __future__ import annotations

from ....amp import maybe_cast_inputs
from ..attention import scaled_dot_product_attention
from ..kernels import layernorm as _ln

__all__ = ["fused_layer_norm", "fused_layer_norm_gelu",
           "fused_residual_layer_norm", "scaled_dot_product_attention"]


def fused_layer_norm(x, weight, bias, epsilon=1e-5, activation=None,
                     approximate=True, residual=None,
                     return_residual_sum=False, *, use_kernel=True):
    """LayerNorm over the last dim with an optional residual-add
    prologue and GeLU epilogue, one kernel launch a direction on the
    card. With `return_residual_sum`, returns (y, s)."""
    if activation not in (None, "gelu"):
        raise ValueError(f"fused_layer_norm: activation={activation!r} "
                         "(expected None or 'gelu')")
    eps = float(epsilon)
    if residual is not None:
        x, residual, weight, bias = maybe_cast_inputs(
            "fused_residual_layer_norm", (x, residual, weight, bias))
        fn = (_ln.fused_residual_layer_norm if use_kernel
              else _ln.fused_residual_layer_norm_reference)
        y, s = fn(x.contiguous(), residual.contiguous(), weight, bias, eps,
                  activation, bool(approximate))
    else:
        x, weight, bias = maybe_cast_inputs("fused_layer_norm",
                                            (x, weight, bias))
        fn = (_ln.fused_layer_norm if use_kernel
              else _ln.fused_layer_norm_reference)
        y = fn(x.contiguous(), weight, bias, eps, activation,
               bool(approximate))
        s = x
    if return_residual_sum:
        return y, s
    return y


def fused_layer_norm_gelu(x, weight, bias, epsilon=1e-5, approximate=True):
    """y = gelu(LayerNorm(x) * weight + bias) in one kernel a direction."""
    return fused_layer_norm(x, weight, bias, epsilon, activation="gelu",
                            approximate=approximate)


def fused_residual_layer_norm(x, residual, weight, bias, epsilon=1e-5,
                              activation=None, approximate=True):
    """(y, s): s = x + residual, y = [gelu](LayerNorm(s) * w + b)."""
    return fused_layer_norm(x, weight, bias, epsilon, activation=activation,
                            approximate=approximate, residual=residual,
                            return_residual_sum=True)
