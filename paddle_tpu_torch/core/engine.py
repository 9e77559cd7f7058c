"""The autograd switches: the port of `paddle_tpu/core/engine.py`
`is_grad_enabled`, `set_grad_enabled`, `no_grad`, `enable_grad`
(:62-104) and `grad` (:657).

The JAX package keeps a tape of its own; the port has none, since
torch's autograd is the tape. These are thin wrappers over
`torch.autograd` with Paddle's parameter order: `no_grad` and
`enable_grad` are torch's context managers (`no_grad` is a decorator
too), `set_grad_enabled(mode)` switches at once (and, as torch's, also
serves as a context manager), and `grad` is `torch.autograd.grad`
that raises `ValueError` for an input the outputs do not use unless
`allow_unused`, as the JAX `grad` does, and returns a list.
`retain_graph` defaults to `create_graph`, as there.
"""
from __future__ import annotations

import torch

__all__ = ["is_grad_enabled", "set_grad_enabled", "no_grad", "enable_grad",
           "grad"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    return torch.set_grad_enabled(bool(mode))


class no_grad(torch.no_grad):
    """Context manager and decorator that turns gradient tracking off
    (paddle.no_grad)."""


class enable_grad(torch.enable_grad):
    """Context manager that turns gradient tracking back on."""


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of `outputs` with respect to `inputs`, without touching
    any `.grad` (paddle.grad). `grad_outputs` are the cotangents (None:
    ones). `no_grad_vars` is not ported and must be None."""
    if no_grad_vars is not None:
        raise NotImplementedError("grad: no_grad_vars is not ported")
    if isinstance(outputs, torch.Tensor):
        outputs = [outputs]
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    outputs, inputs = list(outputs), list(inputs)
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    if grad_outputs is not None:
        grad_outputs = list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    got = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                              retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    for idx, g in enumerate(got):
        if g is None and not allow_unused:
            raise ValueError(
                f"The {idx}-th input tensor is not used in computing the "
                "outputs: pass allow_unused=True to get None for unused "
                "inputs (paddle.grad contract).")
    return list(got)
