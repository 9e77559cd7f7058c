"""paddle_tpu_torch.jit — the train step, the port of
`paddle_tpu/jit/__init__.py` `TrainStepCompiler` (:850).

    step = TrainStepCompiler(model, opt)            # model(*batch) is the loss
    step = TrainStepCompiler(model, opt, loss_fn)   # loss_fn(model(*inputs), label)
    loss = step(*batch)                              # updates the model in place

The JAX class traces forward, backward and update into one donated XLA
program. PyTorch runs eagerly, so there is nothing to trace, compile or
donate here: each call clears the gradients, runs the forward loss,
`backward()` and `optimizer.step()` in order, and returns the loss
detached, as f32. The name is kept so that a training script carries
over unchanged.

Queued: `accumulate_steps`, `steps_per_dispatch`, `guard_nonfinite`,
`grad_scaler` and `amp_level="O1"`; asking for one raises
NotImplementedError. O2 is `amp.decorate` on the model, as in the JAX
package.
"""
from __future__ import annotations

import torch

__all__ = ["TrainStepCompiler"]


class TrainStepCompiler:
    def __init__(self, model, optimizer, loss_fn=None, accumulate_steps=1,
                 amp_level=None, steps_per_dispatch=1, guard_nonfinite=False,
                 grad_scaler=None):
        queued = {"accumulate_steps": accumulate_steps != 1,
                  "steps_per_dispatch": steps_per_dispatch != 1,
                  "guard_nonfinite": bool(guard_nonfinite),
                  "grad_scaler": grad_scaler is not None,
                  "amp_level='O1'": amp_level == "O1"}
        asked = [name for name, on in queued.items() if on]
        if asked:
            raise NotImplementedError(
                f"TrainStepCompiler: {', '.join(asked)} not ported yet")
        if amp_level not in (None, "O2"):
            raise ValueError(f"amp_level must be None, 'O1' or 'O2', got "
                             f"{amp_level!r}")
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn

    def _device(self):
        return next(self._model.parameters()).device

    def __call__(self, *batch):
        dev = self._device()
        batch = [torch.as_tensor(b, device=dev) for b in batch]
        self._opt.clear_grad()
        if self._loss_fn is not None:
            loss = self._loss_fn(self._model(*batch[:-1]), batch[-1])
        else:
            loss = self._model(*batch)
        loss = loss.float()
        loss.backward()
        self._opt.step()
        return loss.detach()
