"""`PipelineParallel`, the port of
`paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py`.

`train_batch(data, optimizer, lr_scheduler=None, scaler=None)` is one
optimizer step over the batch on the micro-batch accumulation path,
`_train_batch_dygraph` (:108-150), which the JAX package takes whenever
no pp > 1 mesh is live: the batch is cut into `accumulate_steps` equal
micro-batches along dim 0; each runs forward and the loss (its mean
when it is not a scalar), then backward on loss / accumulate_steps (on
the scaler's scaled loss with a `scaler`); then the optimizer step (the
scaler's), `clear_grad` and the scheduler's step. It returns the mean
of the micro-batch losses as an f32 0-d tensor. `eval_batch` runs the
forward without gradients and returns the loss (or the output).

With a live pp > 1 mesh the JAX package compiles its GPipe schedule;
the multi-process schedule is not ported, and `train_batch` raises
NotImplementedError (ROADMAP queue 1 item 2).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ... import mesh as mesh_mod
from .parallel_layers.pp_layers import _NO_PP, PipelineLayer

__all__ = ["PipelineParallel"]


def _scalar_loss(loss):
    """Reduce a per-token loss to the scalar the step optimizes."""
    return loss.mean() if loss.numel() != 1 else loss


class PipelineParallel(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        cfg = (strategy.pipeline_configs if strategy is not None else
               {"accumulate_steps": 1, "micro_batch_size": 1})
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", 1)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _device(self):
        return next(self._layers.parameters()).device

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        mesh = mesh_mod.get_mesh()
        if mesh is not None and mesh.shape.get("pp", 1) > 1:
            raise NotImplementedError(f"PipelineParallel.train_batch: "
                                      f"{_NO_PP}")
        return self._train_batch_dygraph(data, optimizer, lr_scheduler,
                                         scaler)

    def _micro(self, t, n):
        t = torch.as_tensor(t, device=self._device())
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} does not split into "
                             f"{n} micro-batches")
        return torch.split(t, t.shape[0] // n) if n > 1 else [t]

    def _train_batch_dygraph(self, data, optimizer, lr_scheduler=None,
                             scaler=None):
        inputs, labels = data
        n_micro = max(self.accumulate_steps, 1)
        losses = []
        for mi, ml in zip(self._micro(inputs, n_micro),
                          self._micro(labels, n_micro)):
            loss = _scalar_loss(self._layers._loss_fn(self._layers(mi), ml))
            scaled = loss * (1.0 / n_micro)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            losses.append(float(loss.item()))
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.tensor(np.float32(np.mean(losses)))

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        out = self._layers(torch.as_tensor(inputs, device=self._device()))
        if compute_loss:
            return self._layers._loss_fn(out, torch.as_tensor(
                labels, device=out.device))
        return out

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)
