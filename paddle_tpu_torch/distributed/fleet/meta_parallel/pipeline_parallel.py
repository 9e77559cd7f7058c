"""`PipelineParallel`, the port of
`paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py`.

`train_batch(data, optimizer, lr_scheduler=None, scaler=None)` is one
optimizer step over the batch; it returns the mean of the micro-batch
losses as an f32 0-d tensor. Its paths:

- A layer that holds every stage (no pp group was live when it was
  built): the micro-batch accumulation path, `_train_batch_dygraph`
  (:108-150): the batch is cut into `accumulate_steps` equal
  micro-batches along dim 0; each runs forward and the loss (its mean
  when it is not a scalar), then backward on loss / accumulate_steps
  (on the scaler's scaled loss with a `scaler`); then the optimizer
  step (the scaler's), `clear_grad` and the scheduler's step. Under a
  pp > 1 mesh the JAX package compiles its GPipe schedule here instead
  (:69-106); with equal micro-batches that is the same mathematics:
  the mean of the micro-batch means.
- A layer that is one stage of a pipeline over processes (built under
  a live pp group, `PipelineLayer`): `distributed.pipeline`'s schedule
  over the pp group with M = `accumulate_steps` micro-batches, in the
  order `strategy.pipeline_configs["schedule_mode"]` names ("1F1B", the
  default, or "F-then-B"; the JAX class ignores the key and always runs
  GPipe, with the same numbers). The arithmetic is the dygraph path's
  for every case the JAX package sends there (a scaler, one
  micro-batch, `can_pipeline` false) and the same mathematics as its
  compiled step for the rest: each micro-batch's backward starts from
  loss / M (times the scale). Then the gradients of layers two stages
  share are summed over their holders, and with dp > 1, where each dp
  line took its contiguous share of the batch (as
  `DistributedTrainStepCompiler._shard` does) and the parameters were
  broadcast from the dp group's first rank at the first call, the
  gradients are averaged over the dp group. A `GradScaler`'s found-inf
  is agreed over every rank (pp, mp and dp), so every stage skips the
  step together. The optimizer's `grad_clip` sums over the pp group
  (`nn.ClipGradByGlobalNorm`). The loss is the mean over the
  micro-batches and the dp ranks, on every rank.

The JAX class guards against switching path or optimizer once its
step is compiled (:75-91): that step owns the optimizer state. Here the
state is the optimizer's own on every path, so switching loses nothing
and the port does not raise.

`eval_batch` runs the forward without gradients over the whole batch
and returns the loss (or the output); over processes, the chain of
stages, with the result on every rank of the pp group.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ... import collective
from ...pipeline import PipelineSchedule
from .parallel_layers.pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]

# strategy.pipeline_configs["schedule_mode"] -> distributed.pipeline's name
SCHEDULE_MODES = {"1F1B": "1f1b", "F-then-B": "gpipe"}


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
        mode = cfg.get("schedule_mode", "1F1B")
        if mode not in SCHEDULE_MODES:
            raise ValueError(f"schedule_mode {mode!r}: expected one of "
                             f"{sorted(SCHEDULE_MODES)}")
        self.schedule_mode = mode
        self._schedule = None
        self._dp_synced = False

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _device(self):
        return next(self._layers.parameters()).device

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        if self._layers.pipe_group is not None:
            return self._train_batch_pipeline(data, optimizer, lr_scheduler,
                                              scaler)
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

    def _pipeline_schedule(self):
        if self._schedule is None:
            self._schedule = PipelineSchedule(
                self._layers, self._layers.pipe_group,
                lambda y, lab: _scalar_loss(self._layers._loss_fn(y, lab)))
        return self._schedule

    def _dp_group(self):
        mesh = self._layers.pipe_group.mesh
        if mesh.shape.get("dp", 1) < 2:
            return None
        return mesh.group(("dp",))

    def _dp_share(self, t, dp):
        """This dp rank's contiguous share of dim 0."""
        if dp is None or t.dim() == 0:
            return t
        n = t.shape[0]
        if n % dp.nranks:
            raise ValueError(f"PipelineParallel: a batch of {n} does not "
                             f"split over {dp.nranks} dp ranks")
        k = n // dp.nranks
        return t.narrow(0, dp.rank * k, k).contiguous()

    def _train_batch_pipeline(self, data, optimizer, lr_scheduler=None,
                              scaler=None):
        dev = self._device()
        dp = self._dp_group()
        if dp is not None and not self._dp_synced:
            with torch.no_grad():
                for p in self._layers.parameters():
                    collective.broadcast(p.data, dp.ranks[0],
                                         group=dp.process_group)
        self._dp_synced = True
        inputs, labels = (self._dp_share(torch.as_tensor(t, device=dev), dp)
                          for t in data)
        n_micro = max(self.accumulate_steps, 1)
        scaling = scaler is not None and scaler.is_enable()
        loss = self._pipeline_schedule().train(
            inputs, labels, n_micro, SCHEDULE_MODES[self.schedule_mode],
            loss_scale=scaler._scale if scaling else None)
        self._layers.allreduce_shared_weight_gradients()
        if dp is not None:
            div = torch.tensor(float(dp.nranks), device=dev)
            for p in self._layers.parameters():
                if p.grad is not None:
                    collective.all_reduce(p.grad, group=dp.process_group)
                    p.grad = p.grad / div
            collective.all_reduce(loss, group=dp.process_group)
            loss = loss / div
        if scaling:
            scaler.unscale_(optimizer)
            found = torch.tensor(float(scaler._found_inf))
            if dist.get_backend() != "gloo":
                found = found.to(dev)
            collective.all_reduce(found, collective.ReduceOp.MAX)
            scaler._found_inf = bool(found.item())
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss.detach().to("cpu", torch.float32)

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        dev = self._device()
        inputs = torch.as_tensor(inputs, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        if self._layers.pipe_group is not None:
            return self._pipeline_schedule().forward(
                inputs, labels if compute_loss else None,
                loss_fn=self._layers._loss_fn)
        out = self._layers(inputs)
        if compute_loss:
            return self._layers._loss_fn(out, labels)
        return out

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)
