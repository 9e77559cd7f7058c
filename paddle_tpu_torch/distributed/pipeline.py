"""The pipeline schedule over processes, the port of
`paddle_tpu/distributed/pipeline.py`: `microbatch` (:40),
`unmicrobatch` (:49), and the GPipe and 1F1B schedules (`gpipe_loop`
:71, `_one_f_one_b` :125).

The JAX package is one controller: `gpipe_loop` vectorises every stage
over the "pp" mesh axis inside one compiled step, XLA turns the stage
shifts into collective-permutes, and autodiff (or the 1F1B custom-vjp)
runs the backward pipeline. Here each rank of the pp group is a process
that holds only its own stage, as in Paddle's dygraph pipeline
(`forward_backward_pipeline`, reference
`fleet/meta_parallel/pipeline_parallel.py:80-150`): a stage receives
each micro-batch's activation from the stage before it, sends its
output to the stage after it, and in the backward receives the
gradient of that output and sends back the gradient of its input
(`collective.isend` / `recv`, counted under comm/send and comm/recv).

    sched = PipelineSchedule(stage_fn, group=pp_group, loss_fn=loss_fn)
    loss = sched.train(inputs, labels, num_micro=4, schedule="1f1b")

`train` runs forward and backward of every micro-batch; the parameter
gradients are left in `.grad`, summed over the micro-batches, of the
mean of the micro-batch losses. The last stage computes each loss,
`loss_fn(y, labels_i)`, and starts its backward from loss_i / M (times
`loss_scale` when given); the mean loss, over the micro-batches in
f32, reaches every rank of the group as a 0-d f32 tensor. Two orders:

- "gpipe" (Paddle's "F-then-B"): every forward, then every backward;
  a stage holds all M micro-batches' activations at the peak.
- "1f1b" (Paddle's "1F1B"): stage s of S runs S - s - 1 warm-up
  forwards, then alternates one forward and one backward, then cools
  down; it holds at most S - s micro-batches' activations (the JAX
  package's vectorised form stashes a ring of 2S).

Both run the backwards in micro-batch order, so each gradient is summed
in the same order and the two give the same gradients bit for bit.
Sends are posted without waiting (`isend`) and receives block, so
neighbouring stages never wait on each other in a cycle; the sends are
waited for at the end of `train`.

The receiver of an activation learns its shape and dtype once, from a
small header the sender posts before the first micro-batch of a call
whose inputs' shape the pair has not seen (Paddle's `p2p_cache_shape`):
the stage's output shape must follow from its inputs' shape. Every rank
passes the whole batch; only the first stage reads the inputs and only
the last the labels.

With no group (or a group of one) every stage is local: `stage_fn` is
the whole chain and the same schedule runs in one process, which is
how JAX's `gpipe_loop` runs without a pp mesh.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import collective

__all__ = ["SCHEDULES", "microbatch", "unmicrobatch", "schedule_order",
           "PipelineSchedule"]

SCHEDULES = ("gpipe", "1f1b")

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool)
_MAX_DIMS = 8


def microbatch(x, num_micro):
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} not divisible by {num_micro} "
                         "micro-batches")
    return x.reshape((num_micro, b // num_micro) + tuple(x.shape[1:]))


def unmicrobatch(x):
    """[M, mb, ...] -> [M * mb, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def schedule_order(schedule, num_stages, stage, num_micro):
    """Stage `stage`'s order of work over `num_micro` micro-batches: a
    list of ("F", i) and ("B", i)."""
    M = num_micro
    if schedule == "gpipe":
        return [("F", i) for i in range(M)] + [("B", i) for i in range(M)]
    if schedule == "1f1b":
        warm = min(num_stages - stage - 1, M)
        order = [("F", i) for i in range(warm)]
        for i in range(M - warm):
            order += [("F", warm + i), ("B", i)]
        return order + [("B", i) for i in range(M - warm, M)]
    raise ValueError(f"unknown pipeline schedule {schedule!r}; expected "
                     f"one of {SCHEDULES}")


def _input_grad(x):
    """The gradient a stage sends back for its input `x`."""
    return x.grad if x.grad is not None else torch.zeros_like(x)


def _header(t):
    """An int64 header of `t`'s dtype and shape."""
    h = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
    h[0] = _DTYPES.index(t.dtype)
    h[1] = t.dim()
    h[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    return h


def _from_header(h):
    n = int(h[1])
    return tuple(int(d) for d in h[2:2 + n]), _DTYPES[int(h[0])]


class PipelineSchedule:
    """This rank's stage of a pipeline over `group` (a mesh `Group` of
    the pp axis; None: every stage local).

    `stage_fn(x) -> y` runs this rank's layers on one micro-batch;
    `loss_fn(y, labels) -> 0-d loss` runs on the last stage.
    `max_stash` is the most micro-batches whose activations this stage
    held at once in the last `train` call."""

    def __init__(self, stage_fn, group=None, loss_fn=None):
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        multi = group is not None and group.nranks > 1
        self.group = group if multi else None
        self.num_stages = group.nranks if multi else 1
        self.stage = group.rank if multi else 0
        self._pg = group.process_group if multi else None
        self._sent = set()     # input-shape keys whose header went out
        self._metas = {}       # input-shape key -> (shape, dtype) received
        self.max_stash = 0

    @property
    def is_first(self):
        return self.stage == 0

    @property
    def is_last(self):
        return self.stage == self.num_stages - 1

    def _peer(self, offset):
        return self.group.ranks[self.stage + offset]

    def _send(self, t, offset, pending):
        pending.append(collective.isend(t, self._peer(offset),
                                        group=self._pg))

    def _recv(self, shape, dtype, device, offset):
        buf = torch.empty(shape, dtype=dtype, device=device)
        return collective.recv(buf, self._peer(offset), group=self._pg)

    def _host(self, dev):
        """Where a header crosses the group: the host under gloo, the
        card under NCCL."""
        return (torch.device("cpu") if dist.get_backend(self._pg) == "gloo"
                else dev)

    def _recv_activation(self, key, device):
        """The activation of the next micro-batch from the stage
        before, with its header first when `key` is new to the pair."""
        if key not in self._metas:
            h = self._recv((2 + _MAX_DIMS,), torch.int64,
                           self._host(device), -1)
            self._metas[key] = _from_header(h.cpu())
        shape, dtype = self._metas[key]
        x = self._recv(shape, dtype, device, -1)
        return x.requires_grad_(x.is_floating_point())

    def _send_activation(self, y, key, pending):
        if key not in self._sent:
            self._sent.add(key)
            self._send(_header(y).to(self._host(y.device)), 1, pending)
        self._send(y.detach(), 1, pending)

    def train(self, inputs, labels, num_micro, schedule="1f1b",
              loss_scale=None):
        """Forward and backward of `num_micro` micro-batches of
        (`inputs`, `labels`) in `schedule`'s order; returns the mean
        micro-batch loss, a 0-d f32 tensor on `inputs`' device, on
        every rank of the group."""
        M = int(num_micro)
        order = schedule_order(schedule, self.num_stages, self.stage, M)
        xs, ls = microbatch(inputs, M), microbatch(labels, M)
        dev = inputs.device
        key = ("train", tuple(inputs.shape), M)
        stash, losses, pending = {}, [], []
        self.max_stash = 0
        for kind, i in order:
            if kind == "F":
                x = xs[i] if self.is_first else self._recv_activation(
                    key, dev)
                y = self.stage_fn(x)
                if self.is_last:
                    y = self.loss_fn(y, ls[i]).float()
                    losses.append(y.detach())
                else:
                    self._send_activation(y, key, pending)
                stash[i] = (x, y)
                self.max_stash = max(self.max_stash, len(stash))
                continue
            x, y = stash.pop(i)
            if self.is_last:
                seed = y * (1.0 / M)
                if loss_scale is not None:
                    seed = seed * float(loss_scale)
                if seed.requires_grad:
                    seed.backward()
            else:
                g = self._recv(y.shape, y.dtype, y.device, 1)
                if y.requires_grad:
                    torch.autograd.backward(y, g)
            if not self.is_first:
                self._send(_input_grad(x), -1, pending)
            del x, y
        for task in pending:
            task.wait()
        loss = None
        if self.is_last:
            vals = torch.stack(losses).cpu().tolist()
            loss = torch.tensor(np.float32(np.mean(vals)), device=dev)
        return self._from_last(loss, dev, ((), torch.float32))

    @torch.no_grad()
    def forward(self, inputs, labels=None, loss_fn=None):
        """The chain's forward over the whole batch, without gradients:
        with `labels`, `loss_fn(y, labels)` (default: the schedule's
        `loss_fn`), else the output; on every rank of the group."""
        dev = inputs.device
        key = ("forward", tuple(inputs.shape))
        pending = []
        x = inputs if self.is_first else self._recv_activation(key, dev)
        y = self.stage_fn(x)
        if self.is_last:
            if labels is not None:
                y = (loss_fn or self.loss_fn)(y, labels)
        else:
            self._send_activation(y, key, pending)
            y = None
        for task in pending:
            task.wait()
        return self._from_last(y, dev)

    def _from_last(self, t, dev, meta=None):
        """The last stage's tensor `t` on every rank of the group; its
        (shape, dtype) `meta`, when not given, broadcast first."""
        if self.group is None:
            return t
        src = self.group.ranks[-1]
        hdev = self._host(dev)
        if meta is None:
            h = (_header(t) if self.is_last
                 else torch.empty(2 + _MAX_DIMS, dtype=torch.int64))
            h = collective.broadcast(h.to(hdev), src, group=self._pg)
            meta = _from_header(h.cpu())
        shape, dtype = meta
        buf = (t.detach().to(hdev).contiguous() if self.is_last
               else torch.empty(shape, dtype=dtype, device=hdev))
        collective.broadcast(buf, src, group=self._pg)
        return buf.to(dev)
