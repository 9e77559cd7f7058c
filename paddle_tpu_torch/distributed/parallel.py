"""`init_parallel_env` and `DataParallel`, the port of
`paddle_tpu/distributed/parallel.py` (:63, :81).

`init_parallel_env` joins this process to the multi-process world the
PADDLE_* env contract describes.

The JAX package maps the contract onto `jax.distributed.initialize`;
here it is `torch.distributed.init_process_group` with the rank and
world size from PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM and the
rendezvous from PADDLE_MASTER (`host:port` means `tcp://host:port`; a
URL such as `file:///path` is used as it is).

The backend: `backend=None` is "nccl" for a CUDA device (the default
device) and "gloo" only when the caller passes `device="cpu"`. gloo on
the card runs only when it is named; nothing switches backend after a
failure. On CUDA each rank takes card `PADDLE_RANK_IN_NODE % count`.

`DataParallel(layers, group=None)` wraps a model for data parallelism.
Under the JAX package's single controller it is a pass-through that
tags every parameter replicated (`dist_spec` None), and GSPMD reduces
the gradients inside the compiled step. Here, with one rank it is that
pass-through. With more (the world, or the ranks of `group`: a
`distributed.mesh.Group` or a `torch.distributed` group) it broadcasts
every parameter and floating buffer from the group's first rank at
construction, and at the end of each backward all-reduces every
gradient over the group and divides it by the rank count (the mean),
each in its own dtype, one collective a parameter, in the order of
`parameters()`. `no_sync()` leaves the gradients local, to be summed
into by the next backward and reduced then. Bucketing and overlap with
the backward are not ported (ROADMAP queue 1 item 2).
"""
from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist
import torch.nn as nn

from ..device import resolve_device
from . import collective
from .env import ParallelEnv, group_size

__all__ = ["init_parallel_env", "DataParallel"]

# how long a collective waits for a missing peer before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def init_parallel_env(*, backend=None, device=None):
    """Join the process group of the PADDLE_* env contract (once; a
    single-rank world starts no group) and return a ParallelEnv. Arms
    the flight watchdog / excepthook first (on by default for
    distributed runs; PADDLE_FLIGHT_AUTOARM gates), and the rendezvous
    runs inside a `bootstrap` flight span, so a missing peer is a hang
    the watchdog sees (JAX :55-71)."""
    from ..monitor import flight as _flight

    _flight.maybe_auto_arm("init_parallel_env")
    nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if nranks <= 1 or dist.is_initialized():
        return ParallelEnv()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    master = os.environ.get("PADDLE_MASTER") or (
        os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")[0])
    if not master:
        raise RuntimeError(
            "a multi-process run needs PADDLE_MASTER or "
            "PADDLE_TRAINER_ENDPOINTS to locate the rendezvous (set by "
            "paddle_tpu_torch.distributed.spawn)")
    url = master if "://" in master else f"tcp://{master}"
    if dev.type == "cuda":
        local = int(os.environ.get("PADDLE_RANK_IN_NODE", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    with _flight.in_flight("bootstrap", "init_process_group", url=url,
                           nranks=nranks):
        dist.init_process_group(backend, init_method=url, rank=rank,
                                world_size=nranks, timeout=TIMEOUT)
    return ParallelEnv()


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        self._group = getattr(group, "process_group", group)
        self._nranks = group_size(self._group)
        self._sync = True
        self._queued = False
        self._params = [p for p in layers.parameters() if p.requires_grad]
        for p in layers.parameters():
            p.dist_spec = None  # replicated
        if self._nranks > 1:
            src = (0 if self._group is None
                   else dist.get_global_rank(self._group, 0))
            with torch.no_grad():
                for t in list(layers.parameters()) + [
                        b for b in layers.buffers() if b.is_floating_point()]:
                    collective.broadcast(t.data, src, group=self._group)
            for p in self._params:
                p.register_post_accumulate_grad_hook(self._on_grad)

    def _on_grad(self, param):
        # the first gradient of a backward queues the reduction for its end
        if self._sync and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._reduce)

    def _reduce(self):
        self._queued = False
        with torch.no_grad():
            for p in self._params:
                if p.grad is None:
                    continue
                collective.all_reduce(p.grad, group=self._group)
                p.grad.copy_(p.grad / torch.tensor(float(self._nranks),
                                                   device=p.grad.device))

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward passes inside keep their gradients local."""
        old, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = old

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass
