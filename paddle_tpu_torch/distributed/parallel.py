"""`init_parallel_env`, the port of `paddle_tpu/distributed/parallel.py`
(:63): joins this process to the multi-process world the PADDLE_* env
contract describes.

The JAX package maps the contract onto `jax.distributed.initialize`;
here it is `torch.distributed.init_process_group` with the rank and
world size from PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM and the
rendezvous from PADDLE_MASTER (`host:port` means `tcp://host:port`; a
URL such as `file:///path` is used as it is).

The backend: `backend=None` is "nccl" for a CUDA device (the default
device) and "gloo" only when the caller passes `device="cpu"`. gloo on
the card runs only when it is named; nothing switches backend after a
failure. On CUDA each rank takes card `PADDLE_RANK_IN_NODE % count`.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from .env import ParallelEnv

__all__ = ["init_parallel_env"]

# how long a collective waits for a missing peer before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def init_parallel_env(backend=None, device=None):
    """Join the process group of the PADDLE_* env contract (once; a
    single-rank world starts no group) and return a ParallelEnv."""
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
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=nranks, timeout=TIMEOUT)
    return ParallelEnv()
