"""Distributed environment, the port of `paddle_tpu/distributed/env.py`:
the PADDLE_* env contract set by a launcher or by `spawn`
(PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_RANK_IN_NODE,
PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT), else
torch.distributed's own rank and world size once a group is up."""
from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "get_local_rank",
           "get_trainer_endpoints", "get_current_endpoint", "group_size",
           "group_rank", "ParallelEnv"]


def _initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank():
    r = os.environ.get("PADDLE_TRAINER_ID")
    if r is not None:
        return int(r)  # a malformed launcher env fails loudly
    return dist.get_rank() if _initialized() else 0


def get_world_size():
    w = os.environ.get("PADDLE_TRAINERS_NUM")
    if w is not None:
        return int(w)
    return dist.get_world_size() if _initialized() else 1


def group_size(group=None):
    """Ranks in a torch.distributed `group` (the default group when
    None); 1 when no process group is up."""
    return dist.get_world_size(group) if _initialized() else 1


def group_rank(group=None):
    """This process's rank within `group`; 0 when no process group is
    up."""
    return dist.get_rank(group) if _initialized() else 0


def get_local_rank():
    return int(os.environ.get("PADDLE_RANK_IN_NODE", "0"))


def get_trainer_endpoints():
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return eps.split(",") if eps else []


def get_current_endpoint():
    return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")


class ParallelEnv:
    """reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_local_rank()

    @property
    def dev_id(self):
        return get_local_rank()

    @property
    def current_endpoint(self):
        return get_current_endpoint()

    @property
    def trainer_endpoints(self):
        return get_trainer_endpoints()

    @property
    def nranks(self):
        return get_world_size()
