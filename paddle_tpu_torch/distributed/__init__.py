"""paddle_tpu_torch.distributed — data parallelism over
torch.distributed, the port of the multi-process part of
`paddle_tpu/distributed`:

  * `env`          rank, world size, ParallelEnv from the PADDLE_* env
                   contract
  * `parallel`     `init_parallel_env`: the process group (NCCL on the
                   card, gloo on the CPU or when named)
  * `spawn`        `spawn(func, args, nprocs, backend=, device=)`
  * `collective`   `all_reduce` (with `compress=`), `all_gather`,
                   `broadcast`, `barrier`, with comm/<op>/* counters
  * `compress`     the two-phase quantized allreduce with error
                   feedback and its int8 kernels (csrc/compress.cu)

The train step over it is `jit.distributed.DistributedTrainStepCompiler`.
Meshes, fleet, `DataParallel`, sharding and pipelines are not ported.
"""
from __future__ import annotations

from . import compress
from .collective import ReduceOp, all_gather, all_reduce, barrier, broadcast
from .env import ParallelEnv, get_rank, get_world_size
from .parallel import init_parallel_env
from .spawn import ProcessContext, spawn

__all__ = ["compress", "ReduceOp", "all_reduce", "all_gather", "broadcast",
           "barrier", "ParallelEnv", "get_rank", "get_world_size",
           "init_parallel_env", "spawn", "ProcessContext"]
