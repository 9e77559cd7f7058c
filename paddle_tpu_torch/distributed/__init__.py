"""paddle_tpu_torch.distributed — data, tensor and pipeline
parallelism over torch.distributed, the port of the multi-process part
of `paddle_tpu/distributed`:

  * `env`          rank, world size, ParallelEnv from the PADDLE_* env
                   contract
  * `parallel`     `init_parallel_env`: the process group (NCCL on the
                   card, gloo on the CPU or when named); `DataParallel`
  * `mesh`         `build_mesh`, `set_mesh`, `get_mesh`: the ranks laid
                   out over named axes (dp, pp, sharding, mp, sp), and
                   each axis's `Group`
  * `fleet`        `fleet.init` from a strategy's hybrid_configs, the
                   topology and its groups, the tensor-parallel layers,
                   `PipelineLayer`, `distributed_model`
  * `spawn`        `spawn(func, args, nprocs, backend=, device=)`
  * `collective`   `all_reduce` (with `compress=`), `all_gather`,
                   `broadcast`, `barrier`, `send` / `recv` / `isend` /
                   `irecv`, with comm/<op>/* counters
  * `pipeline`     `microbatch`, `unmicrobatch` and the GPipe / 1F1B
                   schedule of one rank's stage over the pp group
  * `compress`     the two-phase quantized allreduce with error
                   feedback and its int8 kernels (csrc/compress.cu)

The train step over it is `jit.distributed.DistributedTrainStepCompiler`
(`mesh=` reduces over the mesh's dp group; a pp axis runs GPT's stages
through the pipeline schedule); `fleet`'s `PipelineParallel` trains a
`PipelineLayer` over the pp group. Not ported (ROADMAP queue 1 item 2):
sharding (`ShardingParallel`, `distributed/sharding`), `DataParallel`'s
buckets and overlap, `new_group`, `scatter` / `alltoall`, the parameter
server.
"""
from __future__ import annotations

from . import compress, pipeline
from .collective import (ReduceOp, all_gather, all_reduce, barrier,
                         broadcast, irecv, isend, recv, send)
from .env import ParallelEnv, get_rank, get_world_size
from .mesh import Mesh, build_mesh, get_mesh, set_mesh
from .parallel import DataParallel, init_parallel_env
from .spawn import ProcessContext, spawn

__all__ = ["compress", "pipeline", "ReduceOp", "all_reduce", "all_gather",
           "broadcast", "barrier", "send", "recv", "isend", "irecv", "ParallelEnv", "get_rank", "get_world_size",
           "init_parallel_env", "spawn", "ProcessContext", "DataParallel",
           "Mesh", "build_mesh", "get_mesh", "set_mesh"]
