"""paddle_tpu_torch.distributed.fleet, the port of
`paddle_tpu/distributed/fleet/__init__.py`: hybrid parallelism over
torch.distributed.

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(ErnieForPretraining(cfg))

`init` reads the degrees from `strategy.hybrid_configs` (a -1 is
inferred from the world size), builds the `CommunicateTopology` and the
`HybridCommunicateGroup`, which sets the mesh of the same layout and
creates its groups: collective, so every rank calls it.
`distributed_model` wraps the model as the JAX package's does
(:67-85): `PipelineParallel` for a `PipelineLayer` under pp > 1 (built
after `init`, the layer is this rank's stage and `train_batch` runs the
pipeline schedule over the pp group, `distributed.pipeline`),
`TensorParallel` under mp > 1, `DataParallel` otherwise; a sharding
degree > 1 raises NotImplementedError (`ShardingParallel` and
`distributed/sharding` are not ported). `distributed_optimizer` returns
a thin wrapper that delegates to the optimizer. The parameter-server
functions raise NotImplementedError (ROADMAP queue 1 item 2).
"""
from __future__ import annotations

from ..env import get_rank, get_world_size
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import PaddleCloudRoleMaker, UserDefinedRoleMaker
from .base.topology import CommunicateTopology, HybridCommunicateGroup
from . import meta_parallel
from .meta_parallel import (ColumnParallelLinear, LayerDesc,
                            ParallelCrossEntropy, PipelineLayer,
                            RowParallelLinear, SharedLayerDesc,
                            VocabParallelEmbedding, get_rng_state_tracker)

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "meta_parallel", "init",
           "is_initialized", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer", "worker_index",
           "worker_num", "is_first_worker", "barrier_worker",
           "VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "PipelineLayer",
           "LayerDesc", "SharedLayerDesc", "get_rng_state_tracker"]

_fleet_state = {
    "initialized": False,
    "strategy": None,
    "hcg": None,
    "role_maker": None,
}

_NO_PS = ("the parameter-server runtime is not ported (ROADMAP queue 1 "
          "item 2)")


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    strategy = strategy or DistributedStrategy()
    role_maker = role_maker or PaddleCloudRoleMaker(
        is_collective=is_collective)
    hc = strategy.hybrid_configs
    dims = [hc.get("dp_degree", -1), hc.get("pp_degree", 1),
            hc.get("sharding_degree", 1), hc.get("mp_degree", 1),
            hc.get("sep_degree", 1)]
    n = get_world_size()
    known = 1
    for d in dims:
        if d != -1:
            known *= d
    dims = [max(n // known, 1) if d == -1 else d for d in dims]
    topo = CommunicateTopology(
        ["data", "pipe", "sharding", "model", "sep"], dims)
    hcg = HybridCommunicateGroup(topo)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg,
                        role_maker=role_maker)


def is_initialized():
    return _fleet_state["initialized"]


def get_hybrid_communicate_group():
    return _fleet_state["hcg"]


def _get_strategy():
    return _fleet_state["strategy"] or DistributedStrategy()


def distributed_model(model):
    """The model wrapped for the fleet's parallel mode."""
    from ..parallel import DataParallel
    from .meta_parallel import PipelineParallel, TensorParallel

    hcg = _fleet_state["hcg"]
    strategy = _get_strategy()
    if hcg is None:
        return DataParallel(model)
    mode = hcg.get_parallel_mode()
    if mode == "pipeline" and isinstance(model, PipelineLayer):
        return PipelineParallel(model, hcg, strategy)
    if mode == "tensor_parallel":
        return TensorParallel(model, hcg, strategy)
    if mode == "sharding_parallel":
        raise NotImplementedError(
            "sharding_degree > 1: ShardingParallel and distributed/"
            "sharding are not ported (ROADMAP queue 1 item 2)")
    return DataParallel(model, group=hcg.get_data_parallel_group())


class _DistributedOptimizer:
    """The optimizer, with the strategy beside it."""

    def __init__(self, optimizer, strategy):
        self._inner = optimizer
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner, name)


def distributed_optimizer(optimizer, strategy=None):
    if strategy is not None:
        _fleet_state["strategy"] = strategy
    return _DistributedOptimizer(optimizer, _get_strategy())


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    from ..collective import barrier

    barrier()


def _ps(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"fleet.{name}: {_NO_PS}")

    fn.__name__ = name
    return fn


is_server = _ps("is_server")
init_server = _ps("init_server")
run_server = _ps("run_server")
init_worker = _ps("init_worker")
stop_worker = _ps("stop_worker")
save_persistables = _ps("save_persistables")
