"""DistributedStrategy, the port of
`paddle_tpu/distributed/fleet/base/distributed_strategy.py`: the closed
schema of the reference's distributed_strategy.proto without protobuf.

Every assignment goes through `__setattr__`, which accepts the known
fields (`_FIELDS`) and the config dicts (`*_configs`, whose keys are
checked against the proto sub-message's), raises NotImplementedError
for a truthy value of a knob the package does not implement
(`_UNSUPPORTED`, with the reason) and AttributeError, with a
did-you-mean, for an unknown name. The field sets are the JAX
package's; the fleet of the port reads `hybrid_configs` and
`pipeline_configs`.
"""
from __future__ import annotations

import difflib

__all__ = ["DistributedStrategy"]

# known knobs: name -> default, the JAX package's set (the subset of
# distributed_strategy.proto it implements); defaults match the
# reference proto's.
_FIELDS = {
    # comm/exec
    "nccl_comm_num": 1,
    "use_hierarchical_allreduce": False,
    "sync_nccl_allreduce": True,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "without_graph_optimization": True,
    "find_unused_parameters": False,
    # feature toggles
    "amp": False,
    "recompute": False,
    "gradient_merge": False,
    "sharding": False,
    "pipeline": False,
    "tensor_parallel": False,
    "lamb": False,
    "lars": False,
    # periodic-averaging data parallelism (LocalSGD)
    "localsgd": False,
    "adaptive_localsgd": False,
    "asp": False,
    "qat": False,
    # parameter-server modes
    "a_sync": False,
    # auto parallel
    "auto": False,
    "semi_auto": False,
    "auto_search": False,
}

# config-dict fields: name -> (default, allowed keys). Key sets mirror
# the proto sub-messages (amp -> AMPConfig etc.) restricted to consumed
# knobs plus accepted-but-documented ones.
_CONFIG_FIELDS = {
    "amp_configs": (
        {"init_loss_scaling": 32768.0, "custom_white_list": [],
         "custom_black_list": [], "use_pure_fp16": False,
         "use_fp16_guard": False, "use_bf16": True},
        {"init_loss_scaling", "incr_every_n_steps",
         "decr_every_n_nan_or_inf", "incr_ratio", "decr_ratio",
         "use_dynamic_loss_scaling", "custom_white_list",
         "custom_black_list", "custom_black_varnames", "use_pure_fp16",
         "use_pure_bf16", "use_fp16_guard", "use_bf16"}),
    "recompute_configs": (
        {"checkpoints": []},
        {"checkpoints", "enable_offload", "checkpoint_shape"}),
    "gradient_merge_configs": (
        {"k_steps": 1, "avg": True},
        {"k_steps", "avg"}),
    "localsgd_configs": (
        {"k_steps": 1, "begin_step": 1},
        {"k_steps", "begin_step"}),
    "adaptive_localsgd_configs": (
        {"init_k_steps": 1, "begin_step": 1},
        {"init_k_steps", "begin_step"}),
    "sharding_configs": (
        {"sharding_degree": 1, "mp_degree": 1, "pp_degree": 1,
         "dp_degree": 1, "stage": 1, "offload": False,
         "segment_broadcast_MB": 32.0},
        {"sharding_degree", "mp_degree", "pp_degree", "dp_degree",
         "stage", "offload", "segment_broadcast_MB",
         "sharding_segment_strategy", "segment_anchors", "hybrid_dp",
         "gradient_merge_acc_step", "optimize_offload",
         "pp_allreduce_in_optimize", "optimize_cast"}),
    "pipeline_configs": (
        {"accumulate_steps": 1, "micro_batch_size": 1,
         "schedule_mode": "1F1B"},
        {"accumulate_steps", "micro_batch_size", "schedule_mode",
         "p2p_cache_shape"}),
    "tensor_parallel_configs": (
        {"tensor_parallel_degree": 1},
        {"tensor_parallel_degree", "tensor_init_seed"}),
    "hybrid_configs": (
        {"dp_degree": -1, "mp_degree": 1, "pp_degree": 1,
         "sharding_degree": 1, "sep_degree": 1},
        {"dp_degree", "mp_degree", "pp_degree", "sharding_degree",
         "sep_degree", "sp_degree", "ep_degree"}),
    "lamb_configs": (
        {}, {"lamb_weight_decay", "exclude_from_weight_decay"}),
    "lars_configs": (
        {}, {"lars_coeff", "lars_weight_decay", "epsilon", "momentum",
             "exclude_from_weight_decay"}),
    # parameter-server async / geo knobs
    "a_sync_configs": (
        {},
        {"k_steps", "max_merge_var_num", "send_queue_size",
         "independent_recv_thread", "min_send_grad_num_before_recv",
         "thread_pool_size", "send_wait_times",
         "runtime_split_send_recv", "launch_barrier",
         "heter_worker_device_guard", "lr_decay_steps", "use_ps_gpu",
         "geo_step"}),
}

# deliberately unimplemented: name -> rationale. A truthy assignment
# raises NotImplementedError at the assignment site (a falsy one is
# allowed, so that code which resets defaults works).
_UNSUPPORTED = {
    "dgc": "DGC's top-k gradient sparsification is not implemented; the "
    "data-parallel step's blockwise-quantized allreduce with error "
    "feedback is (DistributedTrainStepCompiler(comm_compress=...)).",
    "dgc_configs": "DGC is not implemented (see dgc).",
    "fp16_allreduce": "a cast-for-communication pass is not implemented; "
    "for a smaller wire use comm_compress='int8[:ef]'.",
    "heter_ccl_mode": "heterogeneous (CPU + GPU) collectives are not "
    "implemented.",
    "sync_batch_norm": "the strategy-level SyncBatchNorm rewrite is not "
    "implemented.",
    "cudnn_exhaustive_search": "set torch.backends.cudnn.benchmark "
    "directly.",
    "conv_workspace_size_limit": "cuDNN's workspace is PyTorch's to "
    "manage.",
    "cudnn_batchnorm_spatial_persistent": "the BatchNorm layers are "
    "written out in plain ops, not cuDNN's.",
    "elastic": "use paddle_tpu_torch.incubate.checkpoint directly.",
}


class DistributedStrategy:
    __slots__ = ("_values",)

    def __init__(self):
        object.__setattr__(self, "_values", {})
        vals = self._values
        for name, default in _FIELDS.items():
            vals[name] = default
        for name, (default, _) in _CONFIG_FIELDS.items():
            vals[name] = dict(default) if isinstance(default, dict) \
                else default

    # -- closed-schema enforcement ------------------------------------
    def __getattr__(self, name):
        # '_values' itself and dunders must degrade to plain
        # AttributeError: copy/pickle probe them on a half-constructed
        # instance and the closed-schema error would self-recurse
        if name == "_values" or name.startswith("__"):
            raise AttributeError(name)
        try:
            return self._values[name]
        except KeyError:
            pass
        if name in _UNSUPPORTED:
            # reads of unsupported knobs degrade as "off": config dicts
            # read empty (probe code iterates/.get()s them), toggles
            # read False
            return {} if name.endswith("_configs") else False
        raise AttributeError(self._unknown_msg(name))

    def __setattr__(self, name, value):
        if name == "_values":  # copy/pickle state restoration
            object.__setattr__(self, name, value)
            return
        if name in _UNSUPPORTED:
            if value:
                raise NotImplementedError(
                    f"DistributedStrategy.{name}: {_UNSUPPORTED[name]} "
                    f"Set strategy.{name}=False (or drop the "
                    "assignment).")
            return  # falsy: accepted, stays off
        if name in _CONFIG_FIELDS:
            _, allowed = _CONFIG_FIELDS[name]
            if not isinstance(value, dict):
                raise TypeError(
                    f"DistributedStrategy.{name} expects a dict, got "
                    f"{type(value).__name__}")
            unknown = set(value) - allowed
            if unknown:
                raise ValueError(
                    f"DistributedStrategy.{name}: unknown config key(s) "
                    f"{sorted(unknown)}; allowed: {sorted(allowed)}")
            # merge over the CURRENT stored value (reference
            # assign_configs_value semantics: later assignments update
            # only the provided keys, earlier explicit settings stay)
            merged = dict(self._values.get(name,
                                           _CONFIG_FIELDS[name][0]))
            merged.update(value)
            self._values[name] = merged
            return
        if name in _FIELDS:
            self._values[name] = value
            return
        raise AttributeError(self._unknown_msg(name))

    @staticmethod
    def _unknown_msg(name):
        known = list(_FIELDS) + list(_CONFIG_FIELDS) + list(_UNSUPPORTED)
        close = difflib.get_close_matches(name, known, n=1)
        hint = f" Did you mean '{close[0]}'?" if close else ""
        return (f"DistributedStrategy has no field '{name}' — the field "
                f"set is closed (distributed_strategy.proto parity); a "
                f"typo'd or unported knob must not be silently "
                f"swallowed.{hint}")

    def __repr__(self):
        on = [k for k, v in self._values.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
