"""paddle_tpu_torch.inference.serving — the serving engine on the card.

  * `kv_cache`      block-allocated paged KV cache: fixed-size blocks
                    in preallocated device pools, per-request block
                    tables, alloc/free/defrag + admission control, the
                    draft model's twin pools, copy-on-write prefix
                    sharing, the `PADDLE_SERVE_*` pool knobs
  * `scheduler`     continuous batching: FIFO admit / priority-aware
                    evict / preempt between decode dispatches, and the
                    SLO ring (deadlines, queue bound and load shedding,
                    the drain gate, static batching)
  * `model_runner`  prefill, paged decode, speculative verify and
                    prefix-cache tail prefill forward passes (gpt2),
                    per-request sampling
  * `engine`        `LLMEngine.generate()` / `add_request()` streaming
                    front end; `spec_k` / `draft_layers` (speculative
                    decoding), `prefix_cache`; the lifecycle (drain,
                    export / import, fencing, incident export, traces)
  * `router`        `Router`: N threaded replicas, least-loaded routing,
                    heartbeat health, token-exact failover
  * `autoscaler`    `Autoscaler`: replicas up and down on the alert
                    engine's transitions

The paged-attention kernels (single-query decode and multi-query
verify) live in `incubate.nn.kernels.paged_attention`.
"""
from __future__ import annotations

from .engine import EngineTimeout, LLMEngine
from .kv_cache import (BlockAllocator, NULL_BLOCK, PagedKVCache,
                       env_block_size, env_max_batch, env_pool_bytes)
from .autoscaler import Autoscaler, maybe_autoscale
from .router import Router, env_heartbeat_s, env_replicas
from .scheduler import (EngineOverloaded, Request, SamplingParams,
                        Scheduler, env_deadline_s, env_max_queue)

__all__ = ["LLMEngine", "SamplingParams", "Request", "Scheduler",
           "Router", "EngineOverloaded", "EngineTimeout",
           "PagedKVCache", "BlockAllocator", "NULL_BLOCK",
           "env_block_size", "env_max_batch", "env_pool_bytes",
           "env_max_queue", "env_deadline_s", "env_replicas",
           "env_heartbeat_s", "Autoscaler", "maybe_autoscale"]
