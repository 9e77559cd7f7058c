"""paddle_tpu_torch.inference.serving — the serving engine on the card.

  * `kv_cache`      block-allocated paged KV cache: fixed-size blocks
                    in preallocated device pools, per-request block
                    tables, alloc/free + admission control, the draft
                    model's twin pools, copy-on-write prefix sharing
  * `scheduler`     continuous batching: FIFO admit / evict / preempt
                    between decode dispatches
  * `model_runner`  prefill, paged decode, speculative verify and
                    prefix-cache tail prefill forward passes (gpt2),
                    per-request sampling
  * `engine`        `LLMEngine.generate()` / `add_request()` streaming
                    front end; `spec_k` / `draft_layers` (speculative
                    decoding) and `prefix_cache` (prefix caching)

The paged-attention kernels (single-query decode and multi-query
verify) live in `incubate.nn.kernels.paged_attention`.
"""
from __future__ import annotations

from .engine import EngineTimeout, LLMEngine
from .kv_cache import BlockAllocator, NULL_BLOCK, PagedKVCache
from .scheduler import Request, SamplingParams, Scheduler

__all__ = ["LLMEngine", "SamplingParams", "Request", "Scheduler",
           "EngineTimeout", "PagedKVCache", "BlockAllocator",
           "NULL_BLOCK"]
