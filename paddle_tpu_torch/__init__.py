"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu.

A package of its own beside the JAX package `paddle_tpu`, which stays
the reference the port is held against. Module paths mirror the JAX
package's, so each counterpart sits at the same path:

  * `device`                            `resolve_device`: CUDA by
                                        default, CPU only when asked
  * `core.monitor`                      the `serve/*` stat registry
  * `incubate.nn.kernels`               hand-written Hopper kernels
                                        (CUDA C++ in `csrc/`, built at
                                        first use) with their plain
                                        PyTorch versions and autograd
                                        Functions
  * `text.models.gpt`                   GPT-2 as an `nn.Module`: logits,
                                        causal-LM loss, training
  * `amp`                               `decorate` (O2: bf16 params,
                                        LayerNorm kept f32)
  * `optimizer`                         Adam, AdamW with f32 master
                                        weights (`multi_precision`)
  * `jit`                               `TrainStepCompiler`: forward
                                        loss, backward, update
  * `inference.serving`                 `LLMEngine`: paged KV cache,
                                        continuous batching, prefill +
                                        paged decode
  * `convert`                           weights carried across from the
                                        JAX package's parameter tree

The port imports torch and numpy, never jax and nothing of paddle_tpu.
"""
from __future__ import annotations

from .device import resolve_device

__all__ = ["resolve_device"]
