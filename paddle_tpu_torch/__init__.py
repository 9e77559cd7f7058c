"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu.

A package of its own beside the JAX package `paddle_tpu`, which stays
the reference the port is held against. Module paths mirror the JAX
package's, so each counterpart sits at the same path:

  * `device`                            `resolve_device`: CUDA by
                                        default, CPU only when asked
  * `core.monitor`                      the `serve/*` stat registry
  * `core.flags`                        `get_flags` / `set_flags` (also
                                        at the package root):
                                        `stable_bn_stats`
  * `incubate.nn.kernels`               hand-written Hopper kernels
                                        (CUDA C++ in `csrc/`, built at
                                        first use) with their plain
                                        PyTorch versions and autograd
                                        Functions
  * `text.models.gpt`                   GPT-2 as an `nn.Module`: logits,
                                        causal-LM loss, training
  * `text.models.bert`                  BERT pretraining (MLM + NSP) on
                                        the fused transformer layers
  * `incubate.nn`                       the fused transformer layers,
                                        the fused LayerNorm entry points
                                        and SDPA with its flash routing
  * `amp`                               `auto_cast` (O1: white-listed
                                        ops on bf16 inputs), `decorate`
                                        (O2: bf16 params, LayerNorm kept
                                        f32), `GradScaler`
  * `optimizer`                         SGD, Momentum, Adam, AdamW (one
                                        multi-tensor kernel launch a
                                        step on the card) and the rules
                                        without a kernel; f32 master
                                        weights; `optimizer.lr`, the LR
                                        schedulers; the averaging
                                        wrappers (EMA, LookAhead,
                                        ModelAverage)
  * `nn`, `ops`                         `Linear`, `Embedding`, `Dropout`,
                                        `LayerNorm`, `Tanh`, `ReLU`,
                                        `Flatten`, `LayerList`,
                                        `Sequential`, `Conv1D/2D/3D`, the
                                        pooling layers, the BatchNorm
                                        family, `CrossEntropyLoss`, the
                                        functional ops they run on
                                        (convolution and pooling on
                                        PyTorch's, BatchNorm written out),
                                        the initializers, the gradient
                                        clips
  * `vision.models`                     LeNet and the ResNet family
  * `jit`                               `TrainStepCompiler`: forward
                                        loss, backward, update; gradient
                                        merge, the non-finite guard,
                                        loss scaling, K steps a call
  * `jit.distributed`                   `DistributedTrainStepCompiler`:
                                        data parallel, the gradients
                                        reduced across ranks, optionally
                                        through the quantized allreduce
  * `distributed`                       `init_parallel_env`, `spawn`,
                                        the collectives over
                                        torch.distributed, and
                                        `distributed.compress`: the
                                        two-phase quantized allreduce
                                        with error feedback and its int8
                                        kernels
  * `inference.serving`                 `LLMEngine`: paged KV cache,
                                        continuous batching, prefill +
                                        paged decode
  * `hapi`                              `Model`: prepare, fit (gradient
                                        merge, K steps a call, the
                                        non-finite guard, elastic resume),
                                        evaluate, predict, save / load;
                                        the callbacks
  * `io`                                datasets, samplers (seeded,
                                        fast-forwardable), `DataLoader`
  * `metric`                            Accuracy, Precision, Recall, Auc
  * `framework`                         `save` / `load` (atomic; bf16 bit
                                        for bit; reads the JAX
                                        package's f32 and integer files)
  * `incubate.checkpoint`               `CheckpointManager` (async
                                        training-state snapshots,
                                        rotation, torn-snapshot fallback,
                                        preemption), `auto_checkpoint`
  * `convert`                           weights carried across from the
                                        JAX package's parameter tree

The port imports torch and numpy, never jax and nothing of paddle_tpu.
"""
from __future__ import annotations

from .core.flags import get_flags, set_flags
from .device import resolve_device

__all__ = ["resolve_device", "get_flags", "set_flags"]
