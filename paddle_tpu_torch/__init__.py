"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu.

A package of its own beside the JAX package `paddle_tpu`, which stays
the reference the port is held against. Module paths mirror the JAX
package's, so each counterpart sits at the same path:

  * the root                            the flat `paddle.*` surface: the
                                        dtypes, `to_tensor`, the
                                        autograd switches (`no_grad`,
                                        `enable_grad`, `set_grad_enabled`,
                                        `is_grad_enabled`, `grad`), `seed`
                                        and the rng state, the default
                                        dtype, and every op of `ops`
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
                                        evaluate, predict, save / load,
                                        summary; the callbacks;
                                        `summary` and `flops` (also at
                                        the package root)
  * `io`                                datasets, samplers (seeded,
                                        fast-forwardable), `DataLoader`
                                        (in process, or forked workers
                                        over shared-memory rings, the
                                        device-feed stage)
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

import sys as _sys

from .core.dtype import (bfloat16, bool_ as bool8, complex64, complex128,
                         float16, float32, float64, int8, int16, int32, int64,
                         uint8)
from .core.engine import (enable_grad, grad, is_grad_enabled, no_grad,
                          set_grad_enabled)
from .core.flags import get_flags, set_flags
from .core.tensor import to_tensor
from .device import resolve_device
from . import ops
from .ops import *  # noqa: F401,F403  (the flat paddle.* op surface)
from .ops import PUBLIC_OPS as _PUBLIC_OPS
from .ops.random import get_rng_state, seed, set_rng_state
from .framework import get_default_dtype, set_default_dtype
from . import nn, optimizer
from .hapi import Model, flops, summary

# `from .ops import *` bound `linalg` to `ops.linalg` (and `math`,
# `random`, ... to their ops modules). The JAX package rebinds
# `paddle.linalg` to its `linalg` package (`paddle_tpu/__init__.py:61-67`);
# the port has no `linalg` package yet, so here `linalg` is `ops.linalg`
# on purpose (ROADMAP queue 1 item 7). Bind it explicitly, so that a
# `linalg` package ported later is not hidden behind the attribute.
linalg = _sys.modules[__name__ + ".ops.linalg"]

__all__ = sorted(set(_PUBLIC_OPS) | {
    "resolve_device", "get_flags", "set_flags", "bfloat16", "bool8",
    "complex64", "complex128", "float16", "float32", "float64", "int8",
    "int16", "int32", "int64", "uint8", "to_tensor", "no_grad",
    "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad", "seed",
    "get_rng_state", "set_rng_state", "set_default_dtype",
    "get_default_dtype", "ops", "linalg", "nn", "optimizer", "Model",
    "summary", "flops"})
