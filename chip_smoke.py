#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py
    python3 chip_smoke.py --measure [--kernels] [--tree DIR]
    python3 chip_smoke.py --bert-grads
    python3 chip_smoke.py --fit-worker      (phase 19's runs start it)

Needs one CUDA card and `nvcc`; exits non-zero, printing no result,
without them. `--measure` runs phases 1-2 and then only the times the
paged-attention, LayerNorm-forward and flash kernels (f32 at ERNIE's
shape, bf16 at BERT's) are judged by
and the decode-step, speculative-round and training-step profiles
(`measure`;
`--kernels`: the kernel times alone), with `paddle_tpu_torch` imported
from DIR when given: a comparison of
two source trees runs it on each in turns in one call.
`--bert-grads`
runs phases 1-2 and then `bert_grads_rows`: where BERT-base's bf16
gradient rows disagree, kernel path, plain path and f32, on two seeds,
with other labels, the decoder untied and after training. Phases, each
printing one line (or a few):

  1. device   card name and power limit (nvidia-smi), torch's name
  2. build    the port's CUDA kernels compiled from paddle_tpu_torch/csrc;
              registers, spills and stack frames of the flash, the
              LayerNorm forward and backward and the paged-attention
              kernels' instantiations
  3. paged    paged-attention decode (the kernel's one-slot launch) vs
              its plain version on the card:
              ragged lengths, f32 and bf16 pools, head_dim 64 and 128,
              the dead-block poison check, and times
  4. ln       fused LayerNorm kernel vs its plain version: rows 8 and
              384, hidden 1024, with and without residual, no / tanh /
              erf GeLU, f32 and bf16; y, s, mean and rstd; and times
  5. serve    GPT-2 345M (random weights from seed 0, f32) through
              LLMEngine with bench_serving's 8-prompt traffic, 64 greedy
              tokens each; launch counters prove the kernels ran
  6. logits   one decode step's logits and written K/V, kernel path vs
              plain path, on the same prefilled pools; then where one
              decode step's time goes (wall vs device busy, top kernels)
  7. flash    flash-attention forward, dq and dk/dv kernels vs their
              plain versions: the training shape (B 4, H 16, S 1024,
              D 64, bf16, causal), f32, ragged S, D 128, non-causal;
              every f32 case also against a float64 oracle (gate 1,
              FLASH_F32_ORACLE_TOL; as in phases 18 and 22); times
              against the bound, SDPA forward and SDPA backward
  8. lnbwd    LayerNorm forward, then backward kernel vs its plain
              version at the training shape (4096 x 1024), f32 and bf16,
              with and without residual, no / tanh / erf GeLU, and a
              second backward call bit-identical; forward and backward
              times with and without the residual
  9. train    GPT-2 345M training at full width, bench_gpt2's on-chip
              config (bf16 O2, AdamW with f32 master weights, B 4 x S
              1024, random weights from seed 0) through
              TrainStepCompiler: loss decreases, launch counters per
              step, step ms, tokens/s, MFU, peak memory, where a step's
              time goes (the flash kernels' and the LayerNorm forward's
              and backward's ms within it)
 10. grads    one step's loss and every gradient, kernel path vs plain
              path from the same state: full width in bf16, and 2
              layers at full width in f32
 11. optim    the three multi-tensor optimizer kernels (fused_adam,
              fused_momentum, fused_sgd) vs the per-parameter rule on the
              GPT-2 345M O2 parameter set (16 tensors, grads from numpy
              seeds), bit for bit after 3 steps: AdamW with the decay
              filter, Adam with coupled L2, SGD, Momentum, Nesterov, an
              f32 model without masters, a zero-size tensor, a parameter
              without a grad, set_state_dict mid-run; times against the
              bound, the plain version and torch.optim's fused step
 12. recipe   GPT-2 345M at full width and depth, bf16 O2, trained with
              a pretraining recipe: AdamW under a warm-up + cosine
              schedule, a global-norm clip, the decay filter, gradient
              merge over 2 microsteps and the non-finite guard, 16 calls
              (8 optimizer steps): the loss falls, every call's lr is
              the schedule's, launches exact per call; then Nesterov
              Momentum and SGD train the model at full width and 4
              layers: the loss falls, one launch a step
 13. multi    multi-query paged-attention kernel (speculative verify) vs
              its plain version: B 8, T 1/2/4/8, H 16 D 64 and H 8 D 128,
              f32 and bf16, phase 3's ragged contexts plus contexts
              whose deepest slot ends at the table's last real column,
              tables with the NULL column appended; the per-slot NaN
              poison check (NaN past slot s's context leaves slot s
              bit-identical); slot t vs the decode wrapper, the same
              kernel's one-slot launch, at context + t; times
 14. spec     GPT-2 345M f32 through LLMEngine(spec_k=4) on phase 5's
              traffic, with the default 12-layer draft and with a draft
              equal to the target: tokens equal phase 5's k=1 tokens (a
              divergence passes only at a shown near-tie), one verify
              dispatch's logits equal sequential decodes', launch counts
              exact, no leaks; acceptance, tokens/s, ITL, where a round's
              time goes
 15. prefix   8 requests sharing a 256-token prefix with phase 5's
              prompts as tails, prefix_cache=True: tokens equal the
              cache-off engine's, hits 7 / 112 blocks shared / 1792
              tokens saved, prefill ms with and without, and each hit's
              tail-only prefill profiled against its whole-context
              prefill (wall vs device busy); then spec_k=4 +
              prefix caching on a pool that forces evictions: tokens
              equal k=1, zero leaks, no block left used
 16. compress blockwise int8 quantize / dequantize kernels vs their plain
              versions, bit for bit (codes, scales, outputs): blocks 128,
              256 and 1024, 1 to 4096 blocks, an all-zero block (scale 1,
              output 0), exact k + 0.5 multiples of the scale (half to
              even), +-absmax (code +-127), subnormals, a block whose
              scale rounds to 0, NaN (scale 1, code 0) and +-Inf (scale
              inf) blocks; times at GPT-2 345M's packed gradient
              (354,871,296 f32, block 1024) against the bound, and
              dequantize against torch.mul(codes, scales), the one
              library call that computes it (bit-identical)
 17. dp       data-parallel training over torch.distributed: first
              whether NCCL takes two ranks on one card (it refuses:
              "Duplicate GPU detected"), then 2 ranks spawned with gloo,
              named explicitly (gloo stages CUDA tensors through the
              host), each GPT-2 345M at full width and depth (bf16 O2,
              AdamW multi_precision, seed 0), global batch B 4 x S 1024,
              through DistributedTrainStepCompiler under comm_compress
              "int8:ef" and its "fp32" twin, 4 steps each: the loss
              falls, every int8:ef loss within 2% of the twin's, the
              ranks' parameters bit-identical, wire bytes <= 0.3 x the
              twin's, exactly 2 quantize and 4 dequantize launches a
              step a rank; step ms, tokens/s, the allreduce's share of
              the step (host clock), peak memory a rank; one more
              int8:ef step profiled on rank 0 (the int8 kernels'
              device ms within the step); then
              all_reduce(compress="int8") on 1M elements a rank, bit for
              bit against the same call on CPU copies (the plain path)
 18. bert     BERT-base pretraining, bench_bert's on-chip recipe (bf16
              O2, dropout 0, AdamW(1e-4, wd 0.01, multi_precision), B 32
              x S 512, the ids as MLM labels, token types 0, no mask,
              random weights from seed 0): the flash kernels vs their
              plain versions at B 32, H 12, S 512, D 64, bf16,
              non-causal, per row (and f32 at B 2, with gate 1); the
              LayerNorm kernels at 16384 x 768 bf16 with no, a bf16 and an f32
              residual (O1's first epilogue), eps 1e-12 and 1e-5, f32
              and bf16 weight and bias, forward, backward and the
              autograd Function; each kernel's time against its bound,
              its plain version and the library call (SDPA non-causal,
              F.layer_norm); then training through TrainStepCompiler,
              3 warm-up steps and 3 windows of 4: the loss falls, exact
              launches a step (LayerNorm forward and backward 25 each,
              the three flash kernels 12 each, fused_adam once for the
              206 parameters), step ms, tokens/s, MFU, peak
              memory, a torch.profiler split of a step (flash,
              LayerNorm, optimizer, GEMMs, elementwise, idle); one
              step's loss and every gradient kernel path vs plain path
              (phase 10's tolerances, full width bf16 12 layers with the
              row scale floored at BERT_GRADS_FLOOR x the tensor's, at
              the initial weights, and f32 2 layers); and an O1 run (f32 parameters, amp_level="O1")
              whose loss falls with every flash launch on bf16 q/k/v
 19. fit      BERT-base through hapi.Model.fit, phase 18's recipe over a
              DataLoader of 192 rows of ids from RandomState(0) shuffled
              by BatchSampler(seed=11), batches of 32, 2 epochs (12
              steps), AdamW under a 4-step warm-up to 1e-4 and a cosine
              decay, training-state snapshots every 4 steps (async, the
              newest 2 kept). Four runs, each a subprocess of this script
              (`--fit-worker`) with its own PADDLE_CKPT_DIR under a
              temporary directory: A and A' uninterrupted, equal bit for
              bit (losses as float.hex, the final parameters and optimizer
              slots by sha256, the step count, the learning rate); B
              SIGKILLed (its process group) once step 8's manifest is on
              disk; C, B's relaunch, resumes from step 8 two batches into
              the second epoch, and B + C equal A bit for bit, overlap
              included; every step of A, A' and C launches kernels #1-6 in
              phase 18's counts. Then, in this process: Model.fit's step
              against the bare TrainStepCompiler step (hapi's host cost),
              the fit with a snapshot every 10 steps against without
              (bench.py's ckpt_overhead_pct), the capture and writer ms
              and the snapshot's bytes, C's restore ms,
              ExponentialMovingAverage.update() ms over the 206 parameters
              with an apply() / restore() round trip bit for bit, and a
              framework.save / load round trip of the bf16 state dict
              bit for bit
 20. lenet    fused_adam vs the per-parameter rule on LeNet's 10 f32
              tensors, bit for bit after each of 3 steps, and its time
              against the bound, the plain version and
              torch.optim.Adam(fused=True); then
              LeNet, bench_mnist's recipe (f32, Adam(1e-3),
              CrossEntropyLoss, B 1024 x 1x28x28 from RandomState(0),
              labels 0-9) through TrainStepCompiler, then the same with
              steps_per_dispatch=8: the loss falls, exactly one fused_adam
              launch a step and no other kernel of the port; step ms
              (median of 3 windows of synchronised steps), imgs/s, MFU
              (bench's 3 x 0.00042 GFLOP an image), peak memory, and
              K=8's imgs/s over the plain step's
 21. resnet   ResNet-50 (1000 classes, NCHW), bench_resnet50's on-chip
              recipe, not cut: amp.decorate O2 bf16, Momentum(0.01, 0.9,
              multi_precision), B 128 x 3x224x224 bf16 from
              RandomState(0), labels 0-999: the O2 split (55 bf16
              tensors with masters, 106 f32 without); fused_momentum vs
              the per-parameter rule on that set, bit for bit after each
              of 3 steps, and its time against the bound, the plain
              version and torch.optim.SGD(momentum=0.9, fused=True);
              then the step timed with and without cudnn.benchmark and a
              channels_last input (the faster kept and named, the global
              setting restored), 5 warm-up steps, 3 windows of 20: the
              loss falls, exactly one fused_momentum launch a step and no
              other kernel of the port, every running statistic finite
              and moved; step ms, imgs/s, MFU (bench's 3 x 4.09 GFLOP an
              image), peak memory, and a profiled step split into
              convolutions, BatchNorm, other elementwise work, the
              optimizer and idle
 22. ernie    ERNIE (BASELINE config 5), bench_ernie's on-chip recipe,
              not cut: vocab 18000, hidden 768, 12 layers, 12 heads, ffn
              3072, S 512, dropout 0, weights from seed 0, amp.decorate
              O2 bf16 (whose residual stream is f32, as in the JAX
              package: the LayerNorm scales stay f32 and promote it),
              AdamW(1e-4, weight_decay 0.01, multi_precision),
              DistributedTrainStepCompiler on the mesh {"dp": 1, "pp":
              1, "mp": -1}, ids and labels (12, 512) int64 from
              RandomState(0): the flash kernels vs plain at B 12, H 12,
              S 512, D 64, non-causal, f32 (the path; and gate 1) and
              bf16 per row;
              the LayerNorm kernels at 6144 x 768 (phase 8's check);
              their times against bound, plain and library; fused_adam
              bit for bit on ERNIE's 152-tensor O2 set after each of 3
              steps and its time; then 3 warm-up steps and 3 windows of
              5: the loss falls, exact launches a step (LayerNorm
              forward and backward 24 each, each flash kernel 12,
              fused_adam 1), step ms, tokens/s, MFU (6 N tokens), peak
              memory, a torch.profiler split (the head's products,
              other GEMMs, flash, LayerNorm, optimizer, elementwise,
              idle)
 23. ernie_mp ERNIE at mp 2: 2 ranks spawned with gloo on the one card,
              each fleet.init with hybrid_configs {"dp_degree": 1,
              "mp_degree": 2, "pp_degree": 1}, phase 22's model (full
              width and depth, bf16 O2, seed 0) and batch, 4 steps
              through DistributedTrainStepCompiler(mesh=): every loss
              within 0.01% of phase 22's first 4 from the same weights,
              the ranks' losses equal, the replicated parameters
              bit-identical across the ranks (sha256), the f32 master
              weights gathered after step 1 against phase 22's (each
              element within 2 lr, no tensor with more than 0.1% of its
              elements off by > lr / 2), exact launches a rank and every
              flash launch on the rank's 6 heads; then a planted fault
              (rank 1 skips its shards' step-1 update, 2 steps) that
              must fail both the loss and the share gate; step ms, the
              collectives' host-clock share, peak memory a rank
 24. ernie_pp ERNIE and GPT at pp 2 over gloo ranks on the one card.
     gpt_pp   First GPT-2 345M (bf16 O2, AdamW, B 4 x S 1024) at pp 1
              for 3 steps in this process, the reference. Then 2 ranks
              spawned once, each fleet.init with hybrid_configs
              {"dp_degree": 1, "mp_degree": 1, "pp_degree": 2}: phase
              22's model (full width and depth, seed 0, bf16 O2; each
              rank builds it whole and keeps its stage: the embedding
              and 6 blocks, or 6 blocks and the head) and batch through
              fleet.distributed_model's PipelineParallel.train_batch,
              accumulate_steps 4 (micro-batches of 3), 4 steps under
              "F-then-B" and again from the same weights under "1F1B":
              each within phase 23's gates (losses 0.01%, the gathered
              f32 weights after step 1 within 2 lr, no tensor with more
              than 0.1% off by > lr / 2) against phase 22 and against a
              pp 1 run of the same micro-batches in this process (the
              share against phase 22 leaves out the elements where that
              pp 1 run lies off phase 22's by > lr / 2: gradients whose
              sign the micro-batch sums flip), each bit-identical to
              that pp 1 run (losses, f32 weights after step 1), the two
              modes bit for bit (losses, weights and masters by sha256),
              exact launches a stage (its blocks x 4 for the LayerNorm
              and flash kernels, 1 fused_adam), 1F1B's stage-0 peak
              memory below F-then-B's; two planted faults, 2 steps each,
              that must fail a gate (stage 1 sends back zeros for its
              input gradient; every stage skips the last micro-batch's
              backward); GPT-2 345M with pp_num_stages 2 and 4
              micro-batches through DistributedTrainStepCompiler(mesh=
              {"pp": 2}), gpipe and 1f1b, 3 steps each: each loss within
              0.1% of the pp 1 run, the loss falls, gpipe = 1f1b bit for
              bit, the tied wte bit-identical on both stages after every
              step, exact launches. Then 4 ranks at mp 2 x pp 2, 1F1B,
              the same gates. Step ms (host clock; the stages share the
              card, so no bubble or overlap shows), comm/send, recv,
              all_reduce calls, bytes and host-clock share, parameters
              and peak memory a rank
 25. router   (runs after phase 15, on phase 5's model) GPT-2 345M f32
              served by a Router of replicas on the one card, phase 5's
              traffic, 512 blocks a replica (equal and explicit: the auto
              size would shrink with each engine built), each run's
              tokens against phase 5's under phase 14's near-tie gate,
              every request finished and no leaked block on any replica:
              (a) 2 replicas, exact launches summed over them (24 paged
              a decode dispatch, 49 LayerNorm a prefill or decode);
              (b) a worker raising after 3 decode dispatches (the
              phase's own wrapper): serve/failovers +1, the survivor
              serves 2 more prompts; (c) a replica asleep 3 s inside a
              dispatch, heartbeat 1 s: failed over, its late wake-up
              emits nothing; (d) a drain mid-flood, the exports
              re-imported after resume(); (e) a ttft_p99 rule (gt 1 us)
              fired through alerts.evaluate_once(): the Autoscaler spawns
              replica 2, 3 replicas serve, then retire_replica() of the
              newest mid-flood; (f) a planted fault, `_replay` dropping
              one export, that must fail (b)'s gate. Tokens/s with 1, 2
              and 3 replicas (host clock), TTFT and ITL p50 / p99 from
              the histograms beside the sorted-list ones, decode
              dispatches a replica, crash-to-replay ms
 26. transformer  the public tensor API and nn.Transformer: (a) every
              row of the CPU parity test's op table (tests/
              torch_op_cases.py: 381 calls of 290 ops, the JAX op tests'
              inputs) on the card against the port's own CPU result,
              integers, bools, indices, sorts and unique bit for bit,
              f32 elementwise within 1e-6, transcendentals and
              reductions 1e-5, linear algebra 1e-4, the decompositions
              by reconstruction, seeded draws and the rng state; (b)
              Transformer-base (nn.Transformer() at its defaults:
              d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout
              0.1, post-norm) with a 37,000-token shared embedding built
              from the public API; kernel #6 on its parameter set
              (`optim_at_shape`: AdamW, bit for bit against the
              per-parameter rule, its time beside the bound and
              AdamW(fused=True)); then f32 (TF32 off), AdamW, the causal
              tgt_mask, one seeded batch of B 96 x S 256 a side, 20
              steps: the loss falls, one fused_adam launch a step and no
              other kernel (dropout is live in every attention call);
              step ms, tokens/s, MFU against the f32 peak, peak memory;
              (c) in eval, the batch encoded without a mask (#1 f32 at
              sq = sk = 256, 6 launches), 32 greedy tokens through
              gen_cache (12 launches a token: self-attention sq = 1 over
              the growing cache, cross-attention sq = 1 against sk =
              256) and by full recompute (6 cross-attention launches a
              token, counted apart); every flash call held row by row
              against the dense route on the same inputs; the cached
              tokens equal full recompute's under phase 6's near-tie
              gate; #1 f32's kernel, plain, SDPA and bound ms at the
              encoder's and the decode's shapes
 27. monitor  the monitor planes on the card: (a) phase 19's BERT-base
              fit (12 steps, default callbacks) with PADDLE_MONITOR_SERVE
              =0, a jsonl exporter and the watchdog armed, a thread
              scraping /metrics /statusz /memz /perfz /flightz during
              it: step/count +12, mem/peak_bytes = max_memory_allocated,
              /metrics = prometheus_text() (the timestamp line aside),
              the exporter's last line = the registry; StepTimer's step
              ms beside the fit's clock, the dispatch histogram's p50
              and its 6 N tokens MFU beside phase 18's (the train step
              records no cost, so perf_report has no entry for it); (b)
              phase 9's and phase 18's steps with PADDLE_PERF_DISPATCH
              on and off (printed, not gated), and no chaos/*,
              sanitize/* or analysis/* counter exists; (c) a Router of
              2 replicas over phase 5's model, its incident export on
              (the default), under
              PADDLE_CHAOS=serve_decode:stall:secs=5:after=10:times=1,
              watchdog 2 s, heartbeat 10 s (longer than the stall, so
              only the incident export can fail over): one watchdog
              bundle naming the stalled replica's thread and the
              serve_decode span, that replica's emergency export alone,
              one failover for "incident_export", no orphaned export,
              phase 5's tokens, the stall triggered once; then phase
              14's k=4 engine
              (draft = target) under serve_spec_verify:corrupt: no
              proposal accepted, phase 5's tokens, 24 multi-query
              launches a round; (d) a 6-step fit snapshotting every 4
              steps under ckpt_write:torn:after=1:times=1: the epoch-end
              snapshot is torn, restore falls back to step 4 bit for
              bit, the ring holds chaos_inject and ckpt_error; (e) a
              BERT-base step at a batch whose activations need twice
              the free memory inside auto_oom_observer: exactly one
              torch.OutOfMemoryError, one "oom" bundle with the
              allocator's stats and the census (its bytes <= allocated
              at the fault), allocated back within 64 MiB; then 3 of
              phase 9's steps under PADDLE_SANITIZE=numerics:sample=1:
              each probed absmax equals a recomputation on the card and
              the losses equal the disarmed run's, bit for bit
 28. pipeline (runs right after phase 21, before any background thread
              of phase 27 exists to be forked) bench_resnet50_pipeline's
              on-chip config, not cut: phase 21's ResNet-50 recipe fed by
              DataLoader(num_workers=-1, persistent_workers=True,
              prefetch_to_device=2) over forked workers and 128 MiB
              shared-memory ring slots (FLAGS_dataloader_shm_slot_mb),
              bench's synthetic ImageNet (3x224x224 f32, one
              preallocated image), cast to bf16 on the card in phase
              21's kept cuDNN and layout setting. Every rate is read in
              steady state, after workers x 2 + 5 batches (each ring
              slot used once): (a) the rings' rate of slot views
              (MultiprocessLoader.run_epoch, one element touched) and
              (b) of user-owned batches (a CPU DataLoader), 40 batches
              each; (c) end to end, phase 21's 3 windows of 20 steps:
              imgs/s and MFU beside phase 21's, exactly one
              fused_momentum launch a step, the loss falls, io/h2d_us a
              batch and io/device_prefetch/stalls of the windows, host
              CPUs, workers and /dev/shm; (d) the same loader with the
              loop only taking batches (the feed's rate and io/h2d_us
              with the GIL to the feeder thread); the device's idle
              share of a profiled window of 5 steps; then the gates:
              six batches of a dataset whose
              image i is base + i x 1e-3, trained from a fresh seed-0
              model through the loader (5 workers, so worker 0 is fed
              two of the six) and in process (num_workers=0, no
              prefetch), cuDNN deterministic: every loss and every
              weight and buffer after the last step bit for bit; again
              under io_fetch:crash:after=200:times=1, armed in each
              worker as PADDLE_CHAOS would arm it (worker 0 dies in its
              second batch; the trainer arms nothing): exactly one
              io_worker_restart, the same bits; no thread fallback
              (its RuntimeWarning fails the phase) and every io_fetch
              event of the worker pipelines carries transport="shm"

Then one JSON line with every kernel's launches (the optimizer kernels'
from phase 12, the other training kernels' from phase 9, the multi-query
kernel's from phase 14, the compress kernels' from rank 0 of phase 17's
int8:ef run, the other serving kernels' from phase 5), error and times,
the nvidia-smi line, and as the LAST line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

fp32 matrix products run in full f32: TF32 is switched off for matmul
and cuDNN, so the kernel-vs-plain comparisons see only the kernels'
own rounding. bf16 matrix products keep PyTorch's default
(`allow_bf16_reduced_precision_reduction`, printed in phase 10); in the
kernel-vs-plain training comparisons the large products are the same
`torch.matmul` calls on both sides.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense); the bound is stated against them
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

# bench_gpt2's on-chip training config (bench.py:540-545)
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_WINDOWS = 3, 10, 3

# bench_serving's on-chip traffic (bench.py:741-747)
SERVE_LENS = (16, 64, 192, 384, 17, 96, 256, 33)
SERVE_NEW_TOKENS = 64
SERVE_MAX_BATCH = 8


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters=100, flush=None):
    """(device ms, host ms) of one fn() call, means over `iters` calls
    after warm-up.

    Device time: a CUDA event pair around every call, with the card
    first held by a spin kernel (torch.cuda._sleep) long enough for the
    host to enqueue every call, so the events bracket the calls' device
    work back to back and not the Python wrappers' host time. An
    enqueue that outlasts half the hold is retried with a hold four
    times longer (at most 5 s) and half the calls: the host may have
    been slow, or the launch queue may have filled behind the hold (a
    plain version's dozens of launches a call, a kernel's 30 KB
    parameter), which blocks the host until the hold ends. With `flush`
    (a tensor larger than the 50 MB L2), the L2 is overwritten before
    every call, as a caller reading cold memory would find it. Host
    time: the enqueue loop's wall time per call. For a function of a
    few launches: a long chain of launches fills the launch queue
    behind the hold (`profile_ms` covers those)."""
    def enqueue(n):
        pairs = []
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        return pairs

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue(iters)
    torch.cuda.synchronize()
    hold_s = min(5.0, 2.0 * (time.perf_counter() - t0))
    n = iters
    for _ in range(8):
        # _sleep counts SM cycles; at <= 2 GHz this holds >= hold_s
        torch.cuda._sleep(int(hold_s * 2e9))
        t0 = time.perf_counter()
        pairs = enqueue(n)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s < 0.5 * hold_s:
            break
        tried = f"{host_s:.3f} s to enqueue {n} calls behind {hold_s:.3f} s"
        hold_s, n = min(5.0, 4 * hold_s), max(1, n // 2)
    else:
        caller = sys._getframe(1)
        raise RuntimeError(
            f"time_ms ({caller.f_code.co_name}, line {caller.f_lineno}): "
            f"the host could not stay ahead of the card ({tried})")
    dev_ms = sum(s.elapsed_time(e) for s, e in pairs) / n
    return dev_ms, host_s * 1e3 / n


def chain_ms(fn, iters=20):
    """(device ms, host ms) of one fn() call for a function of
    milliseconds of device work: a CUDA event pair around `iters` calls
    back to back after warm-up, and the host's wall time to enqueue
    them. Where the host enqueues a call faster than the card runs it,
    the events bracket device work alone; the host ms says whether it
    did."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters, host_ms


def profile_ms(fn, reps=3, n_top=5, record_shapes=False):
    """Where one call of a long launch chain spends its time: (wall ms
    per call, synchronised, without the profiler; device-busy ms per
    call, the sum of its kernels' device durations under
    torch.profiler; kernels per call; the top `n_top` kernels as (name,
    count per call, ms per call); {kernel name: ms per call} of every
    kernel). Device numbers are None when the profiler saw no device
    activity. With `record_shapes` the profiler records operator input
    shapes and is returned as a sixth item."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    extra = (prof,) if record_shapes else ()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by.get(e.name, (0, 0.0))
            by[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by:
        return (wall, None, None, [], {}) + extra
    busy = sum(us for _, us in by.values()) / reps / 1e3
    count = sum(n for n, _ in by.values()) / reps
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n_top]

    def short(name):
        name = name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        return name if len(name) <= 72 else f"{name[:34]}..{name[-36:]}"

    return (wall, busy, count, [(short(name), n / reps, us / reps / 1e3)
                                for name, (n, us) in top], {
        name: us / reps / 1e3 for name, (_, us) in by.items()}) + extra


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def quantile_ms(v, frac):
    """The `frac` quantile of seconds `v` in ms: sorted(v) at rank
    min(n - 1, int(n * frac))."""
    v = sorted(v)
    return v[min(len(v) - 1, int(len(v) * frac))] * 1e3


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def assert_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(
            f"{name}: max |err| {float(err.max()):.3e} over tolerance "
            f"(atol {atol}, rtol {rtol})")
    return float(err.max())


def assert_close_rows(name, got, want, row_tol, floor=1e-3):
    """Each row (the last axis) within row_tol x that row's max|want|:
    a row whose values are small next to the tensor's largest (a late
    causal row of o or dq, a late key of dk or dv, a rarely-used
    embedding row) is held at its own scale. The row scale is floored
    at `floor` x the tensor's max|want|, since a row that is rounding
    noise around zero has no scale of its own (dq of the first causal
    row: p = 1, and dp - delta cancels). Returns (max |err|, worst row
    ratio max|err| / row scale)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(dim=-1)
    row = w.abs().amax(dim=-1)
    row = row.clamp_min(max(floor * float(row.max()), 1e-30))
    ratio = float((err / row).max())
    if not ratio <= row_tol:
        raise AssertionError(
            f"{name}: row max|err| / row max|ref| {ratio:.3e} over "
            f"tolerance {row_tol}")
    return float(err.max()), ratio


# -- phase 1 -----------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("device", f"nvidia-smi: {smi} | torch: {name} | count "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return smi, name


# -- phase 2 -----------------------------------------------------------
def phase_build():
    from paddle_tpu_torch.incubate.nn import kernels

    kernels.load()
    info = kernels.build_info()
    lines = info["log"].splitlines()
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
            if "Used " in ln and " registers" in ln]
    spills, fn = [], ""
    for ln in lines:               # "Function properties for <kernel>"
        if "Function properties for " in ln:
            fn = ln.split("Function properties for ")[1].strip()
        elif "spill stores" in ln and not ln.strip().startswith("0 "):
            spills.append(f"{fn[:60]}: {ln.strip()}")
    log("build", f"{info['seconds']:.1f} s -> {info['path']}; "
        f"{len(regs)} kernel instantiations, registers "
        f"{min(regs, default=0)}..{max(regs, default=0)}; non-zero spills:"
        f" {spills or 'none'}")
    log("build", "flash kernels, registers (at launch; in the bf16 "
        "kernels setmaxnreg moves the producer warpgroup to 40, consumers "
        "to 232) and spills: " + "; ".join(
            f"{k}: {r} registers, {s}" for k, (r, s) in
            flash_registers(info["log"]).items()))
    for kind in ("fwd", "bwd"):
        ln = ln_registers(info["log"], kind)
        log("build", f"LayerNorm {'forward' if kind == 'fwd' else 'backward'}"
            f", {len(ln)} instantiations, registers (spill bytes stored, "
            "stack frame bytes): " + ", ".join(
                f"{k} {r} ({s}, {f})" for k, (r, s, f) in ln.items()))
    pg = paged_registers(info["log"])
    log("build", f"paged attention, {len(pg)} instantiations, registers "
        "(spill bytes stored, stack frame bytes): " + ", ".join(
            f"{k} {r} ({s}, {f})" for k, (r, s, f) in pg.items()))
    return info


def _entry_registers(log_text, pattern, name):
    """{name(match): (registers, spill bytes stored, stack frame bytes)}
    of the kernels whose mangled names match `pattern`, from nvcc's
    `-Xptxas=-v` output."""
    out, fn, spill, frame = {}, None, 0, 0
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill, frame = m.group(1), 0, 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      ln)
        if fn and m:
            frame, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            k = re.search(pattern, fn)
            if k:
                out[name(k)] = (int(m.group(1)), spill, frame)
            fn = None
    return dict(sorted(out.items()))


def ln_registers(log_text, kind="bwd"):
    """{"<dtype> res<0|1> act<n> vw<n> kv<n>": (registers, spill bytes
    stored, stack frame bytes)} of the LayerNorm forward (`kind` "fwd")
    or backward kernel's instantiations."""
    return _entry_registers(
        log_text, rf"ln_{kind}_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d)"
        r"ELi(\d+)ELi(\d+)E",
        lambda k: f"{'f32' if k.group(1) == 'f' else 'bf16'} res{k.group(2)}"
        f" act{k.group(3)} vw{k.group(4)} kv{k.group(5)}")


def paged_registers(log_text):
    """{"<dtype> D<n> T<n>": (registers, spill bytes stored, stack frame
    bytes)} of the paged-attention kernel's instantiations."""
    return _entry_registers(
        log_text, r"paged_multi_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E",
        lambda k: f"{'f32' if k.group(1) == 'f' else 'bf16'} D{k.group(2)} "
        f"T{k.group(3)}")


def flash_registers(log_text):
    """{"fa_fwd_wgmma<64, causal>": (registers, "N bytes spill stores, N
    bytes spill loads")} of the flash kernels (bf16 `_wgmma`, `_f32`),
    from nvcc's `-Xptxas=-v` output."""
    out, fn, spill = {}, None, ""
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = m.group(1), ""
            continue
        if fn and "spill stores" in ln:
            spill = ln.strip().split(", ", 1)[1]
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            k = re.search(r"(fa_(?:fwd|bwd_dq|bwd_dkv)_(?:wgmma|f32))"
                          r"ILi(\d+)ELb([01])E", fn)
            if k:
                name = (f"{k.group(1)}<{k.group(2)}, "
                        f"{'causal' if k.group(3) == '1' else 'full'}>")
                out[name] = (int(m.group(1)), spill)
            fn = None
    return dict(sorted(out.items()))


# -- phase 3 -----------------------------------------------------------
def _paged_inputs(rng, lens, h, d, bs, maxb, dtype, dev, null_slots=()):
    b = len(lens)
    n = b * maxb + 1
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n, bs, h, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n, bs, h, d).astype(np.float32))
    # distinct blocks per sequence; block 0 (NULL) never handed out
    tables = rng.permutation(np.arange(1, n))[:b * maxb].reshape(b, maxb)
    tables = tables.astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for slot in null_slots:        # an inactive engine slot
        tables[slot] = 0
        lens[slot] = 1
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev))


def _poison(kp, vp, tables, lens, bs):
    live = torch.zeros(kp.shape[:2], dtype=torch.bool)
    t_np, l_np = tables.cpu().numpy(), lens.cpu().numpy()
    for b in range(len(l_np)):
        for t in range(l_np[b]):
            live[t_np[b, t // bs], t % bs] = True
    live = live.to(kp.device)[:, :, None, None]
    return (torch.where(live, kp, torch.full_like(kp, 1e9)),
            torch.where(live, vp, torch.full_like(vp, -1e9)))


def phase_paged(dev, h=16, d=64, bs=16, maxb=64, iters=100):
    from paddle_tpu_torch.incubate.nn.kernels.paged_attention import (
        paged_attention, paged_attention_reference)

    rng = np.random.RandomState(0)
    top = maxb * bs
    serve_ctx = tuple(min(top, n + SERVE_NEW_TOKENS // 2)
                      for n in SERVE_LENS)
    cases = {
        "single": (1,) * 8,
        "block_edges": tuple(min(top, bs * k)
                             for k in (1, 2, 3, 4, 8, 16, 32, maxb)),
        "edges_pm1": (1, bs - 1, bs, bs + 1, 2 * bs - 1, 2 * bs + 1,
                      top - 1, top),
        "odd": tuple(min(top, x) for x in (37, 3, 23, 15, 501, 777, 129,
                                           999)),
        "serve": serve_ctx,
    }
    # f32: summation order only. bf16: about one bf16 ulp of the output
    # (1e-2 x max|ref| + 1e-2 relative); kernel and plain version round
    # the same un-normalised probabilities, each against its own max
    def tol(dtype, ref):
        if dtype == torch.float32:
            return 1e-5, 1e-5
        return 1e-2 * float(ref.float().abs().max()), 1e-2

    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    scale = d ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        for name, lens in cases.items():
            nulls = (7,) if name == "serve" else ()
            q, kp, vp, bt, cl = _paged_inputs(rng, lens, h, d, bs, maxb,
                                              dtype, dev, nulls)
            out = paged_attention(q, kp, vp, bt, cl, sm_scale=scale)
            ref = paged_attention_reference(q, kp, vp, bt, cl,
                                            sm_scale=scale)
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError(f"paged {name}: {out.dtype} "
                                     f"{tuple(out.shape)}")
            e = assert_close(f"paged {name} {dtype}", out, ref,
                             *tol(dtype, ref))
            err[dtype] = max(err[dtype], e)
        # dead blocks and dead tail rows are never read: poisoning every
        # non-live pool position leaves the output bit-identical
        pk, pv = _poison(kp, vp, bt, cl, bs)
        out2 = paged_attention(q, pk, pv, bt, cl, sm_scale=scale)
        if not torch.equal(out, out2):
            raise AssertionError(f"paged poison {dtype}: output changed")
        # head_dim 128 (8 heads), odd ragged lengths
        q, kp, vp, bt, cl = _paged_inputs(rng, cases["odd"], 8, 128, bs,
                                          maxb, dtype, dev)
        out = paged_attention(q, kp, vp, bt, cl, sm_scale=128 ** -0.5)
        ref = paged_attention_reference(q, kp, vp, bt, cl,
                                        sm_scale=128 ** -0.5)
        e = assert_close(f"paged d128 {dtype}", out, ref, *tol(dtype, ref))
        err[dtype] = max(err[dtype], e)
    log("paged", f"kernel vs plain: max|err| f32 {err[torch.float32]:.3e} "
        f"(tol 1e-5 abs + 1e-5 rel), bf16 {err[torch.bfloat16]:.3e} "
        "(tol 1e-2 x max|ref| abs + 1e-2 rel); poison check bit-identical")
    k_ms, p_ms, l_ms, b_ms, b_by = paged_times(dev, h, d, bs, maxb, iters,
                                               rng)
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/paged_attention.py:76",
            "max_abs_err": err[torch.float32], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}


def paged_times(dev, h=16, d=64, bs=16, maxb=64, iters=100, rng=None,
                tag="paged"):
    """Phase 3's times: the decode wrapper at the serving shapes (f32
    pools, contexts = prompts + 32 generated tokens, one inactive slot;
    L2 flushed before each launch), its plain version, SDPA on K/V
    gathered beforehand, and the bound. Logs them; returns (kernel,
    plain, SDPA, bound ms, bound_by)."""
    from paddle_tpu_torch.incubate.nn.kernels.paged_attention import (
        paged_attention, paged_attention_reference)

    rng = rng if rng is not None else np.random.RandomState(3)
    scale = d ** -0.5
    serve_ctx = tuple(min(maxb * bs, n + SERVE_NEW_TOKENS // 2)
                      for n in SERVE_LENS)
    q, kp, vp, bt, cl = _paged_inputs(rng, serve_ctx, h, d, bs, maxb,
                                      torch.float32, dev, (7,))
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    k_ms, k_host = time_ms(
        lambda: paged_attention(q, kp, vp, bt, cl, scale), iters, flush)
    p_ms, p_host = time_ms(
        lambda: paged_attention_reference(q, kp, vp, bt, cl, scale),
        max(1, iters // 5), flush)
    # library yardstick: SDPA over K/V gathered beforehand (the gather
    # itself is not timed), padded positions masked out
    tables = bt.long()
    s_len = maxb * bs
    kg = kp[tables].reshape(len(serve_ctx), s_len, h, d).transpose(1, 2)
    vg = vp[tables].reshape(len(serve_ctx), s_len, h, d).transpose(1, 2)
    kg, vg = kg.contiguous(), vg.contiguous()
    mask = (torch.arange(s_len, device=dev)[None, :]
            < cl.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms, _ = time_ms(
        lambda: sdpa(q4, kg, vg, attn_mask=mask, scale=scale), iters, flush)
    live = int(cl.sum())
    nbytes = (2 * q.numel() * 4 + 2 * live * h * d * 4 + bt.numel() * 4
              + cl.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * live * h * d)
    log(tag, f"B={len(serve_ctx)} H={h} D={d} BS={bs} ctx={serve_ctx}"
        f" f32, cold L2, device ms: kernel {k_ms:.5f} | plain {p_ms:.5f} |"
        f" sdpa {l_ms:.5f} | bound {b_ms:.5f} ({b_by}, {nbytes} B); host "
        f"ms per call: kernel wrapper {k_host:.5f}, plain {p_host:.5f}")
    return k_ms, p_ms, l_ms, b_ms, b_by


# -- phase 4 -----------------------------------------------------------
def phase_ln(dev, hidden=1024, rows=(8, 384), iters=100):
    from paddle_tpu_torch.incubate.nn.kernels.layernorm import (
        layer_norm_fwd, layer_norm_fwd_reference)

    rng = np.random.RandomState(1)
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    eps = 1e-5

    def inputs(n, dtype):
        x = torch.from_numpy(rng.randn(n, hidden).astype(np.float32))
        r = torch.from_numpy(rng.randn(n, hidden).astype(np.float32))
        w = torch.from_numpy(
            (1 + 0.1 * rng.randn(hidden)).astype(np.float32))
        b = torch.from_numpy((0.1 * rng.randn(hidden)).astype(np.float32))
        return x.to(dev, dtype), r.to(dev, dtype), w.to(dev), b.to(dev)

    for dtype in (torch.float32, torch.bfloat16):
        for n in rows:
            x, r, w, b = inputs(n, dtype)
            for res in (None, r):
                for act, approx in ((None, True), ("gelu", True),
                                    ("gelu", False)):
                    tag = (f"ln n={n} {dtype} res={res is not None} "
                           f"act={act} approx={approx}")
                    y, s, mu, rs = layer_norm_fwd(x, res, w, b, eps, act,
                                                  approx)
                    y0, s0, mu0, rs0 = layer_norm_fwd_reference(
                        x, res, w, b, eps, act, approx)
                    e = assert_close(tag + " y", y, y0, *tol[dtype])
                    e = max(e, assert_close(tag + " mean", mu, mu0,
                                            1e-5, 1e-5))
                    e = max(e, assert_close(tag + " rstd", rs, rs0,
                                            1e-5, 1e-5))
                    if res is not None and not torch.equal(s, s0):
                        raise AssertionError(tag + ": s differs")
                    err[dtype] = max(err[dtype], e)
    log("ln", f"kernel vs plain: max|err| f32 {err[torch.float32]:.3e} "
        f"(tol 1e-5 abs + 1e-5 rel), bf16 {err[torch.bfloat16]:.3e} "
        "(y tol 1e-2 abs + 1e-2 rel; mean/rstd 1e-5); s bit-identical")

    # times at the decode shape (8 rows) and a prefill shape (384),
    # f32, warm L2: LayerNorm's input was written by the op before it
    entry = None
    for n in rows:
        x, r, w, b = inputs(n, torch.float32)
        for res in (None, r):
            k_ms, k_host = time_ms(
                lambda: layer_norm_fwd(x, res, w, b, eps), iters)
            p_ms, p_host = time_ms(
                lambda: layer_norm_fwd_reference(x, res, w, b, eps),
                max(1, iters // 4))
            elems = n * hidden
            nbytes = (elems * 4 * (2 if res is None else 4)
                      + 2 * hidden * 4 + 2 * n * 4)
            b_ms, b_by = bound_ms(nbytes, 8 * elems)
            lib_ms = lib_txt = None
            if res is None:
                lib_ms, _ = time_ms(lambda: torch.nn.functional.layer_norm(
                    x, (hidden,), w, b, eps), iters)
                lib_txt = f"{lib_ms:.5f}"
            log("ln", f"N={n} H={hidden} f32 residual={res is not None}, "
                f"device ms: kernel {k_ms:.5f} | plain {p_ms:.5f} | "
                f"F.layer_norm {lib_txt} | bound {b_ms:.6f} ({b_by}); host "
                f"ms per call: kernel wrapper {k_host:.5f}, plain "
                f"{p_host:.5f}")
            if entry is None:      # the JSON row: decode shape, no residual
                entry = {"name": "fused_layer_norm", "route": "cuda",
                         "source": "paddle_tpu_torch/csrc/layernorm.cu",
                         "replaces":
                             "paddle_tpu/incubate/nn/pallas/layernorm.py:83",
                         "max_abs_err": err[torch.float32], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms}
    return entry


# -- phase 5 -----------------------------------------------------------
def _serve_model(dev, cfg=None):
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt2_345m

    cfg = cfg or gpt2_345m(max_seq_len=1024, dropout=0.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    return GPTForCausalLM(cfg, device=dev, generator=gen)


def _serve_prompts(vocab, lens=SERVE_LENS):
    rng = np.random.RandomState(0)
    return [list(rng.randint(1, vocab, n)) for n in lens]


def phase_serve(dev, model, smi, lens=SERVE_LENS,
                new_tokens=SERVE_NEW_TOKENS, max_batch=SERVE_MAX_BATCH):
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    cfg = model.config
    prompts = _serve_prompts(cfg.vocab_size, lens)
    sampling = SamplingParams(max_new_tokens=new_tokens)

    def run():
        eng = LLMEngine(model, max_batch=max_batch, device=dev)
        ids = [eng.add_request(p, sampling=sampling) for p in prompts]
        t0 = time.perf_counter()
        while eng.has_unfinished():
            eng.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return eng, ids, time.perf_counter() - t0

    run()                           # warm-up pass, same traffic
    keys = ("serve/prefills", "serve/decode_dispatches", "serve/tokens",
            "serve/evictions", "serve/prefill_us", "serve/decode_us")
    before = {k: cmon.stat_get(k) for k in keys}
    kernels.reset_launches()
    eng, ids, dt = run()
    counts = kernels.launches()
    delta = {k: cmon.stat_get(k) - before[k] for k in keys}
    reqs = [eng.get_request(i) for i in ids]
    outs = [r.output_ids for r in reqs]
    if [len(o) for o in outs] != [new_tokens] * len(prompts):
        raise AssertionError(f"serve: output lengths {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("serve: token id out of range")
    if eng.check_drained() != {} or eng.cache.allocator.used_blocks:
        raise AssertionError("serve: KV blocks leaked")
    n_dec = delta["serve/decode_dispatches"]
    n_pre = delta["serve/prefills"]
    n_layers = cfg.num_layers
    if counts["paged_attention"] != n_layers * n_dec or n_dec < 1:
        raise AssertionError(
            f"serve: paged kernel launched {counts['paged_attention']} "
            f"times for {n_dec} decode dispatches x {n_layers} layers")
    per_dispatch = 2 * n_layers + 1
    if counts["fused_layer_norm"] != per_dispatch * (n_pre + n_dec):
        raise AssertionError(
            f"serve: LN kernel launched {counts['fused_layer_norm']} times"
            f" for {n_pre} prefills + {n_dec} decodes x {per_dispatch}")
    gaps = sorted(b - a for r in reqs
                  for a, b in zip(r.token_times, r.token_times[1:]))
    ttft = sorted(r.token_times[0] - r.arrival_perf for r in reqs)
    total = sum(len(o) for o in outs)
    q = quantile_ms
    log("serve", f"[{smi}] GPT-2 {cfg.hidden_size}h x {n_layers}L f32, "
        f"{len(prompts)} prompts {tuple(lens)}, {new_tokens} greedy tokens"
        f" each: {total} tokens in {dt:.3f} s = {total / dt:.1f} tokens/s"
        f" | ITL p50 {q(gaps, 0.5):.3f} ms p99 {q(gaps, 0.99):.3f} ms | "
        f"TTFT p50 {q(ttft, 0.5):.3f} ms | {n_pre} prefills "
        f"({delta['serve/prefill_us'] / 1e3:.1f} ms), {n_dec} decode "
        f"dispatches ({delta['serve/decode_us'] / 1e3 / n_dec:.3f} ms each)"
        f" | evictions {delta['serve/evictions']} | pool "
        f"{eng.cache.num_blocks} blocks")
    log("serve", f"launches: {counts} = {n_layers} x {n_dec} paged, "
        f"{per_dispatch} x {n_pre + n_dec} LN; drained, 0 blocks used")
    log("serve", f"tokens (reported, not gated) req0: {outs[0][:16]}")
    stats = {"tokens_s": total / dt, "itl_p50": q(gaps, 0.5),
             "itl_p99": q(gaps, 0.99)}
    return counts, outs, stats


# -- phase 6 -----------------------------------------------------------
def _decode_setup(dev, model, num_blocks=512, lens=SERVE_LENS):
    """An engine with phase 5's 8 prompts admitted and prefilled and one
    position each reserved, and the next decode step's arguments:
    (engine, ids, positions, tables, lens, args, tail, kw)."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    cfg = model.config
    eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH, num_blocks=num_blocks,
                    device=dev)
    for p in _serve_prompts(cfg.vocab_size, lens):
        eng.add_request(p, SamplingParams(max_new_tokens=SERVE_NEW_TOKENS))
    eng.scheduler.schedule(
        on_admit=lambda r: eng._emit(r, eng._prefill(r), {}))
    for req in list(eng.scheduler.running.values()):
        eng.scheduler.ensure_capacity(req, new_tokens=1)
    ids, pos, tables, lens_a, _, _, _ = eng._batch_arrays()
    args = [torch.from_numpy(a).to(dev) for a in (ids, pos)]
    tail = [torch.from_numpy(a).to(dev) for a in (tables, lens_a)]
    kw = dict(n_head=cfg.num_heads, eps=cfg.layer_norm_eps,
              block_size=eng.block_size)
    return eng, ids, pos, tables, lens_a, args, tail, kw


def phase_logits(dev, model, num_blocks=512, lens=SERVE_LENS):
    from paddle_tpu_torch.inference.serving import model_runner as mr

    cfg = model.config
    eng, ids, pos, tables, lens_a, args, tail, kw = _decode_setup(
        dev, model, num_blocks, lens)
    k_plain, v_plain = eng.cache.k.clone(), eng.cache.v.clone()
    got = mr.decode_logits(eng.params, *args, eng.cache.k, eng.cache.v,
                           *tail, use_kernel=True, **kw)
    want = mr.decode_logits(eng.params, *args, k_plain, v_plain, *tail,
                            use_kernel=False, **kw)
    if not bool(torch.isfinite(got).all()) or got.shape != (
            SERVE_MAX_BATCH, cfg.vocab_size):
        raise AssertionError(f"logits: shape {tuple(got.shape)} or "
                             "non-finite values")
    scale = float(want.abs().max())
    err = max_err(got, want)
    # f32 throughout: the paths differ only in summation order (LN
    # reductions, online vs dense softmax), ~1e-6 relative per layer
    # over 24 layers; 1e-3 of the largest logit is far above that and
    # far below any real divergence
    if err > 1e-3 * scale:
        raise AssertionError(f"logits: max|dlogits| {err:.3e} > 1e-3 x "
                             f"{scale:.3e}")
    # written K/V: this step's position of every live slot, per layer;
    # everything else in the pools must be untouched and identical
    blk = torch.from_numpy(tables[np.arange(len(pos)),
                                  pos // eng.block_size]).long().to(dev)
    off = torch.from_numpy(pos % eng.block_size).long().to(dev)
    kv_err = 0.0
    for name, pk, pp in (("k", eng.cache.k, k_plain),
                         ("v", eng.cache.v, v_plain)):
        wk, wp = pk[:, blk, off], pp[:, blk, off]
        e = max_err(wk, wp)
        if e > 1e-4 * float(wp.abs().max()):
            raise AssertionError(f"written {name}: max|err| {e:.3e}")
        kv_err = max(kv_err, e)
        pk[:, blk, off] = wp
        if not torch.equal(pk, pp):
            raise AssertionError(f"{name} pool changed off the written "
                                 "positions")
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    log("logits", f"decode step kernel vs plain: max|dlogits| {err:.3e} "
        f"(tol 1e-3 x max|logits| = {1e-3 * scale:.3e}); written K/V max|err|"
        f" {kv_err:.3e} (tol 1e-4 x max), rest of pools identical; argmax "
        f"agrees on {agree}/{SERVE_MAX_BATCH} rows (reported, not gated)")

    # where a decode step's time goes: wall vs device-busy (rewrites
    # the same K/V positions; the pools stay valid)
    def step(use_kernel):
        return mr.decode_logits(eng.params, *args, eng.cache.k, eng.cache.v,
                                *tail, use_kernel=use_kernel, **kw)

    out = {}
    for use, label in ((True, "kernel path"), (False, "plain path")):
        wall, busy, count, top, _ = profile_ms(lambda: step(use))
        out[use] = (wall, busy)
        if busy is None:
            log("where", f"decode step (B=8), {label}: wall {wall:.3f} ms;"
                " device time not measured (the profiler saw no device "
                "activity)")
            continue
        tops = "; ".join(f"{name} x{n:.0f} {ms:.4f} ms"
                         for name, n, ms in top)
        log("where", f"decode step (B=8), {label}: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), "
            f"{count:.0f} kernels; top: {tops}")
    return out


# -- phase 7 -----------------------------------------------------------
def _flash_inputs(rng, b, h, sq, d, dtype, dev, sk=None):
    sk = sq if sk is None else sk

    def t(*shape, scale=0.5):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).to(dev, dtype)

    return (t(b, h, sq, d), t(b, h, sk, d), t(b, h, sk, d),
            t(b, h, sq, d, scale=1.0))


# bf16 flash outputs vs their plain versions, per row of o, dq (a query)
# and dk, dv (a key): 1e-2 x the row's max|ref|, one bf16 ulp of the
# row's largest value (2^-7 = 7.8e-3: a final rounding to bf16 that
# falls the other way) and a quarter ulp for what the f32 sums before it
# differ by. The forward rounds p = exp(s - m) against per-tile running
# maxima where the plain version takes the row maximum; the backward
# kernels recompute p and ds in f32 as the plain versions do and differ
# in summation order only. Per row, because causal rows and keys differ
# in scale (o and dq shrink like 1/sqrt(row), dk and dv with the key
# index): one limit for the whole tensor is set by its first rows and
# passes a late row or key that lost a tile (chip_mutants.py).
FLASH_BF16_ROW_TOL = 1e-2

# Gate 1 of the f32 flash kernels: o, lse, dq, dk and dv each within
# FLASH_F32_ORACLE_TOL x max|ref| of a float64 oracle, and, causal, each
# row of o, dq, dk and dv within it x the row's max|ref|, floored at
# FLASH_F32_ROW_FLOOR x the tensor's max|ref| as `assert_close_rows`
# floors it (a late causal key's dk and dv are 3e-4 of the largest). The
# JAX-parity limits (2e-5 / 2e-4) pass a non-causal kernel whose
# products run in one-pass TF32 (10-bit mantissas); this one does not.
# dq's first FLASH_F32_DQ_FIRST_ROWS causal rows are held by the
# per-tensor limit only: row i sums the terms of i + 1 keys, which
# cancel (row 0: exactly, p = 1 and dp - delta = 0) or by chance nearly
# do, and the row's error is then the f32 rounding of the terms, not a
# share of the row (phase 7's S129: row 2 of one head is 0.008 x
# max|dq|, and with only row 0 left out the plain f32 version and a
# 3xTF32 emulation read past half the limit on the CPU). A tile the
# kernels drop or mask touches at least 8 rows. On the CPU
# (tests/test_torch_flash_f32.py: B 1 H 2, S 256 and 129, D 64 and 128,
# causal and not) the plain f32 version and a 3xTF32 emulation pass at
# half the limit or less and a one-pass-TF32 emulation fails it by 10x
# or more on each of dq, dk and dv; so does the forward's tiled
# emulation, one pass on S alone failing by 8.5x or more on o. Readings
# as the gate takes them (worst max|err| / scale over the outputs) on an
# H100 at the f32 shapes of phases 7, 18 and 22: the plain version 7.5e-7
# to 2.7e-6, the 3xTF32 kernels 9.9e-7 to 5.0e-6 (the tensor cores
# truncate as they accumulate; the backward takes the kernel forward's o
# and lse), chip_mutants.py's one-pass-TF32 kernels 8.5e-5 or more (the
# forward's S alone, not causal; every other 1.6e-4 or more). 1e-5
# passes the f32 grades at 2.0x or more and fails one pass by 8.5x or
# more.
FLASH_F32_ORACLE_TOL = 1e-5
FLASH_F32_ROW_FLOOR = 1e-3
FLASH_F32_DQ_FIRST_ROWS = 8
FLASH_OUTPUTS = ("o", "lse", "dq", "dk", "dv")


def flash_f64_oracle(q, k, v, do, causal, scale):
    """(o, lse, dq, dk, dv) of attention in float64, a dense composition
    with the kernels' mask: q_pos >= k_pos from the top left, -1e30."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p, v)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True)) * scale
    return (o, lse, torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.transpose(-1, -2), do))


def flash_f64_gate(tag, outs, ref, causal, tol=FLASH_F32_ORACLE_TOL):
    """Gate 1: raises unless each of `outs` (o, lse, dq, dk, dv) is
    within tol x its max|ref| of the float64 oracle `ref`, per tensor
    and, causal, per row (floored, FLASH_F32_ROW_FLOOR; dq's first
    FLASH_F32_DQ_FIRST_ROWS rows per tensor only). Returns {name:
    worst max|err| / scale}, the reading the gate holds under tol."""
    read = {}
    for name, got, want in zip(FLASH_OUTPUTS, outs, ref):
        err = (got.double() - want).abs()
        top = float(want.abs().max())
        r = float(err.max()) / max(top, 1e-30)
        if causal and name != "lse":
            row = want.abs().amax(dim=-1).clamp_min(
                max(FLASH_F32_ROW_FLOOR * top, 1e-30))
            ratio = err.amax(dim=-1) / row
            if name == "dq":
                ratio = ratio[..., FLASH_F32_DQ_FIRST_ROWS:]
            r = max(r, float(ratio.max()))
        read[name] = r
    bad = {n: r for n, r in read.items() if not r <= tol}
    if bad:
        raise AssertionError(
            f"{tag}: off the float64 oracle (gate 1, {tol} x max|ref|"
            f"{', per row' if causal else ''}): " + ", ".join(
                f"{n} {r:.3e}" for n, r in bad.items()))
    return read


def flash_outputs(q, k, v, do, causal, scale):
    """((o, lse, dq, dk, dv) of the kernels, the same of the plain
    versions), each side from its own forward."""
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    got = (o, lse) + fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                            scale)
    o0, lse0 = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    want = (o0, lse0) + fa.flash_attention_bwd_reference(
        q, k, v, o0, lse0, do, causal, scale)
    return got, want


def flash_parity(tag, got, want):
    """Kernel outputs `got` vs the plain versions' `want` (o, lse, dq,
    dk, dv). Returns {name: (max |err|, max |err| / row max|ref|)}; raises
    past the limits. f32: o within 2e-5 and the gradients within 2e-4,
    abs + rel, the JAX package's tolerances for its flash kernel
    (test_flash_attention.py:34, 53); bf16: per row, FLASH_BF16_ROW_TOL."""
    dtype = got[0].dtype
    # lse is f32 from the same inputs: summation order only
    errs = {"lse": (assert_close(f"{tag} lse", got[1], want[1], 1e-4, 1e-5),
                    None)}
    for name, g, w in zip(FLASH_OUTPUTS, got, want):
        if name == "lse":
            continue
        if g.dtype != dtype or g.shape != w.shape \
                or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} {name}: {g.dtype} "
                                 f"{tuple(g.shape)} or non-finite")
        if dtype == torch.float32:
            t = 2e-5 if name == "o" else 2e-4
            errs[name] = (assert_close(f"{tag} {name}", g, w, t, t), None)
        else:
            errs[name] = assert_close_rows(f"{tag} {name}", g, w,
                                           FLASH_BF16_ROW_TOL)
    return errs


def _flash_check(tag, q, k, v, do, causal, scale):
    """Kernels vs plain versions (`flash_parity`), and in f32 kernels and
    plain versions both through gate 1 (`flash_f64_gate`, logged).
    Returns `flash_parity`'s errors."""
    got, want = flash_outputs(q, k, v, do, causal, scale)
    errs = flash_parity(tag, got, want)
    if q.dtype == torch.float32:
        ref = flash_f64_oracle(q, k, v, do, causal, scale)
        kern = flash_f64_gate(f"{tag} kernels", got, ref, causal)
        plain = flash_f64_gate(f"{tag} plain", want, ref, causal)
        del ref
        log("oracle", f"{tag}: max|err| / max|ref| against float64 (gate 1:"
            f" {FLASH_F32_ORACLE_TOL}{', per row' if causal else ''}): "
            "kernels " + ", ".join(f"{n} {r:.2e}" for n, r in kern.items())
            + "; plain " + ", ".join(f"{n} {r:.2e}"
                                     for n, r in plain.items()))
    return errs


FLASH_CASES = [  # phase 7's: tag, B, H, Sq, D, dtype, causal, Sk
    ("training shape", TRAIN_BATCH, 16, TRAIN_SEQ, 64, torch.bfloat16, True,
     None),
    ("S256", 2, 4, 256, 64, torch.float32, True, None),
    ("S129", 2, 4, 129, 64, torch.float32, True, None),
    ("S1000", 1, 4, 1000, 64, torch.bfloat16, True, None),
    ("S1000 D128", 1, 4, 1000, 128, torch.float32, True, None),
    ("S129 D128", 2, 4, 129, 128, torch.bfloat16, True, None),
    ("non-causal S256", 2, 4, 256, 64, torch.float32, False, None),
    ("non-causal Sq100 Sk333", 1, 4, 100, 64, torch.bfloat16, False, 333),
    ("non-causal Sq100 Sk333 D128", 1, 4, 100, 128, torch.float32, False,
     333),
]


def flash_checks(dev):
    """Phase 7's check: `_flash_check` on each of FLASH_CASES. Returns
    ({dtype: {name: (worst max|err|, worst row ratio or None)}}, the
    first case's {name: max|err|})."""
    rng = np.random.RandomState(2)
    worst = {torch.float32: {}, torch.bfloat16: {}}
    first = None
    for tag, bb, hh, sq, dd, dtype, causal, sk in FLASH_CASES:
        q, k, v, do = _flash_inputs(rng, bb, hh, sq, dd, dtype, dev, sk)
        errs = _flash_check(f"flash {tag} {dtype}", q, k, v, do, causal,
                            dd ** -0.5)
        first = first or {n: e for n, (e, _) in errs.items()}
        for n, (e, r) in errs.items():
            e0, r0 = worst[dtype].get(n, (0.0, None))
            worst[dtype][n] = (max(e0, e),
                               None if r is None else max(r0 or 0.0, r))
    return worst, first


def phase_flash(dev, shape=(TRAIN_BATCH, 16, TRAIN_SEQ, 64), iters=50):
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    worst, slice_err = flash_checks(dev)
    for dtype, w in worst.items():
        log("flash", f"kernels vs plain, {dtype}, worst of "
            f"{sum(c[5] == dtype for c in FLASH_CASES)} cases, max|err| (/ "
            "row max|ref|): " + ", ".join(
                f"{n} {e:.3e}" + ("" if r is None else f" ({r:.3e})")
                for n, (e, r) in w.items()))
    log("flash", "tolerances: f32 o 2e-5, grads 2e-4 (abs + rel), and gate "
        f"1 ({FLASH_F32_ORACLE_TOL} x max|ref| of float64); bf16 per row: "
        f"{FLASH_BF16_ROW_TOL} x row max|ref| (floored at 1e-3 x "
        "max|ref|); lse 1e-4 abs + 1e-5 rel")

    # times at the training shape, bf16, causal; L2 flushed before each
    # call (34 MB of inputs, most of which a step has evicted by then)
    rng = np.random.RandomState(7)
    b, h, s, d = shape
    bf16 = torch.bfloat16
    scale = d ** -0.5
    q, k, v, do = _flash_inputs(rng, b, h, s, d, bf16, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(dim=-1)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    pit = max(1, iters // 5)
    ms = {
        "fwd": time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, scale),
                       iters, flush)[0],
        "dq": time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, True, scale), iters, flush)[0],
        "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, True, scale), iters, flush)[0],
        "bwd": time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, True, scale), iters, flush)[0],
    }
    plain = {
        "fwd": time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, True, scale), pit, flush)[0],
        "dq": time_ms(lambda: fa.flash_attention_bwd_dq_reference(
            q, k, v, do, lse, delta, True, scale), pit, flush)[0],
        "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
            q, k, v, do, lse, delta, True, scale), pit, flush)[0],
    }
    # library yardstick, timed only: SDPA forward, and SDPA backward
    # alone (dq, dk and dv together) from one forward kept for it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale),
                      iters, flush)[0]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = sdpa(qg, kg, vg, is_causal=True, scale=scale)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters, flush)[0]
    del out
    # bounds: causal work is the lower triangle, diagonal included
    bh = b * h
    mm = 2.0 * bh * d * s * (s + 1) / 2      # one causal S x S x D product
    elem = bh * s * d * 2                    # one bf16 [B, H, S, D] tensor
    row = bh * s * 4                         # one f32 [B, H, S] row stat
    work = {"fwd": (4 * elem + row, 2 * mm),
            "dq": (5 * elem + 2 * row, 3 * mm),
            "dkv": (6 * elem + 2 * row, 4 * mm)}
    bounds = {n: bound_ms(nb, fl, PEAK_BF16_FLOPS)
              for n, (nb, fl) in work.items()}
    for n in ("fwd", "dq", "dkv"):
        log("flash", f"B={b} H={h} S={s} D={d} bf16 causal, cold L2, "
            f"{n}: kernel {ms[n]:.5f} ms | plain {plain[n]:.5f} ms | bound "
            f"{bounds[n][0]:.5f} ms ({bounds[n][1]}; {work[n][1] / 1e9:.2f}"
            f" GFLOP, {work[n][0] / 1e6:.1f} MB) | "
            f"{work[n][1] / ms[n] / 1e9:.1f} TFLOP/s")
    log("flash", f"backward wrapper (delta + dq + dk/dv) {ms['bwd']:.5f} ms;"
        f" SDPA forward {lib_fwd:.5f} ms, backward {lib_bwd:.5f} ms (dq, dk"
        f" and dv in one call; both backward rows' library_ms); kernels "
        f"forward+backward {ms['fwd'] + ms['bwd']:.5f} ms, SDPA "
        f"{lib_fwd + lib_bwd:.5f} ms")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    rep = "paddle_tpu/incubate/nn/attention_pallas.py:"
    rows = [("flash_attention_fwd", "fwd", "97", slice_err["o"], lib_fwd),
            ("flash_attention_bwd_dq", "dq", "215", slice_err["dq"],
             lib_bwd),
            ("flash_attention_bwd_dkv", "dkv", "257",
             max(slice_err["dk"], slice_err["dv"]), lib_bwd)]
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": rep + line, "max_abs_err": err, "ms": ms[key],
             "plain_ms": plain[key], "bound_ms": bounds[key][0],
             "bound_by": bounds[key][1], "library_ms": lib}
            for name, key, line, err, lib in rows]


# -- phase 8 -----------------------------------------------------------
def ln_bwd_checks(dev, rows=TRAIN_BATCH * TRAIN_SEQ, hidden=1024):
    """Phase 8's check: the LayerNorm forward kernel (phase 4's limits)
    and then the backward kernel against their plain versions on the
    forward's outputs, f32 and bf16, with and without the residual, no /
    tanh / erf GeLU; a second backward call on the same inputs gives
    bit-identical dx, dw and db. Returns ({dtype: forward max|err|},
    {dtype: backward max|err|})."""
    from paddle_tpu_torch.incubate.nn.kernels.layernorm import (
        layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
        layer_norm_fwd_reference)

    rng = np.random.RandomState(4)
    eps = 1e-5

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    w = 1 + 0.1 * t(hidden)
    b = 0.1 * t(hidden)
    # dx: f32 summation order (1e-5), bf16 one ulp (1e-2), relative to
    # max|ref| and elementwise; dw, db: f32 sums over the rows in
    # another order, 1e-5 x max|ref|
    dx_tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fwd_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        x, r, dy, ds = (t(rows, hidden, dtype=dtype) for _ in range(4))
        for res in (False, True):
            for act, approx in ((None, True), ("gelu", True),
                                ("gelu", False)):
                tag = f"lnbwd {dtype} res={res} act={act} approx={approx}"
                # the forward kernel at the training shape, at phase 4's
                # limits, before its outputs feed the backward
                rr = r if res else None
                y, s, mu, rs = layer_norm_fwd(x, rr, w, b, eps, act, approx)
                y0, s0, mu0, rs0 = layer_norm_fwd_reference(
                    x, rr, w, b, eps, act, approx)
                fe = assert_close(f"{tag} fwd y", y, y0, dx_tol[dtype],
                                  dx_tol[dtype])
                fe = max(fe, assert_close(f"{tag} fwd mean", mu, mu0, 1e-5,
                                          1e-5))
                fe = max(fe, assert_close(f"{tag} fwd rstd", rs, rs0, 1e-5,
                                          1e-5))
                if res and not torch.equal(s, s0):
                    raise AssertionError(tag + ": fwd s differs")
                fwd_err[dtype] = max(fwd_err[dtype], fe)
                s = s if res else x
                dsr = ds if res else None
                got = layer_norm_bwd(dy, dsr, s, w, b, mu, rs, act, approx)
                want = layer_norm_bwd_reference(dy, dsr, s, w, b, mu, rs,
                                                act, approx)
                tol = dx_tol[dtype]
                e = assert_close(tag + " dx", got[0], want[0],
                                 tol * float(want[0].float().abs().max()),
                                 tol)
                for name, g_, w_ in (("dw", got[1], want[1]),
                                     ("db", got[2], want[2])):
                    e = max(e, assert_close(
                        f"{tag} {name}", g_, w_,
                        1e-5 * float(w_.abs().max()), 1e-5))
                err[dtype] = max(err[dtype], e)
                again = layer_norm_bwd(dy, dsr, s, w, b, mu, rs, act, approx)
                for name, g_, g2 in zip(("dx", "dw", "db"), got, again):
                    if not torch.equal(g_, g2):
                        raise AssertionError(
                            f"{tag} {name}: two calls on the same inputs "
                            "differ")
    return fwd_err, err


def phase_ln_bwd(dev, rows=TRAIN_BATCH * TRAIN_SEQ, hidden=1024, iters=100):
    from paddle_tpu_torch.incubate.nn.kernels.layernorm import (
        layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd)

    fwd_err, err = ln_bwd_checks(dev, rows, hidden)
    log("lnbwd", f"forward kernel vs plain, N={rows} H={hidden}: max|err| "
        f"f32 {fwd_err[torch.float32]:.3e} (tol 1e-5 abs + 1e-5 rel), bf16 "
        f"{fwd_err[torch.bfloat16]:.3e} (y tol 1e-2 abs + 1e-2 rel; "
        "mean/rstd 1e-5); s bit-identical")
    log("lnbwd", f"kernel vs plain, N={rows} H={hidden}: max|err| f32 "
        f"{err[torch.float32]:.3e} (dx 1e-5 x max|ref| + 1e-5 rel), bf16 "
        f"{err[torch.bfloat16]:.3e} (dx 1e-2 x max|ref| + 1e-2 rel); dw, db"
        " 1e-5 x max|ref|; a second call bit-identical (dx, dw, db)")

    ln_fwd_times(dev, rows, hidden, iters)

    # times at the training shape, bf16, warm L2 (the backward's inputs
    # were just written by the op before it): with the residual (ln2,
    # 24 calls a step) and without (ln1 and lnf, 25)
    rng = np.random.RandomState(5)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    w = 1 + 0.1 * t(hidden)
    b = 0.1 * t(hidden)
    x, r, dy, ds = (t(rows, hidden, dtype=torch.bfloat16) for _ in range(4))
    _, s, mu, rs = layer_norm_fwd(x, r, w, b, 1e-5)
    # library yardstick, timed only: F.layer_norm's backward, without
    # the residual's add; weight and bias in bf16, since F.layer_norm on
    # the card takes one dtype
    xl = s.detach().requires_grad_()
    wl, bl = (t_.detach().bfloat16().requires_grad_() for t_ in (w, b))
    yl = torch.nn.functional.layer_norm(xl, (hidden,), wl, bl, 1e-5)
    l_ms, _ = time_ms(lambda: torch.autograd.grad(
        yl, (xl, wl, bl), dy, retain_graph=True), iters)
    elems = rows * hidden
    out = {}
    for tag, dsr in (("residual", ds), ("no residual", None)):
        k_ms, k_host = time_ms(
            lambda: layer_norm_bwd(dy, dsr, s, w, b, mu, rs), iters)
        p_ms, _ = time_ms(
            lambda: layer_norm_bwd_reference(dy, dsr, s, w, b, mu, rs),
            max(1, iters // 4))
        # dy, s (, ds) read and dx written once; w, b, dw, db; mean, rstd
        nbytes = (3 + (dsr is not None)) * elems * 2 + 4 * hidden * 4 \
            + 2 * rows * 4
        b_ms, b_by = bound_ms(nbytes, 12 * elems)
        log("lnbwd", f"N={rows} H={hidden} bf16 {tag}, warm L2, device ms: "
            f"kernel {k_ms:.5f} | plain {p_ms:.5f} | F.layer_norm backward "
            f"{l_ms:.5f} | bound {b_ms:.5f} ({b_by}, {nbytes} B); host ms "
            f"per call: kernel wrapper {k_host:.5f}")
        out[tag] = (k_ms, p_ms, b_ms, b_by)
    k_ms, p_ms, b_ms, b_by = out["residual"]
    return {"name": "fused_layer_norm_bwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/layernorm.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/layernorm.py:156",
            "max_abs_err": err[torch.bfloat16], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}


def ln_fwd_times(dev, rows=TRAIN_BATCH * TRAIN_SEQ, hidden=1024, iters=100,
                 tag="lnbwd"):
    """The LayerNorm forward's times at the training shape, bf16, warm
    L2 (its input was just written by the op before it): with the
    residual (ln2, 24 calls a step) and without (ln1 and lnf, 25);
    kernel, plain version, F.layer_norm (without the residual's add;
    weight and bias in bf16, since F.layer_norm on the card takes one
    dtype) and the bound. Logs them; returns {tag: (kernel, plain,
    F.layer_norm, bound ms, bound_by)}."""
    from paddle_tpu_torch.incubate.nn.kernels.layernorm import (
        layer_norm_fwd, layer_norm_fwd_reference)

    rng = np.random.RandomState(6)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    w = 1 + 0.1 * t(hidden)
    b = 0.1 * t(hidden)
    x, r = (t(rows, hidden, dtype=torch.bfloat16) for _ in range(2))
    wl, bl = w.bfloat16(), b.bfloat16()
    l_ms, _ = time_ms(lambda: torch.nn.functional.layer_norm(
        x, (hidden,), wl, bl, 1e-5), iters)
    elems = rows * hidden
    out = {}
    for name, res in (("residual", r), ("no residual", None)):
        k_ms, k_host = time_ms(
            lambda: layer_norm_fwd(x, res, w, b, 1e-5), iters)
        p_ms, _ = time_ms(
            lambda: layer_norm_fwd_reference(x, res, w, b, 1e-5),
            max(1, iters // 4))
        # x (, res) read and y (, s) written once; w, b; mean, rstd
        nbytes = (2 + 2 * (res is not None)) * elems * 2 + 2 * hidden * 4 \
            + 2 * rows * 4
        b_ms, b_by = bound_ms(nbytes, 8 * elems)
        lib = f"{l_ms:.5f}" if res is None else "n/a (no residual add)"
        log(tag, f"forward N={rows} H={hidden} bf16 {name}, warm L2, device "
            f"ms: kernel {k_ms:.5f} | plain {p_ms:.5f} | F.layer_norm {lib} "
            f"| bound {b_ms:.5f} ({b_by}, {nbytes} B); host ms per call: "
            f"kernel wrapper {k_host:.5f}")
        out[name] = (k_ms, p_ms, l_ms if res is None else None, b_ms, b_by)
    return out


# -- phase 9 -----------------------------------------------------------
def _train_model(dev, num_layers=24, o2=True, **pp):
    """bench_gpt2's on-chip GPT-2 345M (bench.py:540-545), weights from
    seed 0; bf16 O2 unless `o2` is False; `pp`: GPTConfig's pipeline
    fields."""
    import dataclasses

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt2_345m

    cfg = dataclasses.replace(
        gpt2_345m(max_seq_len=TRAIN_SEQ, dropout=0.0, remat=False,
                  use_flash_attention=True, **pp), num_layers=num_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GPTForCausalLM(cfg, device=dev, generator=gen)
    return amp.decorate(model, level="O2", dtype="bfloat16") if o2 else model


def _train_batch(vocab, dev):
    """bench_gpt2's batch: ids and labels from RandomState(0)."""
    rng = np.random.RandomState(0)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = rng.randint(0, vocab, shape).astype(np.int32)
    labels = rng.randint(0, vocab, shape).astype(np.int32)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)


def _train_launches(n_layers):
    """Launches of the forward and backward kernels in one training
    step of an n-layer GPT (no optimizer kernel, no serving kernel)."""
    return {"flash_attention_fwd": n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers,
            "fused_layer_norm": 2 * n_layers + 1,
            "fused_layer_norm_bwd": 2 * n_layers + 1,
            "paged_attention": 0, "paged_attention_multi": 0,
            "fused_sgd": 0, "fused_momentum": 0, "quantize_i8": 0,
            "dequantize_i8": 0}


def phase_train(dev, smi, model=None, windows=TRAIN_WINDOWS,
                steps=TRAIN_STEPS, warmup=TRAIN_WARMUP):
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    model = model or _train_model(dev)
    cfg = model.config
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStepCompiler(model, opt)
    ids, labels = _train_batch(cfg.vocab_size, dev)
    t0 = time.perf_counter()
    for _ in range(warmup):
        loss = step(ids, labels)
    first = float(loss.item())
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    dts = []
    for _ in range(windows):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(ids, labels)
        last = float(loss.item())         # .item() synchronises
        dts.append((time.perf_counter() - t0) / steps)
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = windows * steps
    n_layers = cfg.num_layers
    # AdamW over the 16 parameters is one fused_adam launch a step: one
    # table holds up to MAX_TENSORS tensors
    per_step = dict(_train_launches(n_layers), fused_adam=1)
    for name, per in per_step.items():
        if counts[name] != per * n_steps:
            raise AssertionError(
                f"train: {name} launched {counts[name]} times in {n_steps} "
                f"steps, expected {per} per step")
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"train: loss did not decrease ({first:.4f} "
                             f"-> {last:.4f})")
    dt = float(np.median(dts))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    mfu = 6 * n_params * tokens / dt / PEAK_BF16_FLOPS
    log("train", f"[{smi}] GPT-2 345M ({n_params} params, {n_layers}L) bf16 "
        f"O2, AdamW multi_precision, B={TRAIN_BATCH} S={TRAIN_SEQ}: loss "
        f"{first:.4f} -> {last:.4f} over {n_steps} steps; step "
        f"{dt * 1e3:.3f} ms (median of {windows} windows of {steps}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in dts) + f") = "
        f"{tokens / dt:.1f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"(6 N tokens); peak memory {peak / 2 ** 30:.2f} GiB; {warmup} "
        f"warm-up steps {warm_s:.2f} s")
    log("train", f"launches over {n_steps} steps: "
        + ", ".join(f"{n} {counts[n]} = {per} x {n_steps}"
                    for n, per in per_step.items()))
    wall, busy, count, top, by = profile_ms(lambda: step(ids, labels),
                                           reps=2, n_top=10)
    if busy is None:
        log("train", f"[{smi}] step wall {wall:.3f} ms; device time not "
            "measured (the profiler saw no device activity)")
    else:
        tops = "; ".join(f"{name} x{n:.0f} {t:.3f} ms"
                         for name, n, t in top)
        log("train", f"[{smi}] where a step goes (torch.profiler, 2 steps):"
            f" wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%), {count:.0f} kernels; top: {tops}")
        opt_ms = sum(ms for name, ms in by.items()
                     if "multi_tensor_optim" in name
                     or "advance_beta_pows" in name)
        log("train", f"[{smi}] optimizer (fused_adam: beta-power kernel + "
            f"multi-tensor kernel) {opt_ms:.3f} ms of the step's "
            f"{busy:.3f} ms device busy ({100 * opt_ms / busy:.2f}%)")
        flash = {k: sum(ms for name, ms in by.items() if k in name)
                 for k in ("fa_fwd_wgmma", "fa_bwd_dq_wgmma",
                           "fa_bwd_dkv_wgmma")}
        log("train", f"[{smi}] flash kernels in the step: " + ", ".join(
            f"{k} {ms:.3f} ms" for k, ms in flash.items()) + f" = "
            f"{sum(flash.values()):.3f} ms of {busy:.3f} ms device busy")
        lnb = {k: sum(ms for name, ms in by.items() if k in name)
               for k in ("ln_bwd_kernel", "ln_bwd_sum")}
        log("train", f"[{smi}] LayerNorm backward in the step "
            f"({per_step['fused_layer_norm_bwd']} wrapper calls): "
            + ", ".join(f"{k} {ms:.3f} ms" for k, ms in lnb.items())
            + f" = {sum(lnb.values()):.3f} ms of {busy:.3f} ms device busy")
        lnf = sum(ms for name, ms in by.items() if "ln_fwd_kernel" in name)
        log("train", f"[{smi}] LayerNorm forward in the step "
            f"({per_step['fused_layer_norm']} wrapper calls): ln_fwd_kernel "
            f"{lnf:.3f} ms of {busy:.3f} ms device busy")
    return model, counts


# -- phase 10 ----------------------------------------------------------
# (loss rtol, per-row tolerance x row max|g|) of one step's loss and
# gradients, kernel path vs plain path. bf16: each bf16 rounding of o,
# y or dx that falls the other way on the two paths (at most one ulp,
# 2^-7) is carried through 24 layers into every gradient; a row whose
# gradient is a sum that cancels (a small row of qkv_w, fc2_w, wte)
# then differs by 2-4% of its own max on an H100 (chip_mutants.py,
# PERF.md), so 8e-2 leaves a factor of 2. This is the end-to-end check;
# the sharp one is phase 7's, per kernel. f32: summation order only
# (online vs one-pass softmax, LN sums), ~3e-6 per row.
GRADS_BF16_TOL = (1e-3, 8e-2)
GRADS_F32_TOL = (1e-6, 1e-4)


def _loss_and_grads(model, ids, labels, use_kernel):
    from paddle_tpu_torch.text.models.gpt import gpt_loss

    c = model.config
    named = list(model.gpt.named_parameters())
    loss = gpt_loss(ids, labels, model.gpt.params_tree(detach=False),
                    c.num_heads, c.layer_norm_eps, use_kernel=use_kernel,
                    use_flash=c.use_flash_attention, remat=c.remat)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def _grads_check(tag, model, ids, labels, loss_rtol, row_tol,
                 loss_and_grads=_loss_and_grads):
    """Loss and every gradient, kernels vs plain versions, from the
    same parameters. Each gradient is held per row (its last axis: one
    output unit of a weight, one token of an embedding, one layer of a
    stacked bias) at row_tol x the row's max|g|. Returns the worst row
    ratio max|err| / row max|g| over all parameters."""
    loss_k, gk = loss_and_grads(model, ids, labels, True)
    loss_p, gp = loss_and_grads(model, ids, labels, False)
    if abs(loss_k - loss_p) > loss_rtol * abs(loss_p):
        raise AssertionError(f"{tag}: loss {loss_k} vs plain {loss_p}")
    if set(gk) != set(gp):
        raise AssertionError(f"{tag}: the two paths give gradients to "
                             f"different parameters")
    worst = (0.0, "")
    for name, want in gp.items():
        got = gk[name]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: non-finite grad {name}")
        _, ratio = assert_close_rows(name, got, want, float("inf"))
        worst = max(worst, (ratio, name))
    if not worst[0] <= row_tol:
        raise AssertionError(
            f"{tag}: grad {worst[1]} row max|err| / row max|g| "
            f"{worst[0]:.3e} over tolerance {row_tol}")
    log("grads", f"{tag}: loss kernel {loss_k:.6f} plain {loss_p:.6f} "
        f"(tol {loss_rtol} rel); worst grad row max|err| / row max|g| "
        f"{worst[0]:.3e} ({worst[1]}); tolerance {row_tol} x row max|g| "
        f"on every row of {len(gp)} parameters")
    return worst[0]


def phase_grads(dev, model, f32_layers=2):
    ids, labels = _train_batch(model.config.vocab_size, dev)
    log("grads", "torch.backends.cuda.matmul."
        "allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        ", allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}; the large products are "
        "the same torch.matmul calls on both paths")
    _grads_check(f"full width {model.config.num_layers}L bf16 O2", model,
                 ids, labels, *GRADS_BF16_TOL)
    small = _train_model(dev, num_layers=f32_layers, o2=False)
    _grads_check(f"full width {f32_layers}L f32", small, ids, labels,
                 *GRADS_F32_TOL)


# -- phase 11 ----------------------------------------------------------
OPTIM_LR = 1e-4          # bench_gpt2's AdamW (phase 9)
OPTIM_WD = 0.01
OPTIM_STEPS = 3
# kernel name -> (optimizer classes it serves, line of the TPU kernel)
OPTIM_KERNELS = {"fused_adam": ("Adam", "48"),
                 "fused_momentum": ("Momentum", "79"),
                 "fused_sgd": ("SGD", "70")}


def decay_filter(name):
    """The recipe's weight-decay filter: no decay for biases and
    LayerNorm parameters."""
    return not (name.endswith("_b") or "ln" in name)


# tag, optimizer, its arguments, and what is done to the parameter set
OPTIM_CASES = [
    ("AdamW, decay filter", "AdamW", dict(
        learning_rate=OPTIM_LR, weight_decay=OPTIM_WD,
        apply_decay_param_fun=decay_filter), {}),
    ("Adam, coupled L2", "Adam", dict(learning_rate=OPTIM_LR,
                                      weight_decay=OPTIM_WD), {}),
    ("SGD, coupled L2", "SGD", dict(learning_rate=0.1,
                                    weight_decay=OPTIM_WD), {}),
    ("Momentum", "Momentum", dict(learning_rate=0.1, momentum=0.9), {}),
    ("Nesterov", "Momentum", dict(learning_rate=0.1, momentum=0.9,
                                  use_nesterov=True), {}),
    ("AdamW, f32 model without masters", "AdamW", dict(
        learning_rate=OPTIM_LR, weight_decay=OPTIM_WD), {"f32": True}),
    ("AdamW, a zero-size tensor", "AdamW", dict(
        learning_rate=OPTIM_LR, weight_decay=OPTIM_WD), {"empty": True}),
    ("AdamW, a parameter without a grad", "AdamW", dict(
        learning_rate=OPTIM_LR, weight_decay=OPTIM_WD),
     {"no_grad": "gpt.blocks.fc1_b"}),
    ("AdamW, set_state_dict after 2 steps, 2 more", "AdamW", dict(
        learning_rate=OPTIM_LR, weight_decay=OPTIM_WD), {"reload": 2}),
]


def _optim_grads(named, dev, steps=OPTIM_STEPS):
    """One gradient per parameter and step, uniform in [-1e-2, 1e-2)
    from numpy seeds (step s, tensor i: seed 1000 s + i; uniform, since
    numpy draws 355M normals a step in ~7 s), in the parameter's dtype
    on the card."""
    out = []
    for s in range(steps):
        grads = {}
        for i, (n, p) in enumerate(named):
            a = np.random.default_rng(1000 * s + i).random(
                tuple(p.shape), dtype=np.float32)
            a -= 0.5
            a *= 2e-2
            grads[n] = torch.from_numpy(a).to(dev, p.dtype)
        out.append(grads)
    return out


def _optim_set(named, f32=False, empty=False):
    out = [(n, torch.nn.Parameter(p.detach().float().clone() if f32
                                  else p.detach().clone()))
           for n, p in named]
    if empty:
        out.append(("gpt.empty", torch.nn.Parameter(torch.zeros(
            0, dtype=named[0][1].dtype, device=named[0][1].device))))
    return out


def _optim_compare(tag, sets, opts):
    """Parameters and every slot of the kernel path (0) and the plain
    path (1), bit for bit; raises with the first difference."""
    for (n, a), (_, b) in zip(*sets):
        if not torch.equal(a, b):
            raise AssertionError(
                f"optim {tag}: parameter {n} differs in "
                f"{int((a != b).sum())} elements, max|err| "
                f"{max_err(a, b):.3e}")
    acc = [o._accumulators for o in opts]
    if {n: set(s) for n, s in acc[0].items()} != {
            n: set(s) for n, s in acc[1].items()}:
        raise AssertionError(f"optim {tag}: the two paths hold other slots")
    for n, slots in acc[0].items():
        for sname, a in slots.items():
            b = acc[1][n][sname]
            if not torch.equal(a, b):
                raise AssertionError(
                    f"optim {tag}: {n}.{sname} differs in "
                    f"{int((a != b).sum())} elements, max|err| "
                    f"{max_err(a, b):.3e}")
    if opts[0]._step_count != opts[1]._step_count:
        raise AssertionError(f"optim {tag}: step counts differ")


def optim_checks(named, grads, cases=OPTIM_CASES):
    """Every case of phase 11: step() through the kernel against step()
    through the per-parameter rule (use_kernel=False), from the same
    parameters and grads, bit for bit after every step; one launch a
    step. Returns {kernel name: max |err|} (0.0: bit-identical)."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.incubate.nn import kernels

    worst = {}
    for tag, cls_name, kw, opts_ in cases:
        cls = getattr(optim, cls_name)
        kernel = next(k for k, (c, _) in OPTIM_KERNELS.items()
                      if issubclass(cls, getattr(optim, c)))
        sets = [_optim_set(named, opts_.get("f32", False),
                           opts_.get("empty", False)) for _ in range(2)]

        def make():
            return [cls(parameters=s, multi_precision=True, use_kernel=u,
                        **kw) for s, u in zip(sets, (True, False))]

        opts = make()
        steps = len(grads) + (1 if "reload" in opts_ else 0)
        for step in range(steps):
            if step == opts_.get("reload"):
                sd = opts[0].state_dict()
                opts = make()
                for o in opts:
                    o.set_state_dict(sd)
                del sd
            g = grads[step % len(grads)]
            for s in sets:
                for n, p in s:
                    if n == opts_.get("no_grad"):
                        p.grad = None
                    elif n == "gpt.empty":
                        p.grad = torch.zeros_like(p)
                    else:
                        p.grad = g[n].to(p.dtype)
            before = kernels.launches()[kernel]
            for o in opts:
                o.step()
            torch.cuda.synchronize()
            if kernels.launches()[kernel] != before + 1:
                raise AssertionError(f"optim {tag}: {kernel} launched "
                                     f"{kernels.launches()[kernel] - before}"
                                     " times in a step")
            _optim_compare(f"{tag}, step {step + 1}", sets, opts)
        if "no_grad" in opts_ and opts_["no_grad"] in opts[0]._accumulators:
            raise AssertionError(f"optim {tag}: slots for a parameter "
                                 "without a grad")
        worst[kernel] = 0.0
        del sets, opts
    return worst


def _optim_lists(named, grads, kernel):
    """The wrapper's lists over the O2 set, with masters and fresh
    slots: (params, grads, masters, slot lists...)."""
    params = [p.detach().clone() for _, p in named]
    masters = [p.float() if p.dtype == torch.bfloat16 else None
               for p in params]
    g = [grads[n] for n, _ in named]
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    if kernel == "fused_sgd":
        return params, g, masters
    if kernel == "fused_momentum":
        return params, g, masters, zeros
    ones = [torch.ones((), device=p.device) for p in params]
    return (params, g, masters, zeros,
            [z.clone() for z in zeros], ones, [o.clone() for o in ones])


def _optim_bytes(named, grads, kernel):
    """Bytes the update must move: each input read once, each output
    written once (the update base read and written, a master's bf16
    parameter written, the grad read, each f32 slot read and
    written)."""
    total = 0
    slots = {"fused_adam": 2, "fused_momentum": 1, "fused_sgd": 0}[kernel]
    for n, p in named:
        e = p.numel()
        base = 4 if p.dtype == torch.bfloat16 else p.element_size()
        total += e * (2 * base + grads[n].element_size() + 8 * slots)
        if p.dtype == torch.bfloat16:
            total += 2 * e                      # the re-derived parameter
    return total


def phase_optim(dev, smi, named, iters=20):
    from paddle_tpu_torch.incubate.nn.kernels import optim as ko

    n_elem = sum(p.numel() for _, p in named)
    t0 = time.perf_counter()
    grads = _optim_grads(named, dev)
    torch.cuda.synchronize()
    n_bf16 = sum(p.dtype == torch.bfloat16 for _, p in named)
    log("optim", f"GPT-2 345M O2 parameter set: {len(named)} tensors, "
        f"{n_elem} elements ({n_bf16} bf16 with f32 masters, the rest f32 "
        f"without); grads for "
        f"{OPTIM_STEPS} steps from numpy in {time.perf_counter() - t0:.1f} s")
    errs = optim_checks(named, grads)
    log("optim", f"kernel path vs per-parameter rule, {len(OPTIM_CASES)} "
        f"cases x {OPTIM_STEPS}+ steps: parameters, masters, moments, "
        "velocities and beta powers bit-identical after every step; one "
        "launch a step")

    # times at the set (chain_ms: each call is milliseconds of device
    # work): the wrapper over the 16 tensors, its plain version, and
    # torch.optim's fused step over f32 copies (another
    # rounding: it multiplies by the bias corrections' reciprocals; and
    # other bytes: f32 grads, no master or bf16 parameter)
    g0 = grads[0]
    lr, wd = OPTIM_LR, OPTIM_WD
    decay = [float(np.float32(1) - np.float32(lr) * np.float32(wd))
             if decay_filter(n) else 1.0 for n, _ in named]
    calls = {
        "fused_adam": (dict(lr=lr, beta1=0.9, beta2=0.999, eps=1e-8,
                            decay=decay), 15),
        "fused_momentum": (dict(lr=0.1, momentum=0.9), 4),
        "fused_sgd": (dict(lr=0.1), 2),
    }
    lib_p = [p.detach().float().clone() for _, p in named]
    for p, (n, _) in zip(lib_p, named):
        p.grad = g0[n].float()
    entries = []
    for kernel, (kw, ops) in calls.items():
        lists = _optim_lists(named, g0, kernel)
        fn = getattr(ko, kernel)
        ref = getattr(ko, kernel + "_reference")
        k_ms, k_host = chain_ms(lambda: fn(*lists, **kw), iters)
        p_ms, p_host = chain_ms(lambda: ref(*lists, **kw),
                                max(1, iters // 4))
        del lists
        if kernel == "fused_adam":
            lib = torch.optim.AdamW(lib_p, lr=lr, weight_decay=wd,
                                    fused=True)
        else:
            lib = torch.optim.SGD(lib_p, lr=0.1, fused=True, momentum=(
                0.9 if kernel == "fused_momentum" else 0.0))
        l_ms, _ = chain_ms(lib.step, iters)
        del lib
        nbytes = _optim_bytes(named, g0, kernel)
        b_ms, b_by = bound_ms(nbytes, ops * n_elem)
        log("optim", f"[{smi}] {kernel}, {len(named)} tensors, {n_elem} "
            f"elements: kernel {k_ms:.5f} ms | plain {p_ms:.5f} ms | "
            f"torch.optim fused {l_ms:.5f} ms | bound {b_ms:.5f} ms "
            f"({b_by}, {nbytes / 1e9:.3f} GB) = {nbytes / k_ms / 1e9:.3f} "
            f"TB/s, {100 * b_ms / k_ms:.1f}% of the bound; host ms per "
            f"call: kernel wrapper {k_host:.5f}, plain {p_host:.5f}")
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/optim.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/optim.py:"
                        + OPTIM_KERNELS[kernel][1],
            "max_abs_err": errs[kernel], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    return entries


# -- phase 12 ----------------------------------------------------------
RECIPE_CALLS = 16        # 8 optimizer steps under accumulate_steps=2
RECIPE_WARMUP, RECIPE_T_MAX, RECIPE_PEAK = 2, 16, 1e-4


def recipe_lr(epoch):
    """The schedule's lr at `epoch`, written out: a linear warm-up from
    0 to the peak, then a cosine from the peak to 0 (LinearWarmup and
    CosineAnnealingDecay's formulas)."""
    if epoch < RECIPE_WARMUP:
        return 0.0 + (RECIPE_PEAK - 0.0) * epoch / RECIPE_WARMUP
    t = epoch - RECIPE_WARMUP
    return 0 + (RECIPE_PEAK - 0) * (1 + math.cos(math.pi * t
                                                 / RECIPE_T_MAX)) / 2


def _run_calls(tag, step, ids, labels, per_call, calls, sched=None,
               opt=None):
    """`calls` train-step calls; each call's launches held to
    per_call(i), the lr to the written-out schedule; returns (losses,
    wall seconds per call)."""
    from paddle_tpu_torch.incubate.nn import kernels

    losses, dts = [], []
    for i in range(calls):
        if sched is not None and opt.get_lr() != recipe_lr(i):
            raise AssertionError(f"{tag}: call {i} lr {opt.get_lr()} is "
                                 f"not the schedule's {recipe_lr(i)}")
        before = kernels.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        losses.append(float(loss.item()))
        dts.append(time.perf_counter() - t0)
        if sched is not None:
            sched.step()
        got = {k: v - before[k] for k, v in kernels.launches().items()}
        want = per_call(i)
        if got != want:
            raise AssertionError(f"{tag}: call {i} launched {got}, expected "
                                 f"{want}")
        if step.last_skips:
            raise AssertionError(f"{tag}: call {i} skipped a non-finite "
                                 "step")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    return losses, dts


def phase_recipe(dev, smi, calls=RECIPE_CALLS, small_layers=4,
                 small_steps=6):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum, lr

    model = _train_model(dev)
    cfg = model.config
    n_layers = cfg.num_layers
    ids, labels = _train_batch(cfg.vocab_size, dev)
    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(RECIPE_PEAK, T_max=RECIPE_T_MAX),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=OPTIM_WD, multi_precision=True,
                grad_clip=nn.ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=decay_filter)
    step = TrainStepCompiler(model, opt, accumulate_steps=2,
                             guard_nonfinite=True)
    fwd = _train_launches(n_layers)
    kernels.reset_launches()
    losses, dts = _run_calls(
        "recipe", step, ids, labels,
        lambda i: dict(fwd, fused_adam=i % 2), calls, sched, opt)
    counts = kernels.launches()
    lrs = [recipe_lr(i) for i in range(calls)]
    log("recipe", f"[{smi}] GPT-2 345M {n_layers}L bf16 O2, AdamW (wd "
        f"{OPTIM_WD}, decay filter) + ClipGradByGlobalNorm(1.0) + "
        f"LinearWarmup({RECIPE_WARMUP}) over CosineAnnealingDecay("
        f"{RECIPE_PEAK}, T_max={RECIPE_T_MAX}), accumulate_steps=2, "
        f"guard_nonfinite, B={TRAIN_BATCH} S={TRAIN_SEQ}: {calls} calls, "
        f"{opt._step_count} optimizer steps; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; lr at the apply calls "
        + ", ".join(f"{lrs[i]:.3e}" for i in range(1, calls, 2))
        + f"; median call {1e3 * float(np.median(dts)):.3f} ms (apply "
        f"calls {1e3 * float(np.median(dts[1::2])):.3f}, merge-only "
        f"{1e3 * float(np.median(dts[0::2])):.3f}); last_skips 0")
    log("recipe", "launches over the calls (exact per call): "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    log("recipe", "losses " + " ".join(f"{x:.4f}" for x in losses))
    del model, opt, step
    torch.cuda.empty_cache()

    small = dict(_train_launches(small_layers))
    runs = {"fused_momentum": lambda params: Momentum(
                0.1, momentum=0.9, parameters=params, use_nesterov=True,
                multi_precision=True),
            "fused_sgd": lambda params: SGD(1.0, parameters=params,
                                            multi_precision=True)}
    for kernel, make in runs.items():
        model = _train_model(dev, num_layers=small_layers)
        step = TrainStepCompiler(model, make(model.named_parameters()))
        kernels.reset_launches()
        losses, dts = _run_calls(
            kernel, step, ids, labels, lambda i: dict(small, fused_adam=0,
                                                      **{kernel: 1}),
            small_steps)
        counts[kernel] = kernels.launches()[kernel]
        log("recipe", f"[{smi}] {kernel}: GPT-2 345M width, {small_layers}L "
            f"bf16 O2, {type(step._opt).__name__} ({kernel}), "
            f"{small_steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f};"
            f" median step {1e3 * float(np.median(dts)):.3f} ms; {kernel} "
            f"launches {counts[kernel]} = 1 x {small_steps}")
        del model, step
    return counts


# -- phase 13 ----------------------------------------------------------
def _multi_inputs(rng, lens, t, h, d, bs, maxb, dtype, dev, null_slots=()):
    """Phase 3's pools, tables and contexts, a [B, T, H, D] query, and
    the tables one NULL column wider, as the speculative path passes
    them."""
    _, kp, vp, bt, cl = _paged_inputs(rng, lens, h, d, bs, maxb, dtype,
                                      dev, null_slots)
    q = torch.from_numpy(rng.randn(len(lens), t, h, d).astype(np.float32))
    wide = torch.cat([bt, torch.zeros_like(bt[:, :1])], dim=1).contiguous()
    return q.to(dev, dtype), kp, vp, wide, cl


def _multi_poison(kp, vp, tables, lens, bs, n):
    """The pools with NaN at every position at or past each sequence's
    ctx0 + n (clamped to the table), and in every block no table maps:
    all that slot n does not read (n = T - 1: all that no slot reads)."""
    live = np.zeros(kp.shape[:2], bool)
    t_np, l_np = tables.cpu().numpy(), lens.cpu().numpy()
    cap = t_np.shape[1] * bs
    for b in range(len(l_np)):
        pos = np.arange(min(int(l_np[b]) + n, cap))
        live[t_np[b, pos // bs], pos % bs] = True
    live = torch.from_numpy(live).to(kp.device)[:, :, None, None]
    nan = torch.full_like(kp, float("nan"))
    return torch.where(live, kp, nan), torch.where(live, vp, nan)


def _multi_live(lens, t, cap):
    """(rows the deepest slot reads, scores all slots compute) of a
    verify window: per sequence min(ctx0 + T - 1, cap) rows, and
    sum_t min(ctx0 + t, cap) scores."""
    rows = sum(min(int(c) + t - 1, cap) for c in lens)
    scores = sum(min(int(c) + s, cap) for c in lens for s in range(t))
    return rows, scores


def multi_checks(dev, h=16, d=64, bs=16, maxb=64):
    """Phase 13's checks: the multi-query kernel against its plain
    version (T 1/2/4/8; H16 D64 and H8 D128; f32 and bf16; phase 3's
    contexts and contexts whose deepest slot ends at the table's last
    real column; the NULL column appended), each case also with NaN at
    every position past slot s's context, for each s (slot s
    bit-identical), and slot t against the decode wrapper, the kernel's
    one-slot launch, at context + t (reported). Raises on a failure;
    returns ({dtype: max|err|}, {dtype: (max slot diff, slots
    bit-identical, slots)}, cases)."""
    from paddle_tpu_torch.incubate.nn.kernels.paged_attention import (
        paged_attention, paged_attention_multi,
        paged_attention_multi_reference)

    rng = np.random.RandomState(13)
    top = maxb * bs
    serve_ctx = tuple(min(top, n + SERVE_NEW_TOKENS // 2)
                      for n in SERVE_LENS)
    base_cases = {
        "single": (1,) * 8,
        "block_edges": tuple(min(top, bs * k)
                             for k in (1, 2, 3, 4, 8, 16, 32, maxb)),
        "edges_pm1": (1, bs - 1, bs, bs + 1, 2 * bs - 1, 2 * bs + 1,
                      top - 1, top),
        "odd": tuple(min(top, x) for x in (37, 3, 23, 15, 501, 777, 129,
                                           999)),
        "serve": serve_ctx,
    }

    # phase 3's tolerances: f32 summation order; bf16 about one ulp
    def tol(dtype, ref):
        if dtype == torch.float32:
            return 1e-5, 1e-5
        return 1e-2 * float(ref.float().abs().max()), 1e-2

    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    slots = {torch.float32: [0.0, 0, 0], torch.bfloat16: [0.0, 0, 0]}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for hh, dd in ((h, d), (8, 128)):
            scale = dd ** -0.5
            for t in (1, 2, 4, 8):
                # the deepest slot's context ends at the last real
                # column: the NULL column is what lies past it
                cases = dict(base_cases, table_end=tuple(
                    max(1, top - t + 1 - k) for k in range(8)))
                for name, lens in cases.items():
                    nulls = (7,) if name == "serve" else ()
                    q, kp, vp, wt, cl = _multi_inputs(
                        rng, lens, t, hh, dd, bs, maxb, dtype, dev, nulls)
                    tag = f"multi {name} T={t} H={hh} D={dd} {dtype}"
                    out = paged_attention_multi(q, kp, vp, wt, cl, scale)
                    ref = paged_attention_multi_reference(q, kp, vp, wt, cl,
                                                          scale)
                    if out.dtype != dtype or out.shape != q.shape:
                        raise AssertionError(f"{tag}: {out.dtype} "
                                             f"{tuple(out.shape)}")
                    e = assert_close(tag, out, ref, *tol(dtype, ref))
                    err[dtype] = max(err[dtype], e)
                    n_cases += 1
                    # slot s reads nothing at or past ctx0 + s: NaN there
                    # leaves slot s bit-identical (a row skipped, not
                    # weighted by zero), and at s = T - 1 the whole output
                    for s in range(t):
                        pk, pv = _multi_poison(kp, vp, wt, cl, bs, s)
                        out2 = paged_attention_multi(q, pk, pv, wt, cl,
                                                     scale)
                        if not torch.equal(out[:, s], out2[:, s]):
                            raise AssertionError(
                                f"{tag}: NaN past slot {s}'s context "
                                f"changed slot {s}")
                    if not torch.equal(out, out2):
                        raise AssertionError(f"{tag}: poison changed the "
                                             "output")
                    # slot t against the decode kernel at context + t
                    for s in range(t):
                        one = paged_attention(q[:, s].contiguous(), kp, vp,
                                              wt, cl + s, scale)
                        st = slots[dtype]
                        st[0] = max(st[0], max_err(out[:, s], one))
                        st[1] += int(torch.equal(out[:, s], one))
                        st[2] += 1
    return err, {k: tuple(v) for k, v in slots.items()}, n_cases


def phase_multi(dev, h=16, d=64, bs=16, maxb=64, iters=100):
    err, slots, n_cases = multi_checks(dev, h, d, bs, maxb)
    log("multi", f"kernel vs plain over {n_cases} cases (T 1/2/4/8; H16 D64 "
        f"and H8 D128; f32 and bf16; 6 context sets; NULL column "
        f"appended): max|err| f32 {err[torch.float32]:.3e} (tol 1e-5 abs + "
        f"1e-5 rel), bf16 {err[torch.bfloat16]:.3e} (tol 1e-2 x max|ref| abs"
        " + 1e-2 rel); per-slot NaN poison check (NaN past slot s's "
        "context, slot s unchanged) bit-identical in every case")
    log("multi", "slot t vs the decode wrapper (one-slot launch) at context +"
        " t (reported, not gated): " + "; ".join(
            f"{dt}: {n_eq}/{n} slots bit-identical, max|diff| {e:.3e}"
            for dt, (e, n_eq, n) in slots.items()))

    k_ms, p_ms, l_ms, b_ms, b_by = multi_times(dev, h, d, bs, maxb, iters)
    return {"name": "paged_attention_multi", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/paged_attention.py:187",
            "max_abs_err": err[torch.float32], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}


def multi_times(dev, h=16, d=64, bs=16, maxb=64, iters=100, tag="multi"):
    """Phase 13's times at the serving verify shape: B 8, T 4, f32,
    serve contexts, one inactive slot (context 1), tables 65 columns
    wide, L2 flushed before each launch: the kernel, its plain version,
    SDPA with a per-slot mask on K/V gathered beforehand, and the
    bound. Logs them; returns (kernel, plain, SDPA, bound ms,
    bound_by)."""
    from paddle_tpu_torch.incubate.nn.kernels.paged_attention import (
        paged_attention_multi, paged_attention_multi_reference)

    rng = np.random.RandomState(14)
    serve_ctx = tuple(min(maxb * bs, n + SERVE_NEW_TOKENS // 2)
                      for n in SERVE_LENS)
    t = 4
    scale = d ** -0.5
    q, kp, vp, wt, cl = _multi_inputs(rng, serve_ctx, t, h, d, bs, maxb,
                                      torch.float32, dev, (7,))
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    k_ms, k_host = time_ms(
        lambda: paged_attention_multi(q, kp, vp, wt, cl, scale), iters,
        flush)
    p_ms, p_host = time_ms(
        lambda: paged_attention_multi_reference(q, kp, vp, wt, cl, scale),
        max(1, iters // 5), flush)
    # library yardstick: SDPA over K/V gathered beforehand (the gather
    # not timed), a per-slot [B, 1, T, S] mask
    b = len(serve_ctx)
    s_len = wt.shape[1] * bs
    tables = wt.long()
    kg = kp[tables].reshape(b, s_len, h, d).transpose(1, 2).contiguous()
    vg = vp[tables].reshape(b, s_len, h, d).transpose(1, 2).contiguous()
    ctx = cl.long()[:, None] + torch.arange(t, device=dev)[None, :]
    mask = (torch.arange(s_len, device=dev)[None, None, :]
            < ctx[:, :, None])[:, None]
    q4 = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms, _ = time_ms(
        lambda: sdpa(q4, kg, vg, attn_mask=mask, scale=scale), iters, flush)
    rows, scores = _multi_live(cl.tolist(), t, s_len)
    nbytes = (2 * q.numel() * 4 + 2 * rows * h * d * 4 + wt.numel() * 4
              + cl.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * h * d * scores)
    log(tag, f"B={b} T={t} H={h} D={d} BS={bs} ctx0={tuple(cl.tolist())}"
        f" f32, tables {tuple(wt.shape)}, cold L2, device ms: kernel "
        f"{k_ms:.5f} | plain {p_ms:.5f} | sdpa {l_ms:.5f} | bound {b_ms:.5f} "
        f"({b_by}, {nbytes} B, {4 * h * d * scores} FLOP); host ms per call:"
        f" kernel wrapper {k_host:.5f}, plain {p_host:.5f}")
    return k_ms, p_ms, l_ms, b_ms, b_by


# -- phase 14 ----------------------------------------------------------
SPEC_K = 4
SPEC_BLOCKS = 512        # pool for phases 14-15: the traffic without
                         # evictions, with the draft's twin pools beside


def near_tie(model, dev, ctx, tokens, limit_rel=1e-3):
    """The two paths' logits for the output right after `ctx` (whose
    last token is pending): a decode step (the k=1 path) and slot 0 of
    a verify dispatch (the speculative path, `tokens` in slots 1..),
    each from ctx[:-1] prefilled into the same pools, one live slot of
    a B = max_batch dispatch. Returns (max|dlogits|, limit, top-2 of
    each path as ((token, logit), (token, logit)), top-2 gap)."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.inference.serving import model_runner as mr

    cfg = model.config
    eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH, num_blocks=SPEC_BLOCKS,
                    device=dev)
    kw = dict(n_head=cfg.num_heads, eps=cfg.layer_norm_eps,
              block_size=eng.block_size)
    n = len(ctx)
    eng.cache.allocator.alloc("probe", eng.cache.blocks_for_tokens(
        n + len(tokens)))
    table = eng.cache.block_table("probe", eng.max_blocks_per_seq)
    padded = eng.cache.blocks_for_tokens(n - 1) * eng.block_size
    ids = np.zeros((1, padded), np.int32)
    ids[0, :n - 1] = ctx[:-1]
    mr.prefill_step(eng.params, torch.from_numpy(ids).to(dev), n - 1,
                    eng.cache.k, eng.cache.v, torch.from_numpy(table).to(dev),
                    0.0, 0, 0, **kw)
    b = SERVE_MAX_BATCH
    tables = np.zeros((b, eng.max_blocks_per_seq + 1), np.int32)
    tables[0, :-1] = table
    lens = np.ones((b,), np.int32)
    lens[0] = n
    pos = lens - 1
    dec_ids = np.zeros((b,), np.int32)
    dec_ids[0] = ctx[-1]
    ver_ids = np.zeros((b, 1 + len(tokens)), np.int32)
    ver_ids[0] = [ctx[-1]] + list(tokens)

    def t(a):
        return torch.from_numpy(a).to(dev)

    k2, v2 = eng.cache.k.clone(), eng.cache.v.clone()
    one = mr.decode_logits(eng.params, t(dec_ids), t(pos), eng.cache.k,
                           eng.cache.v, t(tables), t(lens), **kw)[0]
    ver = mr.verify_logits(eng.params, t(ver_ids), t(pos), k2, v2,
                           t(tables), t(lens), **kw)[0, 0]
    limit = limit_rel * float(one.abs().max())
    tops = []
    for row in (one, ver):
        val, idx = row.float().topk(2)
        tops.append(tuple((int(i), float(v)) for i, v in zip(idx, val)))
    gap = max(tp[0][1] - tp[1][1] for tp in tops)
    del eng, k2, v2
    return max_err(one, ver), limit, tops, gap


def _spec_gate(tag, model, dev, prompts, want, got):
    """Gate 1: token identity to the k=1 engine, request by request. A
    divergence passes only where the two paths' logits agree within
    phase 6's limit AND the top-2 gap there is below it (a near-tie,
    shown, not assumed). Returns the near-ties found."""
    ties = []
    for r, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        p = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b),
                 min(len(w), len(g)))
        ctx = prompts[r] + w[:p]
        d, limit, tops, gap = near_tie(model, dev, ctx, g[p:p + SPEC_K - 1])
        log("spec", f"{tag}: request {r} diverges at output {p} (k=1 "
            f"{w[p:p + 4]}, spec {g[p:p + 4]}); top-2 there, decode path "
            f"{tops[0]}, verify path {tops[1]}; max|dlogits| {d:.3e}, top-2 "
            f"gap {gap:.3e}, limit {limit:.3e}")
        if not (d <= limit and gap < limit):
            raise AssertionError(f"{tag}: request {r} diverges at output {p}"
                                 " and it is not a near-tie")
        ties.append((r, p))
    return ties


def _spec_setup(model, dev, lens=SERVE_LENS, **kw):
    """An engine with phase 5's 8 prompts admitted and prefilled and
    room for a speculative window: the state one round starts from."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH, num_blocks=SPEC_BLOCKS,
                    device=dev, **kw)
    for p in _serve_prompts(model.config.vocab_size, lens):
        eng.add_request(p, SamplingParams(max_new_tokens=SERVE_NEW_TOKENS))
    eng.scheduler.schedule(
        on_admit=lambda r: eng._emit(r, eng._prefill(r), {}))
    for req in list(eng.scheduler.running.values()):
        eng.scheduler.ensure_capacity(req, new_tokens=SPEC_K)
    return eng


def spec_logits_check(model, dev, k=SPEC_K):
    """Gate 2: one verify dispatch's logits, slot by slot, against k
    sequential decode_logits calls on the same prefilled pools (the
    decodes feed the verify's slot tokens one at a time), kernel paths
    both; and the K/V each writes. Returns (max|dlogits|, limit)."""
    from paddle_tpu_torch.inference.serving import model_runner as mr

    cfg = model.config
    eng = _spec_setup(model, dev, spec_k=k)
    ids, pos, tables, lens, _, _, _ = eng._batch_arrays()
    wide = eng._wide_tables(tables)
    kw = dict(n_head=cfg.num_heads, eps=cfg.layer_norm_eps,
              block_size=eng.block_size)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    live = sorted(eng.scheduler.running)
    k_seq, v_seq = eng.cache.k.clone(), eng.cache.v.clone()
    v_ids = np.zeros((len(ids), k), np.int32)
    v_ids[:, 0] = ids
    dec = []
    for j in range(k):
        lg = mr.decode_logits(eng.params, t(v_ids[:, j]), t(pos + j), k_seq,
                              v_seq, t(wide), t(lens + j), **kw)
        dec.append(lg)
        if j + 1 < k:                   # the greedy continuation
            v_ids[:, j + 1] = lg.argmax(-1).cpu().numpy()
    ver = mr.verify_logits(eng.params, t(v_ids), t(pos), eng.cache.k,
                           eng.cache.v, t(wide), t(lens), **kw)
    dec = torch.stack(dec, dim=1)
    if not bool(torch.isfinite(ver[live]).all()):
        raise AssertionError("spec logits: non-finite verify logits")
    scale = float(dec[live].abs().max())
    err = max_err(ver[live], dec[live])
    limit = 1e-3 * scale
    if err > limit:
        raise AssertionError(f"spec logits: verify vs sequential decodes "
                             f"max|dlogits| {err:.3e} > {limit:.3e}")
    # the K/V both wrote at the window's positions (held on the live
    # slots; inactive slots write into the NULL block), and nothing else
    def window(slots):
        p = (pos[slots][:, None] + np.arange(k)[None, :]).reshape(-1)
        blk = wide[np.repeat(slots, k), p // eng.block_size]
        return (torch.from_numpy(blk).long().to(dev),
                torch.from_numpy(p % eng.block_size).long().to(dev))

    blk, off = window(np.asarray(live))
    all_blk, all_off = window(np.arange(len(ids)))
    kv_err = 0.0
    for name, pv, ps in (("k", eng.cache.k, k_seq), ("v", eng.cache.v, v_seq)):
        e = max_err(pv[:, blk, off], ps[:, blk, off])
        if e > 1e-4 * float(ps[:, blk, off].abs().max()):
            raise AssertionError(f"spec written {name}: max|err| {e:.3e}")
        kv_err = max(kv_err, e)
        pv[:, all_blk, all_off] = ps[:, all_blk, all_off]
        if not torch.equal(pv, ps):
            raise AssertionError(f"spec {name} pool changed off the window")
    agree = int((ver[live].argmax(-1) == dec[live].argmax(-1)).sum())
    log("spec", f"one verify dispatch (B={len(ids)}, k={k}) vs {k} "
        f"sequential decodes on the same pools: max|dlogits| {err:.3e} (tol "
        f"1e-3 x max|logits| = {limit:.3e}); written K/V max|err| "
        f"{kv_err:.3e}, rest of pools identical; argmax agrees on "
        f"{agree}/{len(live) * k} slots (reported, not gated)")
    del eng, k_seq, v_seq
    return err, limit


def _spec_round_profile(model, dev, draft_layers=None):
    """Where one speculative round's time goes: draft proposals + one
    verify dispatch on a fixed state (every write lands on the same
    positions each time)."""
    eng = _spec_setup(model, dev, spec_k=SPEC_K, draft_layers=draft_layers)
    arrays = eng._batch_arrays()
    wide = eng._to_device(eng._wide_tables(arrays[2]))
    running = dict(eng.scheduler.running)

    def one_round():
        drafts = eng._draft_propose(running, wide, arrays)
        eng._dispatch_verify(running, drafts, wide, arrays)

    out = profile_ms(one_round, n_top=6)
    del eng
    return out


def phase_spec(dev, model, smi, want, base_stats, lens=SERVE_LENS,
               new_tokens=SERVE_NEW_TOKENS, k=SPEC_K):
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    cfg = model.config
    n_layers = cfg.num_layers
    prompts = _serve_prompts(cfg.vocab_size, lens)
    sampling = SamplingParams(max_new_tokens=new_tokens)
    keys = ("serve/prefills", "serve/decode_dispatches", "serve/tokens",
            "serve/evictions", "serve/spec/proposed", "serve/spec/accepted",
            "serve/prefill_us", "serve/decode_us")
    counts_main = None
    for tag, draft in (("default draft", None), ("draft = target", n_layers)):
        def run():
            eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH,
                            num_blocks=SPEC_BLOCKS, device=dev, spec_k=k,
                            draft_layers=draft)
            ids = [eng.add_request(p, sampling=sampling) for p in prompts]
            t0 = time.perf_counter()
            while eng.has_unfinished():
                eng.step()
            torch.cuda.synchronize()
            return eng, ids, time.perf_counter() - t0

        run()                           # warm-up pass, same traffic
        before = {key: cmon.stat_get(key) for key in keys}
        kernels.reset_launches()
        eng, ids, dt = run()
        counts = kernels.launches()
        delta = {key: cmon.stat_get(key) - before[key] for key in keys}
        reqs = [eng.get_request(i) for i in ids]
        outs = [r.output_ids for r in reqs]
        n_draft = eng.draft_layers
        if eng.check_drained() != {} or eng.cache.allocator.used_blocks:
            raise AssertionError(f"spec {tag}: KV blocks leaked")
        ties = _spec_gate(f"spec {tag}", model, dev, prompts, want, outs)
        if not ties and [len(o) for o in outs] != [new_tokens] * len(prompts):
            raise AssertionError(f"spec {tag}: output lengths")
        rounds = delta["serve/decode_dispatches"]
        n_pre = delta["serve/prefills"]
        expect = {
            "paged_attention_multi": n_layers * rounds,
            "paged_attention": n_draft * k * rounds,
            "fused_layer_norm": (2 * n_layers + 1) * (n_pre + rounds)
            + (2 * n_draft + 1) * (n_pre + k * rounds),
        }
        for name, n in expect.items():
            if counts[name] != n or rounds < 1:
                raise AssertionError(f"spec {tag}: {name} launched "
                                     f"{counts[name]} times, expected {n} "
                                     f"({rounds} rounds, {n_pre} prefills)")
        if any(v for name, v in counts.items() if name not in expect):
            raise AssertionError(f"spec {tag}: other kernels launched: "
                                 f"{counts}")
        gaps = [b - a for r in reqs
                for a, b in zip(r.token_times, r.token_times[1:])]
        total = sum(len(o) for o in outs)
        prop = delta["serve/spec/proposed"]
        acc = delta["serve/spec/accepted"]
        log("spec", f"[{smi}] {tag} ({n_draft} layers), k={k}: {total} "
            f"tokens in {dt:.3f} s = {total / dt:.1f} tokens/s (k=1: "
            f"{base_stats['tokens_s']:.1f}) | ITL p50 "
            f"{quantile_ms(gaps, 0.5):.3f} ms p99 "
            f"{quantile_ms(gaps, 0.99):.3f} ms (k=1: "
            f"{base_stats['itl_p50']:.3f} / {base_stats['itl_p99']:.3f}) | "
            f"accepted {acc}/{prop} proposals ({100 * acc / max(1, prop):.1f}"
            f"%), {total / max(1, rounds * len(prompts)):.2f} tokens per "
            f"request-round | {rounds} rounds "
            f"({delta['serve/decode_us'] / 1e3 / rounds:.3f} ms each), "
            f"{n_pre} prefills | tokens "
            + ("equal phase 5's" if not ties else f"near-ties at {ties}"))
        log("spec", f"{tag} launches: {counts} = {n_layers} x {rounds} multi,"
            f" {n_draft} x {k} x {rounds} paged, LN {expect['fused_layer_norm']}"
            "; drained, 0 blocks used")
        if counts_main is None:
            counts_main = counts
        del eng
    spec_logits_check(model, dev, k)
    for tag, draft in (("default draft", None), ("draft = target", n_layers)):
        wall, busy, count, top, by = _spec_round_profile(model, dev, draft)
        if busy is None:
            log("spec", f"one round, {tag}: wall {wall:.3f} ms; device time "
                "not measured (the profiler saw no device activity)")
            continue
        decode, multi = _paged_ms(by)
        tops = "; ".join(f"{name} x{n:.0f} {ms:.4f} ms" for name, n, ms in top)
        log("spec", f"[{smi}] where one round goes (B=8, k={k}, {tag}): wall "
            f"{wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%), {count:.0f} kernels; multi kernel "
            f"{multi:.4f} ms, decode kernel {decode:.4f} ms; top: {tops}")
    return counts_main


# -- phase 15 ----------------------------------------------------------
PREFIX_TOKENS = 256      # 16 blocks of 16
PREFIX_TIGHT_BLOCKS = 64  # forces evictions in the everything-on run


def _prefill_profiles(model, dev, prompts):
    """Where the prefills of the prefix-cache hits go, each request's
    tail-only prefill against its whole-context prefill on the same
    state: every prompt admitted and prefilled in order (the first
    publishes the prefix, the others hit), then, for each hit, both
    prefills of its prompt profiled (their writes land on the same
    positions each time). Returns [(prompt length, cached tokens, tail
    profile_ms, full profile_ms)] per hit."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.inference.serving import model_runner as mr

    eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH, num_blocks=SPEC_BLOCKS,
                    device=dev, prefix_cache=True)
    ids = [eng.add_request(p, SamplingParams(max_new_tokens=SERVE_NEW_TOKENS))
           for p in prompts]
    eng.scheduler.schedule(
        on_admit=lambda r: eng._emit(r, eng._prefill(r), {}))
    kw = eng._fwd_kwargs()
    out = []
    for i in ids:
        req = eng.get_request(i)
        cached, plen = req.cached_tokens, len(req.prompt_ids)
        if not cached:
            continue
        padded = eng.cache.blocks_for_tokens(plen) * eng.block_size
        full = np.zeros((1, padded), np.int32)
        full[0, :plen] = req.prompt_ids
        full_t, tail_t = eng._to_device(full), eng._to_device(
            np.ascontiguousarray(full[:, cached:]))
        table = eng._to_device(eng.cache.block_table(
            i, eng.max_blocks_per_seq))
        pools = (eng.cache.k, eng.cache.v, table, 0.0, 0, 0)
        tail = profile_ms(lambda: mr.prefill_tail_step(
            eng.params, tail_t, cached, plen, *pools, **kw), n_top=3)
        whole = profile_ms(lambda: mr.prefill_step(
            eng.params, full_t, plen, *pools, **kw), n_top=3)
        out.append((plen, cached, tail, whole))
    del eng
    return out


def phase_prefix(dev, model, smi, lens=SERVE_LENS,
                 new_tokens=SERVE_NEW_TOKENS):
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    cfg = model.config
    rng = np.random.RandomState(15)
    prefix = list(rng.randint(1, cfg.vocab_size, PREFIX_TOKENS))
    prompts = [prefix + tail for tail in _serve_prompts(cfg.vocab_size, lens)]
    sampling = SamplingParams(max_new_tokens=new_tokens)
    names = ("serve/prefix/hits", "serve/prefix/blocks_shared",
             "serve/prefix/prefill_tokens_saved", "serve/prefill_us",
             "serve/prefills", "serve/evictions")

    def run(**kw):
        kw.setdefault("num_blocks", SPEC_BLOCKS)
        eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH, device=dev, **kw)
        before = {n: cmon.stat_get(n) for n in names}
        t0 = time.perf_counter()
        outs = eng.generate(prompts, sampling=sampling)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        delta = {n: cmon.stat_get(n) - before[n] for n in names}
        if eng.check_drained() != {} or eng.cache.allocator.used_blocks:
            raise AssertionError(f"prefix {kw}: KV blocks leaked")
        del eng
        return outs, delta, dt

    run(prefix_cache=True)              # warm-up pass
    want, d_off, t_off = run()
    got, d_on, t_on = run(prefix_cache=True)
    if got != want:
        bad = [r for r, (a, b) in enumerate(zip(want, got)) if a != b]
        raise AssertionError(f"prefix: tokens differ from the cache-off "
                             f"engine for requests {bad}")
    n_blocks = PREFIX_TOKENS // 16
    expect = {"serve/prefix/hits": len(prompts) - 1,
              "serve/prefix/blocks_shared": (len(prompts) - 1) * n_blocks,
              "serve/prefix/prefill_tokens_saved":
                  (len(prompts) - 1) * PREFIX_TOKENS}
    for n, v in expect.items():
        if d_on[n] != v:
            raise AssertionError(f"prefix: {n} {d_on[n]}, expected {v}")
    log("prefix", f"[{smi}] {len(prompts)} requests, a {PREFIX_TOKENS}-token "
        f"shared prefix + tails {tuple(lens)}, {new_tokens} greedy tokens "
        f"each: tokens equal the cache-off engine's; hits "
        f"{d_on['serve/prefix/hits']}, blocks shared "
        f"{d_on['serve/prefix/blocks_shared']}, prefill tokens saved "
        f"{d_on['serve/prefix/prefill_tokens_saved']}; prefill ms "
        f"{d_on['serve/prefill_us'] / 1e3:.3f} with the cache vs "
        f"{d_off['serve/prefill_us'] / 1e3:.3f} without ({d_on['serve/prefills']}"
        f" prefills each); generate {t_on:.3f} s vs {t_off:.3f} s")

    prof = _prefill_profiles(model, dev, prompts)
    if len(prof) != len(prompts) - 1:
        raise AssertionError(f"prefix profile: {len(prof)} hits")
    tot = {}
    for _, _, tail, whole in prof:
        for key, p in (("tail", tail), ("full", whole)):
            w, b = tot.get(key, (0.0, 0.0))
            tot[key] = (w + p[0], None if b is None or p[1] is None
                        else b + p[1])
    busy = {key: "not measured" if b is None else f"{b:.3f} ms"
            for key, (_, b) in tot.items()}
    plen, cached, tail, whole = max(prof, key=lambda r: r[0])
    tops = {key: "; ".join(f"{n} x{c:.0f} {ms:.4f} ms" for n, c, ms in p[3])
            for key, p in (("tail", tail), ("full", whole))}
    log("prefix", f"[{smi}] the {len(prof)} hits' prefills, profiled on one "
        f"state (wall synchronised / device busy, summed): tail-only "
        f"{tot['tail'][0]:.3f} ms / {busy['tail']} vs whole context "
        f"{tot['full'][0]:.3f} ms / {busy['full']}; longest ({plen} tokens,"
        f" {cached} cached): tail {tail[0]:.3f} ms wall, top: {tops['tail']}"
        f" | whole {whole[0]:.3f} ms wall, top: {tops['full']}")

    got, d_all, t_all = run(spec_k=SPEC_K, prefix_cache=True,
                            num_blocks=PREFIX_TIGHT_BLOCKS)
    if got != want:
        bad = [r for r, (a, b) in enumerate(zip(want, got)) if a != b]
        _spec_gate("prefix everything-on", model, dev, prompts, want, got)
        log("prefix", f"everything-on: requests {bad} differ at near-ties")
    if d_all["serve/evictions"] < 1:
        raise AssertionError("prefix everything-on: no eviction; the pool "
                             "was not tight")
    log("prefix", f"[{smi}] everything on (spec_k={SPEC_K}, prefix cache, "
        f"{PREFIX_TIGHT_BLOCKS} blocks): tokens equal k=1 cache-off; "
        f"evictions {d_all['serve/evictions']}, prefills "
        f"{d_all['serve/prefills']}, hits {d_all['serve/prefix/hits']}; "
        f"drained, 0 leaks, 0 blocks used; {t_all:.3f} s")


# -- phase 25 ----------------------------------------------------------
ROUTER_BLOCKS = 512      # each replica's pool: equal and explicit, since
#                          the auto size takes 45% of the free memory at
#                          each engine's construction
ROUTER_HEARTBEAT_S = 1.0  # the wedge run's heartbeat timeout
ROUTER_WAIT_S = 120


def _count_dispatches(router):
    """Wrap every replica engine's `_decode_batch` with a per-replica
    call count (the phase's own wrapper, as the CPU tests wrap it);
    returns {replica index: [calls]}."""
    calls = {}
    for rep in router._replicas:
        real, n = rep.engine._decode_batch, [0]

        def wrapped(emitted, _real=real, _n=n):
            _n[0] += 1
            return _real(emitted)

        rep.engine._decode_batch = wrapped
        calls[rep.idx] = n
    return calls


def _fault_after(engines, n, attr, action):
    """Wrap `attr` of each engine so that the (n+1)-th call over all of
    them runs `action(engine)` first: a raise (a crash) or a sleep (a
    wedge). Returns [(engine, perf_counter at the fault)]."""
    import threading

    lock, calls, fired = threading.Lock(), [0], []
    for eng in engines:
        real = getattr(eng, attr)

        def wrapped(arg, _real=real, _eng=eng):
            with lock:
                calls[0] += 1
                hit = calls[0] == n + 1
            if hit:
                fired.append((_eng, time.perf_counter()))
                action(_eng)
            return _real(arg)

        setattr(eng, attr, wrapped)
    return fired


def _router_gate(tag, model, dev, prompts, want, router, ids):
    """(b)'s gate: every request FINISHED, the tokens phase 5's under
    `_spec_gate` (equal, or a divergence at a shown near-tie), no leaked
    block on any replica. Returns the outputs."""
    reqs = [router.get_request(i) for i in ids]
    states = [r.state for r in reqs]
    if any(st != "finished" for st in states):
        raise AssertionError(f"{tag}: requests not finished: {states}")
    outs = [list(r.output_ids) for r in reqs]
    _spec_gate(tag, model, dev, prompts, want, outs)
    leaks = router.check_drained()
    if leaks:
        raise AssertionError(f"{tag}: leaked blocks {leaks}")
    return outs


def _flood(router, prompts, sampling, during=None):
    """Submit every prompt, optionally run `during()` mid-flood, wait.
    Returns (ids, seconds, tokens/s by the host clock)."""
    t0 = time.perf_counter()
    ids = [router.submit(p, sampling=sampling) for p in prompts]
    if during is not None:
        during()
    router.wait(ids, timeout_s=ROUTER_WAIT_S)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(router.get_request(i).output_ids) for i in ids)
    return ids, dt, total / dt


def phase_router(dev, model, smi, want, lens=SERVE_LENS,
                 new_tokens=SERVE_NEW_TOKENS):
    """Phase 25: GPT-2 345M served by a `Router` of replicas on the one
    card, through crash, wedge, drain and the Autoscaler; tokens gated
    against phase 5's single engine."""
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.inference.serving import (Autoscaler, Router,
                                                    SamplingParams)
    from paddle_tpu_torch.monitor import alerts

    cfg = model.config
    n_layers = cfg.num_layers
    prompts = _serve_prompts(cfg.vocab_size, lens)
    sampling = SamplingParams(max_new_tokens=new_tokens)
    kw = dict(max_batch=SERVE_MAX_BATCH, num_blocks=ROUTER_BLOCKS,
              device=dev)

    def router(n, **extra):
        return Router(model, replicas=n, **dict(kw, **extra))

    # tokens/s with 1 replica, by the host clock (not gated)
    r1 = router(1, heartbeat_timeout_s=60.0)
    try:
        _flood(r1, prompts, sampling)           # warm-up
        _, _, tps1 = _flood(r1, prompts, sampling)
    finally:
        r1.shutdown()

    # (a) clean, 2 replicas: tokens, leaks, exact launch counts
    keys = ("serve/prefills", "serve/decode_dispatches")
    ra = router(2, heartbeat_timeout_s=60.0)
    try:
        calls = _count_dispatches(ra)
        for h in ("serve/hist/ttft_us", "serve/hist/itl_us"):
            cmon.hist_get(h).reset()
        before = {k: cmon.stat_get(k) for k in keys}
        kernels.reset_launches()
        ids, dt, tps2 = _flood(ra, prompts, sampling)
        counts = kernels.launches()
        delta = {k: cmon.stat_get(k) - before[k] for k in keys}
        reqs = [ra.get_request(i) for i in ids]
        _router_gate("router (a) clean", model, dev, prompts, want, ra, ids)
        n_dec, n_pre = delta["serve/decode_dispatches"], delta[
            "serve/prefills"]
        if counts["paged_attention"] != n_layers * n_dec or n_dec < 1:
            raise AssertionError(
                f"router (a): paged kernel launched "
                f"{counts['paged_attention']} times for {n_dec} decode "
                f"dispatches x {n_layers} layers")
        if counts["fused_layer_norm"] != (2 * n_layers + 1) * (n_pre + n_dec):
            raise AssertionError(
                f"router (a): LN kernel launched {counts['fused_layer_norm']}"
                f" times for {n_pre} prefills + {n_dec} decodes x "
                f"{2 * n_layers + 1}")
        per_rep = {i: n[0] for i, n in calls.items()}
        if sum(per_rep.values()) != n_dec or min(per_rep.values()) < 1:
            raise AssertionError(f"router (a): decode dispatches per "
                                 f"replica {per_rep}, {n_dec} counted")
        hq = {h: [cmon.hist_get(f"serve/hist/{h}_us").quantile(q) / 1e3
                  for q in (0.5, 0.99)] for h in ("ttft", "itl")}
        gaps = [b - a for r in reqs
                for a, b in zip(r.token_times, r.token_times[1:])]
        ttft = [r.token_times[0] - r.arrival_perf for r in reqs]
        sq = {"ttft": [quantile_ms(ttft, q) for q in (0.5, 0.99)],
              "itl": [quantile_ms(gaps, q) for q in (0.5, 0.99)]}
        log("router", f"[{smi}] (a) clean, 2 replicas x {ROUTER_BLOCKS} "
            f"blocks: phase 5's tokens, no leaks; launches {n_layers} x "
            f"{n_dec} paged = {counts['paged_attention']}, "
            f"{2 * n_layers + 1} x ({n_pre} + {n_dec}) LN = "
            f"{counts['fused_layer_norm']}; decode dispatches per replica "
            f"{per_rep}")
        log("router", "(a) histogram quantiles vs sorted-list, ms: "
            + "; ".join(f"{h} p50 {hq[h][0]:.3f} / {sq[h][0]:.3f}, p99 "
                        f"{hq[h][1]:.3f} / {sq[h][1]:.3f}"
                        for h in ("ttft", "itl")))
    finally:
        ra.shutdown()

    # (b) crash: a worker raises after 3 decode dispatches
    rb = router(2, heartbeat_timeout_s=60.0)
    try:
        placed = []
        real_replay = rb._replay

        def timed_replay(exports, rep, reason):
            real_replay(exports, rep, reason)
            placed.append(time.perf_counter())

        rb._replay = timed_replay

        def boom(eng):
            raise RuntimeError("injected decode fault")

        fired = _fault_after([r.engine for r in rb._replicas], 3,
                             "_decode_batch", boom)
        before = cmon.stat_get("serve/failovers")
        ids, _, _ = _flood(rb, prompts, sampling)
        _router_gate("router (b) crash", model, dev, prompts, want, rb, ids)
        failovers = cmon.stat_get("serve/failovers") - before
        if len(fired) != 1 or failovers != 1:
            raise AssertionError(f"router (b): {len(fired)} faults, "
                                 f"failovers +{failovers}")
        crash_to_replay = (placed[0] - fired[0][1]) * 1e3
        ids2, _, _ = _flood(rb, prompts[:2], sampling)
        _router_gate("router (b) survivor", model, dev, prompts[:2],
                     want[:2], rb, ids2)
        healthy = [i for i in range(2) if rb.replica_healthy(i)]
        log("router", f"(b) crash after 3 decode dispatches: failovers +1, "
            f"phase 5's tokens, no leaks on either replica; crash to replay "
            f"placed {crash_to_replay:.3f} ms (host clock); the survivor "
            f"(replica {healthy}) served 2 more prompts under the gate")
    finally:
        rb.shutdown()

    # (c) wedge: a replica sleeps inside a dispatch for 3 x the timeout
    rc = router(2, heartbeat_timeout_s=ROUTER_HEARTBEAT_S)
    try:
        stall = 3 * ROUTER_HEARTBEAT_S
        fired = _fault_after([r.engine for r in rc._replicas], 3,
                             "_dispatch_decode",
                             lambda eng: time.sleep(stall))
        before = cmon.stat_get("serve/failovers")
        ids, _, _ = _flood(rc, prompts, sampling)
        _router_gate("router (c) wedge", model, dev, prompts, want, rc, ids)
        if len(fired) != 1 or cmon.stat_get("serve/failovers") != before + 1:
            raise AssertionError("router (c): the wedge was not failed over")
        zombie, t_wedge = fired[0]
        snap = {r.req_id: len(r.output_ids)
                for r in zombie._requests.values()}
        time.sleep(max(0.0, t_wedge + stall + 0.5 - time.perf_counter()))
        after = {r.req_id: len(r.output_ids)
                 for r in zombie._requests.values()}
        if after != snap or not zombie.fenced:
            raise AssertionError("router (c): the zombie emitted after its "
                                 "wake-up")
        if rc.check_drained():
            raise AssertionError("router (c): leaked blocks after the wake")
        log("router", f"(c) wedge ({stall:.1f} s asleep in a dispatch, "
            f"heartbeat {ROUTER_HEARTBEAT_S} s): failed over, phase 5's "
            f"tokens, the zombie's wake-up emitted nothing, no leaks")
    finally:
        rc.shutdown()

    # (d) drain mid-flood, then resume and re-import the exports
    rd = router(2, heartbeat_timeout_s=60.0)
    try:
        ids = [rd.submit(p, sampling=sampling) for p in prompts]
        t0 = time.monotonic()
        while not all(rd.get_request(i).output_ids for i in ids):
            if time.monotonic() - t0 > ROUTER_WAIT_S:
                raise AssertionError("router (d): no first tokens")
            time.sleep(0.005)
        exports = rd.drain(timeout_s=0)
        if not exports:
            raise AssertionError("router (d): the drain exported nothing")
        rd.resume()
        with rd._lock:
            rd._replay(exports, rd._replicas[0], "drain")
        rd.wait(ids, timeout_s=ROUTER_WAIT_S)
        _router_gate("router (d) drain", model, dev, prompts, want, rd, ids)
        log("router", f"(d) drain mid-flood: {len(exports)} requests "
            f"exported mid-generation, re-imported after resume(), phase "
            f"5's tokens, check_drained() {{}}")
    finally:
        rd.shutdown()

    # (e) the Autoscaler: a fired ttft_p99 rule spawns replica 2, then a
    # retire of the newest fires mid-flood
    re_ = router(2, heartbeat_timeout_s=60.0)
    scaler = None
    try:
        cmon.hist_get("serve/hist/ttft_us").reset()
        spawns = cmon.stat_get("serve/autoscale/spawns")
        alerts.configure(rules=[alerts.AlertRule(
            "serve/hist/ttft_us", "quantile", q=0.99, gt=1.0,
            name="ttft_p99")], start=False)
        scaler = Autoscaler(re_, rule="ttft_p99", min_replicas=2,
                            max_replicas=3, cooldown_s=0.0).attach()
        ids, _, _ = _flood(re_, prompts, sampling)
        _router_gate("router (e) 2 replicas", model, dev, prompts, want,
                     re_, ids)
        evs = alerts.evaluate_once()
        if [(r.name, ev) for r, ev, _ in evs] != [("ttft_p99", "fire")] \
                or len(re_._live()) != 3:
            raise AssertionError(f"router (e): transitions {evs}, "
                                 f"{len(re_._live())} live replicas")
        ids, _, tps3 = _flood(re_, prompts, sampling)
        _router_gate("router (e) 3 replicas", model, dev, prompts, want,
                     re_, ids)
        retired = []
        ids, _, _ = _flood(re_, prompts, sampling,
                           during=lambda: retired.append(
                               re_.retire_replica()))
        _router_gate("router (e) scale-down", model, dev, prompts, want,
                     re_, ids)
        spawned = cmon.stat_get("serve/autoscale/spawns") - spawns
        if retired != [2] or spawned != 1:
            raise AssertionError(f"router (e): retired {retired}, spawns "
                                 f"+{spawned}")
        log("router", "(e) ttft_p99 (gt 1 us) fired: the Autoscaler spawned "
            "replica 2 (serve/autoscale/spawns +1); 3 replicas served phase "
            "5's tokens, and so did a flood with retire_replica() of the "
            "newest mid-flood; no leaks")
    finally:
        if scaler is not None:
            scaler.detach()
        alerts.disarm()
        re_.shutdown()

    # (f) a planted fault: `_replay` drops one export; (b)'s gate must fail
    rf = router(2, heartbeat_timeout_s=60.0)
    try:
        real_replay = rf._replay
        rf._replay = lambda exports, rep, reason: real_replay(
            exports[1:], rep, reason)
        _fault_after([r.engine for r in rf._replicas], 3, "_decode_batch",
                     boom)
        ids, _, _ = _flood(rf, prompts, sampling)
        try:
            _router_gate("router (f) planted", model, dev, prompts, want,
                         rf, ids)
        except AssertionError as e:
            caught = str(e)
        else:
            raise AssertionError("router (f): the planted fault (_replay "
                                 "drops one export) passed (b)'s gate")
        log("router", f"(f) planted fault (_replay drops one export) fails "
            f"(b)'s gate: {caught[:120]}")
    finally:
        rf.shutdown()
    log("router", f"[{smi}] tokens/s (host clock; one GIL, one card): 1 "
        f"replica {tps1:.1f}, 2 replicas {tps2:.1f}, 3 replicas {tps3:.1f}")


# -- phase 16 ----------------------------------------------------------
COMPRESS_ELEMS = 354871296   # GPT-2 345M's packed gradient
COMPRESS_BLOCK = 1024


def compress_cases(rng, block, nb):
    """(tag, flat f32 numpy) buffers of nb blocks: randn x 3 with, where
    nb allows, an all-zero block, a block of exact k + 0.5 multiples of
    its scale with +-absmax (scale exactly 1), a subnormal block, a
    block whose absmax / 127 rounds to 0, a NaN block, an Inf block and
    a -Inf block; and each special block alone."""
    x = (3 * rng.randn(nb, block)).astype(np.float32)
    special = []
    z = np.zeros(block, np.float32)
    special.append(("zero", z))
    h = (rng.randint(-126, 126, block) + 0.5).astype(np.float32)
    h[:2] = [127.0, -127.0]
    special.append(("half-even", h))
    special.append(("subnormal", (rng.randn(block) * 1e-40).astype(
        np.float32)))
    tiny = np.zeros(block, np.float32)
    tiny[3] = np.float32(1.4e-45)
    special.append(("scale-0", tiny))
    for tag, v in (("nan", np.nan), ("inf", np.inf), ("-inf", -np.inf)):
        b = (3 * rng.randn(block)).astype(np.float32)
        b[block // 3] = v
        special.append((tag, b))
    for i, (_, b) in enumerate(special[:max(0, nb - 1)]):
        x[1 + i] = b
    cases = [(f"random+specials nb={nb}", x.reshape(-1))]
    if nb == 1:
        cases += [(tag, b) for tag, b in special]
    return cases


def _bits_equal(a, b):
    """Same NaN positions, every other value bit for bit."""
    a, b = a.float(), b.float()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32)))


def compress_checks(dev, blocks=(128, 256, 1024), sizes=(1, 3, 64, 4096)):
    """Kernels #11 and #12 vs their plain versions, bit for bit; returns
    the number of buffers checked."""
    from paddle_tpu_torch.distributed.compress import kernels as K

    rng = np.random.RandomState(16)
    n = 0
    for block in blocks:
        for nb in sizes:
            for tag, x in compress_cases(rng, block, nb):
                t = f"compress block={block} {tag}"
                xd = torch.from_numpy(x).to(dev)
                q, s = K.quantize_blocks(xd, block, "int8")
                q0, s0 = K.quantize_ref(xd, block, "int8")
                if not (torch.equal(q, q0) and _bits_equal(s, s0)):
                    raise AssertionError(
                        f"{t}: quantize_i8 differs from its plain version "
                        f"({int((q != q0).sum())} codes, "
                        f"{int((s != s0).sum())} scales)")
                d = K.dequantize_blocks(q, s, block, "int8")
                if not _bits_equal(d, K.dequantize_ref(q, s, block, "int8")):
                    raise AssertionError(
                        f"{t}: dequantize_i8 differs from its plain version")
                blocks_x = xd.view(-1, block)
                sc, qb = s.cpu(), q.view(-1, block).cpu()
                for i in range(blocks_x.shape[0]):
                    row = x.reshape(-1, block)[i]
                    if not row.any():
                        assert sc[i] == 1 and not d.view(-1, block)[i].any()
                    elif np.isnan(row).any():
                        assert sc[i] == 1 and qb[i, block // 3] == 0
                    elif np.isinf(row).any():
                        assert torch.isinf(sc[i])
                n += 1
    return n


def phase_compress(dev, smi, iters=20):
    from paddle_tpu_torch.distributed.compress import kernels as K

    n_cases = compress_checks(dev)
    log("compress", f"quantize_i8 / dequantize_i8 vs plain, blocks 128 / 256 "
        f"/ 1024, 1-4096 blocks, zero / half-even + +-absmax / subnormal / "
        f"scale-0 / NaN / +-Inf blocks: {n_cases} buffers, codes, scales "
        "and outputs bit-identical; zero block scale 1 and output 0, NaN "
        "block scale 1 and code 0, Inf block scale inf")
    # times at GPT-2 345M's packed gradient, block 1024. The buffers
    # (1.4 GB in, 0.35 GB out) are far past the 50 MB L2, so every call
    # reads cold memory without a flush.
    n, blk = COMPRESS_ELEMS, COMPRESS_BLOCK
    nb = n // blk
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(n, device=dev, generator=g)
    q, s = K.quantize_blocks(x, blk, "int8")
    q0, s0 = K.quantize_ref(x, blk, "int8")
    err_q = 0.0 if torch.equal(q, q0) and torch.equal(s, s0) else math.inf
    d = K.dequantize_blocks(q, s, blk, "int8")
    err_d = max_err(d, K.dequantize_ref(q, s, blk, "int8"))
    del q0, s0, d
    if err_q or err_d:
        raise AssertionError(f"compress at {n} elements: kernel vs plain "
                             f"differs ({err_q}, {err_d})")
    torch.cuda.empty_cache()
    kq_ms, kq_host = time_ms(lambda: K.quantize_blocks(x, blk, "int8"), iters)
    pq_ms, _ = time_ms(lambda: K.quantize_ref(x, blk, "int8"),
                       max(1, iters // 4))
    kd_ms, kd_host = time_ms(lambda: K.dequantize_blocks(q, s, blk, "int8"),
                             iters)
    pd_ms, _ = time_ms(lambda: K.dequantize_ref(q, s, blk, "int8"),
                       max(1, iters // 4))

    # the one PyTorch call that computes dequantize_i8: int8 x f32
    # promotes to f32, the conversion is exact and the product rounds once
    def library():
        return torch.mul(q.view(-1, blk), s.view(-1, 1))

    if not _bits_equal(library().view(-1),
                       K.dequantize_ref(q, s, blk, "int8")):
        raise AssertionError("compress: torch.mul(codes, scales) differs "
                             "from dequantize_ref")
    ld_ms, _ = time_ms(library, iters)
    del x, q, s
    torch.cuda.empty_cache()
    nbytes = 4 * n + n + 4 * nb     # f32 in, int8 + f32 scales out (and back)
    # quantize: |x|, max, divide, round, two clamps an element; dequantize:
    # one multiply
    bq_ms, bq_by = bound_ms(nbytes, 6 * n)
    bd_ms, bd_by = bound_ms(nbytes, n)
    for name, k_ms, p_ms, b_ms, b_by, host, lib in (
            ("quantize_i8", kq_ms, pq_ms, bq_ms, bq_by, kq_host,
             "no single PyTorch call computes the blockwise abs-max scale "
             "and the codes together (library none)"),
            ("dequantize_i8", kd_ms, pd_ms, bd_ms, bd_by, kd_host,
             f"library torch.mul(codes, scales) {ld_ms:.5f} ms, "
             "bit-identical")):
        log("compress", f"[{smi}] {name}, {n} elements, block {blk}, cold "
            f"L2: kernel {k_ms:.5f} ms | plain {p_ms:.5f} ms | bound "
            f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e9:.3f} GB) = "
            f"{nbytes / k_ms / 1e9:.3f} TB/s, {100 * b_ms / k_ms:.1f}% of "
            f"the bound; {lib}; host ms per call: kernel wrapper "
            f"{host:.5f}")
    common = {"route": "cuda", "source": "paddle_tpu_torch/csrc/compress.cu"}
    return [dict(common, name="quantize_i8", max_abs_err=err_q,
                 replaces="paddle_tpu/distributed/compress/kernels.py:122",
                 ms=kq_ms, plain_ms=pq_ms, bound_ms=bq_ms, bound_by=bq_by,
                 library_ms=None),
            dict(common, name="dequantize_i8", max_abs_err=err_d,
                 replaces="paddle_tpu/distributed/compress/kernels.py:142",
                 ms=kd_ms, plain_ms=pd_ms, bound_ms=bd_ms, bound_by=bd_by,
                 library_ms=ld_ms)]


# -- phase 17 ----------------------------------------------------------
DP_RANKS = 2
DP_STEPS = 4
DP_SPECS = ("fp32", "int8:ef")
DP_ALLREDUCE_ELEMS = 1 << 20


def _nccl_rank(out_dir):
    """One NCCL all_reduce; a refusal's message goes to nccl_r<rank>.txt
    and the rank exits 1 (without a traceback)."""
    import torch.distributed as dist

    try:
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
    except dist.DistBackendError as e:
        with open(os.path.join(out_dir, f"nccl_r{dist.get_rank()}.txt"),
                  "w") as f:
            f.write(str(e))
        sys.exit(1)


def _profiled_step(step, ids, labels, sync):
    """One more step under torch.profiler: its wall ms, the device ms of
    all its device work, of the host<->device copies (gloo's staging)
    and [launches, device ms] of each int8 kernel. The device numbers
    are 0 when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    by = {"quantize_i8": [0, 0.0], "dequantize_i8": [0, 0.0]}
    busy = copies = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(ids, labels))
        sync()
        wall = time.perf_counter() - t0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        if e.name.startswith("Memcpy"):
            copies += ms
        for k in ("dequantize_i8", "quantize_i8"):
            if f"{k}_kernel" in e.name:
                by[k][0] += 1
                by[k][1] += ms
                break
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "copies_ms": copies,
            "kernels": by}


def _dp_rank(out_dir, steps, device):
    """One rank of phase 17 (spawned: gloo, the one card; `device` "cpu"
    only to rehearse the phase off the card). Writes dp_r<rank>.json."""
    import hashlib

    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce, get_rank
    from paddle_tpu_torch.distributed import compress as C
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    rank = get_rank()
    on_card = device == "cuda"
    if on_card:
        dev = torch.device("cuda", torch.cuda.current_device())
        kernels.load()           # the parent built the library
        sync = torch.cuda.synchronize
    else:
        dev, sync = torch.device("cpu"), (lambda: None)
    out = {"rank": rank}
    keys = ("comm/all_reduce/calls", "comm/all_reduce/bytes",
            "comm/all_reduce/wire_bytes")
    for spec in DP_SPECS:
        model = _train_model(dev)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    weight_decay=0.01, multi_precision=True)
        step = DistributedTrainStepCompiler(model, opt, comm_compress=spec)
        ids, labels = _train_batch(model.config.vocab_size, dev)
        reduce_s = []
        inner = step._reduce_grads

        def timed(loss, named, inner=inner, reduce_s=reduce_s):
            sync()
            t0 = time.perf_counter()
            res = inner(loss, named)
            sync()
            reduce_s.append(time.perf_counter() - t0)
            return res

        step._reduce_grads = timed
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        before = [cmon.stat_get(k) for k in keys]
        kernels.reset_launches()
        losses, step_s = [], []
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels)))   # .item() synchronises
            step_s.append(time.perf_counter() - t0)
        launches = kernels.launches()
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().float().cpu().numpy().tobytes())
        out[spec] = {
            "losses": losses, "step_s": step_s, "reduce_s": reduce_s,
            "comm": [cmon.stat_get(k) - b for k, b in zip(keys, before)],
            "launches": {k: launches[k] for k in ("quantize_i8",
                                                  "dequantize_i8")},
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if on_card
                           else 0),
            "param_sha256": h.hexdigest(),
            "residual": (step._comm_state["residual"].numel()
                         if "residual" in step._comm_state else 0)}
        if spec == "int8:ef":
            # one more step, profiled on rank 0 (after the counts and
            # the hash above were read)
            step._reduce_grads = inner
            if rank == 0 and on_card:
                out["profile"] = _profiled_step(step, ids, labels, sync)
            else:
                float(step(ids, labels))
        del model, opt, step, timed, inner
        if on_card:
            torch.cuda.empty_cache()
    # all_reduce(compress="int8") on 1M elements vs its plain version: the
    # same call on CPU copies (the wrappers' plain versions; gloo carries
    # both), and vs the exact fp32 sum
    g = torch.Generator().manual_seed(17 + rank)
    v = torch.randn(DP_ALLREDUCE_ELEMS, generator=g)
    got = all_reduce(v.to(dev, copy=True), compress="int8")
    want = all_reduce(v.clone(), compress="int8")
    exact = all_reduce(v.clone())
    # each of the W phase-1 codes and the phase-2 code is off by at most
    # half its block's scale: the bound on |got - exact|
    blk = C.effective_block(C.parse_spec("int8"), v.numel(), DP_RANKS)
    s1 = all_reduce(v.view(-1, blk).abs().amax(1, keepdim=True) / 127,
                    op=ReduceOp.MAX)
    s2 = got.cpu().view(-1, blk).abs().amax(1, keepdim=True) / 127
    bound = 0.5 * (DP_RANKS * s1 + s2)
    out["allreduce"] = {
        "bit_identical": _bits_equal(got.cpu(), want),
        "max_abs_err": float((got.cpu() - want).abs().max()),
        "vs_exact_in_bounds": float(((got.cpu() - exact).view(-1, blk).abs()
                                     / bound).max())}
    with open(os.path.join(out_dir, f"dp_r{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_dp(dev, smi, steps=DP_STEPS):
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            spawn(_nccl_rank, args=(tmp,), nprocs=DP_RANKS, backend="nccl",
                  join=False).join(timeout=120)
            nccl = "NCCL took two ranks on one card"
        except RuntimeError as e:
            why = [ln.strip() for r in range(DP_RANKS)
                   if os.path.exists(os.path.join(tmp, f"nccl_r{r}.txt"))
                   for ln in open(os.path.join(tmp, f"nccl_r{r}.txt"))
                   if "NCCL version" in ln or "Duplicate" in ln]
            nccl = ("NCCL refused two ranks on one card: "
                    + " | ".join(why[:2] or [str(e)]))
        log("dp", f"{nccl} ({time.perf_counter() - t0:.1f} s); the ranks "
            "below run gloo, named explicitly, on CUDA tensors")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(_dp_rank, args=(tmp, steps, dev.type), nprocs=DP_RANKS,
              backend="gloo", device=dev.type, join=False).join(timeout=600)
        wall = time.perf_counter() - t0
        runs = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"dp_r{r}.json")) as f:
                runs.append(json.load(f))
    fp, q8 = (runs[0][s] for s in DP_SPECS)
    for spec in DP_SPECS:
        a, b = runs[0][spec], runs[1][spec]
        if a["param_sha256"] != b["param_sha256"]:
            raise AssertionError(f"dp {spec}: the ranks' parameters differ")
        if a["losses"] != b["losses"]:
            raise AssertionError(f"dp {spec}: the ranks' losses differ")
        ls = a["losses"]
        if not (all(map(math.isfinite, ls)) and ls[-1] < ls[0]):
            raise AssertionError(f"dp {spec}: loss did not fall {ls}")
    for a, b in zip(fp["losses"], q8["losses"]):
        if abs(a - b) > 2e-2 * max(1.0, abs(a)):
            raise AssertionError(f"dp: int8:ef loss {b} not within 2% of "
                                 f"the fp32 twin's {a}")
    ratio = q8["comm"][2] / fp["comm"][2]
    if not (ratio <= 0.3 and q8["comm"][1] == fp["comm"][1]
            and fp["comm"][0] == q8["comm"][0] == steps):
        raise AssertionError(f"dp: comm counters {fp['comm']} / "
                             f"{q8['comm']}, wire ratio {ratio:.4f}")
    for r in runs:
        want = {"quantize_i8": 2 * steps, "dequantize_i8": 4 * steps}
        if r["int8:ef"]["launches"] != want or any(r["fp32"]["launches"]
                                                   .values()):
            raise AssertionError(f"dp rank {r['rank']}: launches "
                                 f"{r['int8:ef']['launches']} under int8:ef "
                                 f"(want {want}), {r['fp32']['launches']} "
                                 "under fp32 (want 0)")
        ar = r["allreduce"]
        # (1e-4: the f32 roundings of the dequantize and the sums)
        if not ar["bit_identical"] or ar["vs_exact_in_bounds"] > 1.0 + 1e-4:
            raise AssertionError(f"dp rank {r['rank']}: all_reduce(compress="
                                 f"'int8') {ar}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log("dp", f"[{smi}] GPT-2 345M (24L, bf16 O2, AdamW multi_precision), "
        f"{DP_RANKS} ranks (gloo) on one card, global B={TRAIN_BATCH} "
        f"S={TRAIN_SEQ} ({TRAIN_BATCH // DP_RANKS} a rank), {steps} steps "
        f"each, spawn-to-join {wall:.1f} s")
    for spec in DP_SPECS:
        a = runs[0][spec]
        st = float(np.median(a["step_s"][1:]))
        rd = float(np.median(a["reduce_s"][1:]))
        log("dp", f"[{smi}] {spec}: loss " + " ".join(
            f"{x:.4f}" for x in a["losses"]) + f"; step {st * 1e3:.1f} ms "
            f"(median of steps 2-{steps}) = {tokens / st:.1f} tokens/s; "
            f"gradient allreduce {rd * 1e3:.1f} ms = {100 * rd / st:.1f}% of "
            "the step (host clock, synchronised; gloo through the host on "
            "one shared card, not a wire speed of the port); wire "
            f"{a['comm'][2] // steps} B of {a['comm'][1] // steps} B a step; "
            "peak memory " + " / ".join(
                f"{r[spec]['peak_bytes'] / 2 ** 30:.2f}" for r in runs)
            + " GiB (rank 0 / 1); residual "
            f"{a['residual']} f32; parameters bit-identical on both ranks")
    log("dp", f"int8:ef / fp32 wire bytes {q8['comm'][2]} / "
        f"{fp['comm'][2]} = {ratio:.4f}; launches a rank over {steps} steps: "
        + "; ".join(f"rank {r['rank']} {r['int8:ef']['launches']}"
                    for r in runs) + f" (2 + 4 a step); every int8:ef loss "
        "within 2% of the fp32 twin's")
    prof = runs[0].get("profile")
    if prof and prof["busy_ms"]:
        (nq, qms), (nd, dms) = (prof["kernels"][k] for k in
                                ("quantize_i8", "dequantize_i8"))
        log("dp", f"[{smi}] rank 0's int8:ef step {steps + 1} under "
            f"torch.profiler: wall {prof['wall_ms']:.1f} ms, device work "
            f"{prof['busy_ms']:.2f} ms, of it host<->device copies "
            f"{prof['copies_ms']:.2f} ms; quantize_i8 {nq} launches "
            f"{qms:.4f} ms, dequantize_i8 {nd} launches {dms:.4f} ms: "
            f"{qms + dms:.4f} ms = {100 * (qms + dms) / prof['wall_ms']:.2f}%"
            " of the step's wall")
    else:
        log("dp", "rank 0's profiled int8:ef step: the profiler saw no "
            "device activity (kernel device times not measured)")
    ar = runs[0]["allreduce"]
    log("dp", f"all_reduce(compress='int8') on {DP_ALLREDUCE_ELEMS} elements "
        "a rank: kernel path bit-identical to the plain path on CPU copies "
        f"(max|err| {ar['max_abs_err']:.3e}); error vs the exact sum "
        f"{ar['vs_exact_in_bounds']:.3f} of its bound (half a code step of "
        "each phase-1 block and of the phase-2 block)")
    return runs[0]["int8:ef"]["launches"]


# -- phase 18 ----------------------------------------------------------
# bench_bert's on-chip recipe (bench.py:475-518): BERT-base, dropout 0,
# bf16 O2, AdamW(1e-4, weight_decay=0.01, multi_precision), B 32 x S
# 512, the ids as MLM labels, token types 0, no attention mask, 12
# steps after 3 of warm-up
BERT_BATCH, BERT_SEQ = 32, 512
BERT_WARMUP, BERT_STEPS, BERT_WINDOWS = 3, 4, 3
BERT_ROWS = BERT_BATCH * BERT_SEQ


class _BertStep(torch.nn.Module):
    """bench_bert's fixed signature: (ids, token types, MLM labels) ->
    the pretraining loss."""

    def __init__(self, model):
        super().__init__()
        self.m = model

    def forward(self, ids, tt, labels):
        return self.m(ids, token_type_ids=tt, masked_lm_labels=labels)


def _bert_model(dev, num_layers=12, o2=True, seed=0):
    """BERT-base at full width, weights from `seed`; bf16 O2 unless `o2`
    is False."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.bert import BertForPretraining, bert_base

    gen = torch.Generator(device=dev).manual_seed(seed)
    model = BertForPretraining(bert_base(dropout=0.0, num_layers=num_layers),
                               device=dev, generator=gen)
    return amp.decorate(model, level="O2", dtype="bfloat16") if o2 else model


def _bert_batch(vocab, dev, seed=0):
    """bench_bert's batch: ids from RandomState(seed), token types 0."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (BERT_BATCH, BERT_SEQ)).astype(np.int64)
    ids = torch.from_numpy(ids).to(dev)
    return ids, torch.zeros_like(ids)


def _bert_launches(model):
    """Kernel launches in one BERT training step: the embedding
    LayerNorm and two residual LayerNorm epilogues a block, forward and
    backward; the three flash kernels once a block; AdamW's fused_adam
    once for every MAX_TENSORS parameters (one launch's table: once for
    BERT-base's 206)."""
    from paddle_tpu_torch.incubate.nn.kernels.optim import MAX_TENSORS

    n_layers = model.config.num_layers
    n_tensors = len(list(model.parameters()))
    return {"fused_layer_norm": 2 * n_layers + 1,
            "fused_layer_norm_bwd": 2 * n_layers + 1,
            "flash_attention_fwd": n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers,
            "fused_adam": -(-n_tensors // MAX_TENSORS),
            "paged_attention": 0, "paged_attention_multi": 0,
            "fused_sgd": 0, "fused_momentum": 0, "quantize_i8": 0,
            "dequantize_i8": 0}


def bert_kernel_checks(dev):
    """Kernels #1-5 against their plain versions at BERT's shapes. Flash:
    B 32, H 12, S 512, D 64, bf16, non-causal, per row (phase 7's check
    and limits), and the same in f32 at B 2. LayerNorm at 16384 x 768:
    bf16 x with and without a bf16 residual and with an f32 residual (the
    O1 epilogue), eps 1e-12 (embeddings) and 1e-5 (blocks), f32 and bf16
    weight and bias; the forward (phase 8's limits: y 1e-2 abs + rel,
    mean and rstd 1e-5, s bit-identical) and the backward on its outputs
    (dx 1e-2 x max|ref| + 1e-2 rel, dw and db 1e-5 x max|ref|), then
    through the autograd Function (each gradient in its input's dtype).
    Returns {name: max|err|} of the bf16 cases."""
    from paddle_tpu_torch.incubate.nn.kernels import layernorm as ln

    rng = np.random.RandomState(18)
    scale = 64 ** -0.5
    errs = {}
    q, k, v, do = _flash_inputs(rng, BERT_BATCH, 12, BERT_SEQ, 64,
                                torch.bfloat16, dev)
    fe = _flash_check("bert flash B32 H12 S512 D64 bf16 non-causal", q, k,
                      v, do, False, scale)
    errs.update({n: e for n, (e, _) in fe.items()})
    del q, k, v, do
    q, k, v, do = _flash_inputs(rng, 2, 12, BERT_SEQ, 64, torch.float32,
                                dev)
    _flash_check("bert flash B2 H12 S512 D64 f32 non-causal", q, k, v, do,
                 False, scale)
    h = 768

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    w32, b32 = 1 + 0.1 * t(h), 0.1 * t(h)
    x, dy, ds = (t(BERT_ROWS, h, dtype=torch.bfloat16) for _ in range(3))
    residuals = {"none": None, "bf16": t(BERT_ROWS, h, dtype=torch.bfloat16),
                 "f32": 3 * t(BERT_ROWS, h)}
    fwd_err = bwd_err = 0.0
    for rname, r in residuals.items():
        for eps in (1e-12, 1e-5):
            for wdt in (torch.float32, torch.bfloat16):
                w, b = w32.to(wdt), b32.to(wdt)
                tag = (f"bert ln {BERT_ROWS}x{h} bf16 residual={rname} "
                       f"eps={eps} w/b {wdt}")
                y, s, mu, rs = ln.layer_norm_fwd(x, r, w, b, eps)
                y0, s0, mu0, rs0 = ln.layer_norm_fwd_reference(x, r, w, b,
                                                               eps)
                if y.dtype != x.dtype or (r is not None
                                          and s.dtype != x.dtype):
                    raise AssertionError(f"{tag}: outputs not in x's dtype")
                e = assert_close(f"{tag} y", y, y0, 1e-2, 1e-2)
                e = max(e, assert_close(f"{tag} mean", mu, mu0, 1e-5, 1e-5))
                e = max(e, assert_close(f"{tag} rstd", rs, rs0, 1e-5, 1e-5))
                if r is not None and not torch.equal(s, s0):
                    raise AssertionError(f"{tag}: s differs")
                fwd_err = max(fwd_err, e)
                s = x if r is None else s
                dsr = None if r is None else ds
                got = ln.layer_norm_bwd(dy, dsr, s, w, b, mu, rs)
                want = ln.layer_norm_bwd_reference(dy, dsr, s, w, b, mu, rs)
                e = assert_close(f"{tag} dx", got[0], want[0],
                                 1e-2 * float(want[0].float().abs().max()),
                                 1e-2)
                for name, g_, w_ in (("dw", got[1], want[1]),
                                     ("db", got[2], want[2])):
                    e = max(e, assert_close(f"{tag} {name}", g_, w_,
                                            1e-5 * float(w_.abs().max()),
                                            1e-5))
                bwd_err = max(bwd_err, e)
    # the autograd Function on the O1 epilogue's dtypes: x and the
    # residual's gradients each in its own dtype, dw and db in bf16
    leaves = [x.clone().requires_grad_(),
              residuals["f32"].clone().requires_grad_(),
              w32.bfloat16().requires_grad_(),
              b32.bfloat16().requires_grad_()]
    grads = []
    for fn in (ln.fused_residual_layer_norm,
               ln.fused_residual_layer_norm_reference):
        y, s = fn(*leaves, 1e-5)
        grads.append(torch.autograd.grad((y, s), leaves, (dy, ds)))
    for name, g_, w_, leaf in zip(("dx", "dresidual", "dw", "db"), *grads,
                                  leaves):
        if g_.dtype != leaf.dtype:
            raise AssertionError(f"bert ln Function {name}: {g_.dtype}, "
                                 f"expected {leaf.dtype}")
        bwd_err = max(bwd_err, assert_close(
            f"bert ln Function {name}", g_, w_,
            1e-2 * float(w_.float().abs().max()), 1e-2))
    errs["ln_fwd"], errs["ln_bwd"] = fwd_err, bwd_err
    return errs


def flash_bounds(work, dtype):
    """{name: (bound ms, bound_by, how)} of flash work {name: (bytes,
    FLOP)}. bf16: the bf16 tensor cores. f32: 3xTF32, three tf32
    products for each f32 one at 495 TFLOP/s, the least time f32-grade
    work could take on the card (the f32 SIMT cores at 67 TFLOP/s, also
    logged, take 2.5x as long)."""
    out = {}
    for n, (nb, fl) in work.items():
        if dtype != torch.float32:
            out[n] = bound_ms(nb, fl, PEAK_BF16_FLOPS) + ("bf16",)
        else:
            out[n] = bound_ms(nb, 3 * fl, PEAK_TF32_FLOPS) + (
                f"3xTF32; f32 SIMT {bound_ms(nb, fl)[0]:.5f}",)
    return out


def flash_times(dev, smi, tag, batch, dtypes, iters=50, rng=None):
    """Logs kernel, plain, library and bound ms of #1-3 at B `batch`, H
    12, S 512, D 64, non-causal, cold L2, in each of `dtypes` (the f32
    rows with both bounds, `flash_bounds`). Returns {"flash <n> <dtype>":
    (kernel ms, plain, library, bound, bound_by)}."""
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    rng = np.random.RandomState(19) if rng is None else rng
    b, hh, s, d = batch, 12, 512, 64
    scale = d ** -0.5
    out = {}
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pit = max(1, iters // 5)
    for dtype in dtypes:
        q, k, v, do = _flash_inputs(rng, b, hh, s, d, dtype, dev)
        o, lse = fa.flash_attention_fwd(q, k, v, False, scale)
        delta = (do.float() * o.float()).sum(dim=-1)
        ms = {"fwd": time_ms(lambda: fa.flash_attention_fwd(
                  q, k, v, False, scale), iters, flush)[0],
              "dq": time_ms(lambda: fa.flash_attention_bwd_dq(
                  q, k, v, do, lse, delta, False, scale), iters, flush)[0],
              "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv(
                  q, k, v, do, lse, delta, False, scale), iters, flush)[0]}
        plain = {"fwd": time_ms(lambda: fa.flash_attention_fwd_reference(
                     q, k, v, False, scale), pit, flush)[0],
                 "dq": time_ms(lambda: fa.flash_attention_bwd_dq_reference(
                     q, k, v, do, lse, delta, False, scale), pit, flush)[0],
                 "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
                     q, k, v, do, lse, delta, False, scale), pit, flush)[0]}
        lib_fwd = time_ms(lambda: sdpa(q, k, v, scale=scale), iters,
                          flush)[0]
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        res = sdpa(qg, kg, vg, scale=scale)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            res, (qg, kg, vg), do, retain_graph=True), iters, flush)[0]
        del res, qg, kg, vg
        bh = b * hh
        mm = 2.0 * bh * s * s * d               # one S x S x D product
        elem = bh * s * d * q.element_size()    # one [B, H, S, D] tensor
        row = bh * s * 4                        # one f32 [B, H, S] row stat
        work = {"fwd": (4 * elem + row, 2 * mm),
                "dq": (5 * elem + 2 * row, 3 * mm),
                "dkv": (6 * elem + 2 * row, 4 * mm)}
        dname = "f32" if dtype == torch.float32 else "bf16"
        bounds = flash_bounds(work, dtype)
        for n, (nb, fl) in work.items():
            b_ms, b_by, how = bounds[n]
            lib = lib_fwd if n == "fwd" else lib_bwd
            out[f"flash {n} {dname}"] = (ms[n], plain[n], lib, b_ms, b_by)
            which = "forward" if n == "fwd" else "backward (dq, dk, dv)"
            log(tag, f"[{smi}] flash {n} B={b} H={hh} S={s} D={d} {dname} "
                f"non-causal, cold L2: kernel {ms[n]:.5f} ms | plain "
                f"{plain[n]:.5f} | SDPA {which} {lib:.5f} | bound "
                f"{b_ms:.5f} ({b_by}, {how}; {fl / 1e9:.2f} GFLOP, "
                f"{nb / 1e6:.1f} MB) | {fl / ms[n] / 1e9:.1f} TFLOP/s")
        log(tag, f"[{smi}] flash {dname}: dq + dk/dv "
            f"{ms['dq'] + ms['dkv']:.5f} ms against the SDPA backward's "
            f"{lib_bwd:.5f}")
        del q, k, v, do, o, lse, delta
    return out


def kernel_times(dev, smi, tag, batch, rows, flash_dtypes, ln_dtype,
                 o1_case=False, iters=50):
    """Logs kernel, plain, library and bound ms of #1-5 at a model's
    shapes: flash at B `batch`, H 12, S 512, D 64, non-causal, cold L2,
    in each of `flash_dtypes` (`flash_times`); the LayerNorm forward and
    backward at `rows` x 768 in `ln_dtype` (f32 w/b), warm L2, with and
    without the residual, and with `o1_case` the forward of the O1
    epilogue (a `ln_dtype` x, an f32 residual). Returns {name: (kernel
    ms, plain, library or None, bound, bound_by)}."""
    from paddle_tpu_torch.incubate.nn.kernels import layernorm as ln

    rng = np.random.RandomState(19)
    out = flash_times(dev, smi, tag, batch, flash_dtypes, iters, rng)

    h, n = 768, rows
    x, r, dy, ds = (torch.from_numpy(rng.randn(n, h).astype(np.float32))
                    .to(dev, ln_dtype) for _ in range(4))
    w = (1 + 0.1 * torch.from_numpy(rng.randn(h).astype(np.float32))).to(dev)
    bias = (0.1 * torch.from_numpy(rng.randn(h).astype(np.float32))).to(dev)
    wl, bl = w.to(ln_dtype), bias.to(ln_dtype)
    lib_f = time_ms(lambda: torch.nn.functional.layer_norm(
        x, (h,), wl, bl, 1e-5), 100)[0]
    xl, wg, bg = (t_.detach().requires_grad_() for t_ in (x, wl, bl))
    yl = torch.nn.functional.layer_norm(xl, (h,), wg, bg, 1e-5)
    lib_b = time_ms(lambda: torch.autograd.grad(
        yl, (xl, wg, bg), dy, retain_graph=True), 100)[0]
    del xl, wg, bg, yl
    elems, es = n * h, x.element_size()
    dname = "f32" if ln_dtype == torch.float32 else "bf16"
    _, s_, mu, rs = ln.layer_norm_fwd(x, r, w, bias, 1e-5)
    cases = [("residual", r), ("no residual", None)]
    if o1_case:
        cases.append(("f32 residual (O1)", r.float()))
    for case, res in cases:
        k_ms = time_ms(lambda: ln.layer_norm_fwd(x, res, w, bias, 1e-5),
                       100)[0]
        p_ms = time_ms(lambda: ln.layer_norm_fwd_reference(
            x, res, w, bias, 1e-5), 25)[0]
        # x read, y written; the residual read and the sum written
        res_bytes = 0 if res is None else elems * (res.element_size() + es)
        nbytes = 2 * elems * es + res_bytes + 2 * h * 4 + 2 * n * 4
        b_ms, b_by = bound_ms(nbytes, 8 * elems)
        lib = lib_f if res is None else None
        out[f"ln fwd {case}"] = (k_ms, p_ms, lib, b_ms, b_by)
        log(tag, f"[{smi}] LayerNorm forward N={n} H={h} {dname} {case}, "
            f"warm L2: kernel {k_ms:.5f} ms | plain {p_ms:.5f} | "
            f"F.layer_norm {'n/a' if lib is None else f'{lib:.5f}'} | bound "
            f"{b_ms:.5f} ({b_by}, {nbytes} B)")
    for case, dsr in (("residual", ds), ("no residual", None)):
        k_ms = time_ms(lambda: ln.layer_norm_bwd(dy, dsr, s_, w, bias, mu,
                                                 rs), 100)[0]
        p_ms = time_ms(lambda: ln.layer_norm_bwd_reference(
            dy, dsr, s_, w, bias, mu, rs), 25)[0]
        nbytes = (3 + (dsr is not None)) * elems * es + 4 * h * 4 + 2 * n * 4
        b_ms, b_by = bound_ms(nbytes, 12 * elems)
        lib = lib_b if dsr is None else None
        out[f"ln bwd {case}"] = (k_ms, p_ms, lib, b_ms, b_by)
        log(tag, f"[{smi}] LayerNorm backward N={n} H={h} {dname} {case}, "
            f"warm L2: kernel {k_ms:.5f} ms | plain {p_ms:.5f} | F.layer_norm"
            f" backward {'n/a' if lib is None else f'{lib:.5f}'} | bound "
            f"{b_ms:.5f} ({b_by}, {nbytes} B)")
    return out


def bert_adam_times(dev, smi, named, iters=20):
    """fused_adam over BERT-base's O2 parameter set (206 tensors, bf16
    with f32 masters, f32 LayerNorm parameters): one step bit-identical
    to the plain version, then kernel / plain / torch.optim fused AdamW /
    bound ms (phase 11's measurement)."""
    from paddle_tpu_torch.incubate.nn.kernels import optim as ko

    g0 = _optim_grads(named, dev, steps=1)[0]
    lr, wd = 1e-4, 0.01
    kw = dict(lr=lr, beta1=0.9, beta2=0.999, eps=1e-8,
              decay=[float(np.float32(1) - np.float32(lr) * np.float32(wd))]
              * len(named))
    got, want = (_optim_lists(named, g0, "fused_adam") for _ in range(2))
    ko.fused_adam(*got, **kw)
    ko.fused_adam_reference(*want, **kw)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if x is not None and not torch.equal(x, y):
                raise AssertionError("bert fused_adam: kernel and plain "
                                     "version differ after one step")
    del got, want
    # time_ms, not phase 11's chain_ms: the wrapper's host work for 206
    # table entries outlasts the five launches' device work, so a chain
    # of calls would time the host. The plain version (a Python loop of
    # ~15 ops a tensor) is host-bound itself: chain_ms
    lists = _optim_lists(named, g0, "fused_adam")
    k_ms, k_host = time_ms(lambda: ko.fused_adam(*lists, **kw), iters)
    p_ms, _ = chain_ms(lambda: ko.fused_adam_reference(*lists, **kw),
                       max(1, iters // 4))
    del lists
    lib_p = [p.detach().float().clone() for _, p in named]
    for p, (n, _) in zip(lib_p, named):
        p.grad = g0[n].float()
    lib = torch.optim.AdamW(lib_p, lr=lr, weight_decay=wd, fused=True)
    l_ms, l_host = time_ms(lib.step, iters)
    del lib, lib_p
    n_elem = sum(p.numel() for _, p in named)
    nbytes = _optim_bytes(named, g0, "fused_adam")
    b_ms, b_by = bound_ms(nbytes, 15 * n_elem)
    launches = -(-len(named) // ko.MAX_TENSORS)
    log("bert", f"[{smi}] fused_adam over BERT-base's O2 set ({len(named)} "
        f"tensors, {n_elem} elements; bit-identical to the plain version "
        f"after a step), device ms: kernel ({launches} launches) "
        f"{k_ms:.5f} | plain (host-bound) "
        f"{p_ms:.5f} | torch.optim fused AdamW (f32 copies) {l_ms:.5f} | "
        f"bound {b_ms:.5f} ({b_by}, {nbytes / 1e9:.3f} GB), "
        f"{100 * b_ms / k_ms:.1f}% of the bound; host ms per call: kernel "
        f"wrapper {k_host:.5f}, torch.optim {l_host:.5f}")


def _bert_step_split(by):
    """{part: device ms} of a profiled BERT step's {kernel: ms}: the
    flash kernels, the LayerNorm kernels, the optimizer, the cuBLAS /
    CUTLASS products and the rest (elementwise, reductions, copies)."""
    parts = {"flash": 0.0, "LayerNorm": 0.0, "optimizer": 0.0,
             "GEMMs": 0.0, "elementwise and other": 0.0}
    for name, ms in by.items():
        low = name.lower()
        if "fa_fwd" in low or "fa_bwd" in low:
            parts["flash"] += ms
        elif "ln_fwd_kernel" in low or "ln_bwd" in low:
            parts["LayerNorm"] += ms
        elif "multi_tensor_optim" in low or "advance_beta_pows" in low:
            parts["optimizer"] += ms
        elif ("gemm" in low or "xmma" in low or "cutlass" in low
              or "nvjet" in low):
            parts["GEMMs"] += ms
        else:
            parts["elementwise and other"] += ms
    return parts


def _bert_train(dev, smi, model, tag, amp_level=None, warmup=BERT_WARMUP,
                windows=BERT_WINDOWS, steps=BERT_STEPS, profile=True):
    """Train `model` to bench_bert's recipe through TrainStepCompiler:
    the loss falls over the windows' steps; every kernel's launches are
    exact per step; logs step ms (median of the windows), tokens/s, MFU,
    peak memory and, with `profile`, a torch.profiler split of one
    step."""
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    wrap = _BertStep(model)
    o2 = any(p.dtype == torch.bfloat16 for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=wrap.parameters(),
                weight_decay=0.01, multi_precision=o2)
    step = TrainStepCompiler(wrap, opt, amp_level=amp_level)
    ids, tt = _bert_batch(model.config.vocab_size, dev)
    t0 = time.perf_counter()
    for _ in range(warmup):
        loss = step(ids, tt, ids)
    first = float(loss.item())
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    dts, losses = [], []
    for _ in range(windows):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(ids, tt, ids)
        losses.append(float(loss.item()))        # .item() synchronises
        dts.append((time.perf_counter() - t0) / steps)
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = windows * steps
    per_step = _bert_launches(model)
    for name, per in per_step.items():
        if counts[name] != per * n_steps:
            raise AssertionError(
                f"{tag}: {name} launched {counts[name]} times in {n_steps} "
                f"steps, expected {per} per step")
    last = losses[-1]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"{tag}: loss did not decrease ({first:.4f} "
                             f"-> {last:.4f})")
    dt = float(np.median(dts))
    tokens = BERT_BATCH * BERT_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    mfu = 6 * n_params * tokens / dt / PEAK_BF16_FLOPS
    log("bert", f"[{smi}] {tag} ({n_params} params, "
        f"{model.config.num_layers}L), AdamW multi_precision={o2}, "
        f"B={BERT_BATCH} S={BERT_SEQ}: loss {first:.4f} -> "
        + " -> ".join(f"{x:.4f}" for x in losses) + f" over {n_steps} steps"
        f" after {warmup} warm-up; step {dt * 1e3:.3f} ms (median of "
        f"{windows} windows of {steps}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in dts) + f") = "
        f"{tokens / dt:.1f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"(6 N tokens); peak memory {peak / 2 ** 30:.2f} GiB; warm-up "
        f"{warm_s:.2f} s")
    log("bert", f"[{smi}] {tag} launches over {n_steps} steps: " + ", ".join(
        f"{n} {counts[n]} = {per} x {n_steps}"
        for n, per in per_step.items() if per))
    if profile:
        wall, busy, count, top, by = profile_ms(
            lambda: step(ids, tt, ids), reps=2, n_top=8)
        if busy is None:
            log("bert", f"[{smi}] {tag} step wall {wall:.3f} ms; device "
                "time not measured (the profiler saw no device activity)")
        else:
            parts = _bert_step_split(by)
            log("bert", f"[{smi}] {tag} where a step goes (torch.profiler, 2 "
                f"steps): wall {wall:.3f} ms, device busy {busy:.3f} ms "
                f"({100 * busy / wall:.1f}%), idle {wall - busy:.3f} ms, "
                f"{count:.0f} kernels; " + ", ".join(
                    f"{k} {ms:.3f} ms ({100 * ms / wall:.1f}%)"
                    for k, ms in parts.items()))
            log("bert", f"[{smi}] {tag} top kernels: " + "; ".join(
                f"{name} x{n:.0f} {t:.3f} ms" for name, n, t in top))
    del step, opt, wrap
    return mfu


def _bert_loss_and_grads(model, ids, labels, use_kernel):
    from paddle_tpu_torch.incubate.nn import set_use_kernel

    set_use_kernel(model, use_kernel)
    try:
        named = list(model.named_parameters())
        loss = model(ids, token_type_ids=torch.zeros_like(ids),
                     masked_lm_labels=labels)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    finally:
        set_use_kernel(model, True)
    # a parameter the loss does not read (the NSP head, the pooler, the
    # unused pre-LN scales) has no gradient on either path
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)
                                  if g is not None}


# BERT's bf16 gradients, kernel path vs plain path at the initial
# weights, are held per row at phase 10's 8e-2 x the row's max|g|
# (GRADS_BF16_TOL), with the row scale floored at BERT_GRADS_FLOOR x its
# tensor's max|g|, not at phase 10's 1e-3; and every row, however small,
# within its own max|g| (floored at 1e-3 x the tensor's). The rows under
# the floor are small next to their tensor (rows of `wte`, of the late
# blocks' attention projections), and one bf16 rounding that falls the
# other way moves them by more than 8e-2 of their own size on either
# path: `chip_smoke.py --bert-grads` (an H100, PERF.md) finds every row
# over 8e-2 under 6.3e-2 x its tensor's max|g|, on two seeds, with the
# labels drawn apart from the ids and with the decoder untied, and the
# plain path as far from an f32 copy of the weights on them as from the
# kernel path. After 15 steps such rows reach 0.11 x their tensor's,
# and the plain path is 0.13 x a row off f32 at this floor, so the check
# runs on the initial weights, as chip_mutants.py's BERT faults do.
BERT_GRADS_FLOOR = 0.1


def bert_bf16_grads_check(tag, model, ids):
    """Loss (1e-3 relative) and every gradient of the bf16 model, kernel
    path vs plain path from the same weights; see BERT_GRADS_FLOOR.
    Returns the worst row ratio at the floor."""
    loss_k, gk = _bert_loss_and_grads(model, ids, ids, True)
    loss_p, gp = _bert_loss_and_grads(model, ids, ids, False)
    if abs(loss_k - loss_p) > GRADS_BF16_TOL[0] * abs(loss_p):
        raise AssertionError(f"{tag}: loss {loss_k} vs plain {loss_p}")
    if set(gk) != set(gp):
        raise AssertionError(f"{tag}: the two paths give gradients to "
                             "different parameters")
    worst, own = (0.0, ""), (0.0, "")
    for name, want in gp.items():
        got = gk[name]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: non-finite grad {name}")
        worst = max(worst, (assert_close_rows(
            f"{tag} {name}", got, want, GRADS_BF16_TOL[1],
            BERT_GRADS_FLOOR)[1], name))
        own = max(own, (assert_close_rows(f"{tag} {name}", got, want,
                                          1.0)[1], name))
    log("grads", f"{tag}: loss kernel {loss_k:.6f} plain {loss_p:.6f} (tol "
        f"{GRADS_BF16_TOL[0]} rel); worst grad row max|err| / row scale "
        f"{worst[0]:.3e} ({worst[1]}), tolerance {GRADS_BF16_TOL[1]} with "
        f"the row scale floored at {BERT_GRADS_FLOOR} x the tensor's "
        f"max|g|; worst row against its own max|g| {own[0]:.3e} "
        f"({own[1]}), tolerance 1; on every row of {len(gp)} parameters")
    return worst[0]


class _UntiedEmbedding(torch.nn.Module):
    """BERT's word embedding with the MLM decoder untied: the lookup
    keeps the embedding, and `weight`, which the decoder reads, becomes
    a copy of it."""

    def __init__(self, emb):
        super().__init__()
        self.lookup = emb
        self.weight = torch.nn.Parameter(emb.weight.detach().clone())

    def forward(self, ids):
        return self.lookup(ids)


def _row_stats(got, want):
    """Per row (the last axis): max|got - want| and max|want|, flat, and
    the tensor's max|want|."""
    g, w = got.float(), want.float()
    row = w.abs().amax(dim=-1).flatten()
    return (g - w).abs().amax(dim=-1).flatten(), row, float(row.max())


def bert_grads_rows(dev, smi, floors=(1e-3, 1e-2, 3e-2, 1e-1)):
    """--bert-grads: where BERT-base's bf16 gradient rows disagree. For
    each variant (the weights' seed, the labels, the decoder tied or
    not, trained or not) one step's gradients through the kernels, the
    plain versions and an f32 copy of the same weights (plain versions);
    logs, for kernel vs plain, plain vs f32 and kernel vs f32, the worst
    row ratio max|err| / row scale at each scale floor, how many rows
    are over phase 10's 8e-2 at the 1e-3 floor and the largest of those
    rows' max|g| relative to its tensor's."""
    variants = [("seed 0, ids as labels", 0, 0, False, 0),
                ("seed 1 (weights and ids), ids as labels", 1, None, False,
                 0),
                ("seed 0, labels a second draw of ids", 0, 1, False, 0),
                ("seed 0, decoder untied, ids as labels", 0, 0, True, 0),
                ("seed 0 after 15 O2 steps, ids as labels", 0, 0, False,
                 BERT_WARMUP + BERT_WINDOWS * BERT_STEPS)]
    for tag, seed, label_seed, untie, steps in variants:
        model = _bert_model(dev, seed=seed)
        ref = _bert_model(dev, o2=False, seed=seed)
        if untie:
            for m in (model, ref):
                m.bert.embeddings.word_embeddings = _UntiedEmbedding(
                    m.bert.embeddings.word_embeddings)
        ids, _ = _bert_batch(model.config.vocab_size, dev, seed)
        labels = ids if label_seed in (None, seed) else _bert_batch(
            model.config.vocab_size, dev, label_seed)[0]
        if steps:
            _bert_train(dev, smi, model, f"--bert-grads {tag}",
                        warmup=BERT_WARMUP, windows=BERT_WINDOWS,
                        steps=BERT_STEPS, profile=False)
        with torch.no_grad():
            for (n, p), (n2, q) in zip(ref.named_parameters(),
                                       model.named_parameters()):
                assert n == n2
                p.copy_(q.float())
        loss_k, gk = _bert_loss_and_grads(model, ids, labels, True)
        loss_p, gp = _bert_loss_and_grads(model, ids, labels, False)
        loss_t, gt = _bert_loss_and_grads(ref, ids, labels, False)
        del model, ref
        torch.cuda.empty_cache()
        parts = []
        for pair, a, b in (("kernel vs plain", gk, gp),
                           ("plain vs f32", gp, gt),
                           ("kernel vs f32", gk, gt)):
            worst = {f: (0.0, "") for f in floors}
            over, rel_over = 0, (0.0, "")
            for name, want in b.items():
                err, row, top = _row_stats(a[name], want)
                for f in floors:
                    r = float((err / row.clamp_min(max(f * top, 1e-30)))
                              .max())
                    worst[f] = max(worst[f], (r, name))
                bad = err > GRADS_BF16_TOL[1] * row.clamp_min(
                    max(1e-3 * top, 1e-30))
                if bool(bad.any()):
                    over += int(bad.sum())
                    rel_over = max(rel_over, (float(row[bad].max()) / top,
                                              name))
            parts.append(
                f"{pair}: worst row ratio at floor " + ", ".join(
                    f"{f:g} {r:.3e} ({n})" for f, (r, n) in worst.items())
                + f"; {over} rows over {GRADS_BF16_TOL[1]} at floor 1e-3, "
                f"the largest of them {rel_over[0]:.3e} x its tensor's "
                f"max|g| ({rel_over[1]})")
        log("grads", f"[{smi}] --bert-grads {tag}: loss kernel {loss_k:.6f}"
            f" plain {loss_p:.6f} f32 {loss_t:.6f}; " + " | ".join(parts))
        del gk, gp, gt
        torch.cuda.empty_cache()


def phase_bert(dev, smi):
    """Phase 18: BERT-base pretraining (see the module docstring)."""
    errs = bert_kernel_checks(dev)
    log("bert", f"[{smi}] kernels vs plain at BERT's shapes: flash B32 H12 "
        f"S512 D64 bf16 non-causal per row (o {errs['o']:.3e}, dq "
        f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e}; tol "
        f"{FLASH_BF16_ROW_TOL} x row max|ref|) and f32 B2 (2e-5 / 2e-4); "
        f"LayerNorm 16384x768 bf16, residual none / bf16 / f32, eps 1e-12 "
        f"and 1e-5, w/b f32 and bf16: forward max|err| {errs['ln_fwd']:.3e}"
        f" (y 1e-2 abs + rel, mean/rstd 1e-5, s bit-identical), backward "
        f"{errs['ln_bwd']:.3e} (dx 1e-2 x max|ref|, dw/db 1e-5 x max|ref|)")
    kernel_times(dev, smi, "bert", BERT_BATCH, BERT_ROWS,
                 (torch.bfloat16,), torch.bfloat16, o1_case=True)
    model = _bert_model(dev)
    ids, _ = _bert_batch(model.config.vocab_size, dev)
    bert_bf16_grads_check(f"BERT-base {model.config.num_layers}L bf16 O2, "
                          "initial weights", model, ids)
    bert_adam_times(dev, smi, list(model.named_parameters()))
    mfu = _bert_train(dev, smi, model, "BERT-base bf16 O2")
    del model
    torch.cuda.empty_cache()
    small = _bert_model(dev, num_layers=2, o2=False)
    _grads_check("BERT-base width 2L f32", small, ids, ids, *GRADS_F32_TOL,
                 loss_and_grads=_bert_loss_and_grads)
    del small
    torch.cuda.empty_cache()

    # O1: f32 parameters, the forward under auto_cast; the flash kernels
    # must see bf16 q/k/v
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    seen = []
    real_fwd = fa.flash_attention_fwd

    def spy(q, *a, **kw):
        seen.append(q.dtype)
        return real_fwd(q, *a, **kw)

    fa.flash_attention_fwd = spy
    try:
        o1 = _bert_model(dev, o2=False)
        _bert_train(dev, smi, o1, "BERT-base f32 params, O1", amp_level="O1",
                    warmup=1, windows=2, steps=2, profile=False)
    finally:
        fa.flash_attention_fwd = real_fwd
    if not seen or set(seen) != {torch.bfloat16}:
        raise AssertionError(f"bert O1: flash forward saw {set(seen)}")
    log("bert", f"[{smi}] O1: {len(seen)} flash forward launches, every one "
        "on bf16 q/k/v")
    del o1
    torch.cuda.empty_cache()
    return mfu


# -- phase 19 ----------------------------------------------------------
# hapi.Model.fit of phase 18's BERT-base recipe over a seeded DataLoader:
# 192 rows of ids from RandomState(0), batches of 32 shuffled by
# BatchSampler(seed=11): 6 steps an epoch, 2 epochs; AdamW under a
# warm-up to 1e-4 over 4 steps and a cosine decay, so every step runs
# at another learning rate; training-state snapshots every 4 steps,
# async, the newest 2 kept; the kill lands once step 8's manifest is on
# disk, two batches into the second epoch
FIT_ROWS, FIT_EPOCHS, FIT_SAVE_STEPS, FIT_KILL_AT = 192, 2, 4, 8
FIT_STEPS = FIT_ROWS // BERT_BATCH * FIT_EPOCHS
FIT_KERNELS = ("fused_layer_norm", "fused_layer_norm_bwd",
               "flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "fused_adam")
# the timed loops: 2 warm-up steps, then 3 windows of 10, each window
# holding one save of the checkpointed loop (bench.py:178-217's
# CKPT_EVERY)
FIT_WINDOW, FIT_WINDOWS, FIT_CKPT_EVERY = 10, 3, 10


def _fit_loss(logits, nsp, labels):
    """bench_bert's loss: the MLM cross-entropy, the ids as labels."""
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits, labels, ignore_index=-1)


def _fit_loader(dev, vocab):
    from paddle_tpu_torch.io import BatchSampler, DataLoader, TensorDataset

    ids = np.random.RandomState(0).randint(0, vocab, (FIT_ROWS, BERT_SEQ))
    ids = torch.from_numpy(ids.astype(np.int64))
    ds = TensorDataset([ids, torch.zeros_like(ids), ids])
    return DataLoader(ds, batch_sampler=BatchSampler(
        ds, shuffle=True, batch_size=BERT_BATCH, drop_last=True, seed=11),
        device=dev)


def _fit_sched():
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, FIT_STEPS), 4,
                           0.0, 1e-4)


def _digest(t):
    import hashlib

    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()).hexdigest()


def fit_worker(dev=None):
    """`--fit-worker`: one run of phase 19 (PADDLE_CKPT_DIR and
    PADDLE_JOB_ID say where its snapshots go; FIT_STALL_AT parks it
    after that step's loss is logged). Logs "<global step> <loss hex>"
    to FIT_LOG, fsynced; writes FIT_RESULT: each step's launches, the
    restore and first-step times, and sha256 digests of the final
    parameters and optimizer slots with the step count and learning
    rate."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dev or torch.device("cuda", 0)
    kernels.load()
    stall_at = int(os.environ.get("FIT_STALL_AT", "-1"))
    log_path = os.environ["FIT_LOG"]
    model = _bert_model(dev)
    opt = AdamW(learning_rate=_fit_sched(), parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    m = Model(model).prepare(opt, _fit_loss)
    rec = {"launches": [], "want": _bert_launches(model)}

    class Log(Callback):
        def on_train_begin(self, logs=None):
            torch.cuda.synchronize(dev)
            rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
            rec["start_step"] = self.model._ckpt_manager.global_step
            kernels.reset_launches()

        def on_train_batch_end(self, step, logs=None):
            mgr = self.model._ckpt_manager
            g = mgr.global_step
            rec.setdefault("first_step_ms", (time.perf_counter() - t0) * 1e3)
            rec["launches"].append(kernels.launches())
            kernels.reset_launches()
            with open(log_path, "a") as f:
                f.write(f"{g} {float(logs['loss']).hex()}\n")
                f.flush()
                os.fsync(f.fileno())
            if g == stall_at:
                mgr.flush(600)
                while True:      # the parent SIGKILLs this process
                    time.sleep(0.5)

    t0 = time.perf_counter()
    m.fit(_fit_loader(dev, model.config.vocab_size), epochs=FIT_EPOCHS,
          verbose=0, resume="auto",
          callbacks=[Log()])
    slots = opt._slot_state(list(model.named_parameters()))
    rec["final"] = {
        "params": {n: _digest(p) for n, p in model.named_parameters()},
        "slots": {f"{n}.{k}": _digest(v) for n, sl in slots.items()
                  for k, v in sl.items()},
        "step_count": opt._step_count, "lr": opt.get_lr()}
    with open(os.environ["FIT_RESULT"], "w") as f:
        json.dump(rec, f)
    return 0


def _fit_env(tmp, name, stall_at=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_")}
    env.update(PADDLE_CKPT_DIR=os.path.join(tmp, f"{name}_ckpt"),
               PADDLE_JOB_ID="phase19",
               PADDLE_CKPT_SAVE_STEPS=str(FIT_SAVE_STEPS),
               PADDLE_CKPT_MAX_NUM="2",
               FIT_LOG=os.path.join(tmp, f"{name}.log"),
               FIT_RESULT=os.path.join(tmp, f"{name}.json"))
    if stall_at is not None:
        env["FIT_STALL_AT"] = str(stall_at)
    return env


def _fit_cmd():
    cmd = [sys.executable, os.path.abspath(__file__), "--fit-worker"]
    if "--tree" in sys.argv:
        cmd += ["--tree", sys.argv[sys.argv.index("--tree") + 1]]
    return cmd


def _fit_log(path):
    out = {}
    with open(path) as f:
        for line in f:
            g, h = line.split()
            out[int(g)] = h
    return out


def _fit_run(tmp, name, ckpt_from=None):
    """One run to its end as a subprocess; (losses by step, result)."""
    env = _fit_env(tmp, name)
    if ckpt_from is not None:
        env["PADDLE_CKPT_DIR"] = os.path.join(tmp, f"{ckpt_from}_ckpt")
    res = subprocess.run(_fit_cmd(), env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"fit run {name} failed (exit {res.returncode}):"
                           f"\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    with open(env["FIT_RESULT"]) as f:
        return _fit_log(env["FIT_LOG"]), json.load(f)


def _fit_killed_run(tmp, name):
    """A run SIGKILLed (its whole process group) once step FIT_KILL_AT's
    manifest is on disk and that step's loss is logged; its losses."""
    import signal

    env = _fit_env(tmp, name, stall_at=FIT_KILL_AT)
    manifest = os.path.join(env["PADDLE_CKPT_DIR"], "phase19", "train_state",
                            f"step_{FIT_KILL_AT}", "manifest.json")
    proc = subprocess.Popen(_fit_cmd(), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.monotonic() + 900
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError("fit run B exited before its kill:\n"
                                   + proc.stdout.read().decode()[-4000:])
            if (os.path.exists(manifest) and os.path.exists(env["FIT_LOG"])
                    and FIT_KILL_AT in _fit_log(env["FIT_LOG"])):
                break
            if time.monotonic() > deadline:
                raise RuntimeError("fit run B never reached its kill point")
            time.sleep(0.2)
        os.killpg(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(60)
        proc.stdout.close()
    return _fit_log(env["FIT_LOG"])


def _fit_check_launches(tag, rec):
    """Every step of a run launched exactly phase 18's counts of
    kernels #1-6 (and nothing else); the number of steps checked."""
    want = rec["want"]
    if any(want[k] < 1 for k in FIT_KERNELS):
        raise AssertionError(f"fit {tag}: expected launches {want}")
    for i, counts in enumerate(rec["launches"]):
        bad = {k: v for k, v in counts.items() if v != want[k]}
        if bad:
            raise AssertionError(f"fit {tag}: step {i} launched {bad}, "
                                 f"expected {want}")
    return len(rec["launches"])


def fit_resume_check(dev, smi):
    """Runs A, A' (uninterrupted), B (SIGKILLed after step 8's snapshot)
    and C (B's relaunch) as subprocesses; A' and the stitched B + C must
    equal A bit for bit. Returns C's result."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        la, ra = _fit_run(tmp, "A")
        ta = time.perf_counter() - t0
        la2, ra2 = _fit_run(tmp, "A2")
        for name in ("A", "A2"):     # 1.5 GB a snapshot: free the disk
            shutil.rmtree(os.path.join(tmp, f"{name}_ckpt"))
        if sorted(la) != list(range(FIT_STEPS)):
            raise AssertionError(f"fit A logged steps {sorted(la)}")
        if la2 != la or ra2["final"] != ra["final"]:
            diff = [g for g in la if la2.get(g) != la[g]]
            raise AssertionError(
                "fit: A' differs from A (the card's step is not "
                f"deterministic): losses at steps {diff}, final state "
                f"{'equal' if ra2['final'] == ra['final'] else 'differs'}")
        part1 = _fit_killed_run(tmp, "B")
        part2, rc = _fit_run(tmp, "C", ckpt_from="B")
        snaps = sorted(os.listdir(os.path.join(tmp, "B_ckpt", "phase19",
                                               "train_state")))
    if max(part1) != FIT_KILL_AT or min(part2) != FIT_KILL_AT:
        raise AssertionError(f"fit: B logged to step {max(part1)}, C resumed "
                             f"at {min(part2)}; expected {FIT_KILL_AT}")
    overlap = sorted(set(part1) & set(part2))
    if any(part1[g] != part2[g] for g in overlap):
        raise AssertionError(f"fit: the overlap {overlap} differs")
    stitched = dict(part1)
    stitched.update(part2)
    if stitched != la:
        raise AssertionError(
            "fit: stitched B + C differs from A at steps "
            f"{[g for g in la if stitched.get(g) != la[g]]}")
    if rc["final"] != ra["final"]:
        bad = [k for k in ra["final"]["params"]
               if rc["final"]["params"][k] != ra["final"]["params"][k]]
        raise AssertionError(f"fit: C's final state differs from A's "
                             f"(parameters {bad[:5]}, step count "
                             f"{rc['final']['step_count']} vs "
                             f"{ra['final']['step_count']}, lr "
                             f"{rc['final']['lr']} vs {ra['final']['lr']})")
    n = sum(_fit_check_launches(t, r)
            for t, r in (("A", ra), ("A'", ra2), ("C", rc)))
    want = rc["want"]
    fin = ra["final"]
    masters = sum(k.endswith(".master_weight") for k in fin["slots"])
    log("fit", f"[{smi}] BERT-base bf16 O2 through Model.fit, "
        f"{FIT_STEPS} steps ({FIT_EPOCHS} epochs of {FIT_ROWS} rows, B "
        f"{BERT_BATCH} x S {BERT_SEQ}, BatchSampler seed 11), snapshots "
        f"every {FIT_SAVE_STEPS} steps: loss "
        f"{float.fromhex(la[0]):.4f} -> "
        f"{float.fromhex(la[FIT_STEPS - 1]):.4f};"
        f" A' = A bit for bit ({FIT_STEPS} losses, {len(fin['params'])} "
        f"parameters and {len(fin['slots'])} slots by sha256, {masters} of "
        f"them f32 master weights, step count {fin['step_count']}, lr "
        f"{fin['lr']!r}); run A {ta:.1f} s")
    log("fit", f"[{smi}] B SIGKILLed after step {FIT_KILL_AT}'s manifest "
        f"(snapshots left: {', '.join(snaps)}); C resumed at step "
        f"{min(part2)} (epoch 1, 2 batches fast-forwarded): overlap "
        f"{overlap} bit-identical, stitched {len(stitched)} losses = A's, "
        f"final parameters, slots, step count and lr = A's bit for bit; "
        f"restore {rc['restore_ms']:.1f} ms, restore to the end of the first"
        f" resumed step {rc['first_step_ms']:.1f} ms; every one of {n} steps"
        " launched " + ", ".join(f"{k} {want[k]}" for k in FIT_KERNELS))
    return rc


def _windows(stamps):
    """Per-step seconds of each FIT_WINDOW-step window of the step-end
    times `stamps`, after 2 warm-up steps."""
    return [(stamps[2 + (i + 1) * FIT_WINDOW] - stamps[2 + i * FIT_WINDOW])
            / FIT_WINDOW for i in range(FIT_WINDOWS)]


def fit_times(dev, smi):
    """Model.fit's step against the bare TrainStepCompiler step with the
    same loss; the fit with a snapshot every FIT_CKPT_EVERY steps against
    without (bench.py's ckpt_overhead_pct); the capture and the writer's
    ms; the EMA's update and apply / restore; framework.save / load of
    the bf16 state dict."""
    import tempfile

    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW, ExponentialMovingAverage

    n = 2 + FIT_WINDOW * FIT_WINDOWS + 1
    model = _bert_model(dev)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    loader = _fit_loader(dev, model.config.vocab_size)
    batch = next(iter(loader))
    step = TrainStepCompiler(model, opt,
                             lambda out, lbl: _fit_loss(*out, lbl))
    for _ in range(2):
        loss = step(*batch)
    bare = []
    for _ in range(FIT_WINDOWS):
        # phase 18's windows: one synchronisation at the end of each
        float(loss)
        t0 = time.perf_counter()
        for _ in range(FIT_WINDOW):
            loss = step(*batch)
        float(loss)
        bare.append((time.perf_counter() - t0) / FIT_WINDOW)

    class Stamp(Callback):
        """Step-end times; with `ckpt`, the manager's maybe_save at every
        step, its cadence putting a save at steps 2, 12, 22 and 32: one in
        each window."""

        def __init__(self, ckpt=None):
            super().__init__()
            self.t, self.ckpt = [], ckpt

        def on_train_batch_end(self, s, logs=None):
            self.t.append(time.perf_counter())
            if self.ckpt is not None:
                self.ckpt.maybe_save(self.model._training_state,
                                     global_step=len(self.t) + 7)

    m = Model(model).prepare(opt, _fit_loss)
    plain = Stamp()
    m.fit(loader, epochs=99, num_iters=n, verbose=0, callbacks=[plain])
    keys = ("ckpt/saves", "ckpt/dropped", "ckpt/capture_us",
            "ckpt/write_us", "ckpt/bytes")
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(dir=os.path.join(tmp, "ck"),
                                save_steps=FIT_CKPT_EVERY, max_num=2,
                                async_write=True, device=dev)
        c0 = {k: monitor.stat_get(k) for k in keys}
        # two saves first: the pool's two sets of pinned buffers (one
        # with the writer, one being captured) are allocated here
        mgr.save(m._training_state(), global_step=1)
        mgr.flush(600)
        c1 = {k: monitor.stat_get(k) for k in keys}
        mgr.save(m._training_state(), global_step=2)
        mgr.flush(600)
        c2 = {k: monitor.stat_get(k) for k in keys}
        ck = Stamp(mgr)
        m.fit(loader, epochs=99, num_iters=n, verbose=0, callbacks=[ck])
        mgr.close(600)
        c3 = {k: monitor.stat_get(k) for k in keys}
        snap_files = os.listdir(os.path.join(tmp, "ck"))
    fit_w, ck_w = _windows(plain.t), _windows(ck.t)
    d = {k: c3[k] - c2[k] for k in keys}
    saves, dropped = d["ckpt/saves"], d["ckpt/dropped"]
    if saves + dropped != FIT_WINDOWS + 1 or not saves:
        raise AssertionError(f"fit: {saves} snapshots written and {dropped} "
                             f"dropped in the checkpointed loop, expected "
                             f"{FIT_WINDOWS + 1} captures")
    capture_ms = d["ckpt/capture_us"] / 1e3 / (saves + dropped)
    dt_bare, dt_fit, dt_ck = (float(np.median(w)) * 1e3
                              for w in (bare, fit_w, ck_w))
    log("fit", f"[{smi}] step ms (median of {FIT_WINDOWS} windows of "
        f"{FIT_WINDOW}): bare TrainStepCompiler {dt_bare:.3f} ("
        + ", ".join(f"{x * 1e3:.3f}" for x in bare) + f"), Model.fit "
        f"{dt_fit:.3f} (" + ", ".join(f"{x * 1e3:.3f}" for x in fit_w)
        + f"): hapi's host cost {dt_fit - dt_bare:.3f} ms a step "
        f"({100 * (dt_fit / dt_bare - 1):.2f}%; fit reads the loss every "
        "step, the bare loop once a window)")
    log("fit", f"[{smi}] Model.fit with a snapshot every {FIT_CKPT_EVERY} "
        f"steps {dt_ck:.3f} ms (" + ", ".join(f"{x * 1e3:.3f}" for x in ck_w)
        + f"): checkpoint cost {100 * (dt_ck / dt_fit - 1):.2f}% "
        f"(bench.py's ckpt_overhead_pct); {saves + dropped} captures, "
        f"{saves} written, {dropped} dropped by the latest-wins writer; "
        f"capture on the step thread {capture_ms:.3f} ms a snapshot into "
        f"pooled pinned buffers (the first, allocating its set: "
        f"{(c1['ckpt/capture_us'] - c0['ckpt/capture_us']) / 1e3:.3f} ms), "
        f"the writer's pickle + fsync {d['ckpt/write_us'] / 1e3 / saves:.3f}"
        f" ms, {d['ckpt/bytes'] / saves:.0f} bytes a snapshot; kept: "
        f"{', '.join(sorted(snap_files))}")
    # the EMA over the 206 parameters; apply / restore bit for bit
    params = list(model.parameters())
    ema = ExponentialMovingAverage(params, decay=0.999)
    ema_dev, ema_host = chain_ms(ema.update, iters=20)
    before = [p.detach().clone() for p in params]
    want = ema._corrected()
    with ema.apply():
        inside = all(torch.equal(p, w) for p, w in zip(params, want))
    after = all(torch.equal(p, b) for p, b in zip(params, before))
    if not (inside and after):
        raise AssertionError(f"fit: EMA apply {inside}, restore {after}")
    log("fit", f"[{smi}] ExponentialMovingAverage.update() over "
        f"{len(params)} parameters: {ema_dev:.3f} ms device, "
        f"{ema_host:.3f} ms host a call (chained 20); apply() swaps in the "
        "bias-corrected shadows bit for bit and restore() gives the "
        "parameters back bit for bit")
    del ema, before, want
    sd = model.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.pdparams")
        t0 = time.perf_counter()
        framework.save(sd, path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = framework.load(path)
        t_load = time.perf_counter() - t0
    bad = [k for k, v in sd.items()
           if back[k].dtype != v.dtype or not torch.equal(back[k], v.cpu())]
    n_bf16 = sum(v.dtype == torch.bfloat16 for v in sd.values())
    if bad or set(back) != set(sd):
        raise AssertionError(f"fit: framework.save / load changed {bad[:5]}")
    log("fit", f"[{smi}] framework.save / load of the O2 state dict "
        f"({len(sd)} tensors, {n_bf16} bf16, {size} bytes): bit for bit; "
        f"save {t_save * 1e3:.1f} ms, load {t_load * 1e3:.1f} ms (host "
        "clock)")
    del m, step, opt, model, sd, back


def phase_fit(dev, smi):
    """Phase 19: BERT-base through hapi.Model.fit, checkpointed, killed
    and resumed (see the module docstring)."""
    fit_resume_check(dev, smi)
    torch.cuda.empty_cache()
    fit_times(dev, smi)
    torch.cuda.empty_cache()


# -- phases 20-21 --------------------------------------------------------
# bench_mnist's recipe (bench.py:114-150): LeNet f32, Adam(1e-3),
# CrossEntropyLoss, B 1024 x 1x28x28 from RandomState(0); then K = 8
# steps a dispatch. bench_resnet50's on-chip recipe (bench.py:252-296):
# ResNet-50 (1000 classes, NCHW) bf16 O2, Momentum(0.01, 0.9,
# multi_precision), B 128 x 3x224x224 bf16 from RandomState(0), 5
# warm-up steps, then 3 windows of 20 synchronised steps. The FLOP
# counts are bench's: 3 x 0.00042 GFLOP an image for LeNet, 3 x 4.09
# GFLOP an image for ResNet-50 at 224.
LENET_BATCH, LENET_K = 1024, 8
LENET_WARMUP, LENET_STEPS, LENET_WINDOWS = 5, 60, 3
LENET_FLOP = 3 * 0.00042e9
RESNET_BATCH, RESNET_SIZE = 128, 224
RESNET_WARMUP, RESNET_STEPS, RESNET_WINDOWS = 5, 20, 3
RESNET_PROBE_STEPS = 8       # each cuDNN / layout setting's short timing
RESNET_FLOP = 3 * 4.09e9


def _launch_counts(before=None):
    """Kernel launches since `before` (a `kernels.launches()` dict)."""
    from paddle_tpu_torch.incubate.nn import kernels

    now = kernels.launches()
    return now if before is None else {k: v - before[k]
                                       for k, v in now.items()}


def _timed_windows(step, args, windows, steps):
    """(per-step seconds of each window, last loss of each window): each
    window `steps` calls, synchronised by reading the loss."""
    dts, losses = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(*args)
        losses.append(float(loss.reshape(-1)[-1].item()))
        dts.append((time.perf_counter() - t0) / steps)
    return dts, losses


def _only_launches(tag, got, want):
    """Every kernel's launches exactly `want` (the others 0)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{tag}: launches {got}, expected {full}")


def phase_lenet(dev, smi):
    """Phase 20: kernel #6 on LeNet's parameter set (`optim_at_shape`),
    then LeNet trained to bench_mnist's recipe through
    TrainStepCompiler, plain and K = 8 steps a dispatch: the loss falls,
    exactly one fused_adam launch a step and no other kernel of the
    port; imgs/s (median of the windows), MFU, peak memory."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(LENET_BATCH, 1, 28, 28).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, (LENET_BATCH,)).astype(
        np.int64)).to(dev)
    ce = nn.CrossEntropyLoss()
    gen = torch.Generator(device=dev).manual_seed(0)
    named = list(LeNet(device=dev, generator=gen).named_parameters())
    optim_at_shape(dev, smi, "lenet", named, "fused_adam",
                   ("LeNet's f32 set", "Adam", dict(learning_rate=1e-3), {}),
                   dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8),
                   lambda ps: torch.optim.Adam(ps, lr=1e-3, fused=True))
    results = {}
    for k in (1, LENET_K):
        gen = torch.Generator(device=dev).manual_seed(0)
        net = LeNet(device=dev, generator=gen)
        named = list(net.named_parameters())
        opt = Adam(learning_rate=1e-3, parameters=named)
        step = TrainStepCompiler(net, opt, lambda o, t: ce(o, t),
                                 steps_per_dispatch=k)
        if k == 1:
            args = (x, y)
        else:
            xs = torch.from_numpy(rng.randn(k, LENET_BATCH, 1, 28, 28)
                                  .astype(np.float32)).to(dev)
            ys = torch.from_numpy(rng.randint(0, 10, (k, LENET_BATCH))
                                  .astype(np.int64)).to(dev)
            args = (xs, ys)
        first = float(step(*args).reshape(-1)[0].item())
        for _ in range(LENET_WARMUP - 1):
            step(*args)
        calls = max(1, LENET_STEPS // k)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        dts, losses = _timed_windows(step, args, LENET_WINDOWS, calls)
        n_steps = LENET_WINDOWS * calls * k
        _only_launches(f"lenet K={k}", _launch_counts(),
                       {"fused_adam": n_steps})
        last = losses[-1]
        if not (np.isfinite(last) and last < first):
            raise AssertionError(f"lenet K={k}: loss did not decrease "
                                 f"({first:.4f} -> {last:.4f})")
        dt = float(np.median(dts)) / k
        results[k] = dict(dt=dt, dts=dts, first=first, losses=losses,
                          peak=torch.cuda.max_memory_allocated(dev),
                          n_steps=n_steps, tensors=len(named),
                          elements=sum(p.numel() for _, p in named))
        del net, opt, step
    r1, rk = results[1], results[LENET_K]
    for k, r in results.items():
        mfu = LENET_FLOP * LENET_BATCH / r["dt"] / PEAK_BF16_FLOPS
        log("lenet", f"[{smi}] LeNet f32, Adam(1e-3), B={LENET_BATCH}, "
            f"steps_per_dispatch={k}: loss {r['first']:.4f} -> " + " -> ".join(
                f"{v:.4f}" for v in r["losses"]) + f"; step "
            f"{r['dt'] * 1e3:.3f} ms (median of {LENET_WINDOWS} windows of "
            f"{r['n_steps'] // LENET_WINDOWS} steps, per step: " + ", ".join(
                f"{v / k * 1e3:.3f}" for v in r["dts"]) + f") = "
            f"{LENET_BATCH / r['dt']:.1f} imgs/s, MFU {100 * mfu:.4f}% "
            f"(3 x 0.00042 GFLOP an image over 989 TFLOP/s); peak memory "
            f"{r['peak'] / 2 ** 30:.3f} GiB; fused_adam {r['n_steps']} "
            f"launches = 1 x {r['n_steps']} steps over {r['tensors']} f32 "
            f"tensors, {r['elements']} elements")
    log("lenet", f"[{smi}] K={LENET_K} over K=1: "
        f"{r1['dt'] / rk['dt']:.3f}x the imgs/s")


def _resnet_step_split(by, bn_ms):
    """{part: device ms} of a profiled ResNet-50 step's {kernel: ms}:
    the cuDNN convolutions (and the layout transforms and GEMMs around
    them), the optimizer, BatchNorm (`bn_ms`, the device time of the
    kernels its forward and backward launched) and the rest."""
    parts = {"convolutions": 0.0, "BatchNorm": bn_ms, "optimizer": 0.0,
             "other elementwise": 0.0}
    for name, ms in by.items():
        low = name.lower()
        if "multi_tensor_optim" in low:
            parts["optimizer"] += ms
        elif any(s in low for s in ("conv", "cudnn", "xmma", "implicit",
                                    "wgrad", "dgrad", "fprop", "gemm",
                                    "nchwtonhwc", "nhwctonchw", "cutlass",
                                    "nvjet", "sm90")):
            parts["convolutions"] += ms
        else:
            parts["other elementwise"] += ms
    parts["other elementwise"] -= bn_ms
    return parts


def _bn_device_ms(prof, reps):
    """Device ms a step of the kernels launched inside the "batch_norm"
    ranges (the forward) and by BatchNorm's autograd node (the
    backward), or None when the profiler links no kernel to them."""
    def dev_us(e):
        if hasattr(e, "device_time_total"):
            return e.device_time_total
        return e.cuda_time_total

    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.name == "batch_norm" or "_BatchNormTrainBackward" in e.name:
            parent = e.cpu_parent
            nested = False
            while parent is not None:
                if (parent.name == "batch_norm"
                        or "_BatchNormTrainBackward" in parent.name):
                    nested = True
                    break
                parent = parent.cpu_parent
            if not nested:
                total += dev_us(e)
    return total / reps / 1e3 if total else None


def _resnet_profile(step, args, reps=2):
    """torch.profiler over `reps` steps with every BatchNorm forward in a
    "batch_norm" range: (wall ms, busy ms, kernels, top, {kernel: ms},
    BatchNorm ms or None)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.nn import functional as F

    orig = F.batch_norm

    def ranged(*a, **kw):
        with record_function("batch_norm"):
            return orig(*a, **kw)

    wall, busy, count, top, by = profile_ms(lambda: step(*args), reps=reps,
                                            n_top=8)
    F.batch_norm = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step(*args)
            torch.cuda.synchronize()
    finally:
        F.batch_norm = orig
    return wall, busy, count, top, by, _bn_device_ms(prof, reps)


def _resnet_o2_set(named):
    """(bf16 tensors, their elements, f32 tensors, their elements) of an
    O2 parameter set."""
    half = [p for _, p in named if p.dtype == torch.bfloat16]
    full = [p for _, p in named if p.dtype == torch.float32]
    return (len(half), sum(p.numel() for p in half), len(full),
            sum(p.numel() for p in full))


def optim_at_shape(dev, smi, tag, named, kernel, case, kw, library,
                   iters=50):
    """A multi-tensor optimizer kernel on a model's own parameter set:
    bit for bit against the per-parameter rule after every one of 3
    steps (phase 11's check, `case`), then its time (`time_ms`: the
    wrapper builds its table on the host in about the kernel's own time,
    so the card is held while the calls are enqueued) against the bound,
    its plain version and `library(params)`, a torch.optim fused step
    on f32 copies."""
    from paddle_tpu_torch.incubate.nn.kernels import optim as ko

    grads = _optim_grads(named, dev)
    optim_checks(named, grads, cases=[case])
    g0 = grads[0]
    lists = _optim_lists(named, g0, kernel)
    fn, ref = getattr(ko, kernel), getattr(ko, kernel + "_reference")
    k_ms, k_host = time_ms(lambda: fn(*lists, **kw), iters)
    p_ms, _ = chain_ms(lambda: ref(*lists, **kw), max(1, iters // 4))
    lib_p = [p.detach().float().clone() for _, p in named]
    for p, (n, _) in zip(lib_p, named):
        p.grad = g0[n].float()
    lib = library(lib_p)
    l_ms, _ = time_ms(lib.step, iters)
    n_elem = sum(p.numel() for _, p in named)
    nbytes = _optim_bytes(named, g0, kernel)
    ops = {"fused_adam": 15, "fused_momentum": 4, "fused_sgd": 2}[kernel]
    b_ms, b_by = bound_ms(nbytes, ops * n_elem)
    log(tag, f"[{smi}] {kernel} on {case[0]} ({len(named)} tensors, "
        f"{n_elem} elements): bit-identical to the per-parameter rule after "
        f"each of {OPTIM_STEPS} steps, one launch a step; kernel "
        f"{k_ms:.5f} ms | plain {p_ms:.5f} ms | {type(lib).__name__}("
        f"fused=True) on f32 copies {l_ms:.5f} ms | bound {b_ms:.5f} ms "
        f"({b_by}, {nbytes / 1e6:.3f} MB) = {nbytes / k_ms / 1e9:.3f} TB/s, "
        f"{100 * b_ms / k_ms:.1f}% of the bound; host ms a call "
        f"{k_host:.5f}")
    del lists, lib, lib_p, grads


def phase_resnet(dev, smi):
    """Phase 21: ResNet-50 trained to bench_resnet50's on-chip recipe
    (see above): the O2 split, kernel #8 on its parameter set
    (`optim_at_shape`), the step
    timed under each cuDNN autotuning and activation-layout setting (the
    faster one reported, the global setting restored), 3 windows of
    synchronised steps: the loss falls, exactly one fused_momentum
    launch a step, the running statistics finite and moved; imgs/s,
    MFU, peak memory and a profiled step split. Returns (imgs/s, the
    kept setting as (cudnn.benchmark, channels_last))."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    gen = torch.Generator(device=dev).manual_seed(0)
    model = amp.decorate(resnet50(device=dev, generator=gen), level="O2",
                         dtype="bfloat16")
    named = list(model.named_parameters())
    split = _resnet_o2_set(named)
    log("resnet", f"ResNet-50 O2 parameter set: {len(named)} tensors, "
        f"{sum(p.numel() for _, p in named)} elements: {split[0]} bf16 "
        f"with f32 masters ({split[1]} elements), {split[2]} f32 without "
        f"({split[3]} elements); {len(list(model.buffers()))} f32 buffers")
    if split[0] != 55 or split[2] != 106:
        raise AssertionError(f"resnet: O2 split {split}, expected 55 bf16 "
                             "and 106 f32 tensors")
    optim_at_shape(dev, smi, "resnet", named, "fused_momentum",
                   ("ResNet-50's O2 set", "Momentum",
                    dict(learning_rate=0.01, momentum=0.9), {}),
                   dict(lr=0.01, momentum=0.9),
                   lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9,
                                              fused=True))
    torch.cuda.empty_cache()

    ce = nn.CrossEntropyLoss()
    opt = Momentum(learning_rate=0.01, momentum=0.9, parameters=named,
                   multi_precision=True)
    step = TrainStepCompiler(model, opt, lambda o, t: ce(o, t))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(RESNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE).astype(np.float32)).to(
        dev, torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, (RESNET_BATCH,)).astype(
        np.int64)).to(dev)
    stats0 = [b.detach().clone() for b in model.buffers()]
    first = float(step(x, y).item())
    for _ in range(RESNET_WARMUP - 1):
        step(x, y)
    bench0 = torch.backends.cudnn.benchmark
    probe = {}
    try:
        # the weights stay contiguous (the multi-tensor kernel takes
        # contiguous tensors); channels_last is the input's layout, which
        # the convolutions' outputs and the activations follow
        for cl in (False, True):
            xin = x.contiguous(memory_format=torch.channels_last) if cl else x
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                for _ in range(2):
                    step(xin, y)
                dts, _ = _timed_windows(step, (xin, y), 1,
                                        RESNET_PROBE_STEPS)
                probe[(bench, cl)] = dts[0]
        best = min(probe, key=probe.get)
        torch.backends.cudnn.benchmark = best[0]
        xin = x.contiguous(memory_format=torch.channels_last) if best[1] \
            else x
        name = (f"cudnn.benchmark={best[0]}, input "
                f"{'channels_last' if best[1] else 'NCHW-contiguous'}")
        log("resnet", f"[{smi}] step ms by setting ({RESNET_PROBE_STEPS} "
            "synchronised steps each, after 2): " + ", ".join(
                f"cudnn.benchmark={b} {'channels_last' if c else 'NCHW'} "
                f"{v * 1e3:.3f}" for (b, c), v in probe.items())
            + f"; kept: {name}")
        torch.cuda.reset_peak_memory_stats(dev)
        before = _launch_counts()
        dts, losses = _timed_windows(step, (xin, y), RESNET_WINDOWS,
                                     RESNET_STEPS)
        n_steps = RESNET_WINDOWS * RESNET_STEPS
        counts = _launch_counts(before)
        peak = torch.cuda.max_memory_allocated(dev)
        _only_launches("resnet", counts, {"fused_momentum": n_steps})
        last = losses[-1]
        if not (np.isfinite(last) and last < first):
            raise AssertionError(f"resnet: loss did not decrease "
                                 f"({first:.4f} -> {last:.4f})")
        stats = list(model.buffers())
        if not all(bool(torch.isfinite(b).all()) for b in stats):
            raise AssertionError("resnet: a running statistic is not finite")
        moved = sum(not torch.equal(a, b) for a, b in zip(stats0, stats))
        if moved != len(stats):
            raise AssertionError(f"resnet: {len(stats) - moved} running "
                                 "statistics did not move")
        dt = float(np.median(dts))
        mfu = RESNET_FLOP * RESNET_BATCH / dt / PEAK_BF16_FLOPS
        log("resnet", f"[{smi}] ResNet-50 bf16 O2, Momentum(0.01, 0.9, "
            f"multi_precision), B={RESNET_BATCH} x 3x{RESNET_SIZE}x"
            f"{RESNET_SIZE}, {name}: loss {first:.4f} -> " + " -> ".join(
                f"{v:.4f}" for v in losses) + f" over {n_steps} steps after "
            f"{RESNET_WARMUP} warm-up; step {dt * 1e3:.3f} ms (median of "
            f"{RESNET_WINDOWS} windows of {RESNET_STEPS}: " + ", ".join(
                f"{v * 1e3:.3f}" for v in dts) + f") = "
            f"{RESNET_BATCH / dt:.1f} imgs/s, MFU {100 * mfu:.2f}% (3 x 4.09 "
            f"GFLOP an image over 989 TFLOP/s); peak memory "
            f"{peak / 2 ** 30:.2f} GiB; fused_momentum {counts['fused_momentum']}"
            f" launches = 1 x {n_steps}; {moved} running statistics moved, "
            "all finite")
        wall, busy, count, top, by, bn_ms = _resnet_profile(step, (xin, y))
        if busy is None:
            log("resnet", f"[{smi}] step wall {wall:.3f} ms; device time not "
                "measured (the profiler saw no device activity)")
        else:
            parts = _resnet_step_split(by, bn_ms or 0.0)
            if bn_ms is None:
                parts["BatchNorm"] = "not attributed"
            log("resnet", f"[{smi}] where a step goes (torch.profiler, 2 "
                f"steps): wall {wall:.3f} ms, device busy {busy:.3f} ms "
                f"({100 * busy / wall:.1f}%), idle {wall - busy:.3f} ms, "
                f"{count:.0f} kernels; " + ", ".join(
                    f"{k} {v:.3f} ms ({100 * v / wall:.1f}%)"
                    if isinstance(v, float) else f"{k} {v}"
                    for k, v in parts.items()))
            log("resnet", f"[{smi}] top kernels: " + "; ".join(
                f"{n} x{c:.0f} {t:.3f} ms" for n, c, t in top))
    finally:
        torch.backends.cudnn.benchmark = bench0
    del model, opt, step, x, xin
    return RESNET_BATCH / dt, best


# -- phase 28 ------------------------------------------------------------
# bench_resnet50_pipeline's on-chip config (bench.py:319-470, on_tpu true),
# not cut: phase 21's recipe fed by the worker pool, bench's
# _SynthImageNet, FLAGS_dataloader_shm_slot_mb=128, num_workers=-1,
# persistent workers, prefetch_to_device=2, and phase 21's kept cuDNN and
# input-layout setting. Every rate is read in steady state: a loader first
# serves more batches than its rings hold slots (workers x PIPE_SLOTS, so
# each slot has been written and read once in both processes) plus phase
# 21's 5 warm-up batches; then the rings' rates over 40 batches, and end
# to end phase 21's 3 windows of 20 steps, the dataset sized to serve
# all of (c) and (d) in one epoch.
PIPE_SLOTS = 2                # a ring's slots (prefetch_factor 2)
PIPE_LOADER_BATCHES = 40
PIPE_FEED_BATCHES = 20
PIPE_PROFILE_STEPS = 5
PIPE_SLOT_MB = 128
# the gates: 6 batches through 5 workers, so worker 0 alone is fed two
# (batches 0 and 5) and the crash rule, counted per forked worker, fires
# in its second batch only; the restarted worker is re-fed batch 5 alone
# (128 fetches, under `after`). Decode overlap is off in the crash run,
# so batch 0 is in worker 0's ring before batch 5's fetches start: a
# crash before that commit would re-feed batch 0 too and trip again.
PIPE_GATE_BATCHES = 6
PIPE_GATE_WORKERS = 5
PIPE_CHAOS = "io_fetch:crash:after=200:times=1"
PIPE_FALLBACK = "multiprocess DataLoader unavailable"


class _SynthImageNet:
    """bench.py's pipeline dataset (:300-316): one preallocated image
    from RandomState(0), so a sample costs an index and the measured
    cost is collation, ring transport and the copy to the card."""

    def __init__(self, n, size):
        rng = np.random.RandomState(0)
        self.n = n
        self.base = rng.randn(3, size, size).astype(np.float32)
        self.labels = rng.randint(0, 1000, (n,)).astype(np.int64)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.base, self.labels[i]


class _IndexedImages(_SynthImageNet):
    """The gates' dataset: image i is base + i x 1e-3, so a batch out of
    order, or read after its ring slot was reused, changes the loss."""

    def __getitem__(self, i):
        return self.base + np.float32(i * 1e-3), self.labels[i]


def _np_collate_pair(b):
    xs, ys = zip(*b)
    return np.stack(xs), np.stack(ys)


def _pipe_model(dev):
    """Phase 21's model from seed 0 and its step."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    gen = torch.Generator(device=dev).manual_seed(0)
    model = amp.decorate(resnet50(device=dev, generator=gen), level="O2",
                         dtype="bfloat16")
    ce = nn.CrossEntropyLoss()
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=list(model.named_parameters()),
                   multi_precision=True)
    return model, TrainStepCompiler(model, opt, lambda o, t: ce(o, t))


def _pipe_decreasing(first, last):
    """bench's _check_decreasing (bench.py:107-111)."""
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"pipeline: loss did not decrease "
                             f"({first:.4f} -> {last:.4f})")


def _pipe_events(t0, kind):
    from paddle_tpu_torch.monitor import flight

    return [e for e in flight.tail() if e.get("kind") == kind
            and e.get("ts", 0.0) >= t0]


def _pipe_shm_only(tag, t0):
    """Every io_fetch event since t0 came through the rings."""
    ev = _pipe_events(t0, "io_fetch")
    bad = [e for e in ev if e.get("transport") != "shm"]
    if not ev or bad:
        raise AssertionError(f"pipeline {tag}: {len(ev)} io_fetch events, "
                             f"{len(bad)} not transport='shm'")


def _pipe_close(loader):
    if loader._mp_loader is not None:
        loader._mp_loader.shutdown()


def _pipe_arm_chaos(worker_id):
    """worker_init_fn of the crash run: each worker arms PIPE_CHAOS for
    itself, as PADDLE_CHAOS arms every process of a job at import. A
    rule counts its own process's fetches either way; arming it here
    keeps the trainer's registry free of chaos/* counters, which phase
    27 (b) holds to none."""
    from paddle_tpu_torch.monitor import chaos

    chaos.configure(PIPE_CHAOS)


def _pipe_gate_run(dev, ds, workers, batch, init=None):
    """(losses, state tensors) of a fresh seed-0 model trained on every
    batch of `ds`, fed in process (workers 0) or by the worker pool with
    the device-feed stage (`init`: its worker_init_fn)."""
    from paddle_tpu_torch.io import DataLoader

    kw = (dict(num_workers=0, prefetch_to_device=0) if workers == 0 else
          dict(num_workers=workers, persistent_workers=True,
               prefetch_to_device=2, worker_init_fn=init))
    loader = DataLoader(ds, batch_size=batch, drop_last=True, device=dev,
                        **kw)
    model, step = _pipe_model(dev)
    losses = []
    try:
        for x, y in loader:
            losses.append(float(step(x.to(torch.bfloat16), y).item()))
    finally:
        _pipe_close(loader)
    state = [t.detach().clone() for t in model.state_dict().values()]
    del model, step
    return losses, state


def _pipe_same(tag, got, want):
    (gl, gs), (wl, ws) = got, want
    if gl != wl or len(gl) != PIPE_GATE_BATCHES:
        raise AssertionError(f"pipeline {tag}: losses {gl} != in-process "
                             f"{wl}")
    diff = sum(not torch.equal(a, b) for a, b in zip(gs, ws))
    if diff or len(gs) != len(ws):
        raise AssertionError(f"pipeline {tag}: {diff} of {len(ws)} state "
                             "tensors differ from the in-process run's")


def _pipe_workers(smi):
    """(workers, slot MiB) of phase 28's pools: num_workers=-1's count,
    capped (and said so) where its rings do not fit /dev/shm's free
    bytes; fails when the gates' 5 rings do not fit."""
    from paddle_tpu_torch.io import _auto_num_workers
    from paddle_tpu_torch.io import worker as io_worker

    os.environ.setdefault("FLAGS_dataloader_shm_slot_mb", str(PIPE_SLOT_MB))
    slot_mb = int(os.environ["FLAGS_dataloader_shm_slot_mb"])
    st = os.statvfs("/dev/shm")
    shm_total, shm_free = st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize
    ring = io_worker.ring_bytes(PIPE_SLOTS, slot_mb << 20)
    auto = _auto_num_workers()
    fit = shm_free // ring
    if fit < PIPE_GATE_WORKERS:
        raise AssertionError(
            f"pipeline: /dev/shm has {shm_free} bytes free of {shm_total}; "
            f"{PIPE_GATE_WORKERS} rings of {ring} bytes do not fit")
    capped = ""
    if fit < auto:
        os.environ["PADDLE_IO_WORKERS"] = str(fit)
        capped = (f" (PADDLE_IO_WORKERS capped from {auto} to {fit}: "
                  f"{auto} rings of {ring} bytes exceed /dev/shm's free "
                  f"{shm_free})")
    workers = _auto_num_workers()
    log("pipeline", f"[{smi}] host CPUs {os.cpu_count()}, workers {workers}"
        f"{capped}; /dev/shm {shm_total} bytes, {shm_free} free; slots "
        f"{slot_mb} MiB, ring {ring} bytes a worker, {workers * ring} in all")
    return workers, slot_mb


def _pipe_warm(workers):
    """Batches a pool serves before a timed one: every slot of every
    ring once, then phase 21's warm-up."""
    return workers * PIPE_SLOTS + RESNET_WARMUP


def _pipe_loader_rates(smi, workers, slot_mb):
    """(a) the rings' rate of slot views (MultiprocessLoader.run_epoch,
    one element touched) and (b) of user-owned batches (a CPU
    DataLoader), each over PIPE_LOADER_BATCHES after the warm-up."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.io import worker as io_worker

    batch, warm = RESNET_BATCH, _pipe_warm(workers)
    n = warm + PIPE_LOADER_BATCHES
    ds = _SynthImageNet(n * batch, RESNET_SIZE)
    mpl = io_worker.MultiprocessLoader(
        ds, _np_collate_pair, workers, PIPE_SLOTS, slot_mb, None, 0, False,
        batch_size=batch, default_collate=True)
    try:
        gen = mpl.run_epoch([list(range(i * batch, (i + 1) * batch))
                             for i in range(n)])
        for _ in range(warm):
            next(gen)
        t0 = time.perf_counter()
        for xb, _ in gen:
            _ = xb[0, 0, 0, 0]   # touch: the view holds real data
        view_dt = (time.perf_counter() - t0) / PIPE_LOADER_BATCHES
    finally:
        mpl.shutdown()
    t_b = time.time()
    it = iter(DataLoader(ds, batch_size=batch, num_workers=-1,
                         use_shared_memory=True, drop_last=True,
                         collate_fn=_np_collate_pair, device="cpu"))
    for _ in range(warm):
        next(it)
    t0 = time.perf_counter()
    for _ in it:
        pass
    own_dt = (time.perf_counter() - t0) / PIPE_LOADER_BATCHES
    _pipe_shm_only("(b)", t_b)
    log("pipeline", f"[{smi}] (a) loader_view_imgs_s {batch / view_dt:.1f} "
        f"({view_dt * 1e3:.3f} ms a batch of slot views, {workers} workers, "
        f"{PIPE_LOADER_BATCHES} batches after {warm}); (b) loader_imgs_s "
        f"{batch / own_dt:.1f} ({own_dt * 1e3:.3f} ms a user-owned batch, "
        f"{PIPE_LOADER_BATCHES} after {warm})")


def _pipe_train(dev, smi, workers, setting, resnet_imgs_s):
    """(c) phase 21's model and step fed by the pipeline, in phase 21's
    `setting` (cudnn.benchmark, channels_last): exactly one
    fused_momentum launch a step and a falling loss; imgs/s and MFU
    beside phase 21's, io/h2d_us a batch and the stalls of the timed
    windows; (d) the feed alone; the device's idle share of a profiled
    window. Returns the end-to-end imgs/s."""
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.io import DataLoader

    batch, size, warm = RESNET_BATCH, RESNET_SIZE, _pipe_warm(workers)
    n_steps = warm + RESNET_WINDOWS * RESNET_STEPS
    ds = _SynthImageNet((n_steps + PIPE_FEED_BATCHES + 2
                         + 2 * PIPE_PROFILE_STEPS) * batch, size)
    fmt = torch.channels_last if setting[1] else torch.contiguous_format
    name = (f"cudnn.benchmark={setting[0]}, input "
            f"{'channels_last' if setting[1] else 'NCHW-contiguous'}")
    per_batch = batch * (3 * size * size * 4 + 8)
    keys = ("io/h2d_us", "io/device_prefetch/stalls",
            "io/device_prefetch/bytes")
    bench0 = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = setting[0]
    t_c = time.time()
    loader = DataLoader(ds, batch_size=batch, num_workers=-1,
                        use_shared_memory=True, drop_last=True,
                        persistent_workers=True, prefetch_to_device=2,
                        device=dev)
    model, step = _pipe_model(dev)
    it = iter(loader)

    def next_batch():
        nonlocal it
        try:
            return next(it)
        except StopIteration:
            it = iter(loader)
            return next(it)

    def next_step():
        x, y = next_batch()
        return step(x.to(torch.bfloat16, memory_format=fmt), y)

    try:
        kernels.reset_launches()
        first = float(next_step().item())
        for _ in range(warm - 1):
            next_step()
        c0 = {k: cmon.stat_get(k) for k in keys}
        dts, losses = _timed_windows(next_step, (), RESNET_WINDOWS,
                                     RESNET_STEPS)
        c1 = {k: cmon.stat_get(k) for k in keys}
        counts = _launch_counts()
        _only_launches("pipeline", counts, {"fused_momentum": n_steps})
        _pipe_decreasing(first, losses[-1])
        # (d) the feed alone: the loop only takes batches, so the feeder
        # thread has the GIL to itself
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PIPE_FEED_BATCHES):
            next_batch()
        torch.cuda.synchronize()
        feed_dt = (time.perf_counter() - t0) / PIPE_FEED_BATCHES
        c2 = {k: cmon.stat_get(k) for k in keys}
        wall, busy, count, top, _ = profile_ms(next_step,
                                               reps=PIPE_PROFILE_STEPS)
    finally:
        _pipe_close(loader)
        torch.backends.cudnn.benchmark = bench0
    _pipe_shm_only("(c)", t_c)
    del model, step
    torch.cuda.empty_cache()
    d = {k: c1[k] - c0[k] for k in keys}
    placed = d["io/device_prefetch/bytes"] / per_batch
    feed_placed = (c2["io/device_prefetch/bytes"] - c1[
        "io/device_prefetch/bytes"]) / per_batch
    feed_h2d = (c2["io/h2d_us"] - c1["io/h2d_us"]) / max(1, feed_placed)
    dt = float(np.median(dts))
    mfu = RESNET_FLOP * batch / dt / PEAK_BF16_FLOPS
    log("pipeline", f"[{smi}] (c) ResNet-50 bf16 O2 fed by "
        f"DataLoader(num_workers=-1 = {workers}, persistent, "
        f"prefetch_to_device=2), B={batch} x 3x{size}x{size} f32 cast to "
        f"bf16 on the card, {name}: loss {first:.4f} -> " + " -> ".join(
            f"{v:.4f}" for v in losses) + f"; after {warm} warm-up steps "
        f"({workers} x {PIPE_SLOTS} slots + {RESNET_WARMUP}): step "
        f"{dt * 1e3:.3f} ms (median of {RESNET_WINDOWS} windows of "
        f"{RESNET_STEPS}: " + ", ".join(f"{v * 1e3:.3f}" for v in dts)
        + f") = {batch / dt:.1f} imgs/s end to end, MFU {100 * mfu:.2f}% "
        f"(3 x 4.09 GFLOP an image over 989 TFLOP/s); phase 21 fed from the "
        f"card: {resnet_imgs_s:.1f} imgs/s "
        f"({100 * batch / dt / resnet_imgs_s:.1f}%); fused_momentum "
        f"{counts['fused_momentum']} launches = 1 x {n_steps}; in the timed "
        f"windows io/h2d_us {d['io/h2d_us'] / max(placed, 1):.1f} a batch "
        f"(pinned copy + issue, {placed:.0f} batches placed), "
        f"io/device_prefetch/stalls {d['io/device_prefetch/stalls']} in "
        f"{RESNET_WINDOWS * RESNET_STEPS} steps")
    log("pipeline", f"[{smi}] (d) the feed alone (the loop only takes "
        f"batches, {PIPE_FEED_BATCHES} after (c)): {feed_dt * 1e3:.3f} ms a "
        f"batch = {batch / feed_dt:.1f} imgs/s, io/h2d_us {feed_h2d:.1f} a "
        "batch")
    if busy is None:
        log("pipeline", f"[{smi}] profiled window: wall {wall:.3f} ms a "
            "step; device time not measured (the profiler saw no device "
            "activity)")
    else:
        log("pipeline", f"[{smi}] profiled window ({PIPE_PROFILE_STEPS} "
            f"pipeline-fed steps after (d)): wall {wall:.3f} ms a step, "
            f"device busy {busy:.3f} ms (kernels and copies, summed over "
            f"streams), idle share {max(0.0, 1 - busy / wall):.3f}; "
            f"{count:.0f} device events a step; top: " + "; ".join(
                f"{n} x{c:.0f} {t:.3f} ms" for n, c, t in top))
    return batch / dt


def _pipe_gates(dev, smi):
    """The gates: 6 indexed batches from a fresh seed-0 model, cuDNN
    deterministic, through 5 workers and the device feed, bit for bit
    the in-process feed; again with PIPE_CHAOS armed in each worker:
    exactly one io_worker_restart, the same bits; every io_fetch event
    transport="shm"."""
    from paddle_tpu_torch.core import monitor as cmon

    batch = RESNET_BATCH
    bench0 = torch.backends.cudnn.benchmark
    det0 = torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        gds = _IndexedImages(PIPE_GATE_BATCHES * batch, RESNET_SIZE)
        want = _pipe_gate_run(dev, gds, 0, batch)
        t_g = time.time()
        got = _pipe_gate_run(dev, gds, PIPE_GATE_WORKERS, batch)
        _pipe_same("workers", got, want)
        _pipe_shm_only("gate", t_g)
        r0 = cmon.stat_get("io/workers/restarts")
        overlap0 = os.environ.get("PADDLE_IO_OVERLAP_DECODE")
        os.environ["PADDLE_IO_OVERLAP_DECODE"] = "0"
        t_x = time.time()
        try:
            crashed = _pipe_gate_run(dev, gds, PIPE_GATE_WORKERS, batch,
                                     init=_pipe_arm_chaos)
        finally:
            if overlap0 is None:
                os.environ.pop("PADDLE_IO_OVERLAP_DECODE", None)
            else:
                os.environ["PADDLE_IO_OVERLAP_DECODE"] = overlap0
        restarts = _pipe_events(t_x, "io_worker_restart")
        if len(restarts) != 1 or \
                cmon.stat_get("io/workers/restarts") - r0 != 1:
            raise AssertionError(f"pipeline chaos: {len(restarts)} "
                                 "io_worker_restart events, expected 1: "
                                 f"{restarts}")
        _pipe_same("chaos", crashed, want)
        _pipe_shm_only("chaos", t_x)
    finally:
        torch.backends.cudnn.benchmark = bench0
        torch.backends.cudnn.deterministic = det0
    log("pipeline", f"[{smi}] gates: {PIPE_GATE_BATCHES} batches of "
        f"image i = base + i x 1e-3 from a fresh seed-0 model, cuDNN "
        f"deterministic: {PIPE_GATE_WORKERS} workers + device feed "
        "bit-identical to the in-process feed (losses " + ", ".join(
            f"{v:.6f}" for v in want[0]) + f"; {len(want[1])} state "
        f"tensors); under {PIPE_CHAOS} (armed in each worker): 1 "
        f"io_worker_restart (worker {restarts[0].get('worker')}, "
        f"{restarts[0].get('why')}, {restarts[0].get('refed')} batches "
        "re-fed), bit-identical again; every io_fetch event of the worker "
        "pipelines transport='shm'")


def phase_pipeline(dev, smi, resnet_imgs_s, setting):
    """Phase 28 (see above). `resnet_imgs_s`, `setting`: phase 21's
    imgs/s and kept (cudnn.benchmark, channels_last)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        workers, slot_mb = _pipe_workers(smi)
        _pipe_loader_rates(smi, workers, slot_mb)
        _pipe_train(dev, smi, workers, setting, resnet_imgs_s)
        _pipe_gates(dev, smi)
    fallback = [str(w.message) for w in caught
                if PIPE_FALLBACK in str(w.message)]
    if fallback:
        raise AssertionError(f"pipeline: the thread fallback ran: {fallback}")


# -- phases 22-23 --------------------------------------------------------
# bench_ernie's on-chip recipe (bench.py:570-616), not cut: ERNIE (vocab
# 18000, hidden 768, 12 layers, 12 heads, ffn 3072, S 512, dropout 0),
# bf16 O2, AdamW(1e-4, weight_decay=0.01, multi_precision), the mesh
# {"dp": 1, "pp": 1, "mp": -1}, ids and labels (12, 512) int64 from
# RandomState(0), 3 warm-up steps and 3 windows of 5
ERNIE_BATCH, ERNIE_SEQ = 12, 512
ERNIE_WARMUP, ERNIE_STEPS, ERNIE_WINDOWS = 3, 5, 3
ERNIE_ROWS = ERNIE_BATCH * ERNIE_SEQ
ERNIE_LR, ERNIE_WD = 1e-4, 0.01
ERNIE_MP, ERNIE_MP_STEPS = 2, 4
# phase 23's gates, each set between the sound run's reading and the
# planted fault's on an H100 (PERF.md §6): the relative loss gap to mp
# 1 over the steps (read 1e-7 sound, 7.2e-3 with the fault), and the
# largest share of a tensor's f32 weights off mp 1's by more than lr / 2
# after step 1 (read 3e-6 sound, 0.5 with the fault)
ERNIE_MP_LOSS_TOL, ERNIE_MP_SHARE_TOL = 1e-4, 1e-3


def _ernie_model(dev, seed=0):
    """ERNIE at bench_ernie's full size, weights from `seed`, bf16 O2;
    tensor-parallel over fleet's mp group when fleet.init ran."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.ernie import (ErnieConfig,
                                                    ErnieForPretraining)

    cfg = ErnieConfig(vocab_size=18000, hidden_size=768, num_layers=12,
                      num_heads=12, ffn_hidden=3072, max_seq_len=512,
                      dropout=0.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = ErnieForPretraining(cfg, device=dev, generator=gen)
    return amp.decorate(model, level="O2", dtype="bfloat16")


def _ernie_batch(vocab, dev):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (ERNIE_BATCH, ERNIE_SEQ)).astype(np.int64)
    labels = rng.randint(0, vocab, (ERNIE_BATCH, ERNIE_SEQ)).astype(
        np.int64)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)


def _ernie_weights(model, opt):
    """{name: f32 tensor} of the weights the optimizer updates: an O2
    parameter's master weight, an f32 (norm) parameter itself."""
    state = opt.state_dict()
    return {n: state.get(f"{n}.master_weight", p).detach()
            for n, p in model.named_parameters()}


def _ernie_launches(model):
    """Kernel launches in one ERNIE training step: the block's two
    LayerNorms (the fused one before the attention, the fused residual
    one after it), forward and backward, the embedding's and the head's
    being plain `nn.LayerNorm`s as in the JAX model; the three flash
    kernels once a block; fused_adam once for every MAX_TENSORS
    parameters (once for ERNIE's 152)."""
    from paddle_tpu_torch.incubate.nn.kernels.optim import MAX_TENSORS

    n_layers = model.config.num_layers
    n_tensors = len(list(model.parameters()))
    return {"fused_layer_norm": 2 * n_layers,
            "fused_layer_norm_bwd": 2 * n_layers,
            "flash_attention_fwd": n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers,
            "fused_adam": -(-n_tensors // MAX_TENSORS)}


def _head_gemm_ms(prof, vocab, reps):
    """Device ms a step of the products whose operands span the
    vocabulary (the head's forward and its two backward products: no
    other product of ERNIE has that dimension), or None when the
    profiler links no kernel to them."""
    total = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if e.name not in ("aten::mm", "aten::addmm", "aten::bmm"):
            continue
        if not any(vocab in shape for shape in (e.input_shapes or [])
                   if isinstance(shape, (list, tuple))):
            continue
        total += (e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total)
    return total / reps / 1e3 if total else None


def _ernie_train(dev, smi, model):
    """Train to bench_ernie's recipe through DistributedTrainStepCompiler
    on the mesh {"dp": 1, "pp": 1, "mp": -1}: the loss falls; every
    kernel's launches exact per step; step ms (median of the windows),
    tokens/s, MFU, peak memory, a torch.profiler split. Returns (every
    step's loss, the f32 weights after step 1 on the host)."""
    from paddle_tpu_torch.distributed import build_mesh, set_mesh
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=ERNIE_LR, parameters=model.named_parameters(),
                weight_decay=ERNIE_WD, multi_precision=True)
    mesh = build_mesh({"dp": 1, "pp": 1, "mp": -1})
    step = DistributedTrainStepCompiler(model, opt, loss_fn=None, mesh=mesh)
    vocab = model.config.vocab_size
    ids, labels = _ernie_batch(vocab, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(ids, labels).detach()]
    after1 = {n: t.to("cpu", copy=True)
              for n, t in _ernie_weights(model, opt).items()}
    t0 = time.perf_counter()
    for _ in range(ERNIE_WARMUP - 1):
        losses.append(step(ids, labels).detach())
    first = float(losses[-1].item())
    warm_s = time.perf_counter() - t0
    kernels.reset_launches()
    dts = []
    for _ in range(ERNIE_WINDOWS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(ERNIE_STEPS):
            losses.append(step(ids, labels).detach())
        float(losses[-1].item())                 # synchronises
        dts.append((time.perf_counter() - t0) / ERNIE_STEPS)
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    n_steps = ERNIE_WINDOWS * ERNIE_STEPS
    per_step = _ernie_launches(model)
    _only_launches("ernie", counts, {k: v * n_steps
                                     for k, v in per_step.items()})
    last = losses[-1]
    if not (all(map(math.isfinite, losses)) and last < first):
        raise AssertionError(f"ernie: loss did not decrease ({first:.4f} "
                             f"-> {last:.4f})")
    dt = float(np.median(dts))
    tokens = ERNIE_ROWS
    n_params = sum(p.numel() for p in model.parameters())
    mfu = 6 * n_params * tokens / dt / PEAK_BF16_FLOPS
    log("ernie", f"[{smi}] ERNIE bf16 O2 ({n_params} params, "
        f"{model.config.num_layers}L, "
        f"{len(list(model.parameters()))} tensors), AdamW multi_precision, "
        f"mesh {mesh.shape}, B={ERNIE_BATCH} S={ERNIE_SEQ}: loss "
        + " -> ".join(f"{x:.4f}" for x in losses[:ERNIE_WARMUP + 1])
        + f" ... {last:.4f} over {len(losses)} steps; step {dt * 1e3:.3f} ms "
        f"(median of {ERNIE_WINDOWS} windows of {ERNIE_STEPS}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in dts) + f") = "
        f"{tokens / dt:.1f} tokens/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
        f"(6 N tokens); peak memory {peak / 2 ** 30:.2f} GiB; warm-up "
        f"{warm_s:.2f} s")
    log("ernie", f"[{smi}] launches over {n_steps} steps: " + ", ".join(
        f"{n} {counts[n]} = {per} x {n_steps}" for n, per in per_step.items())
        + "; every other kernel of the port 0")
    wall, busy, count, top, by, prof = profile_ms(
        lambda: step(ids, labels), reps=2, n_top=8, record_shapes=True)
    head = _head_gemm_ms(prof, vocab, 2)
    del prof
    if busy is None:
        log("ernie", f"[{smi}] step wall {wall:.3f} ms; device time not "
            "measured (the profiler saw no device activity)")
    else:
        parts = _bert_step_split(by)
        if head is not None:
            parts["GEMMs"] -= head
            parts = {"head GEMMs": head, **parts}
        log("ernie", f"[{smi}] where a step goes (torch.profiler, 2 steps): "
            f"wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%), idle {wall - busy:.3f} ms, "
            f"{count:.0f} kernels; " + ", ".join(
                f"{k} {ms:.3f} ms ({100 * ms / wall:.1f}%)"
                for k, ms in parts.items())
            + ("" if head is not None else "; the head's products not "
               "measured (the profiler linked no kernel to them)"))
        log("ernie", f"[{smi}] top kernels: " + "; ".join(
            f"{name} x{n:.0f} {t:.3f} ms" for name, n, t in top))
    set_mesh(None)
    del step, opt
    return losses, after1


def phase_ernie(dev, smi):
    """Phase 22: ERNIE at bench_ernie's recipe (see the module
    docstring). Returns (every step's loss, the f32 weights after step 1
    on the host) for phase 23."""
    errs = {}
    rng = np.random.RandomState(23)
    scale = 64 ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _flash_inputs(rng, ERNIE_BATCH, 12, ERNIE_SEQ, 64,
                                    dtype, dev)
        fe = _flash_check(f"ernie flash B12 H12 S512 D64 {dtype} non-causal",
                          q, k, v, do, False, scale)
        errs[dtype] = max(e for e, _ in fe.values())
        del q, k, v, do
    ln_fwd, ln_bwd = ln_bwd_checks(dev, rows=ERNIE_ROWS, hidden=768)
    log("ernie", f"[{smi}] kernels vs plain at ERNIE's shapes: flash B12 H12 "
        f"S512 D64 non-causal f32 max|err| {errs[torch.float32]:.3e} (o 2e-5,"
        f" gradients 2e-4; gate 1 logged above) and bf16 {errs[torch.bfloat16]:.3e} (per row, "
        f"{FLASH_BF16_ROW_TOL} x row max|ref|); LayerNorm 6144x768, f32 and "
        f"bf16, with and without the residual, no / tanh / erf GeLU: forward"
        f" {ln_fwd[torch.float32]:.3e} / {ln_fwd[torch.bfloat16]:.3e}, "
        f"backward {ln_bwd[torch.float32]:.3e} / {ln_bwd[torch.bfloat16]:.3e}"
        " (phase 8's limits), a second backward bit-identical")
    kernel_times(dev, smi, "ernie", ERNIE_BATCH, ERNIE_ROWS,
                 (torch.float32, torch.bfloat16), torch.float32)
    model = _ernie_model(dev)
    named = list(model.named_parameters())
    lr, wd = ERNIE_LR, ERNIE_WD
    optim_at_shape(
        dev, smi, "ernie", named, "fused_adam",
        ("ERNIE's O2 set", "AdamW",
         dict(learning_rate=lr, weight_decay=wd), {}),
        dict(lr=lr, beta1=0.9, beta2=0.999, eps=1e-8,
             decay=[float(np.float32(1) - np.float32(lr) * np.float32(wd))]
             * len(named)),
        lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=wd,
                                     fused=True))
    del named
    torch.cuda.empty_cache()
    out = _ernie_train(dev, smi, model)
    del model
    torch.cuda.empty_cache()
    return out


def _ernie_mp_rank(out_dir, steps, device, fault=False):
    """One rank of phase 23 (spawned: gloo, the one card; `device` "cpu"
    only to rehearse the phase off the card): fleet.init at mp 2, ERNIE
    from seed 0 at full width, `steps` steps of phase 22's batch through
    DistributedTrainStepCompiler(mesh=). Writes ernie_mp_r<rank>.json and
    rank 0 the gathered f32 weights after step 1 (ernie_mp_step1.pt).
    With `fault`, the planted fault the gates must catch: rank 1's
    shards keep their weights through step 1, as if their update were
    skipped."""
    import hashlib

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.core import monitor as cmon
    from paddle_tpu_torch.distributed import fleet, get_rank, mesh
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    rank = get_rank()
    on_card = device == "cuda"
    if on_card:
        dev = torch.device("cuda", torch.cuda.current_device())
        kernels.load()           # the parent built the library
        sync = torch.cuda.synchronize
    else:
        dev, sync = torch.device("cpu"), (lambda: None)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": ERNIE_MP,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    model = _ernie_model(dev)
    opt = AdamW(learning_rate=ERNIE_LR, parameters=model.named_parameters(),
                weight_decay=ERNIE_WD, multi_precision=True)
    step = DistributedTrainStepCompiler(model, opt, loss_fn=None,
                                        mesh=mesh.get_mesh())
    ids, labels = _ernie_batch(model.config.vocab_size, dev)
    frozen = ({n: p.detach().clone() for n, p in model.named_parameters()
               if getattr(p, "mp_group", None) is not None}
              if fault and rank == 1 else {})
    heads = []
    real_fwd = fa.flash_attention_fwd

    def spy(q, *a, **kw):
        heads.append(int(q.shape[1]))
        return real_fwd(q, *a, **kw)

    fa.flash_attention_fwd = spy
    keys = ("comm/all_reduce/host_us", "comm/all_gather/host_us",
            "comm/all_reduce/calls", "comm/all_gather/calls")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    losses, step_s, comm_us = [], [], []
    for i in range(steps):
        before = [cmon.stat_get(k) for k in keys]
        sync()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))      # .item() synchronises
        step_s.append(time.perf_counter() - t0)
        comm_us.append([cmon.stat_get(k) - b for k, b in zip(keys, before)])
        if i == 0:
            launches = kernels.launches()
            if frozen:
                state = opt.state_dict()
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        if n in frozen:
                            p.copy_(frozen[n])
                            state[f"{n}.master_weight"] = frozen[n].float()
                opt.set_state_dict(state)
                del state
            full = convert.gather_state_dict(model,
                                             _ernie_weights(model, opt))
            if rank == 0:
                torch.save(full, os.path.join(out_dir, "ernie_mp_step1.pt"))
            del full
            kernels.reset_launches()
    fa.flash_attention_fwd = real_fwd
    launches = {k: launches[k] + v for k, v in kernels.launches().items()}
    h = hashlib.sha256()
    n_repl = 0
    for n, p in model.named_parameters():
        if getattr(p, "mp_group", None) is None:
            n_repl += 1
            h.update(n.encode())
            h.update(p.detach().float().cpu().numpy().tobytes())
    out = {"rank": rank, "losses": losses, "step_s": step_s,
           "comm_us": comm_us, "launches": launches, "heads": heads,
           "per_step": _ernie_launches(model),
           "num_heads": model.config.num_heads,
           "replicated": n_repl, "replicated_sha256": h.hexdigest(),
           "tensors": len(list(model.parameters())),
           "elements": sum(p.numel() for p in model.parameters()),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev) if on_card
                          else 0)}
    with open(os.path.join(out_dir, f"ernie_mp_r{rank}.json"), "w") as f:
        json.dump(out, f)


def _ernie_mp_run(dev, steps, fault=False):
    """Spawn phase 23's two ranks: (each rank's record, the gathered f32
    weights after step 1, spawn-to-join seconds)."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(_ernie_mp_rank, args=(tmp, steps, dev.type, fault),
              nprocs=ERNIE_MP, backend="gloo", device=dev.type,
              join=False).join(timeout=900)
        wall = time.perf_counter() - t0
        runs = []
        for r in range(ERNIE_MP):
            with open(os.path.join(tmp, f"ernie_mp_r{r}.json")) as f:
                runs.append(json.load(f))
        full = torch.load(os.path.join(tmp, "ernie_mp_step1.pt"))
    return runs, full, wall


def _ernie_mp_readings(losses, full, ref_losses, ref_after1,
                       share_mask=None):
    """Phase 23's readings against phase 22's mp 1 run from the same
    weights and batch: the worst relative loss gap over the steps; of
    the f32 weights after step 1 (master weights, f32 norm parameters),
    the worst element's gap over its limit, and the largest share of a
    tensor's elements off mp 1's by more than lr / 2, with that tensor.
    AdamW's first step moves an element by lr g / (|g| + eps), never by
    more than lr, so an element whose tiny gradient takes the other sign
    at mp 2 is off by up to 2 lr (the element limit, plus f32 rounding),
    while a skipped or reversed update moves a whole shard by lr or 2 lr.
    The key third of each qkv bias is held to the element limit only:
    its true gradient is 0 (a key bias adds the same score to a whole
    row), so its sign is rounding noise in both runs. `share_mask`
    ({name: bool tensor}) limits the share to the elements it marks."""
    loss = max(abs(got - want) / abs(want)
               for got, want in zip(losses, ref_losses))
    if set(full) != set(ref_after1):
        raise AssertionError("ernie_mp: gathered parameter names differ")
    elem, share, worst = 0.0, 0.0, None
    for n, want in ref_after1.items():
        got = full[n]
        if got.shape != want.shape or got.dtype != torch.float32 \
                or want.dtype != torch.float32:
            raise AssertionError(f"ernie_mp: {n} {got.dtype} "
                                 f"{tuple(got.shape)} vs {want.dtype} "
                                 f"{tuple(want.shape)}")
        err = (got - want).abs()
        elem = max(elem, float((err / (2 * ERNIE_LR + 2 ** -22
                                       * want.abs())).max()))
        if share_mask is not None:
            err = torch.where(share_mask[n], err, 0.0)
        if n.endswith("qkv.bias"):
            third = err.shape[-1] // 3
            err = torch.cat([err[..., :third], err[..., 2 * third:]], -1)
        frac = float((err > ERNIE_LR / 2).float().mean())
        if frac > share:
            share, worst = frac, n
    return {"loss": loss, "elem": elem, "share": share, "worst": worst}


def _ernie_mp_failures(read):
    """The gates phase 23's readings fail, as messages."""
    out = []
    if not read["loss"] <= ERNIE_MP_LOSS_TOL:
        out.append(f"loss {100 * read['loss']:.5f}% off mp 1's, over "
                   f"{100 * ERNIE_MP_LOSS_TOL}%")
    if not read["elem"] <= 1:
        out.append(f"an f32 weight after step 1 {read['elem']:.3f} x "
                   "(2 lr + f32 rounding) off mp 1's")
    if not read["share"] <= ERNIE_MP_SHARE_TOL:
        out.append(f"{100 * read['share']:.4f}% of {read['worst']} off mp "
                   f"1's by more than lr / 2 after step 1, over "
                   f"{100 * ERNIE_MP_SHARE_TOL}%")
    return out


def phase_ernie_mp(dev, smi, ref_losses, ref_after1,
                   steps=ERNIE_MP_STEPS):
    """Phase 23: ERNIE at mp 2 over two gloo ranks on the one card
    against phase 22's mp 1 run from the same weights and batch, then
    the planted fault (`_ernie_mp_rank`), which must fail the gates."""
    runs, full, wall = _ernie_mp_run(dev, steps)
    a, b = runs
    if a["losses"] != b["losses"]:
        raise AssertionError(f"ernie_mp: the ranks' losses differ "
                             f"{a['losses']} / {b['losses']}")
    if not all(map(math.isfinite, a["losses"])):
        raise AssertionError(f"ernie_mp: losses {a['losses']}")
    if a["replicated_sha256"] != b["replicated_sha256"] or not a[
            "replicated"]:
        raise AssertionError("ernie_mp: the replicated parameters differ "
                             "across the ranks")
    read = _ernie_mp_readings(a["losses"], full, ref_losses, ref_after1)
    del full
    failed = _ernie_mp_failures(read)
    if failed:
        raise AssertionError("ernie_mp: " + "; ".join(failed) + f" ({read})")
    for r in runs:
        per_step = r["per_step"]
        _only_launches(f"ernie_mp rank {r['rank']}", r["launches"],
                       {k: v * steps for k, v in per_step.items()})
        mine = r["num_heads"] // ERNIE_MP
        want = [mine] * (per_step["flash_attention_fwd"] * steps)
        if r["heads"] != want:
            raise AssertionError(f"ernie_mp rank {r['rank']}: flash heads "
                                 f"{sorted(set(r['heads']))} x "
                                 f"{len(r['heads'])}, expected {mine} x "
                                 f"{len(want)}")
    log("ernie_mp", f"[{smi}] ERNIE bf16 O2 at mp {ERNIE_MP} over "
        f"{ERNIE_MP} gloo ranks on one card (12 layers, full width, seed 0; "
        f"{a['tensors']} tensors, {a['elements']} elements a rank), "
        f"phase 22's batch, spawn-to-join {wall:.1f} s: loss " + " ".join(
            f"{x:.6f}" for x in a["losses"]) + " vs mp 1's " + " ".join(
            f"{x:.6f}" for x in ref_losses[:steps])
        + f" (worst {100 * read['loss']:.5f}%, gate "
        f"{100 * ERNIE_MP_LOSS_TOL}%); the two ranks' losses equal; "
        f"{a['replicated']} replicated parameters bit-identical across the "
        "ranks (sha256); the gathered f32 weights after step 1: worst "
        f"element {read['elem']:.3f} of 2 lr + f32 rounding, worst share "
        f"off by > lr / 2 {100 * read['share']:.4f}% ({read['worst']}; "
        f"gate {100 * ERNIE_MP_SHARE_TOL}%); every flash launch on "
        f"{a['num_heads'] // ERNIE_MP} heads")
    bad_runs, bad_full, bad_wall = _ernie_mp_run(dev, 2, fault=True)
    bad = _ernie_mp_readings(bad_runs[0]["losses"], bad_full, ref_losses,
                             ref_after1)
    del bad_full
    caught = _ernie_mp_failures(bad)
    log("ernie_mp", f"[{smi}] planted fault (rank 1 skips its shards' "
        f"step-1 update; 2 steps, spawn-to-join {bad_wall:.1f} s): loss "
        + " ".join(f"{x:.6f}" for x in bad_runs[0]["losses"])
        + f", worst {100 * bad['loss']:.5f}%; worst element "
        f"{bad['elem']:.3f}; worst share {100 * bad['share']:.4f}% "
        f"({bad['worst']}); caught: " + "; ".join(caught))
    if not (bad["loss"] > ERNIE_MP_LOSS_TOL
            and bad["share"] > ERNIE_MP_SHARE_TOL):
        raise AssertionError("ernie_mp: the planted fault (rank 1 skips "
                             "its shards' step-1 update) passed a gate")
    st = float(np.median(a["step_s"][1:]))
    shares = []
    for r in runs:
        comm = sum(c[0] + c[1] for c in r["comm_us"][1:]) / 1e6
        shares.append(100 * comm / sum(r["step_s"][1:]))
    calls = a["comm_us"][1]
    log("ernie_mp", f"[{smi}] step {st * 1e3:.1f} ms (median of steps "
        f"2-{steps}) = {ERNIE_ROWS / st:.1f} tokens/s; collectives "
        f"{calls[2]} all_reduce + {calls[3]} all_gather a step, their "
        "host-clock share of the step " + " / ".join(
            f"{x:.1f}%" for x in shares) + " (rank 0 / 1; gloo through the "
        "host on one shared card, not a wire speed of the port); peak memory "
        + " / ".join(f"{r['peak_bytes'] / 2 ** 30:.2f}" for r in runs)
        + " GiB; launches a rank over the steps: " + "; ".join(
            f"rank {r['rank']} {r['launches']}" for r in runs[:1]))


# -- phase 24 ------------------------------------------------------------
# ERNIE at pp 2 (and mp 2 x pp 2) over gloo ranks on the one card, at
# phase 22's recipe with accumulate_steps 4 (micro-batches of 3), held to
# phase 23's gates against phase 22's run; GPT-2 345M at pp 2 with 4
# micro-batches, held within GPT_PP_TOL of a pp 1 run
ERNIE_PP_ACC, ERNIE_PP_STEPS = 4, 4
GPT_PP_M, GPT_PP_STEPS, GPT_PP_TOL = 4, 3, 1e-3
PP_COMM = ("comm/send/calls", "comm/send/bytes", "comm/send/host_us",
           "comm/recv/calls", "comm/recv/bytes", "comm/recv/host_us",
           "comm/all_reduce/calls", "comm/all_reduce/bytes",
           "comm/all_reduce/host_us", "comm/broadcast/host_us")


def _pp_stage_launches(n_blocks, micro, ln_extra=0):
    """Launches a step of a pipeline stage of `n_blocks` transformer
    blocks over `micro` micro-batches: each block's two LayerNorms
    forward and backward and its three flash kernels once a micro-batch
    (`ln_extra` more LayerNorms a micro-batch: GPT's last LayerNorm on
    its last stage), and one fused_adam (a stage's parameters fill one
    table)."""
    ln = (2 * n_blocks + ln_extra) * micro
    return {"fused_layer_norm": ln, "fused_layer_norm_bwd": ln,
            "flash_attention_fwd": n_blocks * micro,
            "flash_attention_bwd_dq": n_blocks * micro,
            "flash_attention_bwd_dkv": n_blocks * micro,
            "fused_adam": 1}


def _sha(tensors):
    import hashlib

    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _pp_steps(train, steps, sync, after_first=None):
    """`steps` calls of `train()` (each returns the loss), timed on the
    host clock with the comm counters read around each: (losses,
    seconds, comm deltas)."""
    from paddle_tpu_torch.core import monitor as cmon

    losses, step_s, comm = [], [], []
    for i in range(steps):
        before = [cmon.stat_get(k) for k in PP_COMM]
        sync()
        t0 = time.perf_counter()
        losses.append(float(train()))
        sync()
        step_s.append(time.perf_counter() - t0)
        comm.append([cmon.stat_get(k) - b for k, b in zip(PP_COMM, before)])
        if i == 0 and after_first is not None:
            after_first()
    return losses, step_s, comm


def _pp_ernie(out_dir, dev, sync, mp, modes, fault=None):
    """ERNIE at mp x pp 2 through fleet's PipelineParallel, once for
    each schedule mode in `modes` from the same start weights: losses,
    times, comm, launches, peak memory and the weights' hash; rank 0
    saves the gathered f32 weights after step 1. `fault`: "no_grad_back"
    (stage 1 sends back zeros for its input gradient) or
    "skip_backward" (every stage skips the last micro-batch's
    backward), 2 steps."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import fleet, get_rank, pipeline
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.ernie import ErnieBlock

    rank = get_rank()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": mp,
                               "pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    model = _ernie_model(dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    blocks = sum(isinstance(m, ErnieBlock) for m in model.ernie._layers.values())
    ids, labels = _ernie_batch(model.config.vocab_size, dev)
    real_order, real_grad = pipeline.schedule_order, pipeline._input_grad
    if fault == "skip_backward":
        pipeline.schedule_order = lambda *a: [
            o for o in real_order(*a) if o != ("B", a[-1] - 1)]
    if fault == "no_grad_back" and hcg.get_stage_id() == 1:
        pipeline._input_grad = lambda x: torch.zeros_like(x)
    steps = 2 if fault else ERNIE_PP_STEPS
    out = {}
    for mode in modes:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        strategy.pipeline_configs = {"accumulate_steps": ERNIE_PP_ACC,
                                     "schedule_mode": mode}
        pp = fleet.distributed_model(model.ernie)
        opt = AdamW(learning_rate=ERNIE_LR,
                    parameters=model.named_parameters(),
                    weight_decay=ERNIE_WD, multi_precision=True)
        tag = f"{mode}{'_' + fault if fault else ''}"
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        held = {}

        def first():
            held["launches"] = kernels.launches()
            full = convert.gather_state_dict(
                model, _ernie_weights(model, opt), all_ranks=False)
            if rank == 0:
                torch.save(full, os.path.join(out_dir,
                                              f"ernie_pp_{tag}_step1.pt"))
            del full
            kernels.reset_launches()

        losses, step_s, comm = _pp_steps(
            lambda: pp.train_batch((ids, labels), opt), steps, sync, first)
        counts = kernels.launches()
        out[tag] = {
            "losses": losses, "step_s": step_s, "comm": comm,
            "launches": {k: held["launches"][k] + v
                         for k, v in counts.items()},
            "per_step": _pp_stage_launches(blocks, ERNIE_PP_ACC),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0),
            "max_stash": pp._schedule.max_stash,
            "sha256": _sha({**dict(model.named_parameters()),
                            **{f"{n}.master": t for n, t in
                               _ernie_weights(model, opt).items()}})}
        del pp, opt
    pipeline.schedule_order, pipeline._input_grad = real_order, real_grad
    return {"stage": hcg.get_stage_id(), "mp_rank": hcg.get_model_parallel_rank(),
            "blocks": blocks,
            "tensors": len(list(model.parameters())),
            "elements": sum(p.numel() for p in model.parameters()),
            "runs": out}


def _pp_gpt(dev, sync, schedule):
    """GPT-2 345M at pp 2 (`pp_microbatches` GPT_PP_M) through
    DistributedTrainStepCompiler(mesh=): losses, times, comm, launches,
    peak memory, the tied wte's hash after every step and the weights'
    hash after the last."""
    from paddle_tpu_torch.distributed import build_mesh, set_mesh
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.jit.distributed import DistributedTrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    mesh = set_mesh(build_mesh({"pp": 2}))
    model = _train_model(dev, pp_num_stages=2, pp_microbatches=GPT_PP_M,
                         pp_schedule=schedule)
    gpt = model.gpt
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True)
    step = DistributedTrainStepCompiler(model, opt, mesh=mesh)
    ids, labels = _train_batch(model.config.vocab_size, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    wte = []

    def train():
        loss = step(ids, labels)
        wte.append(_sha({"wte": gpt.wte}))
        return loss

    losses, step_s, comm = _pp_steps(train, GPT_PP_STEPS, sync)
    n_blocks = gpt.blocks["ln1_w"].shape[0]
    rec = {"losses": losses, "step_s": step_s, "comm": comm,
           "launches": kernels.launches(),
           "per_step": _pp_stage_launches(n_blocks, GPT_PP_M,
                                          int(gpt.is_last_stage)),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0),
           "max_stash": step._pp[1].max_stash, "wte": wte,
           "tensors": len(list(model.parameters())),
           "elements": sum(p.numel() for p in model.parameters()),
           "sha256": _sha(dict(model.named_parameters()))}
    set_mesh(None)
    del step, opt, model
    return rec


def _pp_rank(out_dir, device, mp, jobs):
    """One rank of phase 24 (spawned: gloo, the one card; `device` "cpu"
    only to rehearse the phase off the card): the `jobs` in order, each
    from a fresh fleet; writes pp_r<rank>.json."""
    from paddle_tpu_torch.distributed import fleet, get_rank, mesh
    from paddle_tpu_torch.incubate.nn import kernels

    if device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        kernels.load()           # the parent built the library
        sync = torch.cuda.synchronize
    else:
        dev, sync = torch.device("cpu"), (lambda: None)

    def fresh():
        mesh.set_mesh(None)
        fleet._fleet_state.update(initialized=False, strategy=None,
                                  hcg=None, role_maker=None)

    out = {"rank": get_rank()}
    for job in jobs:
        fresh()
        if job == "ernie":
            out["ernie"] = _pp_ernie(out_dir, dev, sync, mp,
                                     ("F-then-B", "1F1B"))
        elif job == "ernie_1f1b":
            out["ernie"] = _pp_ernie(out_dir, dev, sync, mp, ("1F1B",))
        elif job in ("no_grad_back", "skip_backward"):
            out[job] = _pp_ernie(out_dir, dev, sync, mp, ("1F1B",),
                                 fault=job)
        else:
            out[job] = _pp_gpt(dev, sync, job.split("_", 1)[1])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"pp_r{out['rank']}.json"), "w") as f:
        json.dump(out, f)


def _pp_run(dev, nprocs, mp, jobs):
    """Spawn phase 24's ranks: (each rank's record, {tag: the gathered
    f32 ERNIE weights after step 1}, spawn-to-join seconds)."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(_pp_rank, args=(tmp, dev.type, mp, jobs), nprocs=nprocs,
              backend="gloo", device=dev.type, join=False).join(timeout=900)
        wall = time.perf_counter() - t0
        runs = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"pp_r{r}.json")) as f:
                runs.append(json.load(f))
        full = {name[len("ernie_pp_"):-len("_step1.pt")]:
                torch.load(os.path.join(tmp, name))
                for name in os.listdir(tmp) if name.startswith("ernie_pp_")}
    return runs, full, wall


def _pp_comm_line(recs):
    """Each rank's comm calls, bytes and host-clock share over the steps
    after the first."""
    parts = []
    for r, rec in recs:
        tot = [sum(c[i] for c in rec["comm"][1:]) for i in range(len(PP_COMM))]
        k = dict(zip(PP_COMM, tot))
        n = max(len(rec["comm"]) - 1, 1)
        wall = sum(rec["step_s"][1:]) or 1.0
        share = {op: 100 * k[f"comm/{op}/host_us"] / 1e6 / wall
                 for op in ("send", "recv", "all_reduce", "broadcast")}
        parts.append(
            f"rank {r}: send {k['comm/send/calls'] / n:.0f} calls "
            f"{k['comm/send/bytes'] / n / 2 ** 20:.2f} MiB "
            f"{share['send']:.1f}%, recv {k['comm/recv/calls'] / n:.0f} "
            f"{k['comm/recv/bytes'] / n / 2 ** 20:.2f} MiB "
            f"{share['recv']:.1f}%, all_reduce "
            f"{k['comm/all_reduce/calls'] / n:.0f} "
            f"{k['comm/all_reduce/bytes'] / n / 2 ** 20:.2f} MiB "
            f"{share['all_reduce']:.1f}%, broadcast {share['broadcast']:.1f}%")
    return "; ".join(parts) + " a step (host clock)"


def _pp_ernie_micro(dev):
    """Phase 22's model and batch at pp 1 through PipelineParallel's
    micro-batch path (accumulate_steps ERNIE_PP_ACC, the pipeline's
    arithmetic in one process): (every step's loss, the f32 weights
    after step 1 on the host)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    model = _ernie_model(dev)
    strategy = fleet.DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": ERNIE_PP_ACC}
    pp = fleet.meta_parallel.PipelineParallel(model.ernie, None, strategy)
    opt = AdamW(learning_rate=ERNIE_LR, parameters=model.named_parameters(),
                weight_decay=ERNIE_WD, multi_precision=True)
    ids, labels = _ernie_batch(model.config.vocab_size, dev)
    losses = [float(pp.train_batch((ids, labels), opt))]
    after1 = {n: t.to("cpu", copy=True)
              for n, t in _ernie_weights(model, opt).items()}
    losses += [float(pp.train_batch((ids, labels), opt))
               for _ in range(ERNIE_PP_STEPS - 1)]
    return losses, after1


def _pp_refs(ref_losses, ref_after1, micro_losses, micro_after1):
    """Phase 24's references: phase 22 (`"22"`) and the pp 1
    micro-batched run (`"micro"`), each (losses, f32 weights after step
    1, share mask). Against phase 22 the share counts only the elements
    where the micro-batched run's weights after step 1 lie within lr / 2
    of phase 22's: the micro-batches' gradient sums round otherwise than
    one batch's, which flips the sign of some near-zero gradients at pp
    1 already, and AdamW's first step turns each flip into 2 lr, a
    visible share of a 768-element bias (phase 23's 0.1% is under one
    element there). The count left out is returned as `"flipped"`."""
    keep = {n: (micro_after1[n] - w).abs() <= ERNIE_LR / 2
            for n, w in ref_after1.items()}
    flipped = sum(int((~k).sum()) for k in keep.values())
    return {"22": (ref_losses, ref_after1, keep),
            "micro": (micro_losses, micro_after1, None)}, flipped


def _pp_readings(losses, full, refs):
    """Phase 23's readings against each of `_pp_refs`'s references."""
    return {k: _ernie_mp_readings(losses, full, *ref)
            for k, ref in refs.items()}


def _pp_failures(read):
    """The gates phase 24's readings fail, as messages: phase 23's
    loss, element and share gates against phase 22 and against the pp 1
    micro-batched run."""
    return [f"vs {'phase 22' if k == '22' else 'pp 1 micro-batched'}: {f}"
            for k, r in read.items() for f in _ernie_mp_failures(r)]


def _pp_ernie_gates(tag, runs, mode, full, refs):
    """Phase 24's gates on one ERNIE pipeline run; the ranks' launches
    exact. Returns the readings."""
    recs = [r["ernie"]["runs"][mode] for r in runs]
    losses = recs[0]["losses"]
    if any(r["losses"] != losses for r in recs):
        raise AssertionError(f"{tag}: the ranks' losses differ")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    read = _pp_readings(losses, full, refs)
    failed = _pp_failures(read)
    if failed:
        raise AssertionError(f"{tag}: " + "; ".join(failed) + f" ({read})")
    for r, rec in zip(runs, recs):
        _only_launches(f"{tag} rank {r['rank']}", rec["launches"],
                       {k: v * len(losses)
                        for k, v in rec["per_step"].items()})
    return read


def _pp_read_text(r):
    return "; ".join(
        f"vs {'phase 22' if k == '22' else 'pp 1 micro-batched'}: worst "
        f"loss {100 * x['loss']:.5f}%, f32 weights after step 1 worst "
        f"element {x['elem']:.3f} of 2 lr + f32 rounding, worst share "
        f"{100 * x['share']:.4f}% ({x['worst']})" for k, x in r.items())


def phase_ernie_pp(dev, smi, ref_losses, ref_after1):
    """Phase 24: ERNIE at pp 2 and mp 2 x pp 2 and GPT-2 345M at pp 2
    over gloo ranks on the one card (see the module docstring)."""
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    # GPT-2 345M at pp 1 from the same weights and batch: the reference
    model = _train_model(dev)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStepCompiler(model, opt)
    ids, labels = _train_batch(model.config.vocab_size, dev)
    gpt_ref = [float(step(ids, labels)) for _ in range(GPT_PP_STEPS)]
    del model, opt, step, ids, labels
    micro_losses, micro_after1 = _pp_ernie_micro(dev)
    refs, flipped = _pp_refs(ref_losses, ref_after1, micro_losses,
                             micro_after1)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    runs, full, wall = _pp_run(dev, 2, 1, [
        "ernie", "no_grad_back", "skip_backward", "gpt_gpipe", "gpt_1f1b"])
    reads = {}
    for mode in ("F-then-B", "1F1B"):
        reads[mode] = _pp_ernie_gates(f"ernie_pp {mode}", runs, mode,
                                      full[mode], refs)
    same = {m: (runs[0]["ernie"]["runs"][m]["losses"] == micro_losses
                and all(torch.equal(full[m][n], micro_after1[n])
                        for n in micro_after1))
            for m in ("F-then-B", "1F1B")}
    if not all(same.values()):
        raise AssertionError(f"ernie_pp: pp 2 is not bit-identical to pp 1 "
                             f"micro-batched (losses, f32 weights after "
                             f"step 1): {same}")
    st = [r["ernie"] for r in runs]
    a, b = st[0]["runs"]["F-then-B"], st[0]["runs"]["1F1B"]
    for r in st:
        x, y = r["runs"]["F-then-B"], r["runs"]["1F1B"]
        if x["losses"] != y["losses"] or x["sha256"] != y["sha256"]:
            raise AssertionError("ernie_pp: 1F1B and F-then-B differ")
    peaks = {m: [r["runs"][m]["peak_bytes"] for r in st]
             for m in ("F-then-B", "1F1B")}
    stash = {m: [r["runs"][m]["max_stash"] for r in st]
             for m in ("F-then-B", "1F1B")}
    if dev.type == "cuda" and not peaks["1F1B"][0] < peaks["F-then-B"][0]:
        raise AssertionError(f"ernie_pp: stage 0's peak under 1F1B "
                             f"{peaks['1F1B'][0]} is not below F-then-B's "
                             f"{peaks['F-then-B'][0]}")
    med = {m: float(np.median(st[0]["runs"][m]["step_s"][1:]))
           for m in ("F-then-B", "1F1B")}
    log("ernie_pp", f"[{smi}] ERNIE bf16 O2 at pp 2 over 2 gloo ranks on "
        f"one card (12 layers, full width, seed 0; stage 0: "
        f"{st[0]['blocks']} blocks + the embedding, {st[0]['tensors']} "
        f"tensors, {st[0]['elements']} elements; stage 1: "
        f"{st[1]['blocks']} blocks + the head, {st[1]['tensors']} tensors, "
        f"{st[1]['elements']} elements), phase 22's batch, "
        f"accumulate_steps {ERNIE_PP_ACC}, spawn-to-join {wall:.1f} s "
        "(with the faults and GPT below): loss " + " ".join(
            f"{x:.6f}" for x in b["losses"]) + " vs phase 22's " + " ".join(
            f"{x:.6f}" for x in ref_losses[:ERNIE_PP_STEPS])
        + " and pp 1 micro-batched " + " ".join(
            f"{x:.6f}" for x in micro_losses) + "; " + "; ".join(
            f"{m}: {_pp_read_text(r)}; bit-identical to pp 1 micro-batched "
            f"(losses, f32 weights after step 1): {same[m]}"
            for m, r in reads.items())
        + f" (gates: loss {100 * ERNIE_MP_LOSS_TOL}%, element 1, share "
        f"{100 * ERNIE_MP_SHARE_TOL}% against both, the share against "
        f"phase 22 leaving out the {flipped} elements where pp 1 "
        "micro-batched lies off phase 22's by > lr / 2; bit-identical to "
        "pp 1 micro-batched)"
        + "; 1F1B = F-then-B bit for bit (losses, weights and masters by "
        f"sha256); launches a step a rank exact: stage 0 "
        f"{a['per_step']}, stage 1 {st[1]['runs']['1F1B']['per_step']}")
    log("ernie_pp", f"[{smi}] step (host clock, median of steps 2-"
        f"{ERNIE_PP_STEPS}) F-then-B {med['F-then-B'] * 1e3:.1f} ms, 1F1B "
        f"{med['1F1B'] * 1e3:.1f} ms (= {ERNIE_ROWS / med['1F1B']:.1f} "
        "tokens/s; the stages share one card, so no bubble or overlap "
        "shows); peak memory a rank F-then-B " + " / ".join(
            f"{x / 2 ** 30:.3f}" for x in peaks["F-then-B"]) + " GiB, 1F1B "
        + " / ".join(f"{x / 2 ** 30:.3f}" for x in peaks["1F1B"])
        + " GiB (stage 0 / 1; gate: 1F1B's stage 0 below F-then-B's); "
        "micro-batches held at once F-then-B " + "/".join(
            map(str, stash["F-then-B"])) + ", 1F1B " + "/".join(
            map(str, stash["1F1B"])) + "; 1F1B comm: "
        + _pp_comm_line([(r["rank"], r["ernie"]["runs"]["1F1B"])
                         for r in runs]))
    for fault, what in (("no_grad_back", "stage 1 sends back zeros for its "
                         "input gradient"),
                        ("skip_backward", "every stage skips the last "
                         "micro-batch's backward")):
        rec = runs[0][fault]["runs"][f"1F1B_{fault}"]
        bad = _pp_readings(rec["losses"], full[f"1F1B_{fault}"], refs)
        caught = _pp_failures(bad)
        log("ernie_pp", f"[{smi}] planted fault ({what}; 2 steps): loss "
            + " ".join(f"{x:.6f}" for x in rec["losses"]) + "; "
            + _pp_read_text(bad) + "; caught: "
            + ("; ".join(caught) or "none"))
        if not caught:
            raise AssertionError(f"ernie_pp: the planted fault ({what}) "
                                 "passed every gate")
    del full
    # GPT-2 345M at pp 2
    g = {s: [r[f"gpt_{s}"] for r in runs] for s in ("gpipe", "1f1b")}
    for sched, recs in g.items():
        for r, rec in zip(runs, recs):
            _only_launches(f"gpt_pp {sched} rank {r['rank']}",
                           rec["launches"],
                           {k: v * GPT_PP_STEPS
                            for k, v in rec["per_step"].items()})
        losses = recs[0]["losses"]
        if recs[1]["losses"] != losses:
            raise AssertionError(f"gpt_pp {sched}: the ranks' losses differ")
        gap = max(abs(x - y) / abs(y) for x, y in zip(losses, gpt_ref))
        if not gap <= GPT_PP_TOL:
            raise AssertionError(f"gpt_pp {sched}: loss {losses} vs pp 1's "
                                 f"{gpt_ref} ({100 * gap:.4f}%)")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"gpt_pp {sched}: loss did not fall "
                                 f"{losses}")
        if recs[0]["wte"] != recs[1]["wte"]:
            raise AssertionError(f"gpt_pp {sched}: the tied wte differs "
                                 "between the stages")
    for r in range(2):
        if (g["gpipe"][r]["losses"] != g["1f1b"][r]["losses"]
                or g["gpipe"][r]["sha256"] != g["1f1b"][r]["sha256"]):
            raise AssertionError("gpt_pp: gpipe and 1f1b differ")
    gap = max(abs(x - y) / abs(y) for x, y in zip(g["1f1b"][0]["losses"],
                                                  gpt_ref))
    gmed = {s: float(np.median(g[s][0]["step_s"][1:])) for s in g}
    log("gpt_pp", f"[{smi}] GPT-2 345M bf16 O2 at pp 2 over 2 gloo ranks "
        f"(stage 0: {g['1f1b'][0]['tensors']} tensors, "
        f"{g['1f1b'][0]['elements']} elements; stage 1: "
        f"{g['1f1b'][1]['tensors']} tensors, {g['1f1b'][1]['elements']} "
        f"elements), B {TRAIN_BATCH} x S {TRAIN_SEQ}, {GPT_PP_M} "
        f"micro-batches: loss " + " ".join(
            f"{x:.6f}" for x in g["1f1b"][0]["losses"]) + " vs pp 1's "
        + " ".join(f"{x:.6f}" for x in gpt_ref) + f" (worst "
        f"{100 * gap:.5f}%, gate {100 * GPT_PP_TOL}%); gpipe = 1f1b bit for "
        "bit; the tied wte bit-identical on both stages after every step; "
        "launches a step exact: " + "; ".join(
            f"stage {i} {g['1f1b'][i]['per_step']}" for i in range(2)))
    log("gpt_pp", f"[{smi}] step (host clock, median of steps 2-"
        f"{GPT_PP_STEPS}) gpipe {gmed['gpipe'] * 1e3:.1f} ms, 1f1b "
        f"{gmed['1f1b'] * 1e3:.1f} ms; peak memory a rank gpipe "
        + " / ".join(f"{r['peak_bytes'] / 2 ** 30:.3f}" for r in g["gpipe"])
        + " GiB, 1f1b " + " / ".join(
            f"{r['peak_bytes'] / 2 ** 30:.3f}" for r in g["1f1b"])
        + " GiB; 1f1b comm: " + _pp_comm_line(
            [(r["rank"], rec) for r, rec in zip(runs, g["1f1b"])]))
    # mp 2 x pp 2 over four ranks
    runs4, full4, wall4 = _pp_run(dev, 4, 2, ["ernie_1f1b"])
    read = _pp_ernie_gates("ernie_mp2pp2", runs4, "1F1B", full4["1F1B"],
                           refs)
    del full4
    recs = [r["ernie"]["runs"]["1F1B"] for r in runs4]
    log("ernie_pp", f"[{smi}] ERNIE at mp 2 x pp 2 over 4 gloo ranks "
        f"(rank = stage x 2 + mp rank; {runs4[0]['ernie']['tensors']} "
        f"tensors, {runs4[0]['ernie']['elements']} elements on rank 0), "
        f"1F1B, spawn-to-join {wall4:.1f} s: loss " + " ".join(
            f"{x:.6f}" for x in recs[0]["losses"]) + f"; "
        + _pp_read_text(read) + "; launches exact; step (host clock, median of "
        f"steps 2-{ERNIE_PP_STEPS}) "
        f"{float(np.median(recs[0]['step_s'][1:])) * 1e3:.1f} ms; peak "
        "memory a rank " + " / ".join(
            f"{r['peak_bytes'] / 2 ** 30:.3f}" for r in recs) + " GiB; comm: "
        + _pp_comm_line([(r["rank"], rec) for r, rec in zip(runs4, recs)]))


# -- phase 26 ----------------------------------------------------------
# Transformer-base (Vaswani et al. 2017, "Attention Is All You Need",
# Table 3 "base"): nn.Transformer() at its defaults, a 37,000-token shared
# BPE vocabulary (the paper's WMT14 En-De), batches of about 25,000 source
# and 25,000 target tokens
TF_VOCAB = 37000
TF_BATCH, TF_SEQ = 96, 256
TF_STEPS, TF_WARMUP = 20, 2
TF_LR, TF_WD = 2e-4, 0.01
TF_DECODE = 32
TF_FLASH_ROW_TOL = 5e-5     # each flash call's rows against the dense route
TF_TIE_REL = 1e-3           # phase 6's near-tie limit, of the row's max|logit|


def _op_cases():
    """The CPU parity test's op table (`tests/torch_op_cases.py`, which
    imports no JAX) and its inputs, from the JAX op tests' seeds."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    try:
        import torch_op_cases
    finally:
        sys.path.pop(0)
    return torch_op_cases


def _op_run(paddle, case, dev):
    """One row of the op table through the port on `dev`."""
    import inspect

    _, name, args, kwargs, _, _ = case

    def conv(a):
        if isinstance(a, list) and a and all(isinstance(
                v, (np.ndarray, np.generic)) for v in a):
            return [torch.from_numpy(np.array(v)).to(dev) for v in a]
        if isinstance(a, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(a)).to(dev)
        return a

    fn = getattr(paddle, name)
    kw = dict(kwargs)
    if "device" in inspect.signature(fn).parameters:
        kw["device"] = dev
    return fn(*[conv(a) for a in args], **kw)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [x]


def _op_table(dev, smi):
    """(a) Every row of the CPU parity table on the card against the
    port's own CPU result for the same numpy inputs, at the row's
    tolerance class; the decompositions by reconstruction; the random
    ops' form and seeded determinism on the card."""
    import paddle_tpu_torch as paddle

    oc = _op_cases()
    rows = oc.cases(**oc.inputs())
    worst = {k: 0.0 for k in oc.TOL}
    for case in rows:
        cid, tol = case[0], oc.TOL[case[4]]
        got = _flat(_op_run(paddle, case, dev))
        want = _flat(_op_run(paddle, case, torch.device("cpu")))
        if len(got) != len(want):
            raise AssertionError(f"ops {cid}: {len(got)} outputs on the "
                                 f"card, {len(want)} on the CPU")
        for g, w in zip(got, want):
            if not isinstance(w, torch.Tensor):
                if g != w:
                    raise AssertionError(f"ops {cid}: {g!r} != {w!r}")
                continue
            g = g.detach().cpu()
            w = w.detach()
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"ops {cid}: {g.dtype} {tuple(g.shape)}"
                                     f" on the card, {w.dtype} "
                                     f"{tuple(w.shape)} on the CPU")
            if tol == 0.0 or not (w.is_floating_point() or w.is_complex()):
                if not torch.equal(g, w) and not (
                        w.is_floating_point() and torch.equal(
                            g.isnan(), w.isnan()) and torch.equal(
                            g.nan_to_num(), w.nan_to_num())):
                    raise AssertionError(f"ops {cid}: not bit for bit")
                continue
            if w.is_complex():
                g, w = torch.view_as_real(g), torch.view_as_real(w)
            ok = torch.isclose(g, w, rtol=tol, atol=tol, equal_nan=True)
            if not bool(ok.all()):
                err = max_err(g.nan_to_num(), w.nan_to_num())
                raise AssertionError(f"ops {cid}: max|err| {err:.3e} over "
                                     f"{case[4]} ({tol})")
            fin = w.isfinite() & g.isfinite()
            if bool(fin.any()):
                worst[case[4]] = max(worst[case[4]], float(
                    ((g - w).abs()[fin] / w.abs()[fin].clamp_min(1.0))
                    .max()))
    d = oc.inputs()
    spd, sq, a = (torch.from_numpy(d[k]).to(dev) for k in ("SPD", "SQ", "A"))
    la = paddle.linalg
    rec = {}
    u, s, vh = la.svd(a)
    rec["svd"] = max_err((u * s) @ vh, a)
    q, r = la.qr(spd)
    rec["qr"] = max_err(q @ r, spd)
    w_, v_ = la.eigh(spd)
    rec["eigh"] = max_err((v_ * w_) @ v_.T, spd)
    w_, v_ = la.eig(sq)
    rec["eig"] = max_err(((v_ * w_) @ torch.linalg.inv(v_)).real, sq)
    lu, piv = la.lu(sq)
    p_, lo, up = la.lu_unpack(lu, piv)
    rec["lu"] = max_err(p_ @ lo @ up, sq)
    cpu_piv = la.lu(sq.cpu())[1]
    if not torch.equal(piv.cpu(), cpu_piv):
        raise AssertionError("ops lu: pivots differ from the CPU's")
    sol = la.lstsq(spd, spd[:, :1])[0]
    rec["lstsq"] = max_err(spd @ sol, spd[:, :1])
    scale = float(spd.abs().max())
    bad = {k: v for k, v in rec.items() if not v <= 1e-4 * scale}
    if bad:
        raise AssertionError(f"ops: reconstruction off: {bad}")
    for call in (lambda: paddle.rand([64], device=dev),
                 lambda: paddle.randn([64], device=dev),
                 lambda: paddle.randint(0, 9, [64], device=dev),
                 lambda: paddle.randperm(64, device=dev)):
        paddle.seed(11)
        x = call()
        paddle.seed(11)
        if x.device.type != dev.type or not torch.equal(x, call()):
            raise AssertionError("ops: a seeded draw on the card differs")
    state = paddle.get_rng_state()
    x = paddle.rand([8], device=dev)
    paddle.set_rng_state(state)
    if not torch.equal(x, paddle.rand([8], device=dev)):
        raise AssertionError("ops: the rng state did not round-trip")
    log("transformer", f"[{smi}] (a) op table: {len(rows)} calls of "
        f"{len({c[1] for c in rows})} ops on the card equal the port's CPU "
        "results (exact: bit for bit; worst relative error "
        + ", ".join(f"{k} {worst[k]:.2e} <= {oc.TOL[k]:.0e}"
                    for k in ("ew", "tr", "la"))
        + "); reconstructions within 1e-4 x max|x|: " + ", ".join(
            f"{k} {v:.2e}" for k, v in rec.items())
        + "; LU pivots equal the CPU's; seeded draws and the rng state "
        "replay on the card")


def _transformer_model(dev, seed=0):
    """Transformer-base built from the public API, as a Paddle user
    would: `paddle.nn.Transformer()` at its defaults, a shared
    `Embedding` (Normal(0, d^-0.5) through a ParamAttr) scaled by
    sqrt(d), sinusoidal positions from `arange`, `sin`, `cos` and
    `concat`, logits `matmul(h, emb.weight, transpose_y=True)`."""
    import paddle_tpu_torch as paddle

    nn = paddle.nn

    class TransformerBase(nn.Layer):
        def __init__(self, vocab, max_len):
            gen = torch.Generator(device=dev).manual_seed(seed)
            super().__init__(device=dev, generator=gen)
            self.transformer = nn.Transformer(device=dev, generator=gen)
            d = self.transformer.d_model
            self.d_model = d
            self.emb = nn.Embedding(vocab, d, weight_attr=nn.ParamAttr(
                initializer=nn.initializer.Normal(0.0, d ** -0.5)),
                device=dev, generator=gen)
            pos = paddle.unsqueeze(paddle.arange(
                0, max_len, dtype="float32", device=dev), 1)
            inv = paddle.exp(paddle.scale(paddle.arange(
                0, d, 2, dtype="float32", device=dev),
                -math.log(10000.0) / d))
            ang = paddle.multiply(pos, inv)
            self.register_buffer("pe", paddle.concat(
                [paddle.sin(ang), paddle.cos(ang)], axis=-1),
                persistable=False)

        def embed(self, ids, offset=0):
            x = paddle.scale(self.emb(ids), math.sqrt(self.d_model))
            return x + self.pe[offset:offset + ids.shape[1]]

        def logits(self, h):
            return paddle.matmul(h, self.emb.weight, transpose_y=True)

        def forward(self, src, tgt, tgt_mask=None):
            h = self.transformer(self.embed(src), self.embed(tgt),
                                 tgt_mask=tgt_mask)
            return self.logits(h)

    return TransformerBase(TF_VOCAB, TF_SEQ)


def _tf_batch(dev):
    rng = np.random.RandomState(17)
    src = rng.randint(1, TF_VOCAB, (TF_BATCH, TF_SEQ))
    tgt = rng.randint(1, TF_VOCAB, (TF_BATCH, TF_SEQ + 1))
    tgt[:, 0] = 0                                      # BOS
    return (torch.from_numpy(src).to(dev),
            torch.from_numpy(tgt[:, :-1].copy()).to(dev),
            torch.from_numpy(tgt[:, 1:].copy()).to(dev))


def _tf_flops(model):
    """Model FLOPs of one step: 6 x (encoder parameters x source tokens
    + (decoder parameters + the output projection) x target tokens) +
    3 x 18 attention products of 4 B S^2 d each (the embedding lookups
    left out)."""
    t = model.transformer
    n_enc = sum(p.numel() for p in t.encoder.parameters())
    n_dec = sum(p.numel() for p in t.decoder.parameters())
    tokens = TF_BATCH * TF_SEQ
    dense = 6 * (n_enc + n_dec + model.emb.weight.numel()) * tokens
    attn = 3 * 18 * 4 * TF_BATCH * TF_SEQ ** 2 * t.d_model
    return dense + attn


def _tf_train(dev, smi, model):
    """(b) AdamW, f32 (TF32 off), the causal tgt_mask, dropout 0.1:
    the loss falls; exactly one fused_adam launch a step and no other
    kernel (every attention call has live dropout, so the dense route
    runs). Step ms, tokens/s, MFU against the f32 peak, peak memory."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.nn import kernels

    F = paddle.nn.functional
    src, tgt_in, labels = _tf_batch(dev)
    mask = model.transformer.generate_square_subsequent_mask(TF_SEQ)
    opt = paddle.optimizer.AdamW(learning_rate=TF_LR,
                                 parameters=model.parameters(),
                                 weight_decay=TF_WD)
    model.train()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    losses, dts = [], []
    for _ in range(TF_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits = model(src, tgt_in, mask)
        loss = F.cross_entropy(paddle.reshape(logits, [-1, TF_VOCAB]),
                               paddle.reshape(labels, [-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))            # synchronises
        dts.append(time.perf_counter() - t0)
        del logits, loss
    counts = kernels.launches()
    peak = torch.cuda.max_memory_allocated(dev)
    _only_launches("transformer train", counts, {"fused_adam": TF_STEPS})
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"transformer: the loss did not fall "
                             f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    timed = dts[TF_WARMUP:]
    dt = float(np.median(timed))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = 2 * TF_BATCH * TF_SEQ
    mfu = _tf_flops(model) / dt / PEAK_F32_FLOPS
    log("transformer", f"[{smi}] (b) Transformer-base f32 (d_model 512, 8 "
        f"heads, 6 + 6 layers, FFN 2048, dropout 0.1, post-norm; {n_params}"
        f" params, shared {TF_VOCAB}-token embedding), AdamW lr {TF_LR}, "
        f"B {TF_BATCH} x S {TF_SEQ} source and target, causal tgt_mask: "
        "loss " + " -> ".join(f"{x:.4f}" for x in losses[:3])
        + f" ... {losses[-1]:.4f} over {TF_STEPS} steps; fused_adam "
        f"{counts['fused_adam']} = 1 x {TF_STEPS}, every other kernel 0; "
        f"step {dt * 1e3:.3f} ms (median of steps {TF_WARMUP + 1}-"
        f"{TF_STEPS}; min {min(timed) * 1e3:.3f}, max "
        f"{max(timed) * 1e3:.3f}) = {tokens / dt:.1f} tokens/s (source + "
        f"target), MFU {100 * mfu:.2f}% of 67 TFLOP/s f32 "
        f"({_tf_flops(model) / 1e12:.3f} TFLOP a step: 6 N tokens a side "
        f"+ attention); peak memory {peak / 2 ** 30:.2f} GiB")
    del opt
    return losses


class _FlashWatch:
    """Inside the block, every call of the flash route
    (`kernels.flash_attention.flash_attention`, which the routing in
    `incubate.nn.attention` calls) is also run through the dense route
    (`_dense_attention`) on the same q, k, v, and its output held row by
    row against it within TF_FLASH_ROW_TOL; the calls' shapes and the
    worst row ratio are kept. The dense route launches no kernel of the
    port, so the launch counts stay the flash route's."""

    def __init__(self, tag):
        self.tag, self.shapes, self.worst = tag, {}, 0.0

    def __enter__(self):
        from paddle_tpu_torch.incubate.nn import attention as attn
        from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

        self._fa, self._orig = fa, fa.flash_attention

        def watched(q, k, v, causal=False, sm_scale=1.0, use_kernel=True):
            out = self._orig(q, k, v, causal, sm_scale, use_kernel)
            dense = attn._dense_attention(q, k, v, None, sm_scale, causal,
                                          0.0, None)
            key = (tuple(q.shape), k.shape[2], bool(causal))
            self.shapes[key] = self.shapes.get(key, 0) + 1
            _, ratio = assert_close_rows(f"{self.tag} flash {key}", out,
                                         dense, TF_FLASH_ROW_TOL)
            self.worst = max(self.worst, ratio)
            return out

        fa.flash_attention = watched
        return self

    def __exit__(self, *exc):
        self._fa.flash_attention = self._orig
        return False

    def sq_sk(self):
        return sorted({(s[0][2], s[1]) for s in self.shapes})


def _tf_greedy(model, memory, cached):
    """TF_DECODE greedy tokens from BOS (id 0) for every row: through
    `gen_cache` one token a step (decoder self-attention sq = 1 over the
    growing cache, cross-attention sq = 1 against the memory), or by
    recomputing the decoder on the whole prefix under the causal mask.
    Returns (tokens [B, TF_DECODE], each step's logits)."""
    t = model.transformer
    ids = torch.zeros(memory.shape[0], 1, dtype=torch.long,
                      device=memory.device)
    cache = t.decoder.gen_cache(memory) if cached else None
    steps = []
    for i in range(TF_DECODE):
        if cached:
            h, cache = t.decoder(model.embed(ids[:, -1:], i), memory, None,
                                 None, cache)
        else:
            h = t.decoder(model.embed(ids), memory,
                          t.generate_square_subsequent_mask(i + 1))[:, -1:]
        logits = model.logits(h)[:, -1]
        steps.append(logits)
        ids = torch.cat([ids, logits.argmax(-1, keepdim=True)], dim=1)
    return ids[:, 1:], steps


def _tf_decode_gate(cached, full, lc, lf):
    """Cached tokens equal full recompute's; a row that diverges passes
    only where the two paths' logits there agree within TF_TIE_REL of
    the row's max|logit| and the top-2 gap is below that (a near-tie,
    shown). Returns the near-ties as (row, step, max|dlogits|, gap)."""
    ties = []
    for r in torch.nonzero((cached != full).any(dim=1)).reshape(-1).tolist():
        p = int(torch.nonzero(cached[r] != full[r])[0])
        a, b = lc[p][r], lf[p][r]
        limit = TF_TIE_REL * float(a.abs().max())
        top = a.topk(2).values
        gap = float(top[0] - top[1])
        d = max_err(a, b)
        if not (d <= limit and gap < limit):
            raise AssertionError(
                f"transformer decode: row {r} diverges at token {p} "
                f"(cached {cached[r, p]}, recompute {full[r, p]}) and it is "
                f"not a near-tie (max|dlogits| {d:.3e}, gap {gap:.3e}, "
                f"limit {limit:.3e})")
        ties.append((r, p, d, gap))
    return ties


def _tf_eval(dev, smi, model):
    """(c) Encode without a mask (#1 f32 at sq = sk = TF_SEQ), then
    greedy decode through `gen_cache` and by full recompute: every
    flash call against the dense route, #1's launches exact in each
    part, the cached tokens equal full recompute's."""
    from paddle_tpu_torch.incubate.nn import kernels

    src, _, _ = _tf_batch(dev)
    model.eval()
    n_layers = len(model.transformer.encoder.layers)
    with torch.no_grad():
        kernels.reset_launches()
        with _FlashWatch("encode") as enc:
            memory = model.transformer.encoder(model.embed(src))
        _only_launches("transformer encode", kernels.launches(),
                       {"flash_attention_fwd": n_layers})
        kernels.reset_launches()
        with _FlashWatch("cached decode") as dec:
            t0 = time.perf_counter()
            cached, lc = _tf_greedy(model, memory, True)
            torch.cuda.synchronize(dev)
            dec_s = time.perf_counter() - t0
        _only_launches("transformer cached decode", kernels.launches(),
                       {"flash_attention_fwd": 2 * n_layers * TF_DECODE})
        kernels.reset_launches()
        with _FlashWatch("recompute") as full_w:
            full, lf = _tf_greedy(model, memory, False)
        _only_launches("transformer recompute", kernels.launches(),
                       {"flash_attention_fwd": n_layers * TF_DECODE})
        ties = _tf_decode_gate(cached, full, lc, lf)
    sk_self = sorted({sk for sq, sk in dec.sq_sk() if sk <= TF_DECODE})
    log("transformer", f"[{smi}] (c) encode B {TF_BATCH} x S {TF_SEQ}, no "
        f"mask: flash_attention_fwd (#1 f32) {n_layers} launches at sq = sk"
        f" = {TF_SEQ}, each within {TF_FLASH_ROW_TOL} of its row's max of "
        f"the dense route (worst {enc.worst:.2e}); greedy decode of "
        f"{TF_DECODE} tokens through gen_cache: {2 * n_layers * TF_DECODE} "
        f"launches = 12 x {TF_DECODE} (self-attention sq = 1 over sk = "
        f"{sk_self[0]}..{sk_self[-1]}, cross-attention sq = 1 against sk = "
        f"{TF_SEQ}; worst row ratio {dec.worst:.2e}), {dec_s * 1e3:.1f} ms "
        f"wall with the dense checks; full recompute (causal mask, dense "
        f"self-attention): {n_layers * TF_DECODE} cross-attention launches "
        f"(sq = 1..{TF_DECODE}, sk = {TF_SEQ}; worst {full_w.worst:.2e}) "
        f"counted apart; cached tokens equal full recompute's for "
        f"{TF_BATCH - len(ties)} of {TF_BATCH} rows"
        + (f", the rest near-ties {ties}" if ties else ""))


def _tf_flash_times(dev, smi):
    """#1 f32 at phase 26's shapes (B 96, H 8, D 64, non-causal, cold
    L2): the encoder's sq = sk = 256, the cached decode's cross-
    attention sq 1 against sk 256 and its self-attention sq 1 over the
    last step's sk 32; kernel, plain version, f32 SDPA and bound ms."""
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    rng = np.random.RandomState(23)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for sq, sk in ((TF_SEQ, TF_SEQ), (1, TF_SEQ), (1, TF_DECODE)):
        q, k, v, _ = _flash_inputs(rng, TF_BATCH, 8, sq, 64, torch.float32,
                                   dev, sk)
        k_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, False,
                                                      0.125), 50, flush)[0]
        p_ms = time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, False, 0.125), 10, flush)[0]
        l_ms = time_ms(lambda: sdpa(q, k, v, scale=0.125), 50, flush)[0]
        bh = TF_BATCH * 8
        nbytes = 4 * (2 * bh * sq * 64 + 2 * bh * sk * 64 + bh * sq)
        (bound, by, how), = flash_bounds(
            {"fwd": (nbytes, 4.0 * bh * sq * sk * 64)},
            torch.float32).values()
        out.append(f"sq {sq} sk {sk}: kernel {k_ms:.5f}, plain {p_ms:.5f}, "
                   f"SDPA {l_ms:.5f}, bound {bound:.5f} ({by}; {how})")
    del flush
    log("transformer", f"[{smi}] #1 f32 at B {TF_BATCH}, H 8, D 64, "
        "non-causal, cold L2, device ms: " + "; ".join(out))


def phase_transformer(dev, smi):
    """Phase 26: the public tensor API and nn.Transformer on the card
    (see the module docstring)."""
    t0 = time.perf_counter()
    _op_table(dev, smi)
    model = _transformer_model(dev)
    named = list(model.named_parameters())
    optim_at_shape(
        dev, smi, "transformer", named, "fused_adam",
        ("Transformer-base's set", "AdamW",
         dict(learning_rate=TF_LR, weight_decay=TF_WD), {}),
        dict(lr=TF_LR, beta1=0.9, beta2=0.999, eps=1e-8,
             decay=[float(np.float32(1) - np.float32(TF_LR)
                          * np.float32(TF_WD))] * len(named)),
        lambda ps: torch.optim.AdamW(ps, lr=TF_LR, weight_decay=TF_WD,
                                     fused=True))
    del named
    torch.cuda.empty_cache()
    _tf_train(dev, smi, model)
    torch.cuda.empty_cache()
    _tf_eval(dev, smi, model)
    del model
    torch.cuda.empty_cache()
    _tf_flash_times(dev, smi)
    log("transformer", f"phase 26 in {time.perf_counter() - t0:.1f} s")

# -- phase 27 ----------------------------------------------------------
MON_TIMED_STEPS = 6       # (b): steps a PADDLE_PERF_DISPATCH setting
MON_SCRAPE_S = 1.0        # (a): the scraper's pause between rounds
MON_CHAOS_STALL = "serve_decode:stall:secs=5:after=10:times=1"
MON_WATCHDOG_S = 2        # (c): the watchdog's timeout
MON_HEARTBEAT_S = 10.0    # (c): the router's, above the stall's 5 s
MON_TORN = "ckpt_write:torn:after=1:times=1"
MON_OOM_SLACK = 64 << 20  # (e): allocated back within 64 MiB


def _mon_get(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _mon_scrape(base, paths, stop, seen, ms):
    """(a)'s scraper: GET every page in turn until `stop`; counts each
    page's 200s (its body parsed) and keeps its fetch ms."""
    while not stop.is_set():
        for path in paths:
            t0 = time.perf_counter()
            code, body = _mon_get(base + path)
            ms.setdefault(path, []).append((time.perf_counter() - t0) * 1e3)
            if path != "/metrics":
                json.loads(body)
            seen[path] = seen.get(path, 0) + (code == 200)
        stop.wait(MON_SCRAPE_S)


def _mon_fit(dev, tmp, callbacks, epochs=FIT_EPOCHS, resume=None):
    """Phase 19's fit recipe in this process: BERT-base bf16 O2 from
    seed 0, its loader and schedule. Returns (model, optimizer, Model,
    fit seconds)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW

    model = _bert_model(dev)
    opt = AdamW(learning_rate=_fit_sched(), parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    m = Model(model).prepare(opt, _fit_loss)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    m.fit(_fit_loader(dev, model.config.vocab_size), epochs=epochs,
          verbose=0, callbacks=callbacks, resume=resume)
    torch.cuda.synchronize(dev)
    return model, opt, m, time.perf_counter() - t0


def _mon_fit_telemetry(dev, smi, tmp, bert_mfu):
    """(a): see the module docstring."""
    import threading

    from paddle_tpu_torch import monitor as mon
    from paddle_tpu_torch.hapi.callbacks import Callback, Telemetry
    from paddle_tpu_torch.monitor import flight, server

    os.environ["PADDLE_MONITOR_SERVE"] = "0"
    jsonl = os.path.join(tmp, "metrics.jsonl")
    mon.start_exporter(path=jsonl, interval=1.0)
    flight.start_watchdog()
    steps0 = mon.stat_get("step/count")
    # perf_report reads this fit's dispatches alone (phases 18-19 ran
    # the same program name)
    mon.hist_get("jit/hist/train_step:BertForPretraining/dispatch_us") \
        .reset()
    tel = Telemetry()
    stop, seen, errs, page_ms = threading.Event(), {}, [], {}
    pages = ("/metrics", "/statusz", "/memz", "/perfz", "/flightz")

    class Scrape(Callback):
        def on_train_begin(self, logs=None):
            srv = server.get_server()
            if srv is None:
                raise AssertionError("monitor (a): fit armed no server")

            def run():
                try:
                    _mon_scrape(srv.url, pages, stop, seen, page_ms)
                except Exception as e:   # read after the fit
                    errs.append(e)

            self.t = threading.Thread(target=run, name="phase27-scrape",
                                      daemon=True)
            self.t.start()

    scrape = Scrape()
    model, opt, m, fit_s = _mon_fit(dev, tmp, [tel, scrape])
    stop.set()
    scrape.t.join(30)
    if errs or set(seen) != set(pages) or min(seen.values()) < 1:
        raise AssertionError(f"monitor (a): scrapes {seen}, errors {errs}")
    n = mon.stat_get("step/count") - steps0
    if n != FIT_STEPS:
        raise AssertionError(f"monitor (a): step/count +{n}, expected "
                             f"{FIT_STEPS}")
    mon.stop_exporter(flush=True)
    with open(jsonl) as f:
        lines = f.read().splitlines()
    last = json.loads(lines[-1])["stats"]
    live = mon.registry.snapshot()
    if last != live:
        diff = sorted(k for k in set(last) | set(live)
                      if last.get(k) != live.get(k))
        raise AssertionError(f"monitor (a): exporter's last line differs "
                             f"from the registry at {diff[:10]}")
    mon.telemetry_snapshot()
    peak_gauge = mon.stat_get("mem/peak_bytes")
    peak = torch.cuda.max_memory_allocated(dev)
    if peak_gauge != peak:
        raise AssertionError(f"monitor (a): mem/peak_bytes {peak_gauge} != "
                             f"max_memory_allocated {peak}")
    code, page = _mon_get(server.get_server().url + "/metrics")
    local = mon.prometheus_text()
    ts_line = "paddle_tpu_export_timestamp_seconds "

    def strip_ts(text):
        return [ln for ln in text.splitlines() if not ln.startswith(ts_line)]

    if code != 200 or strip_ts(page) != strip_ts(local):
        diff = sorted(set(strip_ts(page)) ^ set(strip_ts(local)))
        raise AssertionError(f"monitor (a): /metrics != prometheus_text(): "
                             f"{diff[:10]}")
    name = f"train_step:{type(model).__name__}"
    if name in mon.perf.perf_report()["programs"]:
        raise AssertionError(f"monitor (a): perf_report holds {name}, "
                             "whose step records no cost")
    disp = mon.hist_get(f"jit/hist/{name}/dispatch_us")
    d_p50 = disp.quantile(0.5) / 1e6
    d_mfu = 6 * sum(p.numel() for p in model.parameters()) * BERT_ROWS \
        / d_p50 / PEAK_BF16_FLOPS
    hist = mon.hist_get("step/hist/time_us")
    summ = tel.step_timer.summary()
    log("monitor", f"[{smi}] (a) BERT-base fit, {FIT_STEPS} steps, default "
        f"callbacks, server on port {server.get_server().port}, exporter "
        f"{len(lines)} lines, watchdog armed: step/count +{n}; "
        f"mem/peak_bytes = max_memory_allocated = {peak}; /metrics = "
        f"prometheus_text() ({len(local.splitlines())} lines, the "
        f"timestamp line aside); the exporter's last line = the registry "
        f"({len(last)} stats); scrapes {seen}, every {MON_SCRAPE_S} s, "
        "median ms a page: " + ", ".join(
            f"{p} {float(np.median(v)):.1f}" for p, v in page_ms.items()))
    first = tel.step_timer._times[0] * 1e3
    log("monitor", f"[{smi}] (a) StepTimer step {summ['avg_step_ms']:.3f} "
        f"ms (mean of its window), p50 {hist.quantile(0.5) / 1e3:.3f} ms, "
        f"first step {first:.1f} ms (its memory ledger included); the "
        f"fit's clock {fit_s * 1e3 / FIT_STEPS:.3f} ms a step, "
        f"{(fit_s * 1e3 - first) / (FIT_STEPS - 1):.3f} ms a step after "
        f"the first; jit/hist/{name}/dispatch_us: {disp.count} "
        f"dispatches, p50 {d_p50 * 1e3:.3f} ms, 6 N tokens MFU at it "
        f"{d_mfu:.4f} (phase 18's {bert_mfu:.4f}); perf_report has no "
        f"entry for it (the train step records no cost)")
    del m, model, opt
    torch.cuda.empty_cache()


def _mon_dispatch_cost(dev, smi):
    """(b): step ms with PADDLE_PERF_DISPATCH on and off, alternated
    (on, off, on, off), for phase 9's and phase 18's steps."""
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    def timed(step, args):
        out = {"1": [], "0": []}
        for setting in ("1", "0", "1", "0"):
            os.environ["PADDLE_PERF_DISPATCH"] = setting
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(MON_TIMED_STEPS):
                loss = step(*args)
            float(loss)
            out[setting].append(
                (time.perf_counter() - t0) * 1e3 / MON_TIMED_STEPS)
        os.environ.pop("PADDLE_PERF_DISPATCH")
        return out

    res = {}
    gpt = _train_model(dev)
    opt = AdamW(learning_rate=1e-4, parameters=gpt.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStepCompiler(gpt, opt)
    ids, labels = _train_batch(gpt.config.vocab_size, dev)
    for _ in range(2):
        step(ids, labels)
    res["GPT-2 345M (phase 9)"] = timed(step, (ids, labels))
    del gpt, opt, step
    torch.cuda.empty_cache()
    bert = _bert_model(dev)
    wrap = _BertStep(bert)
    opt = AdamW(learning_rate=1e-4, parameters=wrap.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStepCompiler(wrap, opt)
    ids, tt = _bert_batch(bert.config.vocab_size, dev)
    for _ in range(2):
        step(ids, tt, ids)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res["BERT-base (phase 18)"] = timed(step, (ids, tt, ids))
    act = torch.cuda.max_memory_allocated(dev) - before
    log("monitor", f"[{smi}] (b) step ms, PADDLE_PERF_DISPATCH on (a "
        f"device synchronisation after each step) vs off, {MON_TIMED_STEPS}"
        f" steps a reading, on/off/on/off: " + "; ".join(
            f"{k}: on " + ", ".join(f"{x:.3f}" for x in v["1"]) + " / off "
            + ", ".join(f"{x:.3f}" for x in v["0"]) for k, v in res.items()))
    return bert, wrap, opt, step, act


def _mon_zero_counters(smi):
    from paddle_tpu_torch import monitor as mon

    bad = sorted(k for k in mon.registry.snapshot()
                 if k.startswith(("chaos/", "sanitize/", "analysis/")))
    if bad:
        raise AssertionError(f"monitor (b): counters with nothing armed: "
                             f"{bad[:10]}")
    log("monitor", f"[{smi}] (b) nothing armed: no chaos/*, sanitize/* or "
        "analysis/* counter exists")


def _mon_chaos_router(dev, smi, model, want):
    """(c)'s router half: see the module docstring."""
    from paddle_tpu_torch import monitor as mon
    from paddle_tpu_torch.inference.serving import Router, SamplingParams
    from paddle_tpu_torch.monitor import chaos, flight

    cfg = model.config
    prompts = _serve_prompts(cfg.vocab_size)
    sampling = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    fdir = flight.dump_dir()
    old = set(os.listdir(fdir)) if os.path.isdir(fdir) else set()
    os.environ["PADDLE_WATCHDOG_TIMEOUT_S"] = str(MON_WATCHDOG_S)
    os.environ["PADDLE_CHAOS"] = MON_CHAOS_STALL
    flight.stop_watchdog()
    flight.start_watchdog()
    chaos.configure()
    failovers = mon.stat_get("serve/failovers")
    t_start = time.time()   # the ring's clock
    router = Router(model, replicas=2, max_batch=SERVE_MAX_BATCH,
                    num_blocks=ROUTER_BLOCKS, device=dev,
                    heartbeat_timeout_s=MON_HEARTBEAT_S)
    try:
        ids, _, _ = _flood(router, prompts, sampling)
        _router_gate("monitor (c) stall", model, dev, prompts, want, router,
                     ids)
        stalled = [r for r in router._replicas if r.dead]
        orphans = len(router.orphan_exports)
    finally:
        chaos.disarm()
        os.environ.pop("PADDLE_CHAOS")
        flight.stop_watchdog()
        os.environ.pop("PADDLE_WATCHDOG_TIMEOUT_S")
        router.shutdown()
    trig = mon.stat_get("chaos/serve_decode/stall/triggered")
    n_fo = mon.stat_get("serve/failovers") - failovers
    bundles = sorted(f for f in set(os.listdir(fdir)) - old
                     if f.startswith("watchdog_"))
    if trig != 1 or n_fo != 1 or len(stalled) != 1 or len(bundles) != 1 \
            or orphans:
        raise AssertionError(f"monitor (c): stall triggered {trig}, "
                             f"failovers +{n_fo}, dead {len(stalled)}, "
                             f"orphaned exports {orphans}, watchdog "
                             f"bundles {bundles}")
    b = flight.read_dump(os.path.join(fdir, bundles[0]))
    stuck = b["stuck"]
    names = {t["tid"]: t["name"] for t in b["threads"]}
    want_thread = f"serve-replica-{stalled[0].idx}"
    if [e["kind"] for e in stuck] != ["serve_decode"] \
            or names.get(stuck[0]["tid"]) != want_thread:
        raise AssertionError(f"monitor (c): stuck {stuck}, its thread "
                             f"{names.get(stuck[0]['tid'])}, expected "
                             f"{want_thread}")
    # this run's ring events (the ring also holds phase 25's failovers)
    ring = [e for e in flight.tail() if e["ts"] >= t_start]
    drains = [e for e in ring if e["kind"] == "serve_drain_done"
              and e.get("emergency")]
    fo = [e for e in ring if e["kind"] == "serve_failover"]
    if len(drains) != 1 or drains[0].get("reason") != "watchdog" \
            or [e.get("reason") for e in fo] != ["incident_export"] \
            or fo[0].get("replica") != stalled[0].idx:
        raise AssertionError(f"monitor (c): emergency exports {drains}, "
                             f"failovers {fo}")
    t_wd = max(e["ts"] for e in ring if e["kind"] == "watchdog")
    log("monitor", f"[{smi}] (c) Router x 2, incident export on (the "
        f"default), under {MON_CHAOS_STALL}, watchdog {MON_WATCHDOG_S} s, "
        f"heartbeat {MON_HEARTBEAT_S} s: chaos/serve_decode/stall/"
        f"triggered {trig}; one watchdog bundle ({bundles[0]}): stuck "
        f"serve_decode/{stuck[0]['name']} on thread {want_thread}, age "
        f"{stuck[0]['age_s']} s; that replica alone exported "
        f"{drains[0].get('exported')} requests from its incident hook; one "
        f"failover (incident_export), no orphaned export; phase 5's "
        f"tokens; watchdog event to failover event "
        f"{(fo[0]['ts'] - t_wd) * 1e3:.3f} ms (ring clock)")


def _mon_chaos_spec(dev, smi, model, want):
    """(c)'s speculative half."""
    from paddle_tpu_torch import monitor as mon
    from paddle_tpu_torch.incubate.nn import kernels
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.monitor import chaos

    cfg = model.config
    prompts = _serve_prompts(cfg.vocab_size)
    keys = ("serve/spec/proposed", "serve/spec/accepted",
            "serve/decode_dispatches", "chaos/serve_spec_verify/corrupt/"
            "triggered")
    chaos.configure("serve_spec_verify:corrupt")
    try:
        eng = LLMEngine(model, max_batch=SERVE_MAX_BATCH,
                        num_blocks=SPEC_BLOCKS, device=dev, spec_k=SPEC_K,
                        draft_layers=cfg.num_layers)
        ids = [eng.add_request(p, SamplingParams(
            max_new_tokens=SERVE_NEW_TOKENS)) for p in prompts]
        before = {k: mon.stat_get(k) for k in keys}
        kernels.reset_launches()
        while eng.has_unfinished():
            eng.step()
        torch.cuda.synchronize(dev)
        counts = kernels.launches()
        d = {k: mon.stat_get(k) - before[k] for k in keys}
    finally:
        chaos.disarm()
    outs = [eng.get_request(i).output_ids for i in ids]
    _spec_gate("monitor (c) corrupt", model, dev, prompts, want, outs)
    rounds = d["serve/decode_dispatches"]
    multi = counts["paged_attention_multi"]
    if d["serve/spec/accepted"] or not d["serve/spec/proposed"] \
            or d[keys[3]] != rounds or multi != cfg.num_layers * rounds:
        raise AssertionError(f"monitor (c) corrupt: {d}, multi-query "
                             f"launches {multi}")
    log("monitor", f"[{smi}] (c) k={SPEC_K} engine (draft = target) under "
        f"serve_spec_verify:corrupt: {rounds} rounds, "
        f"{d['serve/spec/proposed']} proposals, 0 accepted (one token a "
        f"request a round), corrupt triggered {d[keys[3]]}; phase 5's "
        f"tokens; #10 launched {multi} = {cfg.num_layers} x {rounds}")


def _mon_torn(dev, smi, tmp):
    """(d): see the module docstring."""
    from paddle_tpu_torch import monitor as mon
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.incubate.checkpoint.elastic import (
        CheckpointManager)
    from paddle_tpu_torch.monitor import chaos, flight

    ckdir = os.path.join(tmp, "torn_ckpt")
    os.environ["PADDLE_CKPT_SAVE_STEPS"] = str(FIT_SAVE_STEPS)
    seen = {}

    class Digest(Callback):
        n = 0

        def on_train_batch_end(self, step, logs=None):
            Digest.n += 1
            if Digest.n == FIT_SAVE_STEPS:
                seen.update({k: _digest(v) for k, v in
                             self.model.network.state_dict().items()})

    chaos.configure(MON_TORN)
    try:
        model, opt, m, _ = _mon_fit(dev, tmp, [Digest()], epochs=1,
                                    resume=ckdir)
    finally:
        chaos.disarm()
        os.environ.pop("PADDLE_CKPT_SAVE_STEPS")
    trig = mon.stat_get("chaos/ckpt_write/torn/triggered")
    mgr = CheckpointManager(dir=ckdir, device=dev)
    state = mgr.restore()
    got = {k: _digest(v) for k, v in state["model"].items()}
    kinds = [e["kind"] for e in flight.tail()]
    steps = sorted(os.listdir(ckdir))
    if trig != 1 or mgr.cursor["global_step"] != FIT_SAVE_STEPS \
            or got != seen or "chaos_inject" not in kinds \
            or "ckpt_error" not in kinds:
        raise AssertionError(f"monitor (d): torn triggered {trig}, restored "
                             f"{mgr.cursor}, {len(got)} tensors, equal "
                             f"{got == seen}, dirs {steps}")
    log("monitor", f"[{smi}] (d) {FIT_STEPS // FIT_EPOCHS}-step fit "
        f"snapshotting every {FIT_SAVE_STEPS} steps under {MON_TORN}: step "
        f"dirs {steps}, the epoch-end snapshot torn; restore fell back to "
        f"global step {mgr.cursor['global_step']}, its {len(got)} tensors "
        f"bit for bit the fit's at that step; the ring holds chaos_inject "
        f"and ckpt_error")
    del m, model, opt, state
    torch.cuda.empty_cache()


def _mon_oom(dev, smi, bert, opt, step, act):
    """(e)'s out-of-memory: a BERT-base step at a batch whose
    activations (`act` bytes a B 32 step, measured in (b)) need twice
    the free memory."""
    import gc

    from paddle_tpu_torch.monitor import flight, memory

    # the step clears the gradients first: let them go before `before`
    opt.clear_grad()
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    batch = int(math.ceil(2 * free / (act / BERT_BATCH)))
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, bert.config.vocab_size, (batch, BERT_SEQ))).to(dev)
    tt = torch.zeros_like(ids)
    fdir = flight.dump_dir()
    old = set(os.listdir(fdir)) if os.path.isdir(fdir) else set()
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    outcomes = []
    try:
        with memory.auto_oom_observer():
            step(ids, tt, ids)
        outcomes.append("returned")
    except torch.OutOfMemoryError:
        outcomes.append("oom")
    except Exception as e:
        outcomes.append(f"{type(e).__name__}: {e}"[:200])
    gc.collect()
    after = torch.cuda.memory_allocated(dev)
    bundles = sorted(f for f in set(os.listdir(fdir)) - old
                     if f.startswith("oom_"))
    if outcomes != ["oom"] or len(bundles) != 1:
        raise AssertionError(f"monitor (e): outcomes {outcomes}, oom "
                             f"bundles {bundles}")
    mem = flight.read_dump(os.path.join(fdir, bundles[0]))["memory"]
    at_fault = mem["device"]["allocated_bytes"]
    census = mem["census"]["devices"].get(str(dev), 0)
    if "num_ooms" not in mem["device"] or census > at_fault \
            or abs(after - before) > MON_OOM_SLACK:
        raise AssertionError(f"monitor (e): census {census} vs allocated "
                             f"{at_fault}, allocated {before} -> {after}")
    log("monitor", f"[{smi}] (e) BERT-base step at B {batch} x S {BERT_SEQ}"
        f" ({act / BERT_BATCH / 2 ** 20:.1f} MiB of activations a row, "
        f"{free / 2 ** 30:.2f} GiB free): exactly one "
        f"torch.OutOfMemoryError; one oom bundle ({bundles[0]}) with "
        f"torch.cuda.memory_stats (num_ooms {mem['device']['num_ooms']}) "
        f"and the census: {census} bytes on {dev} in "
        f"{mem['census']['total_arrays']} storages <= {at_fault} allocated "
        f"at the fault; allocated {before} before, {after} after (within "
        f"{MON_OOM_SLACK >> 20} MiB)")


def _mon_numerics(dev, smi, steps=3):
    """(e)'s numerics probe: phase 9's GPT-2 steps under
    PADDLE_SANITIZE=numerics:sample=1, then disarmed from the same seed;
    the probed absmax of every tensor at the last step against a
    recomputation from copies taken before it."""
    from paddle_tpu_torch import monitor as mon
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.monitor import numerics, sanitize
    from paddle_tpu_torch.optimizer import AdamW

    def absmax(t):
        a = t.detach().float().abs()
        return float(torch.where(torch.isfinite(a), a,
                                 torch.zeros_like(a)).max())

    def run(spec):
        sanitize.configure(spec)
        try:
            gpt = _train_model(dev)
            opt = AdamW(learning_rate=1e-4, parameters=gpt.parameters(),
                        weight_decay=0.01, multi_precision=True)
            step = TrainStepCompiler(gpt, opt)
            ids, labels = _train_batch(gpt.config.vocab_size, dev)
            losses, want = [], {}
            for i in range(steps):
                if i == steps - 1:
                    want = {f"param/{n}": absmax(p)
                            for n, p in gpt.named_parameters()}
                loss = step(ids, labels)
                losses.append(float(loss))
            want["loss"] = absmax(loss)
            want.update({f"grad/{n}": absmax(p.grad)
                         for n, p in gpt.named_parameters()})
            return losses, want
        finally:
            sanitize.disarm()

    numerics.clear()
    armed, want = run("numerics:sample=1")
    # describe() keeps the freshest 256 tensors; the gauges keep all
    last = numerics.describe()["last"]
    stats = mon.registry.snapshot()
    bad = [n for n, v in want.items()
           if (n in last and last[n]["absmax"] != v)
           or stats.get(f"numerics/{n}/absmax") != math.ceil(v)]
    plain, _ = run("")
    if bad or len(last) != min(256, len(want)) or armed != plain:
        raise AssertionError(f"monitor (e) numerics: {len(bad)} of "
                             f"{len(want)} gauges differ ({bad[:5]}), "
                             f"losses {armed} vs {plain}")
    log("monitor", f"[{smi}] (e) PADDLE_SANITIZE=numerics:sample=1 over "
        f"{steps} of phase 9's steps: the numerics/*/absmax gauges of all "
        f"{len(want)} tensors (loss, every grad, every pre-update param) "
        f"equal the ceilings of a recomputation on the card, and the "
        f"{len(last)} float absmax values the probe keeps equal it bit for "
        f"bit; losses {[x.hex() for x in armed]} = the disarmed run's")
    torch.cuda.empty_cache()


def phase_monitor(dev, smi, serve_want, bert_mfu):
    """Phase 27: the monitor planes (see the module docstring)."""
    import tempfile

    from paddle_tpu_torch.monitor import flight, server

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase27_")
    os.environ["PADDLE_FLIGHT_DIR"] = os.path.join(tmp, "flight")
    try:
        _mon_fit_telemetry(dev, smi, tmp, bert_mfu)
        bert, wrap, opt, step, act = _mon_dispatch_cost(dev, smi)
        _mon_zero_counters(smi)
        model = _serve_model(dev)
        _mon_chaos_router(dev, smi, model, serve_want)
        _mon_chaos_spec(dev, smi, model, serve_want)
        del model
        torch.cuda.empty_cache()
        _mon_oom(dev, smi, bert, opt, step, act)
        del bert, wrap, opt, step
        torch.cuda.empty_cache()
        _mon_torn(dev, smi, tmp)
        _mon_numerics(dev, smi)
    finally:
        server.stop_server()
        flight.stop_watchdog()
        os.environ.pop("PADDLE_MONITOR_SERVE", None)
    log("monitor", f"phase 27 in {time.perf_counter() - t0:.1f} s")



def _paged_ms(by):
    """(T = 1 launches' ms, T > 1 launches' ms) of the paged kernel in a
    profile's {kernel name: ms}: one kernel, told apart by its slot
    count."""
    nq = {name: re.search(r"paged_multi_kernel<[^,]+, *\d+, *(\d+)>", name)
          for name in by}
    one = sum(ms for name, ms in by.items()
              if nq[name] and nq[name].group(1) == "1")
    many = sum(ms for name, ms in by.items()
               if nq[name] and nq[name].group(1) != "1")
    return one, many


def measure(dev, smi, kernels_only=False):
    """`--measure`: the times the redesigned kernels are judged by (the
    LayerNorm forward, paged attention, the f32 flash kernels at
    ERNIE's shape with the f32 SDPA and both bounds, and the bf16 flash
    kernels at BERT's), and
    (unless `kernels_only`, `--kernels`) where the decode step, the
    speculative round and the training step spend their device time, on
    whichever `paddle_tpu_torch` is imported (`--tree`). A
    parent-vs-change comparison runs this on each tree in turns (parent,
    change, change, parent) in one call."""
    import paddle_tpu_torch
    from paddle_tpu_torch.incubate.nn.kernels.layernorm import layer_norm_fwd
    from paddle_tpu_torch.jit import TrainStepCompiler
    from paddle_tpu_torch.optimizer import AdamW

    tree = os.path.dirname(os.path.dirname(paddle_tpu_torch.__file__))
    log("measure", f"[{smi}] paddle_tpu_torch from {tree}")
    ln_fwd_times(dev, tag="measure")
    rng = np.random.RandomState(1)
    x, w, b = (torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev)
               for sh in ((8, 1024), (1024,), (1024,)))
    k_ms, _ = time_ms(lambda: layer_norm_fwd(x, None, w, b, 1e-5))
    log("measure", f"forward N=8 H=1024 f32 no residual (phase 4's decode "
        f"shape), device ms: kernel {k_ms:.5f}")
    paged_times(dev, tag="measure")
    multi_times(dev, tag="measure")
    flash_times(dev, smi, "measure", ERNIE_BATCH, (torch.float32,))
    flash_times(dev, smi, "measure", BERT_BATCH, (torch.bfloat16,))
    if kernels_only:
        return

    from paddle_tpu_torch.inference.serving import model_runner as mr

    model = _serve_model(dev)
    eng, _, _, _, _, args, tail, kw = _decode_setup(dev, model)
    wall, busy, count, _, by = profile_ms(lambda: mr.decode_logits(
        eng.params, *args, eng.cache.k, eng.cache.v, *tail, use_kernel=True,
        **kw))
    del eng
    if busy is None:
        raise RuntimeError("measure: the profiler saw no device activity")
    lnf = sum(ms for name, ms in by.items() if "ln_fwd_kernel" in name)
    log("measure", f"[{smi}] decode step (B=8): wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms, {count:.0f} kernels; paged kernel "
        f"{_paged_ms(by)[0]:.4f} ms, LN forward {lnf:.4f} ms")
    wall, busy, count, _, by = _spec_round_profile(model, dev)
    one, many = _paged_ms(by)
    log("measure", f"[{smi}] one spec round (B=8, k={SPEC_K}, default "
        f"draft): wall {wall:.3f} ms, device busy {busy:.3f} ms, {count:.0f}"
        f" kernels; multi kernel {many:.4f} ms, decode kernel {one:.4f} ms, "
        f"together {one + many:.4f} ms")
    del model
    torch.cuda.empty_cache()

    model = _train_model(dev)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStepCompiler(model, opt)
    ids, labels = _train_batch(model.config.vocab_size, dev)
    for _ in range(TRAIN_WARMUP):
        step(ids, labels)
    wall, busy, count, _, by = profile_ms(lambda: step(ids, labels), reps=2)
    part = {k: sum(ms for name, ms in by.items() if k in name)
            for k in ("ln_fwd_kernel", "ln_bwd_kernel", "ln_bwd_sum")}
    log("measure", f"[{smi}] training step (GPT-2 345M bf16 O2, B="
        f"{TRAIN_BATCH} S={TRAIN_SEQ}): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, {count:.0f} kernels; " + ", ".join(
            f"{k} {ms:.3f} ms" for k, ms in part.items()))
    del model, opt, step
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # --tree DIR: import paddle_tpu_torch from the checkout at DIR
    if "--tree" in sys.argv:
        sys.path.insert(0, os.path.abspath(
            sys.argv[sys.argv.index("--tree") + 1]))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    if "--fit-worker" in sys.argv:
        return fit_worker()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi, name = phase_device()
    phase_build()
    if "--bert-grads" in sys.argv:
        bert_grads_rows(dev, smi)
        log("done", f"measured in {time.perf_counter() - t0:.1f} s")
        return 0
    if "--measure" in sys.argv:
        measure(dev, smi, "--kernels" in sys.argv)
        log("done", f"measured in {time.perf_counter() - t0:.1f} s")
        return 0
    entries = [phase_paged(dev), phase_ln(dev)]
    model = _serve_model(dev)
    counts, serve_outs, serve_stats = phase_serve(dev, model, smi)
    phase_logits(dev, model)
    for e in entries:
        e["launches"] = counts[e["name"]]
    serve_model = model             # phases 14-15 serve it again
    train_entries = phase_flash(dev) + [phase_ln_bwd(dev)]
    model, counts = phase_train(dev, smi)
    phase_grads(dev, model)
    for e in train_entries:
        e["launches"] = counts[e["name"]]
    entries += train_entries
    del model
    torch.cuda.empty_cache()
    named = list(_train_model(dev).named_parameters())
    optim_entries = phase_optim(dev, smi, named)
    del named
    torch.cuda.empty_cache()
    counts = phase_recipe(dev, smi)
    for e in optim_entries:
        e["launches"] = counts[e["name"]]
    entries += optim_entries
    torch.cuda.empty_cache()
    multi_entry = phase_multi(dev)
    counts = phase_spec(dev, serve_model, smi, serve_outs, serve_stats)
    multi_entry["launches"] = counts["paged_attention_multi"]
    phase_prefix(dev, serve_model, smi)
    phase_router(dev, serve_model, smi, serve_outs)
    entries.append(multi_entry)
    del serve_model
    torch.cuda.empty_cache()
    compress_entries = phase_compress(dev, smi)
    counts = phase_dp(dev, smi)
    for e in compress_entries:
        e["launches"] = counts[e["name"]]
    entries += compress_entries
    torch.cuda.empty_cache()
    bert_mfu = phase_bert(dev, smi)
    torch.cuda.empty_cache()
    phase_fit(dev, smi)
    torch.cuda.empty_cache()
    phase_lenet(dev, smi)
    torch.cuda.empty_cache()
    resnet_imgs_s, resnet_setting = phase_resnet(dev, smi)
    torch.cuda.empty_cache()
    phase_pipeline(dev, smi, resnet_imgs_s, resnet_setting)
    torch.cuda.empty_cache()
    ernie_losses, ernie_after1 = phase_ernie(dev, smi)
    torch.cuda.empty_cache()
    phase_ernie_mp(dev, smi, ernie_losses, ernie_after1)
    torch.cuda.empty_cache()
    phase_ernie_pp(dev, smi, ernie_losses, ernie_after1)
    del ernie_after1
    torch.cuda.empty_cache()
    phase_transformer(dev, smi)
    torch.cuda.empty_cache()
    phase_monitor(dev, smi, serve_outs, bert_mfu)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
