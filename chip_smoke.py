#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py
    python3 chip_smoke.py --measure [--kernels] [--tree DIR]

Needs one CUDA card and `nvcc`; exits non-zero, printing no result,
without them. `--measure` runs phases 1-2 and then only the times the
paged-attention and LayerNorm-forward kernels are judged by and the
decode-step, speculative-round and training-step profiles (`measure`;
`--kernels`: the kernel times alone), with `paddle_tpu_torch` imported
from DIR when given: a comparison of
two source trees runs it on each in turns in one call. Phases, each printing one line (or a few):

  1. device   card name and power limit (nvidia-smi), torch's name
  2. build    the port's CUDA kernels compiled from paddle_tpu_torch/csrc;
              registers, spills and stack frames of the bf16 flash, the
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
              times against the bound, SDPA forward and SDPA backward
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
    work back to back and not the Python wrappers' host time (an
    enqueue that outlasts half the hold is retried with a longer one).
    With `flush` (a tensor larger than the 50 MB L2), the L2 is
    overwritten before every call, as a caller reading cold memory
    would find it. Host time: the enqueue loop's wall time per call.
    For a function of a few launches: a long chain of launches fills
    the launch queue behind the hold (`profile_ms` covers those)."""
    def enqueue():
        pairs = []
        for _ in range(iters):
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
    enqueue()
    torch.cuda.synchronize()
    hold_s = min(5.0, 2.0 * (time.perf_counter() - t0))
    for _ in range(4):
        # _sleep counts SM cycles; at <= 2 GHz this holds >= hold_s
        torch.cuda._sleep(int(hold_s * 2e9))
        t0 = time.perf_counter()
        pairs = enqueue()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s < 0.5 * hold_s:
            break
        hold_s = min(5.0, 4 * hold_s)       # the host caught up
    else:
        raise RuntimeError("time_ms: the host could not stay ahead of "
                           "the card")
    dev_ms = sum(s.elapsed_time(e) for s, e in pairs) / iters
    return dev_ms, host_s * 1e3 / iters


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


def profile_ms(fn, reps=3, n_top=5):
    """Where one call of a long launch chain spends its time: (wall ms
    per call, synchronised, without the profiler; device-busy ms per
    call, the sum of its kernels' device durations under
    torch.profiler; kernels per call; the top `n_top` kernels as (name,
    count per call, ms per call); {kernel name: ms per call} of every
    kernel). Device numbers are None when the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by.get(e.name, (0, 0.0))
            by[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by:
        return wall, None, None, [], {}
    busy = sum(us for _, us in by.values()) / reps / 1e3
    count = sum(n for n, _ in by.values()) / reps
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n_top]

    def short(name):
        name = name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        return name if len(name) <= 72 else f"{name[:34]}..{name[-36:]}"

    return wall, busy, count, [(short(name), n / reps, us / reps / 1e3)
                               for name, (n, us) in top], {
        name: us / reps / 1e3 for name, (_, us) in by.items()}


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
    log("build", "bf16 flash kernels, registers (at launch; setmaxnreg "
        "moves the producer warpgroup to 40, consumers to 232) and "
        "spills: " + "; ".join(
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
    bytes spill loads")} of the bf16 flash kernels, from nvcc's
    `-Xptxas=-v` output."""
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
            k = re.search(r"(fa_(?:fwd|bwd_dq|bwd_dkv)_wgmma)"
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


def _flash_check(tag, q, k, v, do, causal, scale):
    """Kernels vs plain versions, each side from its own forward.
    Returns {name: (max |err|, max |err| / row max|ref|)}. f32: o within
    2e-5 and the gradients within 2e-4, abs + rel, the JAX package's
    tolerances for its flash kernel (test_flash_attention.py:34, 53);
    bf16: per row, FLASH_BF16_ROW_TOL."""
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    o0, lse0 = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    dq0, dk0, dv0 = fa.flash_attention_bwd_reference(q, k, v, o0, lse0, do,
                                                     causal, scale)
    # lse is f32 from the same inputs: summation order only
    errs = {"lse": (assert_close(f"{tag} lse", lse, lse0, 1e-4, 1e-5),
                    None)}
    for name, got, want in (("o", o, o0), ("dq", dq, dq0), ("dk", dk, dk0),
                            ("dv", dv, dv0)):
        if got.dtype != q.dtype or got.shape != want.shape \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} {name}: {got.dtype} "
                                 f"{tuple(got.shape)} or non-finite")
        if q.dtype == torch.float32:
            t = 2e-5 if name == "o" else 2e-4
            errs[name] = (assert_close(f"{tag} {name}", got, want, t, t),
                          None)
        else:
            errs[name] = assert_close_rows(f"{tag} {name}", got, want,
                                           FLASH_BF16_ROW_TOL)
    return errs


def phase_flash(dev, shape=(TRAIN_BATCH, 16, TRAIN_SEQ, 64), iters=50):
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    rng = np.random.RandomState(2)
    b, h, s, d = shape
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # tag, B, H, Sq, D, dtype, causal, Sk
        ("training shape", b, h, s, d, bf16, True, None),
        ("S256", 2, 4, 256, 64, f32, True, None),
        ("S129", 2, 4, 129, 64, f32, True, None),
        ("S1000", 1, 4, 1000, 64, bf16, True, None),
        ("S1000 D128", 1, 4, 1000, 128, f32, True, None),
        ("S129 D128", 2, 4, 129, 128, bf16, True, None),
        ("non-causal S256", 2, 4, 256, 64, f32, False, None),
        ("non-causal Sq100 Sk333", 1, 4, 100, 64, bf16, False, 333),
        ("non-causal Sq100 Sk333 D128", 1, 4, 100, 128, f32, False, 333),
    ]
    worst = {f32: {}, bf16: {}}
    slice_err = None
    for tag, bb, hh, sq, dd, dtype, causal, sk in cases:
        q, k, v, do = _flash_inputs(rng, bb, hh, sq, dd, dtype, dev, sk)
        errs = _flash_check(f"flash {tag} {dtype}", q, k, v, do, causal,
                            dd ** -0.5)
        slice_err = slice_err or {n: e for n, (e, _) in errs.items()}
        for n, (e, r) in errs.items():
            e0, r0 = worst[dtype].get(n, (0.0, None))
            worst[dtype][n] = (max(e0, e),
                               None if r is None else max(r0 or 0.0, r))
    for dtype in (f32, bf16):
        log("flash", f"kernels vs plain, {dtype}, worst of "
            f"{sum(c[5] == dtype for c in cases)} cases, max|err| (/ row "
            "max|ref|): " + ", ".join(
                f"{n} {e:.3e}" + ("" if r is None else f" ({r:.3e})")
                for n, (e, r) in worst[dtype].items()))
    log("flash", "tolerances: f32 o 2e-5, grads 2e-4 (abs + rel); bf16 "
        f"per row: {FLASH_BF16_ROW_TOL} x row max|ref| (floored at 1e-3 x "
        "max|ref|); lse 1e-4 abs + 1e-5 rel")

    # times at the training shape, bf16, causal; L2 flushed before each
    # call (34 MB of inputs, most of which a step has evicted by then)
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
def _train_model(dev, num_layers=24, o2=True):
    """bench_gpt2's on-chip GPT-2 345M (bench.py:540-545), weights from
    seed 0; bf16 O2 unless `o2` is False."""
    import dataclasses

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt2_345m

    cfg = dataclasses.replace(
        gpt2_345m(max_seq_len=TRAIN_SEQ, dropout=0.0, remat=False,
                  use_flash_attention=True), num_layers=num_layers)
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


def _grads_check(tag, model, ids, labels, loss_rtol, row_tol):
    """Loss and every gradient, kernels vs plain versions, from the
    same parameters. Each gradient is held per row (its last axis: one
    output unit of a weight, one token of an embedding, one layer of a
    stacked bias) at row_tol x the row's max|g|. Returns the worst row
    ratio max|err| / row max|g| over all parameters."""
    loss_k, gk = _loss_and_grads(model, ids, labels, True)
    loss_p, gp = _loss_and_grads(model, ids, labels, False)
    if abs(loss_k - loss_p) > loss_rtol * abs(loss_p):
        raise AssertionError(f"{tag}: loss {loss_k} vs plain {loss_p}")
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
    """`--measure`: the times the redesigned kernels are judged by, and
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi, name = phase_device()
    phase_build()
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
    entries.append(multi_entry)
    del serve_model
    torch.cuda.empty_cache()
    compress_entries = phase_compress(dev, smi)
    counts = phase_dp(dev, smi)
    for e in compress_entries:
        e["launches"] = counts[e["name"]]
    entries += compress_entries
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
