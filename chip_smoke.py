#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero, printing no result,
without them. Phases, each printing one line (or a few):

  1. device   card name and power limit (nvidia-smi), torch's name
  2. build    the port's CUDA kernels compiled from paddle_tpu_torch/csrc
  3. paged    paged-attention kernel vs its plain version on the card:
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
              times against the bound and SDPA
  8. lnbwd    LayerNorm backward kernel vs its plain version at the
              training shape (4096 x 1024), f32 and bf16, with and
              without residual, no / tanh / erf GeLU; times
  9. train    GPT-2 345M training at full width, bench_gpt2's on-chip
              config (bf16 O2, AdamW with f32 master weights, B 4 x S
              1024, random weights from seed 0) through
              TrainStepCompiler: loss decreases, launch counters per
              step, step ms, tokens/s, MFU, peak memory, where a step's
              time goes
 10. grads    one step's loss and every gradient, kernel path vs plain
              path from the same state: full width in bf16, and 2
              layers at full width in f32

Then one JSON line with every kernel's launches, error and times, the
nvidia-smi line, and as the LAST line
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


def profile_ms(fn, reps=3, n_top=5):
    """Where one call of a long launch chain spends its time: (wall ms
    per call, synchronised, without the profiler; device-busy ms per
    call, the sum of its kernels' device durations under
    torch.profiler; kernels per call; the top `n_top` kernels as (name,
    count per call, ms per call)). Device numbers are None when the
    profiler saw no device activity."""
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
        return wall, None, None, []
    busy = sum(us for _, us in by.values()) / reps / 1e3
    count = sum(n for n, _ in by.values()) / reps
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n_top]

    def short(name):
        name = name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        return name if len(name) <= 72 else f"{name[:34]}..{name[-36:]}"

    return wall, busy, count, [(short(name), n / reps, us / reps / 1e3)
                               for name, (n, us) in top]


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
    spills = [ln.strip() for ln in lines
              if "spill stores" in ln and not ln.strip().startswith("0 ")]
    log("build", f"{info['seconds']:.1f} s -> {info['path']}; "
        f"{len(regs)} kernel instantiations, registers "
        f"{min(regs, default=0)}..{max(regs, default=0)}; non-zero spills:"
        f" {spills or 'none'}")
    return info


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

    # times at the serving shapes: f32 pools, contexts = prompts + 32
    # generated tokens, one inactive slot; L2 flushed before each launch
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
    log("paged", f"B={len(serve_ctx)} H={h} D={d} BS={bs} ctx={serve_ctx}"
        f" f32, cold L2, device ms: kernel {k_ms:.5f} | plain {p_ms:.5f} |"
        f" sdpa {l_ms:.5f} | bound {b_ms:.5f} ({b_by}, {nbytes} B); host "
        f"ms per call: kernel wrapper {k_host:.5f}, plain {p_host:.5f}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/paged_attention.py:76",
            "max_abs_err": err[torch.float32], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}


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

    def q(v, frac):
        return v[min(len(v) - 1, int(len(v) * frac))] * 1e3

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
    return counts, outs


# -- phase 6 -----------------------------------------------------------
def phase_logits(dev, model, num_blocks=512, lens=SERVE_LENS):
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.inference.serving import model_runner as mr

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
        wall, busy, count, top = profile_ms(lambda: step(use))
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
    # library yardstick, timed only: SDPA forward, and forward+backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale),
                      iters, flush)[0]
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg, is_causal=True, scale=scale)
        return torch.autograd.grad(out, (qg, kg, vg), do)

    lib_fb = time_ms(sdpa_fwd_bwd, iters, flush)[0]
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
        f" SDPA forward {lib_fwd:.5f} ms, forward+backward {lib_fb:.5f} "
        f"ms (backward alone ~{lib_fb - lib_fwd:.5f} ms); kernels "
        f"forward+backward {ms['fwd'] + ms['bwd']:.5f} ms")
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    rep = "paddle_tpu/incubate/nn/attention_pallas.py:"
    rows = [("flash_attention_fwd", "fwd", "97", slice_err["o"], lib_fwd),
            ("flash_attention_bwd_dq", "dq", "215", slice_err["dq"], None),
            ("flash_attention_bwd_dkv", "dkv", "257",
             max(slice_err["dk"], slice_err["dv"]), None)]
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": rep + line, "max_abs_err": err, "ms": ms[key],
             "plain_ms": plain[key], "bound_ms": bounds[key][0],
             "bound_by": bounds[key][1], "library_ms": lib}
            for name, key, line, err, lib in rows]


# -- phase 8 -----------------------------------------------------------
def phase_ln_bwd(dev, rows=TRAIN_BATCH * TRAIN_SEQ, hidden=1024, iters=100):
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
    log("lnbwd", f"forward kernel vs plain, N={rows} H={hidden}: max|err| "
        f"f32 {fwd_err[torch.float32]:.3e} (tol 1e-5 abs + 1e-5 rel), bf16 "
        f"{fwd_err[torch.bfloat16]:.3e} (y tol 1e-2 abs + 1e-2 rel; "
        "mean/rstd 1e-5); s bit-identical")
    log("lnbwd", f"kernel vs plain, N={rows} H={hidden}: max|err| f32 "
        f"{err[torch.float32]:.3e} (dx 1e-5 x max|ref| + 1e-5 rel), bf16 "
        f"{err[torch.bfloat16]:.3e} (dx 1e-2 x max|ref| + 1e-2 rel); dw, db"
        " 1e-5 x max|ref|")

    # times at the training shape: bf16 with residual (ln2), warm L2
    # (the backward's inputs were just written by the op before it)
    x, r, dy, ds = (t(rows, hidden, dtype=torch.bfloat16) for _ in range(4))
    _, s, mu, rs = layer_norm_fwd(x, r, w, b, eps)
    k_ms, k_host = time_ms(
        lambda: layer_norm_bwd(dy, ds, s, w, b, mu, rs), iters)
    p_ms, _ = time_ms(
        lambda: layer_norm_bwd_reference(dy, ds, s, w, b, mu, rs),
        max(1, iters // 4))
    # library yardstick, timed only: F.layer_norm's backward, without
    # the residual's add; weight and bias in bf16, since F.layer_norm on
    # the card takes one dtype
    xl = s.detach().requires_grad_()
    wl, bl = (t_.detach().bfloat16().requires_grad_() for t_ in (w, b))
    yl = torch.nn.functional.layer_norm(xl, (hidden,), wl, bl, eps)
    l_ms, _ = time_ms(lambda: torch.autograd.grad(
        yl, (xl, wl, bl), dy, retain_graph=True), iters)
    elems = rows * hidden
    nbytes = 4 * elems * 2 + 4 * hidden * 4 + 2 * rows * 4
    b_ms, b_by = bound_ms(nbytes, 12 * elems)
    log("lnbwd", f"N={rows} H={hidden} bf16 residual, warm L2, device ms: "
        f"kernel {k_ms:.5f} | plain {p_ms:.5f} | F.layer_norm backward "
        f"{l_ms:.5f} | bound {b_ms:.5f} ({b_by}, {nbytes} B); host ms per "
        f"call: kernel wrapper {k_host:.5f}")
    return {"name": "fused_layer_norm_bwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/layernorm.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/layernorm.py:156",
            "max_abs_err": err[torch.bfloat16], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}


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
    per_step = {"flash_attention_fwd": n_layers,
                "flash_attention_bwd_dq": n_layers,
                "flash_attention_bwd_dkv": n_layers,
                "fused_layer_norm": 2 * n_layers + 1,
                "fused_layer_norm_bwd": 2 * n_layers + 1,
                "paged_attention": 0}
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
    wall, busy, count, top = profile_ms(lambda: step(ids, labels), reps=2,
                                       n_top=10)
    if busy is None:
        log("train", f"[{smi}] step wall {wall:.3f} ms; device time not "
            "measured (the profiler saw no device activity)")
    else:
        tops = "; ".join(f"{name} x{n:.0f} {t:.3f} ms"
                         for name, n, t in top)
        log("train", f"[{smi}] where a step goes (torch.profiler, 2 steps):"
            f" wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%), {count:.0f} kernels; top: {tops}")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi, name = phase_device()
    phase_build()
    entries = [phase_paged(dev), phase_ln(dev)]
    model = _serve_model(dev)
    counts, _ = phase_serve(dev, model, smi)
    phase_logits(dev, model)
    for e in entries:
        e["launches"] = counts[e["name"]]
    del model
    train_entries = phase_flash(dev) + [phase_ln_bwd(dev)]
    model, counts = phase_train(dev, smi)
    phase_grads(dev, model)
    for e in train_entries:
        e["launches"] = counts[e["name"]]
    entries += train_entries
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
