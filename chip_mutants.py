#!/usr/bin/env python3
"""Planted faults in the bf16 flash-attention kernels, and which of
`chip_smoke.py`'s checks catch them.

    python3 chip_mutants.py

Needs one CUDA card and `nvcc`. The source files are not touched: each
mutant is `csrc/flash_attention.cu` with one edit, written and compiled
(one `nvcc` per mutant, all started together) under
`paddle_tpu_torch/_build/mutants/`, and linked with the other kernels
into a library of its own. The flash wrappers then run on that library
in turn. Every mutant breaks only late causal rows or keys (query rows
or keys >= 512 of 1024), or one tile: the faults a limit set by a
tensor's first rows would miss.

For the unmutated library (the control) and each mutant, three checks:
  per-row    chip_smoke's flash check at the training shape (B 4, H 16,
             S 1024, D 64, bf16, causal, chip_smoke's inputs): o, dq,
             dk and dv per row, lse within 1e-4; with each output's
             worst row ratio max|err| / row max|ref|
  tensor     o, dq, dk and dv at the whole-tensor limit the per-row
             one replaced, 2e-2 x max|ref| + 2e-2 relative
  grads      chip_smoke's phase 10 bf16 check, at the initial weights
             (seed 0): one step's loss and every gradient of GPT-2 345M
             (24 layers, bf16 O2, B 4 x S 1024), kernel path vs plain
             path, per row
Exits non-zero when the control fails a check or a mutant passes the
per-row flash check.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

# (name, [(unique text of flash_attention.cu, replacement)])
MUTANTS = [
    ("fwd: KV tile 0 skipped for query rows >= 512",
     [("    __syncthreads();  // the previous tile's readers are done\n"
       "    load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, kb, k0, sk);\n",
       "    __syncthreads();  // the previous tile's readers are done\n"
       "    if (k0 == 0 && q0 >= 512) continue;\n"
       "    load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, kb, k0, sk);\n"
       )]),
    ("fwd: causal diagonal masked for query rows >= 512",
     [("        const bool ok = kp < sk && (!kCausal || qp >= kp);\n"
       "        s[nt][i] = ok",
       "        const bool ok = kp < sk && (!kCausal || qp > kp ||\n"
       "                                    (qp == kp && qp < 512));\n"
       "        s[nt][i] = ok")]),
    ("dq: KV tile 0 skipped for query rows >= 512",
     [("    __syncthreads();\n"
       "    load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, kb, k0, sk);\n",
       "    __syncthreads();\n"
       "    if (k0 == 0 && q0 >= 512) continue;\n"
       "    load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, kb, k0, sk);\n"
       )]),
    ("dq: causal diagonal masked for query rows >= 512",
     [("        const bool ok = kp < sk && (!kCausal || qp >= kp);\n"
       "        const float p =\n"
       "            expf((ok ? s[nt][i]",
       "        const bool ok = kp < sk && (!kCausal || qp > kp ||\n"
       "                                    (qp == kp && qp < 512));\n"
       "        const float p =\n"
       "            expf((ok ? s[nt][i]")]),
    ("dk/dv: causal diagonal masked for keys >= 512",
     [("const bool ok = kp < sk && qp < sq && (!kCausal || qp >= kp);\n"
       "        const float p =\n"
       "            expf((ok ? st[nt][i]",
       "const bool ok = kp < sk && qp < sq && (!kCausal || qp > kp ||\n"
       "                                    (qp == kp && kp < 512));\n"
       "        const float p =\n"
       "            expf((ok ? st[nt][i]")]),
    ("dk/dv: last q tile skipped for keys < 512",
     [("  for (int q0 = kCausal ? k0 : 0; q0 < sq; q0 += kTcRows) {\n"
       "    __syncthreads();\n",
       "  for (int q0 = kCausal ? k0 : 0; q0 < sq; q0 += kTcRows) {\n"
       "    __syncthreads();\n"
       "    if (q0 + kTcRows >= sq && k0 < 512) continue;\n")]),
]


def build_mutants():
    """One loaded library per mutant, built from the checkout's csrc."""
    from paddle_tpu_torch.incubate.nn import kernels as K

    nvcc = K._nvcc()
    root = K.BUILD_DIR / "mutants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    base = (K.CSRC_DIR / "flash_attention.cu").read_text()
    jobs, common = [], []
    for src in K.SOURCES:
        if src != "flash_attention.cu":
            common.append(root / src.replace(".cu", ".o"))
            jobs.append((src, [nvcc, *K.NVCC_FLAGS, "-c",
                               str(K.CSRC_DIR / src), "-o",
                               str(common[-1])]))
    for i, (name, edits) in enumerate(MUTANTS):
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"mutant {name!r}: its text occurs "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        (root / f"m{i}.cu").write_text(text)
        jobs.append((name, [nvcc, *K.NVCC_FLAGS, "-c", str(root / f"m{i}.cu"),
                            "-o", str(root / f"m{i}.o")]))
    procs = [(n, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for n, cmd in jobs]
    for n, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {n}:\n{out}")
    libs = []
    for i in range(len(MUTANTS)):
        so = root / f"m{i}.so"
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(so), str(root / f"m{i}.o"),
                        *map(str, common)], check=True,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        lib = ctypes.CDLL(str(so))
        K._declare(lib)
        libs.append(lib)
    return libs


def flash_outputs(q, k, v, do, scale):
    """{name: (kernel output, plain output)} for lse, o, dq, dk, dv."""
    from paddle_tpu_torch.incubate.nn.kernels import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    got = (lse, o, *fa.flash_attention_bwd(q, k, v, o, lse, do, True,
                                           scale))
    o0, lse0 = fa.flash_attention_fwd_reference(q, k, v, True, scale)
    want = (lse0, o0, *fa.flash_attention_bwd_reference(
        q, k, v, o0, lse0, do, True, scale))
    return dict(zip(("lse", "o", "dq", "dk", "dv"), zip(got, want)))


def run_checks(model, batch, inputs):
    import chip_smoke as cs

    q, k, v, do = inputs
    scale = q.shape[-1] ** -0.5
    outs = flash_outputs(q, k, v, do, scale)
    # the worst row ratio of each output, and the lse error
    ratios = ", ".join(
        f"{n} {cs.assert_close_rows(n, g, w, float('inf'))[1]:.2e}"
        for n, (g, w) in outs.items() if n != "lse")
    lse_err = cs.max_err(*outs["lse"])
    res = {}
    try:
        cs._flash_check("flash", q, k, v, do, True, scale)
        res["per-row"] = "passes"
    except AssertionError as e:
        res["per-row"] = f"FAILS ({e})"
    res["per-row"] += (f"; worst row max|err| / row max|ref|: {ratios}; lse"
                       f" max|err| {lse_err:.2e}")
    bad = []
    for name, (g, w) in outs.items():
        g, w = g.float(), w.float()
        lim = 2e-2 * float(w.abs().max()) + 2e-2 * w.abs()
        if name != "lse" and not bool(((g - w).abs() <= lim).all()):
            bad.append(name)
    res["tensor"] = f"fails ({', '.join(bad)})" if bad else "passes"
    try:
        r = cs._grads_check("grads", model, *batch, *cs.GRADS_BF16_TOL)
        res["grads"] = f"passes (worst row ratio {r:.3e})"
    except AssertionError as e:
        res["grads"] = f"FAILS ({e})"
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.incubate.nn import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    control = K.load()
    libs = build_mutants()
    rng = np.random.RandomState(2)
    inputs = cs._flash_inputs(rng, cs.TRAIN_BATCH, 16, cs.TRAIN_SEQ, 64,
                              torch.bfloat16, dev)
    model = cs._train_model(dev)
    batch = cs._train_batch(model.config.vocab_size, dev)
    ok = True
    for name, lib in [("control (unmutated)", control)] + [
            (n, lib) for (n, _), lib in zip(MUTANTS, libs)]:
        K._lib = lib
        try:
            res = run_checks(model, batch, inputs)
        finally:
            K._lib = control
        for check, verdict in res.items():
            print(f"[mutant] {name} | {check}: {verdict}", flush=True)
        if lib is control:
            ok &= not any(r.lower().startswith("fails")
                          for r in res.values())
        else:
            ok &= res["per-row"].startswith("FAILS")
    print(f"[mutant] {'every' if ok else 'NOT every'} mutant fails the "
          "per-row flash check and the control passes every check")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
