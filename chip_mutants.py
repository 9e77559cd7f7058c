#!/usr/bin/env python3
"""Planted faults in the bf16 and f32 flash-attention kernels, the
LayerNorm forward and backward kernels, the multi-tensor optimizer kernel, the
paged-attention kernel and the int8 quantize kernel, and which of
`chip_smoke.py`'s checks catch them.

    python3 chip_mutants.py

Needs one CUDA card and `nvcc`. The source files are not touched: each
mutant is one source of `csrc/` with its edits, written and compiled
(one `nvcc` per mutant, all started together) under
`paddle_tpu_torch/_build/mutants/`, and linked with the other kernels
into a library of its own. The wrappers then run on that library in
turn. Every bf16 flash mutant breaks only late causal rows or keys (query
rows or keys >= 512 of 1024), or one tile: the faults a limit set by a
tensor's first rows would miss. Of the eight, four target the forward
kernel (KV tile 0 skipped, the diagonal masked, the diagonal tile run
without its mask, the last KV tile's V read from the other ring
stage), two the dq kernel (KV tile 0 skipped, the diagonal masked) and
two the dk/dv kernel (the diagonal masked, the last q tile skipped).
The three LayerNorm-backward mutants drop the m2 term of dx for rows
>= 2048 of 4096, leave the CTA's last row group (two warps at H 1024
in bf16) out of its dw/db partial, and drop ds from the last of each
lane's vectors of dx. The three LayerNorm-forward mutants take the
statistics of rows >= N/2 from the unrounded x + residual (s still
written rounded), leave a row's last vector out of the variance, and
read w and b of a row's last vector from the vector before it. The two optimizer mutants divide the
bias corrections by multiplying with an f32 reciprocal, and skip the
last chunk of one tensor (the first of the table, GPT-2's wte). The five
paged-attention mutants let slot t see one token too many (ctx0 + t +
1), make the deepest slot's merge skip its last live chunk of 64
tokens, weight the rows past slot t's context (which later slots read)
by zero instead of skipping them (exact zeros on finite data, so only
the per-slot NaN poison check can see it), leave chunk 1 out of every
merge of three or more chunks, and read the second page of a chunk
through the block id of its first page (a table-column fault only
chunks that span pages show). The two quantize mutants take the abs-max with
fmaxf alone, which drops a NaN, so a NaN block gets a finite scale, and
round the codes with truncf in place of rintf. Four more show only at
BERT's shapes: the forward and dq kernels skip the last KV tile and the
dk/dv kernel the last q tile when not causal (every other check is
causal), and the LayerNorm forward (variance) and backward (means and
dw/db) leave out a lane's last vector when a row does not fill its
lanes' vectors, as 768 does and 1024 does not. Five target the f32
backward kernels (3xTF32 on the tensor cores): one-pass TF32 in the dq
kernel's three products (their lo terms dropped), the same in the dk/dv
kernel's four, dq skipping the last KV tile and dk/dv the last q tile
when not causal, and dq with the causal diagonal masked. Four target the
f32 forward kernel (3xTF32): one-pass TF32 in S = Q.K^T alone, the same
in O += P.V alone, the last KV tile skipped when not causal, and O not
rescaled when a tile raises the running maximum.

For the unmutated library (the control) and each flash mutant, three
checks:
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
For the control and each optimizer mutant, one check:
  optim      chip_smoke's phase 11 check: every optimizer case on the
             GPT-2 345M O2 parameter set, kernel path vs per-parameter
             rule, bit for bit after every step
For the control and each multi-query mutant, one check:
  multi      chip_smoke's phase 13 check: the multi-query kernel vs its
             plain version over T 1/2/4/8, two head widths, f32 and
             bf16, ragged contexts, with the per-slot NaN poison check;
             the verdict names the check that failed first
For the control and each quantize mutant, one check:
  compress   chip_smoke's phase 16 check: quantize_i8 and dequantize_i8
             vs their plain versions, bit for bit, over blocks 128 / 256
             / 1024, 1-4096 blocks, zero, half-even, subnormal, NaN and
             Inf blocks
For the control and each LayerNorm mutant, forward or backward, one
check:
  lnbwd      chip_smoke's phase 8 check: the forward kernel vs its plain
             version (y within 1e-5 / 1e-2, mean and rstd within 1e-5, s
             bit-identical), then the backward kernel vs its plain
             version on the forward's outputs, at 4096 x 1024, f32 and
             bf16, with and without the residual, no / tanh / erf GeLU
             (dx within 1e-5 / 1e-2 x max|ref|, dw and db within 1e-5 x
             max|ref|), and a second call bit-identical
For the control and each f32 mutant, one check:
  f32        chip_smoke's phase 7 f32 cases (S 256, S 129, S 1000 D 128
             causal; S 256, Sq 100 Sk 333 D 128 not), both gates apart:
             the JAX-parity gate (kernels vs plain versions, o 2e-5,
             gradients 2e-4) and gate 1 (every output within 1e-5 x
             max|ref| of a float64 oracle, per row where causal); the
             verdict names the cases each gate failed
For the control and each of the four BERT-shape mutants, one more check:
  bert       chip_smoke's phase 18 kernel check: the flash kernels vs
             their plain versions at B 32, H 12, S 512, D 64, bf16,
             non-causal, per row (and f32 at B 2), and the LayerNorm
             forward and backward at 16384 x 768 bf16 with no, a bf16
             and an f32 residual, eps 1e-12 and 1e-5, f32 and bf16
             weights
  bert grads chip_smoke's phase 18 bf16 gradient check, at the initial
             weights (seed 0): BERT-base (12 layers, bf16 O2, B 32 x S
             512), kernel path vs plain path per row at 8e-2 x the
             row's max|g|, the row scale floored at 0.1 x the
             tensor's (BERT_GRADS_FLOOR), and every row within its
             own max|g|
Exits non-zero when the control fails a check, a BERT-shape mutant
passes the bert check, another flash mutant passes the
per-row flash check, another LayerNorm mutant passes the lnbwd check,
an optimizer mutant passes the optim check, a multi-query mutant passes
the multi check, a quantize mutant passes the compress check, or an
f32 mutant passes the f32 check.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

FLASH = "flash_attention.cu"
OPTIM = "optim.cu"
PAGED = "paged_attention.cu"
COMPRESS = "compress.cu"
LN = "layernorm.cu"
BERT = "bert"   # the check of the mutants only BERT's shapes show
F32 = "f32"     # the check of the f32 flash mutants
# one-pass TF32 products (the lo terms dropped), for the f32 mutants to
# call in place of `mma_abt` and `mma_xb`
ONE_PASS = """// one-pass TF32: the products without their lo terms
template <int D, int N>
__device__ __forceinline__ void mma_abt1(float (&d)[N / 8][4],
                                         const float* a, const float* b) {
  for (int nt = 0; nt < N / 8; ++nt)
    for (int i = 0; i < 4; ++i) d[nt][i] = 0.f;
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a<D + 4>(ah, al, a, 8 * kk);
    for (int nt = 0; nt < N / 8; nt += 2) {
      uint32_t bh[2][2], bl[2][2];
      frag_bt2<D + 4>(bh, bl, b + 8 * nt * (D + 4), 8 * kk);
      mma_tf32(d[nt], ah, bh[0]);
      mma_tf32(d[nt + 1], ah, bh[1]);
    }
  }
}

template <int D, int N>
__device__ __forceinline__ void mma_xb1(float (&d)[D / 8][4],
                                        const float (&x)[N / 8][4],
                                        const float* b) {
  for (int kt = 0; kt < N / 8; ++kt) {
    uint32_t ah[4], al[4];
    split(x[kt][0], ah[0], al[0]);
    split(x[kt][2], ah[1], al[1]);
    split(x[kt][1], ah[2], al[2]);
    split(x[kt][3], ah[3], al[3]);
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t bh[2], bl[2];
      frag_bp<D + 4>(bh, bl, b + 8 * kt * (D + 4) + 8 * nd);
      mma_tf32(d[nd], ah, bh);
    }
  }
}

"""
ONE_PASS_AT = ("// rows [row0, row0 + R) of a [rows, D] f32 matrix into a "
               "shared tile of")
# (name, source in csrc/, [(unique text of the source, replacement)]
#  [, the check that must catch it; default: the source's own])
MUTANTS = [
    ("fwd: KV tile 0 skipped for query rows >= 512", FLASH,
     [("      mbar_wait(&k_full[s], parity);\n"
       "      wgmma_fence();\n",
       "      mbar_wait(&k_full[s], parity);\n"
       "      if (t == 0 && item.q0 >= 512) {\n"
       "        mbar_wait(&v_full[s], parity);\n"
       "        if (lane0) mbar_arrive(&empty[s]);\n"
       "        continue;\n"
       "      }\n"
       "      wgmma_fence();\n")]),
    ("fwd: causal diagonal masked for query rows >= 512", FLASH,
     [("        if (!(kp < sk && (!kCausal || qp >= kp))) s[nt][i] = kNegInf;\n",
       "        if (!(kp < sk && (!kCausal || qp > kp ||\n"
       "                          (qp == kp && qp < 512))))\n"
       "          s[nt][i] = kNegInf;\n")]),
    ("fwd: the diagonal tile's mask skipped for query rows >= 512", FLASH,
     [("      if ((kCausal && k0 + kFwdKeys - 1 > row0) || k0 + kFwdKeys > sk)"
       "\n",
       "      if ((kCausal && k0 + kFwdKeys - 1 > row0 && row0 < 512) ||\n"
       "          k0 + kFwdKeys > sk)\n")]),
    ("fwd: the last KV tile's V read from the other ring stage", FLASH,
     [("desc_b128(sV + s * kStage + h * kFwdKeys * 64 +",
       "desc_b128(sV + (t == item.n_kv - 1 && t > 0 ? (s + 1) % kStages"
       " : s) * kStage + h * kFwdKeys * 64 +")]),
    ("dq: KV tile 0 skipped for query rows >= 512", FLASH,
     [("      mbar_wait(&k_full[s], par);\n",
       "      mbar_wait(&k_full[s], par);\n"
       "      if (t == 0 && item.q0 >= 512) {\n"
       "        mbar_wait(&v_full[s], par);\n"
       "        if (lane0) mbar_arrive(&empty[s]);\n"
       "        continue;\n"
       "      }\n")]),
    ("dq: causal diagonal masked for query rows >= 512", FLASH,
     [("        if (!(kp < sk && (!kCausal || qp >= kp))) p = 0.f;\n",
       "        if (!(kp < sk && (!kCausal || qp > kp ||\n"
       "                          (qp == kp && qp < 512))))\n"
       "          p = 0.f;\n")]),
    ("dk/dv: causal diagonal masked for keys >= 512", FLASH,
     [("        if (!(qp < sq && (!kCausal || qp >= kp))) p = 0.f;\n",
       "        if (!(qp < sq && (!kCausal || qp > kp ||\n"
       "                          (qp == kp && kp < 512))))\n"
       "          p = 0.f;\n")]),
    ("dk/dv: last q tile skipped for keys < 512", FLASH,
     [("      mbar_wait(&full[s], ((j + t) / kStages) & 1);\n",
       "      mbar_wait(&full[s], ((j + t) / kStages) & 1);\n"
       "      if (q0 + kDkvRows >= sq && item.k0 < 512) {\n"
       "        if (lane0) mbar_arrive(&empty[s]);\n"
       "        continue;\n"
       "      }\n")]),
    ("lnbwd: the m2 term of dx dropped for rows >= 2048", LN,
     [("        float v = rs * (g * wv[e] - m1 - xh * m2);\n",
       "        float v = rs * (g * wv[e] - m1 -\n"
       "                        (row >= 2048 ? 0.f : xh * m2));\n")]),
    ("lnbwd: the CTA's last row group left out of its dw/db partial", LN,
     [("    for (int g = 0; g < groups; ++g) v += sums",
       "    for (int g = 0; g < groups - 1; ++g) v += sums")]),
    ("lnbwd: ds dropped from each lane's last vector of dx", LN,
     [("        if (kResidual) v += rv[e];\n",
       "        if (kResidual && j < kV - 1) v += rv[e];\n")]),
    ("optim: bias corrections multiplied by an f32 reciprocal", OPTIM,
     [("    const float mhat = __fdiv_rn(m, d1);\n"
       "    const float vhat = __fdiv_rn(v, d2);\n",
       "    const float mhat = __fmul_rn(m, __frcp_rn(d1));\n"
       "    const float vhat = __fmul_rn(v, __frcp_rn(d2));\n")]),
    ("optim: the last chunk of the table's first tensor skipped", OPTIM,
     [("  const long long end = start + kChunk < e.n ? start + kChunk : "
       "e.n;\n",
       "  const long long end = start + kChunk < e.n ? start + kChunk : "
       "e.n;\n"
       "  if (e.chunk0 == 0 && end == e.n && start > 0) return;\n")]),
    ("multi: slot t sees one token too many (ctx0 + t + 1)", PAGED,
     [("    const int c = ctx0 + t < cap ? ctx0 + t : cap;\n",
       "    const int c = ctx0 + t + 1 < cap ? ctx0 + t + 1 : cap;\n")]),
    ("multi: the deepest slot skips its last live chunk", PAGED,
     [("    return ctx > kChunk ? (ctx + kChunk - 1) / kChunk : 1;\n",
       "    const int nc = ctx > kChunk ? (ctx + kChunk - 1) / kChunk : 1;\n"
       "    return nc - (t == NQ - 1 && nc > 1 ? 1 : 0);\n")]),
    ("multi: rows past slot t's context weighted by zero, not skipped",
     PAGED,
     [("        if (r >= nv[t]) continue;  // skipped, not weighted by zero\n",
       "")]),
    ("multi: chunk 1 left out of the merge of 3 or more chunks", PAGED,
     [("      if (c >= nc) break;\n",
       "      if (c >= nc) break;\n"
       "      if (nc >= 3 && c == 1) continue;\n")]),
    ("multi: a chunk's second page read through its first page's block id",
     PAGED,
     [("        const int blk = tables[seq * max_blocks + pos / block_size];\n",
       "        const int pg = pos / block_size, pg0 = t0 / block_size;\n"
       "        const int blk =\n"
       "            tables[seq * max_blocks + (pg == pg0 + 1 ? pg0 : pg)];\n")]),
    ("lnfwd: statistics from the unrounded x + residual for rows >= N/2",
     LN,
     [("        for (int e = 0; e < VW; ++e)\n"
       "          v[j][e] = to_f32(from_f32<T>(__fadd_rn(v[j][e], rv[e])));\n"
       "        store_vec<T, VW>(s_out + base + c, v[j]);\n",
       "        float sr[VW];\n"
       "        for (int e = 0; e < VW; ++e) {\n"
       "          sr[e] = to_f32(from_f32<T>(__fadd_rn(v[j][e], rv[e])));\n"
       "          v[j][e] = row >= n / 2 ? __fadd_rn(v[j][e], rv[e]) : sr[e];\n"
       "        }\n"
       "        store_vec<T, VW>(s_out + base + c, sr);\n")]),
    ("lnfwd: a row's last vector left out of the variance", LN,
     [("      if (col(j) >= h) continue;\n",
       "      if (col(j) >= h || col(j) == h - VW) continue;\n")]),
    ("lnfwd: w and b of the last vector read from the vector before", LN,
     [("      load_f32<VW>(wv, sW + c);\n"
       "      load_f32<VW>(bv, sB + c);\n",
       "      const int cw = c == h - VW ? c - VW : c;\n"
       "      load_f32<VW>(wv, sW + cw);\n"
       "      load_f32<VW>(bv, sB + cw);\n")]),
    ("compress: abs-max by fmaxf alone (a NaN block gets a finite scale)",
     COMPRESS,
     [("  const float scale = (!nan && m > 0.f) ? __fdiv_rn(m, 127.f) : 1.f;\n",
       "  const float scale = (m > 0.f) ? __fdiv_rn(m, 127.f) : 1.f;\n")]),
    ("compress: codes rounded by truncf, not rintf", COMPRESS,
     [("  const float r = rintf(__fdiv_rn(x, scale));\n",
       "  const float r = truncf(__fdiv_rn(x, scale));\n")]),
    # faults only BERT's shapes show: non-causal attention, 768-wide rows
    ("fwd and dq: the last KV tile skipped when not causal", FLASH,
     [("  if (kCausal) it.n_kv = min(it.n_kv, (it.q0 + kFwdRows - 1) / kKeys"
       " + 1);\n",
       "  if (kCausal) it.n_kv = min(it.n_kv, (it.q0 + kFwdRows - 1) / kKeys"
       " + 1);\n"
       "  else if (it.n_kv > 1) it.n_kv -= 1;\n")], BERT),
    ("dk/dv: the last q tile skipped when not causal", FLASH,
     [("  it.n_t = (sq + kDkvRows - 1) / kDkvRows - it.t0;\n",
       "  it.n_t = (sq + kDkvRows - 1) / kDkvRows - it.t0;\n"
       "  if (!kCausal && it.n_t > 1) it.n_t -= 1;\n")], BERT),
    # the f32 backward kernels (3xTF32)
    ("f32 dq: one-pass TF32 (the lo terms dropped)", FLASH,
     [(ONE_PASS_AT, ONE_PASS + ONE_PASS_AT),
      ("    mma_abt<D, kKeys>(s, sQ, sK);\n"
       "    mma_abt<D, kKeys>(dps, sDO, sV);\n",
       "    mma_abt1<D, kKeys>(s, sQ, sK);\n"
       "    mma_abt1<D, kKeys>(dps, sDO, sV);\n"),
      ("    mma_xb<D, kKeys>(acc, dps, sK);",
       "    mma_xb1<D, kKeys>(acc, dps, sK);")], F32),
    ("f32 dk/dv: one-pass TF32 (the lo terms dropped)", FLASH,
     [(ONE_PASS_AT, ONE_PASS + ONE_PASS_AT),
      ("    mma_abt<D, R>(st, sK, sQ);\n"
       "    mma_abt<D, R>(dpt, sV, sDO);\n",
       "    mma_abt1<D, R>(st, sK, sQ);\n"
       "    mma_abt1<D, R>(dpt, sV, sDO);\n"),
      ("    mma_xb<D, R>(dv_acc, st, sDO);",
       "    mma_xb1<D, R>(dv_acc, st, sDO);"),
      ("    mma_xb<D, R>(dk_acc, dpt, sQ);",
       "    mma_xb1<D, R>(dk_acc, dpt, sQ);")], F32),
    ("f32 dq: the last KV tile skipped when not causal", FLASH,
     [("  const int n_kv = (kv_end + kKeys - 1) / kKeys;\n",
       "  const int n_kv = (kv_end + kKeys - 1) / kKeys -\n"
       "                   (!kCausal && kv_end > kKeys);\n")], F32),
    ("f32 dk/dv: the last q tile skipped when not causal", FLASH,
     [("  const int n_t = (sq + R - 1) / R - t0;\n",
       "  const int n_t = (sq + R - 1) / R - t0 - (!kCausal && sq > R);\n")],
     F32),
    ("f32 dq: the causal diagonal masked", FLASH,
     [("      dq_tile<true, kCausal>(s, dps, lse2, dl, r0, k0, sk, sl2, scale);",
       "      dq_tile<true, kCausal>(s, dps, lse2, dl, r0 - 1, k0, sk, sl2,\n"
       "                             scale);")], F32),
    # the f32 forward kernel (3xTF32)
    ("f32 fwd: one-pass TF32 on S = Q.K^T (its lo terms dropped)", FLASH,
     [(ONE_PASS_AT, ONE_PASS + ONE_PASS_AT),
      ("    mma_abt<D, kKeys>(sc, sQ, sK);\n",
       "    mma_abt1<D, kKeys>(sc, sQ, sK);\n")], F32),
    ("f32 fwd: one-pass TF32 on O += P.V (its lo terms dropped)", FLASH,
     [(ONE_PASS_AT, ONE_PASS + ONE_PASS_AT),
      ("    mma_xb<D, kKeys>(acc, sc, sV);\n",
       "    mma_xb1<D, kKeys>(acc, sc, sV);\n")], F32),
    ("f32 fwd: the last KV tile skipped when not causal", FLASH,
     [("  const int n_tiles = (kv_end + kKeys - 1) / kKeys;\n",
       "  const int n_tiles = (kv_end + kKeys - 1) / kKeys -\n"
       "                      (!kCausal && kv_end > kKeys);\n")], F32),
    ("f32 fwd: O not rescaled by alpha when the running max moves", FLASH,
     [("    // O = alpha O + P V; p is not rounded, v being f32 (:137-139)\n"
       "#pragma unroll\n"
       "    for (int nt = 0; nt < D / 8; ++nt)\n"
       "#pragma unroll\n"
       "      for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];\n",
       "    // O += P V, O not rescaled\n")], F32),
    ("lnfwd: a row that does not fill its lanes' vectors (768) leaves its "
     "last vector out of the variance", LN,
     [("    // the variance from the registers: mean((s - mean)^2)\n"
       "    p = 0.f;\n"
       "#pragma unroll\n"
       "    for (int j = 0; j < kV; ++j) {\n",
       "    // the variance from the registers: mean((s - mean)^2)\n"
       "    p = 0.f;\n"
       "#pragma unroll\n"
       "    for (int j = 0; j < (h % (64 * VW * wpr) ? kV - 1 : kV); ++j) {\n"
       )], BERT),
    ("lnbwd: a row that does not fill its lanes' vectors (768) leaves its "
     "last vector out of the means and the dw/db partial", LN,
     [("    // pass 1: the row's two means (:172-174), and dw, db\n"
       "    float p1 = 0.f, p2 = 0.f;\n"
       "#pragma unroll\n"
       "    for (int j = 0; j < kV; ++j) {\n",
       "    // pass 1: the row's two means (:172-174), and dw, db\n"
       "    float p1 = 0.f, p2 = 0.f;\n"
       "#pragma unroll\n"
       "    for (int j = 0; j < (h % (64 * VW * wpr) ? kV - 1 : kV); ++j) {\n"
       )], BERT),
]


def build_mutants():
    """One loaded library per mutant, built from the checkout's csrc."""
    from paddle_tpu_torch.incubate.nn import kernels as K

    nvcc = K._nvcc()
    root = K.BUILD_DIR / "mutants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    jobs, common = [], {}
    for src in K.SOURCES:
        common[src] = root / src.replace(".cu", ".o")
        jobs.append((src, [nvcc, *K.NVCC_FLAGS, "-c", str(K.CSRC_DIR / src),
                           "-o", str(common[src])]))
    for i, (name, src, edits, *_) in enumerate(MUTANTS):
        text = (K.CSRC_DIR / src).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"mutant {name!r}: its text occurs "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        (root / f"m{i}.cu").write_text(text)
        # -I: the copy includes csrc/'s headers (hopper.cuh)
        jobs.append((name, [nvcc, *K.NVCC_FLAGS, "-I", str(K.CSRC_DIR), "-c",
                            str(root / f"m{i}.cu"), "-o",
                            str(root / f"m{i}.o")]))
    procs = [(n, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for n, cmd in jobs]
    for n, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {n}:\n{out}")
    libs = []
    for i, (_, src, *_) in enumerate(MUTANTS):
        so = root / f"m{i}.so"
        others = [str(o) for s, o in common.items() if s != src]
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(so), str(root / f"m{i}.o"),
                        *others], check=True,
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


def f32_check(dev):
    """chip_smoke's phase 7 f32 cases with each gate apart: "passes", or
    "FAILS (...)" with the messages of every case each gate failed."""
    import chip_smoke as cs
    import numpy as np

    rng = np.random.RandomState(2)
    fails = {"JAX parity": [], "gate 1": []}
    for tag, b, h, sq, d, dtype, causal, sk in cs.FLASH_CASES:
        q, k, v, do = cs._flash_inputs(rng, b, h, sq, d, dtype, dev, sk)
        if dtype != torch.float32:
            continue
        scale = d ** -0.5
        got, want = cs.flash_outputs(q, k, v, do, causal, scale)
        try:
            cs.flash_parity(tag, got, want)
        except AssertionError as e:
            fails["JAX parity"].append(str(e))
        try:
            cs.flash_f64_gate(tag, got, cs.flash_f64_oracle(
                q, k, v, do, causal, scale), causal)
        except AssertionError as e:
            fails["gate 1"].append(str(e))
    bad = "; ".join(f"{gate}: " + " | ".join(msgs)
                    for gate, msgs in fails.items() if msgs)
    return f"FAILS ({bad})" if bad else "passes"


def optim_check(named, grads):
    import chip_smoke as cs

    try:
        cs.optim_checks(named, grads)
        return "passes"
    except AssertionError as e:
        return f"FAILS ({e})"


def multi_check(dev):
    import chip_smoke as cs

    try:
        cs.multi_checks(dev)
        return "passes"
    except AssertionError as e:
        return f"FAILS ({e})"


def lnbwd_check(dev):
    import chip_smoke as cs

    try:
        cs.ln_bwd_checks(dev)
        return "passes"
    except AssertionError as e:
        return f"FAILS ({e})"


def bert_check(dev):
    import chip_smoke as cs

    try:
        cs.bert_kernel_checks(dev)
        return "passes"
    except AssertionError as e:
        return f"FAILS ({e})"


def bert_grads_check(dev, model, ids):
    import chip_smoke as cs

    try:
        cs.bert_bf16_grads_check("bert grads", model, ids)
        return "passes"
    except AssertionError as e:
        return f"FAILS ({e})"


def compress_check(dev):
    import chip_smoke as cs

    try:
        cs.compress_checks(dev)
        return "passes"
    except AssertionError as e:
        return f"FAILS ({e})"


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
    named = list(cs._train_model(dev).named_parameters())
    grads = cs._optim_grads(named, dev)
    bert = cs._bert_model(dev)
    bert_ids, _ = cs._bert_batch(bert.config.vocab_size, dev)
    ok, caught = True, 0
    own = {FLASH: "per-row", OPTIM: "optim", PAGED: "multi", LN: "lnbwd",
           COMPRESS: "compress"}
    runs = [("control (unmutated)", None, control, None)] + [
        (m[0], m[1], lib, m[3] if len(m) > 3 else own[m[1]])
        for m, lib in zip(MUTANTS, libs)]
    for name, src, lib, check in runs:
        K._lib = lib
        try:
            res = {}
            if src is None or check == F32:
                res[F32] = f32_check(dev)
            if src is None or (src == FLASH and check != F32):
                res.update(run_checks(model, batch, inputs))
            if src in (None, OPTIM):
                res["optim"] = optim_check(named, grads)
            if src in (None, PAGED):
                res["multi"] = multi_check(dev)
            if src in (None, COMPRESS):
                res["compress"] = compress_check(dev)
            if src in (None, LN):
                res["lnbwd"] = lnbwd_check(dev)
            if src is None or check == BERT:
                res[BERT] = bert_check(dev)
                res["bert grads"] = bert_grads_check(dev, bert, bert_ids)
        finally:
            K._lib = control
        for which, verdict in res.items():
            print(f"[mutant] {name} | {which}: {verdict}", flush=True)
        if lib is control:
            ok &= not any(r.lower().startswith("fails")
                          for r in res.values())
            continue
        caught += res[check].startswith("FAILS")
        ok &= res[check].startswith("FAILS")
    print(f"[mutant] {caught}/{len(MUTANTS)} mutants caught; "
          f"{'every' if ok else 'NOT every'} mutant fails its check "
          "(per-row flash, f32, optim, multi, compress, lnbwd, bert) and "
          "the control passes every check")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
