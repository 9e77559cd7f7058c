// Ragged paged attention for Hopper (sm_90a): T <= 8 query slots per
// sequence, K/V read out of block-paged pools through per-sequence block
// tables, slot t of sequence b seeing context_lens[b] + t tokens. T = 1
// is the decode step; T = k verifies a speculative window in one launch.
//
// Replaces: paddle_tpu/incubate/nn/pallas/paged_attention.py
// `_paged_kernel` (:76), launched by `paged_attention` (:125) once per
// layer of every decode dispatch (here as T = 1), and
// `_paged_multi_kernel` (:187), launched by `paged_attention_multi`
// (:252) once per layer of every verify dispatch.
//
// What bounds it on an H100: memory. The live K/V rows of the deepest
// slot are read once and used by all T slots, 4*T*D operations per row
// pair, under the card's 20 f32 operations per byte at T <= 8, so the
// time floor is those rows' bytes over the card's 3.35 TB/s: a few
// microseconds at GPT-2 345M serving shapes (8 sequences, 16 heads,
// head_dim 64, a few hundred tokens each). What limits a kernel at that
// size is the number of dependent trips to device memory on its longest
// path, and the instructions it issues a byte.
//
// Design (split context, "flash-decoding"): the context is cut into
// fixed chunks of kChunk = 64 token positions, whose boundaries depend
// on neither T nor the context. One CTA of 4 warps takes one (chunk,
// head, sequence); the grid is (heads, sequences, chunks of the table's
// width), chunk-major so that the live chunks are dispatched first, and
// a CTA whose chunk lies past the deepest slot's context exits after
// reading the context length. A CTA
//   1. reads its sequence's context length (one trip); then, with the
//      slots' queries in flight, each thread reads the block ids of the
//      pages its rows lie on from the table itself (a second trip; table
//      slots past the context are never read);
//   2. copies its chunk's live K rows, then V rows (up to the deepest
//      slot's context; rows past it are never read), into shared memory
//      with 16-byte cp.async copies, a warp's copies covering whole
//      neighbouring rows, K and V in two cp.async groups so that V lands
//      while the scores are computed; each row is padded by 16 bytes so
//      that the reads below hit distinct banks. The chunk is read from
//      device memory once for all T slots;
//   3. computes the scores with lanes owning tokens: lane l of warp w
//      takes token 16 w + (l & 15) and half (l >> 4) of D, a dot product
//      from shared memory against the slots' queries (broadcast), and one
//      shuffle adds the two halves: no per-row shuffle tree;
//   4. per slot: one warp max and one CTA max over the tokens the slot
//      sees in this chunk (ctx0 + t, clamped to the table's width), then
//      p = exp(s - m) rounded to the pool dtype (as the TPU kernel does,
//      :113) and one warp sum and a fixed-order CTA sum of the unrounded
//      p (the denominator). A row at or past slot t's context is SKIPPED
//      for slot t, never weighted by zero: a non-finite value in a later
//      slot's K/V never reaches an earlier slot;
//   5. P.V with lanes owning dimensions: a thread holds 4 dimensions of
//      every slot over one group of the chunk's rows (8 rows at D 64, 16
//      at D 128), each V row read once from shared memory for all slots,
//      in row order; the groups' sums are added in a fixed order. Every
//      slot index is a compile-time constant, so the slots' state stays
//      in registers.
// The chunk's (m, l, acc) per slot is its partial. A sequence whose
// deepest slot has one chunk finishes in that CTA. Otherwise every
// chunk writes its partials to a workspace, and the last CTA of a
// (sequence, head) to arrive, found through an integer counter bumped
// with acquire-release order (which it resets for the next launch),
// fetches the first 8 chunks' partials in one trip and merges each slot's
// partials IN CHUNK ORDER, over the chunks that slot sees only: a chunk
// wholly past slot t's context takes no part in slot t's merge. No float
// atomics. The
// one-chunk path runs the same merge over its one partial. The result
// is acc / max(l, 1e-30), cast to the query dtype. Every rounding step
// is an explicit intrinsic (__fmaf_rn, __fmul_rn, ...), so nvcc cannot
// contract the instantiations differently: slot t's arithmetic depends
// only on its own context, and slot t of any T repeats the T = 1 result
// at context + t bit for bit, from run to run. f32 and bf16 pools run on
// the CUDA cores (no TF32, no tensor cores). The kernel is templated on
// T so the slot loops unroll, as the TPU kernel's python-unrolled slot
// loop does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 64;         // token positions a work item
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // _NEG_INF in the TPU kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T from shared memory at p, widened to f32
template <typename T>
__device__ __forceinline__ void load16(float (&o)[16 / sizeof(T)],
                                       const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// old = *p, *p += v, with acquire-release order at device scope: the
// CTA's writes before it (made visible to this thread by a CTA barrier)
// are visible to whoever reads the new count, and what that thread and,
// after a CTA barrier, its CTA read next sees theirs
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// K and V rows of a chunk in shared memory: a row holds D values and 16
// bytes of padding, so lanes reading 16 bytes of 8 neighbouring rows
// fall on 8 distinct groups of 4 banks
template <typename T, int D>
struct ChunkRows {
  static constexpr int kRow = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kBytes =
      2 * kChunk * kRow * static_cast<int>(sizeof(T));
};

// chunks whose partials the last CTA fetches in one trip
constexpr int kMergeBatch = 8;

template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kThreads)
    paged_multi_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters,
                       int num_heads, int block_size, int max_blocks,
                       float scale) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(NQ >= 1 && NQ <= 8, "1..8 query slots");
  using Rows = ChunkRows<T, D>;
  constexpr int kRow = Rows::kRow;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a copy
  constexpr int kRowCopies = D / kVec;
  constexpr int kPasses = kChunk * kRowCopies / kThreads;  // copies a thread
  constexpr int kHalf = D / 2;
  constexpr int kQRow = D + 8;  // the two halves of q 4 banks apart
  constexpr int kDimThreads = D / 4;  // P.V: a thread owns 4 dimensions
  constexpr int kTokGroups = kThreads / kDimThreads;
  constexpr int kGroupRows = kChunk / kTokGroups;
  constexpr int kQPer = (NQ * D + kThreads - 1) / kThreads;
  constexpr int kOutPer = (NQ * D + kThreads - 1) / kThreads;
  static_assert(kChunk * kRowCopies % kThreads == 0, "whole passes");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kChunk * kRow;
  __shared__ __align__(16) float q_s[NQ][kQRow];
  __shared__ float pt_s[NQ][kChunk];
  __shared__ __align__(16) float acc_s[kTokGroups][NQ][D];
  __shared__ float red_m[NQ][kWarps], red_l[NQ][kWarps];
  __shared__ float m_s[NQ], l_s[NQ];
  __shared__ float pm_s[NQ][kMergeBatch], pl_s[NQ][kMergeBatch];
  __shared__ float pw_s[NQ][kMergeBatch], pmax_s[NQ];
  __shared__ int last_s;

  const int head = blockIdx.x, seq = blockIdx.y, chunk = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t tok_stride = static_cast<size_t>(num_heads) * D;
  // q and out are [B, NQ, H, D]: slot t of this (seq, head) at
  // ((seq * NQ + t) * H + head) * D
  const size_t row0 = (static_cast<size_t>(seq) * NQ * num_heads + head) * D;

  // trip 1: the context length
  const int cap = max_blocks * block_size;
  // slot t sees ctx0 + t tokens, clamped to the table's width
  const int ctx0 = lens[seq];
  auto slot_ctx = [&](int t) {
    const int c = ctx0 + t < cap ? ctx0 + t : cap;
    return c > 0 ? c : 0;
  };
  const int ctx_max = slot_ctx(NQ - 1);
  const int n_chunks = ctx_max > kChunk ? (ctx_max + kChunk - 1) / kChunk : 1;
  if (chunk >= n_chunks) return;
  const int t0 = chunk * kChunk;
  const int n_live = ctx_max - t0 < kChunk ? ctx_max - t0 : kChunk;

  // the queries, in flight with the table reads below
  float qv[kQPer];
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    qv[j] = i < NQ * D ? to_f32(q[row0 + (i / D) * tok_stride + i % D]) : 0.f;
  }

  // trips 2 and 3: copy i of the chunk (row i / kRowCopies, 16 bytes
  // at (i % kRowCopies) * kVec) goes to thread i % kThreads, so a warp
  // copies whole neighbouring rows; each thread reads its rows' block
  // ids from the table first, then copies K (one cp.async group) and V
  // (a second, landing while the scores are computed)
  {
    size_t at[kPasses];
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int u = (tid + j * kThreads) / kRowCopies;
      at[j] = 0;
      if (u < n_live) {
        const int pos = t0 + u;
        const int blk = tables[seq * max_blocks + pos / block_size];
        at[j] = (static_cast<size_t>(blk) * block_size + pos % block_size) *
                    tok_stride +
                static_cast<size_t>(head) * D +
                ((tid + j * kThreads) % kRowCopies) * kVec;
      }
    }
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int i = tid + j * kThreads;
      if (i / kRowCopies < n_live)
        cp_async16(ks + (i / kRowCopies) * kRow + (i % kRowCopies) * kVec,
                   k_pool + at[j]);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int i = tid + j * kThreads;
      if (i / kRowCopies < n_live)
        cp_async16(vs + (i / kRowCopies) * kRow + (i % kRowCopies) * kVec,
                   v_pool + at[j]);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    const int d = i % D;
    if (i < NQ * D) q_s[i / D][d + (d >= kHalf ? 4 : 0)] = qv[j];
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // K has landed
  __syncthreads();

  // rows of this chunk that slot t sees
  int nv[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    const int n = slot_ctx(t) - t0;
    nv[t] = n < 0 ? 0 : (n < kChunk ? n : kChunk);
  }

  // scores: lane owns token u, half hf of D; the halves meet in a shuffle
  const int u = warp * 16 + (lane & 15), hf = lane >> 4;
  float s[NQ];
  {
#pragma unroll
    for (int t = 0; t < NQ; ++t) s[t] = 0.f;
    const T* kr = ks + u * kRow + hf * kHalf;
#pragma unroll
    for (int c = 0; c < kHalf; c += kVec) {
      float kf[kVec];
      load16<T>(kf, kr + c);
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        const float* qr = &q_s[t][hf * (kHalf + 4) + c];
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
          s[t] = __fmaf_rn(q4.x, kf[e], s[t]);
          s[t] = __fmaf_rn(q4.y, kf[e + 1], s[t]);
          s[t] = __fmaf_rn(q4.z, kf[e + 2], s[t]);
          s[t] = __fmaf_rn(q4.w, kf[e + 3], s[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NQ; ++t)
      s[t] = __fmul_rn(
          __fadd_rn(s[t], __shfl_xor_sync(0xffffffffu, s[t], 16)), scale);
  }

  // per slot: the chunk's max, then p and its sum
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    float mx = u < nv[t] ? s[t] : kNegInf;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red_m[t][warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    float m = red_m[t][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_m[t][w]);
    // skipped, not weighted by zero
    const float p = u < nv[t] ? expf(__fsub_rn(s[t], m)) : 0.f;
    if (hf == 0) pt_s[t][u] = to_f32(from_f32<T>(p));  // pool dtype
    float ps = p;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
    if (lane == 0) red_l[t][warp] = ps;
    if (tid == 0) m_s[t] = m;
  }
  __syncthreads();
  if (tid < NQ) {
    float l = red_l[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l = __fadd_rn(l, red_l[tid][w]);
    l_s[tid] = l;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // V has landed
  __syncthreads();

  // P.V: a thread owns dimensions 4 dq .. 4 dq + 3 of every slot over
  // its token group's rows, in row order; the groups meet below in a
  // fixed order
  {
    const int dq = tid % kDimThreads, tg = tid / kDimThreads;
    float acc[NQ][4];
#pragma unroll
    for (int t = 0; t < NQ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      const int r = tg * kGroupRows + i;
      if (r >= nv[NQ - 1]) break;
      float vv[4];
      const T* vr = vs + r * kRow + 4 * dq;
      if constexpr (sizeof(T) == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr);
        vv[0] = v4.x;
        vv[1] = v4.y;
        vv[2] = v4.z;
        vv[3] = v4.w;
      } else {
        const uint2 v2 = *reinterpret_cast<const uint2*>(vr);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v2.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v2.y));
        vv[0] = a.x;
        vv[1] = a.y;
        vv[2] = b.x;
        vv[3] = b.y;
      }
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        if (r >= nv[t]) continue;  // skipped, not weighted by zero
        const float pt = pt_s[t][r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = __fmaf_rn(pt, vv[e], acc[t][e]);
      }
    }
#pragma unroll
    for (int t = 0; t < NQ; ++t)
      *reinterpret_cast<float4*>(&acc_s[tg][t][4 * dq]) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  }
  __syncthreads();  // acc_s and l_s are written

  // thread owns (slot, dimension) pairs idx = tid, tid + kThreads, ...
  float accf[kOutPer];
#pragma unroll
  for (int j = 0; j < kOutPer; ++j) {
    const int idx = tid + j * kThreads;
    float a = 0.f;
    if (idx < NQ * D) {
      a = acc_s[0][idx / D][idx % D];
#pragma unroll
      for (int g = 1; g < kTokGroups; ++g)
        a = __fadd_rn(a, acc_s[g][idx / D][idx % D]);
    }
    accf[j] = a;
  }

  if (n_chunks == 1) {  // the one partial is the CTA's own: the merge
                        // below over one chunk, step for step
#pragma unroll
    for (int j = 0; j < kOutPer; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= NQ * D) continue;
      const int t = idx / D, d = idx % D;
      const float m = fmaxf(kNegInf, m_s[t]);
      const float w = expf(__fsub_rn(m_s[t], m));
      const float l = __fmaf_rn(l_s[t], w, 0.f);
      const float a = __fmaf_rn(accf[j], w, 0.f);
      out[row0 + t * tok_stride + d] =
          from_f32<T>(__fdiv_rn(a, fmaxf(l, 1e-30f)));
    }
    return;
  }

  // partials [B, H, NQ, chunks of the table's width, D + 2]: m, l, acc
  const int n_cmax = (cap + kChunk - 1) / kChunk;
  float* pbase =
      part + (static_cast<size_t>(seq) * num_heads + head) * NQ * n_cmax *
                 (D + 2);
  auto slot_chunk = [&](int t, int c) {
    return pbase + (static_cast<size_t>(t) * n_cmax + c) * (D + 2);
  };
#pragma unroll
  for (int j = 0; j < kOutPer; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= NQ * D) continue;
    const int t = idx / D, d = idx % D;
    float* pc = slot_chunk(t, chunk);
    pc[2 + d] = accf[j];
    if (d == 0) {
      pc[0] = m_s[t];
      pc[1] = l_s[t];
    }
  }
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + seq * num_heads + head;
    const int prev = atomic_add_acq_rel(cnt, 1);
    last_s = prev == n_chunks - 1;
    if (last_s) atomicExch(cnt, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;

  // the last CTA of (seq, head) merges each slot's partials over the
  // chunks it sees, in chunk order: m = max m_c; l = sum l_c exp(m_c -
  // m), acc likewise; acc / max(l, 1e-30). One trip fetches the first
  // kMergeBatch chunks' partials of every slot (m and l into shared
  // memory, acc into registers); each (slot, chunk) weight exp(m_c - m)
  // is computed once, a thread each (chunks past kMergeBatch, contexts
  // over 512 tokens, are read from global memory)
  auto slot_chunks = [&](int t) {
    const int ctx = slot_ctx(t);
    return ctx > kChunk ? (ctx + kChunk - 1) / kChunk : 1;
  };
  if (tid < NQ * kMergeBatch) {
    const int t = tid / kMergeBatch, c = tid % kMergeBatch;
    const bool in = c < n_chunks;
    pm_s[t][c] = in ? __ldcg(slot_chunk(t, c)) : kNegInf;
    pl_s[t][c] = in ? __ldcg(slot_chunk(t, c) + 1) : 0.f;
  }
  float pa[kOutPer][kMergeBatch];
#pragma unroll
  for (int j = 0; j < kOutPer; ++j) {
    const int idx = tid + j * kThreads;
#pragma unroll
    for (int c = 0; c < kMergeBatch; ++c)
      pa[j][c] = idx < NQ * D && c < n_chunks
                     ? __ldcg(slot_chunk(idx / D, c) + 2 + idx % D)
                     : 0.f;
  }
  __syncthreads();
  if (tid < NQ * kMergeBatch) {
    const int t = tid / kMergeBatch, c = tid % kMergeBatch;
    const int nc = slot_chunks(t);
    float m = kNegInf;
    for (int k = 0; k < nc; ++k)
      m = fmaxf(m, k < kMergeBatch ? pm_s[t][k] : __ldcg(slot_chunk(t, k)));
    pw_s[t][c] = c < nc ? expf(__fsub_rn(pm_s[t][c], m)) : 0.f;
    if (c == 0) pmax_s[t] = m;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kOutPer; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= NQ * D) continue;
    const int t = idx / D, d = idx % D;
    const int nc = slot_chunks(t);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < kMergeBatch; ++c) {
      if (c >= nc) break;
      l = __fmaf_rn(pl_s[t][c], pw_s[t][c], l);
      a = __fmaf_rn(pa[j][c], pw_s[t][c], a);
    }
    for (int c = kMergeBatch; c < nc; ++c) {
      const float* pc = slot_chunk(t, c);
      const float w = expf(__fsub_rn(__ldcg(pc), pmax_s[t]));
      l = __fmaf_rn(__ldcg(pc + 1), w, l);
      a = __fmaf_rn(__ldcg(pc + 2 + d), w, a);
    }
    out[row0 + t * tok_stride + d] = from_f32<T>(__fdiv_rn(a, fmaxf(l, 1e-30f)));
  }
}

template <typename T, int D, int NQ>
int launch_multi_nq(const T* q, const T* k, const T* v, const int* tables,
                    const int* lens, T* out, float* part, int* counters,
                    int batch, int heads, int block_size, int max_blocks,
                    float scale, cudaStream_t st) {
  auto* const kern = &paged_multi_kernel<T, D, NQ>;
  constexpr int kSmem = ChunkRows<T, D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_cmax = (max_blocks * block_size + kChunk - 1) / kChunk;
  kern<<<dim3(heads, batch, n_cmax), kThreads, kSmem, st>>>(
      q, k, v, tables, lens, out, part, counters, heads, block_size,
      max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_multi_d(const T* q, const T* k, const T* v, const int* tables,
                   const int* lens, T* out, float* part, int* counters,
                   int batch, int num_q, int heads, int block_size,
                   int max_blocks, float scale, cudaStream_t st) {
#define PTT_MULTI_CASE(NQ)                                                 \
  case NQ:                                                                 \
    return launch_multi_nq<T, D, NQ>(q, k, v, tables, lens, out, part,     \
                                     counters, batch, heads, block_size,   \
                                     max_blocks, scale, st);
  switch (num_q) {
    PTT_MULTI_CASE(1)
    PTT_MULTI_CASE(2)
    PTT_MULTI_CASE(3)
    PTT_MULTI_CASE(4)
    PTT_MULTI_CASE(5)
    PTT_MULTI_CASE(6)
    PTT_MULTI_CASE(7)
    PTT_MULTI_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_MULTI_CASE
}

template <typename T>
int launch_multi(const void* q, const void* k, const void* v,
                 const int* tables, const int* lens, void* out, float* part,
                 int* counters, int batch, int num_q, int heads, int head_dim,
                 int block_size, int max_blocks, float scale,
                 cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (head_dim == 64)
    return launch_multi_d<T, 64>(qt, kt, vt, tables, lens, ot, part,
                                 counters, batch, num_q, heads, block_size,
                                 max_blocks, scale, st);
  if (head_dim == 128)
    return launch_multi_d<T, 128>(qt, kt, vt, tables, lens, ot, part,
                                  counters, batch, num_q, heads, block_size,
                                  max_blocks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Token positions a work item covers (the chunk the workspace is cut in).
extern "C" int ptt_paged_chunk() { return kChunk; }

// q, out: [batch, num_q, heads, head_dim] (1 <= num_q <= 8); k, v: one
// layer's pool [num_blocks, block_size, heads, head_dim], 16-byte
// aligned; all contiguous in the dtype named by `dtype` (0 f32, 1
// bf16). tables: [batch, max_blocks] int32; lens: [batch] int32. Slot t
// of sequence b sees lens[b] + t tokens (clamped to max_blocks *
// block_size). part: f32 workspace of batch * heads * num_q * n * (
// head_dim + 2) values, n = ceil(max_blocks * block_size / chunk), the
// chunks' partials (may be NULL when n is 1); counters: batch * heads
// int32, zero before the launch and zero again after it (the caller
// keeps them, one set a stream). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
extern "C" int ptt_paged_attention_multi(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lens, void* out, void* part, void* counters, int batch,
    int num_q, int heads, int head_dim, int block_size, int max_blocks,
    float scale, int dtype, void* stream) {
  if (block_size < 8 || block_size % 8 || heads < 1 || max_blocks < 1 ||
      batch < 0 || batch > 65535 || num_q < 1 || num_q > 8 ||
      counters == nullptr ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_cmax =
      (static_cast<long long>(max_blocks) * block_size + kChunk - 1) / kChunk;
  if (n_cmax > 65535 || (n_cmax > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const int* tt = static_cast<const int*>(tables);
  const int* lt = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_multi<float>(q, k, v, tt, lt, out, pt, ct, batch, num_q,
                               heads, head_dim, block_size, max_blocks, scale,
                               st);
  if (dtype == 1)
    return launch_multi<__nv_bfloat16>(q, k, v, tt, lt, out, pt, ct, batch,
                                       num_q, heads, head_dim, block_size,
                                       max_blocks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
