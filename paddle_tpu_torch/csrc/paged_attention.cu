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
// time floor is those rows' bytes over the card's 3.35 TB/s. At GPT-2
// 345M serving shapes (8 sequences, 16 heads, head_dim 64, a few hundred
// tokens each) that floor is a few microseconds, and what actually
// limits a simple kernel is memory LATENCY: one CTA walks one
// (sequence, head)'s context, so the time is the number of dependent
// trips to device memory along the longest context.
//
// Design: one CTA of 8 warps per (head, sequence); a batch of 8 x 16
// heads is one wave on the card's 132 SMs. The TPU kernel's sequential
// grid axis over table slots becomes a loop over the sequence's LIVE
// tokens only (up to the deepest slot's context), in groups of 8
// (block_size % 8 == 0, so a group never straddles a block): warp w
// takes groups w, w+8, ..., reads the group's block id from block_tables
// itself, and starts the group's 8 K rows and 8 V rows as independent
// loads before using any of them — up to 16 rows in flight per warp, 128
// per CTA. Each row is loaded ONCE for all T slots (the TPU kernel reads
// each block once for all slots). Table slots past the context and rows
// past it inside the last block are never read (the TPU kernel masks
// those to -1e30, which gives them exactly zero weight; not reading them
// gives the same result). The T query vectors stay in registers: each
// lane owns D/32 dimensions per slot, so a score is a warp reduction and
// the P.V update is per lane with no reduction. Each warp keeps T online
// softmax states (running max, denominator and accumulator, all f32),
// with p rounded to the pool dtype before the product as the TPU kernel
// does (:113). A row at position >= ctx0 + t is skipped for slot t,
// never weighted by zero, so a non-finite value in a later slot's K/V
// never reaches an earlier slot, and slot t's arithmetic is that of a
// T = 1 launch at context ctx0 + t. The warps' states are merged per
// slot once at the end through shared memory. The result is
// acc / max(l, 1e-30), cast to the query dtype. Every rounding step is
// an explicit intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn, ...), so nvcc
// cannot contract the instantiations differently: slot t of any T
// repeats the T = 1 result at context + t bit for bit. The kernel is
// templated on T so the slot loops unroll, as the TPU kernel's
// python-unrolled slot loop does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;          // tokens per warp step
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

template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kThreads)
    paged_multi_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int num_heads, int block_size, int max_blocks,
                       float scale) {
  static_assert(D % 32 == 0, "a lane owns D / 32 dims");
  static_assert(NQ >= 1 && NQ <= 8, "1..8 query slots");
  constexpr int kPer = D / 32;
  __shared__ float m_s[NQ][kWarps];
  __shared__ float l_s[NQ][kWarps];
  __shared__ float acc_s[NQ][kWarps][D];

  const int head = blockIdx.x, seq = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t tok_stride = static_cast<size_t>(num_heads) * D;
  // q and out are [B, NQ, H, D]: slot t of this (seq, head) at
  // ((seq * NQ + t) * H + head) * D
  const size_t row0 = (static_cast<size_t>(seq) * NQ * num_heads + head) * D;
  float qr[NQ][kPer];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      qr[t][i] = to_f32(q[row0 + t * tok_stride + lane + 32 * i]);
  }

  // slot t sees ctx0 + t tokens, clamped to the table's width
  const int cap = max_blocks * block_size;
  const int ctx0 = lens[seq];
  int ctx[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) ctx[t] = ctx0 + t < cap ? ctx0 + t : cap;
  const int ctx_max = ctx[NQ - 1];
  const int n_groups = (ctx_max + kGroup - 1) / kGroup;

  float m[NQ], l[NQ], acc[NQ][kPer];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[t][i] = 0.f;
  }

  for (int g = warp; g < n_groups; g += kWarps) {
    const int t0 = g * kGroup;
    const int blk = tables[seq * max_blocks + t0 / block_size];
    const int n_live = ctx_max - t0 < kGroup ? ctx_max - t0 : kGroup;
    const size_t base =
        (static_cast<size_t>(blk) * block_size + t0 % block_size) *
            tok_stride +
        static_cast<size_t>(head) * D + lane;

    // the group's rows live for the deepest slot, loaded once for all
    float kr[kGroup][kPer], vr[kGroup][kPer];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool live = u < n_live;
        const size_t at = base + u * tok_stride + 32 * i;
        kr[u][i] = live ? to_f32(k_pool[at]) : 0.f;
        vr[u][i] = live ? to_f32(v_pool[at]) : 0.f;
      }
    }

#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      // rows of this group that slot t sees (warp-uniform); none: the
      // group does not exist for slot t, its state passes untouched
      const int n_valid = ctx[t] - t0 < kGroup ? ctx[t] - t0 : kGroup;
      if (n_valid <= 0) continue;
      float s[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          dot = __fmaf_rn(qr[t][i], kr[u][i], dot);
        s[u] = dot;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          s[u] = __fadd_rn(s[u], __shfl_xor_sync(0xffffffffu, s[u], o));
      }

      float m_grp = kNegInf;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        s[u] = __fmul_rn(s[u], scale);
        if (u < n_valid) m_grp = fmaxf(m_grp, s[u]);
      }
      const float m_new = fmaxf(m[t], m_grp);
      const float alpha = expf(__fsub_rn(m[t], m_new));
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[t][i] = __fmul_rn(acc[t][i], alpha);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (u >= n_valid) continue;  // skipped, not weighted by zero
        const float p = expf(__fsub_rn(s[u], m_new));
        psum = __fadd_rn(psum, p);
        const float pt = to_f32(from_f32<T>(p));  // p in the pool dtype
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          acc[t][i] = __fmaf_rn(pt, vr[u][i], acc[t][i]);
      }
      l[t] = __fmaf_rn(l[t], alpha, psum);
      m[t] = m_new;
    }
  }

  // merge the warps' online-softmax states, slot by slot
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      m_s[t][warp] = m[t];
      l_s[t][warp] = l[t];
    }
  }
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc_s[t][warp][lane + 32 * i] = acc[t][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NQ * D; idx += kThreads) {
    const int t = idx / D, d = idx % D;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[t][w]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(__fsub_rn(m_s[t][w], m_all));
      l_all = __fmaf_rn(l_s[t][w], c, l_all);
      o = __fmaf_rn(acc_s[t][w][d], c, o);
    }
    out[row0 + t * tok_stride + d] =
        from_f32<T>(__fdiv_rn(o, fmaxf(l_all, 1e-30f)));
  }
}

template <typename T, int D, int NQ>
int launch_multi_nq(const T* q, const T* k, const T* v, const int* tables,
                    const int* lens, T* out, int batch, int heads,
                    int block_size, int max_blocks, float scale,
                    cudaStream_t st) {
  paged_multi_kernel<T, D, NQ><<<dim3(heads, batch), kThreads, 0, st>>>(
      q, k, v, tables, lens, out, heads, block_size, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_multi_d(const T* q, const T* k, const T* v, const int* tables,
                   const int* lens, T* out, int batch, int num_q, int heads,
                   int block_size, int max_blocks, float scale,
                   cudaStream_t st) {
#define PTT_MULTI_CASE(NQ)                                                  \
  case NQ:                                                                  \
    return launch_multi_nq<T, D, NQ>(q, k, v, tables, lens, out, batch,     \
                                     heads, block_size, max_blocks, scale, \
                                     st);
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
                 const int* tables, const int* lens, void* out, int batch,
                 int num_q, int heads, int head_dim, int block_size,
                 int max_blocks, float scale, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (head_dim == 64)
    return launch_multi_d<T, 64>(qt, kt, vt, tables, lens, ot, batch, num_q,
                                 heads, block_size, max_blocks, scale, st);
  if (head_dim == 128)
    return launch_multi_d<T, 128>(qt, kt, vt, tables, lens, ot, batch, num_q,
                                  heads, block_size, max_blocks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: [batch, num_q, heads, head_dim] (1 <= num_q <= 8); k, v: one
// layer's pool [num_blocks, block_size, heads, head_dim], all contiguous
// in the dtype named by `dtype` (0 f32, 1 bf16). tables: [batch,
// max_blocks] int32; lens: [batch] int32. Slot t of sequence b sees
// lens[b] + t tokens (clamped to max_blocks * block_size). Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int ptt_paged_attention_multi(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lens, void* out, int batch, int num_q, int heads,
    int head_dim, int block_size, int max_blocks, float scale, int dtype,
    void* stream) {
  if (block_size < kGroup || block_size % kGroup || heads < 1 ||
      max_blocks < 1 || batch < 0 || batch > 65535 || num_q < 1 ||
      num_q > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const int* tt = static_cast<const int*>(tables);
  const int* lt = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_multi<float>(q, k, v, tt, lt, out, batch, num_q, heads,
                               head_dim, block_size, max_blocks, scale, st);
  if (dtype == 1)
    return launch_multi<__nv_bfloat16>(q, k, v, tt, lt, out, batch, num_q,
                                       heads, head_dim, block_size,
                                       max_blocks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
