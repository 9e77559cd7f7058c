// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels (dq; dk and dv), causal or not, bf16 or f32, head_dim 64 or
// 128, over [B*H, S, D] row-major tensors.
//
// Replaces: paddle_tpu/incubate/nn/attention_pallas.py
//   `_fa_fwd_kernel` (:97), launched by `_flash_fwd_impl` (:159);
//   `_fa_bwd_dq_kernel` (:215) and `_fa_bwd_dkv_kernel` (:257), launched
//   by `_flash_bwd_impl` (:307 -> :345 and :365).
//
// What bounds it on an H100: at the training shape (B 4, H 16, S 1024,
// D 64, causal, bf16) the forward does 8.6 GFLOP against 34 MB of
// q/k/v/o, about 256 operations per byte, just under the ~295 where
// the bf16 tensor cores take over from memory; the backward kernels
// recompute the scores and do 3 and 4 products, and are bound by the
// tensor cores. The [S, S] score matrix never reaches device memory.
//
// Design. The TPU walks KV tiles as a sequential grid axis and carries
// the online-softmax state in VMEM scratch between grid steps. CTAs on
// the card run in parallel with nothing carried between them, so that
// axis is a loop inside one CTA: the forward and the dq kernel own one
// (batch*head, 64-row q tile) and loop over KV tiles; the dk/dv kernel
// owns one (batch*head, 64-key tile) and loops over q tiles. Nothing is
// accumulated across CTAs, so there are no atomics and the gradients
// are deterministic.
//
// bf16, the training path: 4 warps, each owning 16 rows of the CTA's
// tile. Q/K/V/dO tiles are staged in shared memory (16 bytes of padding
// per row, so `ldmatrix` reads are free of bank conflicts) and read
// into `mma.sync.m16n8k16` fragments; the scores, p, ds, the running
// max and sum, and the accumulators (o; dq; dk and dv) stay in
// registers, f32. An m16n8 accumulator pair has the layout of an
// m16n8k16 A fragment, so p and ds go from the score product into the
// next product without leaving registers.
//
// f32, the comparison dtype: no tensor-core route keeps f32 exact, so
// 8 warps share shared-memory tiles of 32 rows and compute the products
// on SIMT cores; scores and accumulators are f32 in shared memory.
//
// Both follow the TPU kernel's casts: the un-normalised p = exp(s - m)
// is rounded to v's dtype before P.V (:137-139), ds to k's dtype before
// ds.K and ds^T.Q (:247, :295), p to dO's dtype before p^T.dO (:288).
// Causal tiles strictly above the diagonal are skipped as `run` does
// (:112). Ragged lengths need no padded copies: rows past the end load
// as zeros and their scores are -1e30, so their weight is exactly 0,
// and no output row past the end is written. The causal mask is the
// TPU kernel's, q_pos >= k_pos from the top left (:81-85); the wrapper
// refuses a causal call with sq != sk. delta = rowsum(dO * O) is
// computed by the wrapper in torch, outside the kernels, as
// `_flash_bwd_impl` does it outside its kernels (:331).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // `_NEG_INF`: exp underflows to 0

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + kRows) of a [rows, D] row-major matrix into a
// shared tile of pitch `ld`, 16 bytes per thread step; rows past the
// end are zeros
template <int kThreads, typename T, int kRows, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int rows) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      v = reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D)[ch];
    reinterpret_cast<uint4*>(dst + r * ld)[ch] = v;
  }
}

// ---------------------------------------------------------------------
// bf16: tensor cores, register-resident fragments
// ---------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int kTcRows = 64;      // rows of every tile

template <int D>
struct TcTile {
  static constexpr int LD = D + 8;  // row pitch in bf16: 16 bytes of pad
  static constexpr size_t bytes = sizeof(bf16) * kTcRows * LD;
};

// d += a . b for one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address
// of row (l % 8) of matrix (l / 8). `kTrans` hands each lane a column
// pair instead of a row pair.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // RNE
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 rows x 16 k) of rows [r0, r0 + 16) and columns
// [c0, c0 + 16) of a row-major shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4<false>(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles for S = A . T^T, T a row-major shared
// tile whose rows are the n index: rows [n0, n0 + 16), columns (the k
// index) [c0, c0 + 16). b[0], b[1] for rows n0..n0+7; b[2], b[3] for
// n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const bf16* tile, int n0,
                                            int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4<false>(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles for O = P . T, T a row-major shared tile
// whose rows are the k index: rows [k0, k0 + 16), columns (the n index)
// [n0, n0 + 16). b[0], b[1] for columns n0..n0+7; b[2], b[3] for
// n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const bf16* tile, int k0,
                                            int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4<true>(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LD + n0 + (lane >> 4) * 8);
}

// acc[NT][4] = A . T^T over D, A the warp's 16 rows of `a_tile` and T
// the 64 rows of `t_tile` (8 n8 tiles); `acc2` the same with `a2_tile`
// and `t2_tile`, sharing the loop
template <int D, bool kTwo>
__device__ __forceinline__ void scores(float (&acc)[8][4],
                                       float (&acc2)[8][4],
                                       const bf16* a_tile,
                                       const bf16* t_tile,
                                       const bf16* a2_tile,
                                       const bf16* t2_tile, int r0) {
  constexpr int LD = TcTile<D>::LD;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = acc2[nt][i] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 16) {
    uint32_t a[4], a2[4], b[4];
    load_a<LD>(a, a_tile, r0, c0);
    if (kTwo) load_a<LD>(a2, a2_tile, r0, c0);
#pragma unroll
    for (int n0 = 0; n0 < kTcRows; n0 += 16) {
      load_b_rows<LD>(b, t_tile, n0, c0);
      mma(acc[n0 / 8], a, b[0], b[1]);
      mma(acc[n0 / 8 + 1], a, b[2], b[3]);
      if (kTwo) {
        load_b_rows<LD>(b, t2_tile, n0, c0);
        mma(acc2[n0 / 8], a2, b[0], b[1]);
        mma(acc2[n0 / 8 + 1], a2, b[2], b[3]);
      }
    }
  }
}

// out[D/8][4] += P . T, P the A fragments of a 16 x 64 product
// (p[c] for k columns [16c, 16c + 16)), T a row-major [64, D] tile
template <int D>
__device__ __forceinline__ void accumulate(float (&out)[D / 8][4],
                                           const uint32_t (&p)[4][4],
                                           const bf16* tile) {
  constexpr int LD = TcTile<D>::LD;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t b[4];
      load_b_cols<LD>(b, tile, c * 16, n0);
      mma(out[n0 / 8], p[c], b[0], b[1]);
      mma(out[n0 / 8 + 1], p[c], b[2], b[3]);
    }
}

// Element i of n8 tile nt of a warp's 16 x 64 accumulator sits at row
// (lane / 4) + 8 * (i / 2), column 8 * nt + 2 * (lane % 4) + i % 2; two
// neighbouring tiles form one A fragment of the next product.
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int i) {
  return 8 * nt + 2 * (threadIdx.x & 3) + (i & 1);
}

// a 16 x 64 f32 accumulator, rounded to bf16, as 4 A fragments
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][(nt & 1) * 2] = pack_bf16(x[nt][0], x[nt][1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

// rows [row0, row0 + 16) of the warp's f32 accumulator, divided by
// the row's divisor (l0 for rows g, l1 for rows g + 8) and rounded to
// bf16, into a [rows, D] row-major matrix
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&x)[D / 8][4],
                                           int row0, int rows, float l0,
                                           float l1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + frag_row(2 * half);
    if (r >= rows) continue;
    const float l = half ? l1 : l0;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r) * D +
                                   frag_col(nt, 0)) =
          pack_bf16(x[nt][2 * half] / l, x[nt][2 * half + 1] / l);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    fa_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, float scale) {
  using L = TcTile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::bytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * L::bytes);

  const int q0 = blockIdx.x * kTcRows;
  const size_t bh = blockIdx.y;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows in the tile
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  load_tile<kTcThreads, bf16, kTcRows, D>(sQ, L::LD, q + bh * sq * D, q0,
                                          sq);
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8
  // causal: KV tiles at or past the q tile's end are all masked
  const int kv_end = kCausal ? min(sk, q0 + kTcRows) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kTcRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, kb, k0, sk);
    load_tile<kTcThreads, bf16, kTcRows, D>(sV, L::LD, vb, k0, sk);
    __syncthreads();
    float s[8][4], unused[8][4];
    scores<D, false>(s, unused, sQ, sK, nullptr, nullptr, r0);
    // online softmax over this tile (:130-141); a row's 64 scores are
    // spread over the 4 lanes of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + r0 + frag_row(i), kp = k0 + frag_col(nt, i);
        const bool ok = kp < sk && (!kCausal || qp >= kp);
        s[nt][i] = ok ? s[nt][i] * scale : kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m[i >> 1]);
        l[i >> 1] += s[nt][i];  // this lane's part of the row sum
      }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];
    uint32_t p[4][4];
    to_a(p, s);  // p in v's dtype
    accumulate<D>(acc, p, sV);
  }
  // acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (:143-149)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    const int qp = q0 + r0 + frag_row(2 * h);
    if ((threadIdx.x & 3) == 0 && qp < sq)
      lse[bh * sq + qp] = m[h] + logf(l[h]);
  }
  store_rows<D>(o + bh * sq * D, acc, q0 + r0, sq, l[0], l[1]);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int sq, int sk, float scale) {
  using L = TcTile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::bytes);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * L::bytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * L::bytes);

  const int q0 = blockIdx.x * kTcRows;
  const size_t bh = blockIdx.y;
  const int r0 = (threadIdx.x >> 5) * 16;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  load_tile<kTcThreads, bf16, kTcRows, D>(sQ, L::LD, q + bh * sq * D, q0,
                                          sq);
  load_tile<kTcThreads, bf16, kTcRows, D>(sDO, L::LD, dout + bh * sq * D,
                                          q0, sq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + r0 + frag_row(2 * h);
    row_lse[h] = qp < sq ? lse[bh * sq + qp] : 0.f;
    row_delta[h] = qp < sq ? delta[bh * sq + qp] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  const int kv_end = kCausal ? min(sk, q0 + kTcRows) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kTcRows) {
    __syncthreads();
    load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, kb, k0, sk);
    load_tile<kTcThreads, bf16, kTcRows, D>(sV, L::LD, vb, k0, sk);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores<D, true>(s, dp, sQ, sK, sDO, sV, r0);  // s = Q K^T, dp = dO V^T
    // p = exp(s - lse); ds = p * (dp - delta) * scale (:243-247)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + r0 + frag_row(i), kp = k0 + frag_col(nt, i);
        const bool ok = kp < sk && (!kCausal || qp >= kp);
        const float p =
            expf((ok ? s[nt][i] * scale : kNegInf) - row_lse[i >> 1]);
        s[nt][i] = p * (dp[nt][i] - row_delta[i >> 1]) * scale;
      }
    uint32_t ds[4][4];
    to_a(ds, s);  // ds in k's dtype
    accumulate<D>(acc, ds, sK);
  }
  store_rows<D>(dq + bh * sq * D, acc, q0 + r0, sq, 1.f, 1.f);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    fa_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int sq, int sk, float scale) {
  using L = TcTile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::bytes);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * L::bytes);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 3 * L::bytes);
  float* sLse = reinterpret_cast<float*>(smem + 4 * L::bytes);
  float* sDelta = sLse + kTcRows;

  const int k0 = blockIdx.x * kTcRows;
  const size_t bh = blockIdx.y;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's keys in the tile
  const bf16* qb = q + bh * sq * D;
  const bf16* dob = dout + bh * sq * D;
  load_tile<kTcThreads, bf16, kTcRows, D>(sK, L::LD, k + bh * sk * D, k0,
                                          sk);
  load_tile<kTcThreads, bf16, kTcRows, D>(sV, L::LD, v + bh * sk * D, k0,
                                          sk);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
  // causal: q tiles that end at or before this KV tile are all masked
  for (int q0 = kCausal ? k0 : 0; q0 < sq; q0 += kTcRows) {
    __syncthreads();
    load_tile<kTcThreads, bf16, kTcRows, D>(sQ, L::LD, qb, q0, sq);
    load_tile<kTcThreads, bf16, kTcRows, D>(sDO, L::LD, dob, q0, sq);
    for (int r = threadIdx.x; r < kTcRows; r += kTcThreads) {
      const bool ok = q0 + r < sq;
      sLse[r] = ok ? lse[bh * sq + q0 + r] : 0.f;
      sDelta[r] = ok ? delta[bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns the q tile
    float st[8][4], dpt[8][4];
    scores<D, true>(st, dpt, sK, sQ, sV, sDO, r0);  // K Q^T, V dO^T
    // rows past the end of q score -1e30 too, so they add exactly 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = frag_col(nt, i);
        const int kp = k0 + r0 + frag_row(i), qp = q0 + c;
        const bool ok = kp < sk && qp < sq && (!kCausal || qp >= kp);
        const float p =
            expf((ok ? st[nt][i] * scale : kNegInf) - sLse[c]);
        st[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - sDelta[c]) * scale;
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a(pa, st);    // p in dO's dtype
    to_a(dsa, dpt);  // ds in q's dtype
    accumulate<D>(dv_acc, pa, sDO);  // dv += p^T dO (:290)
    accumulate<D>(dk_acc, dsa, sQ);  // dk += ds^T q (:297)
  }
  store_rows<D>(dk + bh * sk * D, dk_acc, k0 + r0, sk, 1.f, 1.f);
  store_rows<D>(dv + bh * sk * D, dv_acc, k0 + r0, sk, 1.f, 1.f);
}

// ---------------------------------------------------------------------
// f32: SIMT products over shared-memory tiles
// ---------------------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // rows of every tile
constexpr int kPad = 4;        // f32 row padding: 16 bytes

// C[M][N] = (C +) op(A)[M][K] . op(B)[K][N], all in shared memory:
//   A(m, k) = kTransA ? a[k * lda + m] : a[m * lda + k]
//   B(k, n) = kTransB ? b[n * ldb + k] : b[k * ldb + n]
// one output element per thread step, summed in k order and then added
// to C (the TPU kernel's `acc + dot(...)`)
template <bool kTransA, bool kTransB, int M, int N, int K>
__device__ __forceinline__ void gemm(float* c, int ldc, const float* a,
                                     int lda, const float* b, int ldb,
                                     bool accumulate) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i % N;
    float acc = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk)
      acc = fmaf(kTransA ? a[kk * lda + m] : a[m * lda + kk],
                 kTransB ? b[n * ldb + kk] : b[kk * ldb + n], acc);
    c[m * ldc + n] = accumulate ? c[m * ldc + n] + acc : acc;
  }
}

// the first `rows - row0` rows of a shared tile into a [rows, D]
// row-major matrix
template <int D>
__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           int ld, int row0, int rows) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < rows)
      dst[static_cast<size_t>(row0 + r) * D + d] = src[r * ld + d];
  }
}

// shared-memory layout of the f32 forward kernel, in floats
template <int D>
struct FwdSmem {
  static constexpr int LDT = D + kPad, LDS = kRows + kPad;
  static constexpr int q = 0;
  static constexpr int k = q + kRows * LDT;
  static constexpr int v = k + kRows * LDT;
  static constexpr int s = v + kRows * LDT;  // scores, then p
  static constexpr int o = s + kRows * LDS;
  static constexpr int m = o + kRows * LDT;
  static constexpr int l = m + kRows;
  static constexpr size_t bytes = sizeof(float) * (l + kRows);
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float scale) {
  using L = FwdSmem<D>;
  constexpr int R = kRows;
  extern __shared__ __align__(128) float fsmem[];
  float* sQ = fsmem + L::q;
  float* sK = fsmem + L::k;
  float* sV = fsmem + L::v;
  float* sS = fsmem + L::s;
  float* sO = fsmem + L::o;
  float* sM = fsmem + L::m;
  float* sL = fsmem + L::l;

  const int q0 = blockIdx.x * R;
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  load_tile<kThreads, float, R, D>(sQ, L::LDT, q + bh * sq * D, q0, sq);
  for (int i = threadIdx.x; i < R * D; i += kThreads)
    sO[(i / D) * L::LDT + i % D] = 0.f;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_end = kCausal ? min(sk, q0 + R) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<kThreads, float, R, D>(sK, L::LDT, kb, k0, sk);
    load_tile<kThreads, float, R, D>(sV, L::LDT, vb, k0, sk);
    __syncthreads();
    gemm<false, true, R, R, D>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    __syncthreads();
    // online softmax, one warp per row, one score per lane (:130-141)
    for (int r = warp; r < R; r += kWarps) {
      const int kp = k0 + lane;
      const bool ok = kp < sk && (!kCausal || q0 + r >= kp);
      const float sv = ok ? sS[r * L::LDS + lane] * scale : kNegInf;
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float p = expf(sv - m_new);
      sS[r * L::LDS + lane] = p;
      const float sum = warp_sum(p);
      const float alpha = expf(m_prev - m_new);
      for (int d = lane; d < D; d += 32) sO[r * L::LDT + d] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm<false, false, R, D, R>(sO, L::LDT, sS, L::LDS, sV, L::LDT, true);
  }
  __syncthreads();
  // acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (:143-149)
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < sq)
      o[(bh * sq + q0 + r) * D + d] =
          sO[r * L::LDT + d] / fmaxf(sL[r], 1e-30f);
  }
  for (int r = threadIdx.x; r < R; r += kThreads)
    if (q0 + r < sq)
      lse[bh * sq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

// shared-memory layout of the f32 backward kernels, in floats: the dq
// kernel uses one accumulator, the dk/dv kernel two and p
template <int D>
struct BwdSmem {
  static constexpr int LDT = D + kPad, LDS = kRows + kPad;
  static constexpr int q = 0;
  static constexpr int dO = q + kRows * LDT;
  static constexpr int k = dO + kRows * LDT;
  static constexpr int v = k + kRows * LDT;
  static constexpr int s = v + kRows * LDT;
  static constexpr int dp = s + kRows * LDS;
  static constexpr int ds = dp + kRows * LDS;
  static constexpr int lse = ds + kRows * LDS;
  static constexpr int delta = lse + kRows;
  static constexpr int acc = delta + kRows;
  static constexpr int acc2 = acc + kRows * LDT;
  static constexpr size_t dq_bytes = sizeof(float) * acc2;
  static constexpr int p = acc2 + kRows * LDT;
  static constexpr size_t dkv_bytes = sizeof(float) * (p + kRows * LDS);
};

// per-row lse and delta of q rows [q0, q0 + kRows) into shared memory;
// rows past the end get 0
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int sq) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool ok = q0 + r < sq;
    s_lse[r] = ok ? lse[q0 + r] : 0.f;
    s_delta[r] = ok ? delta[q0 + r] : 0.f;
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int sq, int sk, float scale) {
  using L = BwdSmem<D>;
  constexpr int R = kRows;
  extern __shared__ __align__(128) float fsmem[];
  float* sQ = fsmem + L::q;
  float* sDO = fsmem + L::dO;
  float* sK = fsmem + L::k;
  float* sV = fsmem + L::v;
  float* sS = fsmem + L::s;
  float* sDP = fsmem + L::dp;
  float* sDS = fsmem + L::ds;
  float* sLse = fsmem + L::lse;
  float* sDelta = fsmem + L::delta;
  float* sAcc = fsmem + L::acc;

  const int q0 = blockIdx.x * R;
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  load_tile<kThreads, float, R, D>(sQ, L::LDT, q + bh * sq * D, q0, sq);
  load_tile<kThreads, float, R, D>(sDO, L::LDT, dout + bh * sq * D, q0, sq);
  load_rows(sLse, sDelta, lse + bh * sq, delta + bh * sq, q0, sq);
  for (int i = threadIdx.x; i < R * D; i += kThreads)
    sAcc[(i / D) * L::LDT + i % D] = 0.f;
  const int kv_end = kCausal ? min(sk, q0 + R) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += R) {
    __syncthreads();
    load_tile<kThreads, float, R, D>(sK, L::LDT, kb, k0, sk);
    load_tile<kThreads, float, R, D>(sV, L::LDT, vb, k0, sk);
    __syncthreads();
    gemm<false, true, R, R, D>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    gemm<false, true, R, R, D>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, false);
    __syncthreads();
    // p = exp(s - lse); ds = p * (dp - delta) * scale (:243-247)
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R, c = i % R, kp = k0 + c;
      const bool ok = kp < sk && (!kCausal || q0 + r >= kp);
      const float s = ok ? sS[r * L::LDS + c] * scale : kNegInf;
      const float p = expf(s - sLse[r]);
      sDS[r * L::LDS + c] = p * (sDP[r * L::LDS + c] - sDelta[r]) * scale;
    }
    __syncthreads();
    gemm<false, false, R, D, R>(sAcc, L::LDT, sDS, L::LDS, sK, L::LDT, true);
  }
  __syncthreads();
  store_tile<D>(dq + bh * sq * D, sAcc, L::LDT, q0, sq);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int sq, int sk, float scale) {
  using L = BwdSmem<D>;
  constexpr int R = kRows;
  extern __shared__ __align__(128) float fsmem[];
  float* sQ = fsmem + L::q;
  float* sDO = fsmem + L::dO;
  float* sK = fsmem + L::k;
  float* sV = fsmem + L::v;
  float* sS = fsmem + L::s;
  float* sDP = fsmem + L::dp;
  float* sDS = fsmem + L::ds;
  float* sLse = fsmem + L::lse;
  float* sDelta = fsmem + L::delta;
  float* sDK = fsmem + L::acc;
  float* sDV = fsmem + L::acc2;
  float* sP = fsmem + L::p;

  const int k0 = blockIdx.x * R;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* dob = dout + bh * sq * D;
  load_tile<kThreads, float, R, D>(sK, L::LDT, k + bh * sk * D, k0, sk);
  load_tile<kThreads, float, R, D>(sV, L::LDT, v + bh * sk * D, k0, sk);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    sDK[(i / D) * L::LDT + i % D] = 0.f;
    sDV[(i / D) * L::LDT + i % D] = 0.f;
  }
  // causal: q tiles that end at or before this KV tile are all masked
  for (int q0 = kCausal ? k0 : 0; q0 < sq; q0 += R) {
    __syncthreads();
    load_tile<kThreads, float, R, D>(sQ, L::LDT, qb, q0, sq);
    load_tile<kThreads, float, R, D>(sDO, L::LDT, dob, q0, sq);
    load_rows(sLse, sDelta, lse + bh * sq, delta + bh * sq, q0, sq);
    __syncthreads();
    gemm<false, true, R, R, D>(sS, L::LDS, sQ, L::LDT, sK, L::LDT, false);
    gemm<false, true, R, R, D>(sDP, L::LDS, sDO, L::LDT, sV, L::LDT, false);
    __syncthreads();
    // rows past the end of q score -1e30 too, so they add exactly 0
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R, c = i % R, qp = q0 + r, kp = k0 + c;
      const bool ok = kp < sk && qp < sq && (!kCausal || qp >= kp);
      const float s = ok ? sS[r * L::LDS + c] * scale : kNegInf;
      const float p = expf(s - sLse[r]);
      sP[r * L::LDS + c] = p;
      sDS[r * L::LDS + c] = p * (sDP[r * L::LDS + c] - sDelta[r]) * scale;
    }
    __syncthreads();
    gemm<true, false, R, D, R>(sDV, L::LDT, sP, L::LDS, sDO, L::LDT, true);
    gemm<true, false, R, D, R>(sDK, L::LDT, sDS, L::LDS, sQ, L::LDT, true);
  }
  __syncthreads();
  store_tile<D>(dk + bh * sk * D, sDK, L::LDT, k0, sk);
  store_tile<D>(dv + bh * sk * D, sDV, L::LDT, k0, sk);
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

dim3 tiles(int rows, int tile, int bh) {
  return dim3((rows + tile - 1) / tile, bh);
}

template <int D, bool kCausal>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* o, void* lse, int bh, int sq, int sk, float scale,
                cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch(fa_fwd_tc<D, kCausal>, tiles(sq, kTcRows, bh), kTcThreads,
                  3 * TcTile<D>::bytes, st, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<bf16*>(o), l, sq, sk, scale);
  return launch(fa_fwd_f32<D, kCausal>, tiles(sq, kRows, bh), kThreads,
                FwdSmem<D>::bytes, st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), l, sq, sk, scale);
}

template <int D, bool kCausal>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, float scale,
                   cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch(fa_bwd_dq_tc<D, kCausal>, tiles(sq, kTcRows, bh),
                  kTcThreads, 4 * TcTile<D>::bytes, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), l, dl,
                  static_cast<bf16*>(dq), sq, sk, scale);
  return launch(fa_bwd_dq_f32<D, kCausal>, tiles(sq, kRows, bh), kThreads,
                BwdSmem<D>::dq_bytes, st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), l, dl,
                static_cast<float*>(dq), sq, sk, scale);
}

template <int D, bool kCausal>
cudaError_t bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, float scale,
                    cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch(fa_bwd_dkv_tc<D, kCausal>, tiles(sk, kTcRows, bh),
                  kTcThreads,
                  4 * TcTile<D>::bytes + 2 * kTcRows * sizeof(float), st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), l, dl,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
                  scale);
  return launch(fa_bwd_dkv_f32<D, kCausal>, tiles(sk, kRows, bh), kThreads,
                BwdSmem<D>::dkv_bytes, st, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), l, dl,
                static_cast<float*>(dk), static_cast<float*>(dv), sq, sk,
                scale);
}

// one call of F<D, kCausal> for the run-time head_dim (64, 128) and
// causal flag
template <template <int, bool> class F, typename... Args>
cudaError_t dispatch(int d, int causal, Args... args) {
  if (d == 64)
    return causal ? F<64, true>::call(args...) : F<64, false>::call(args...);
  return causal ? F<128, true>::call(args...) : F<128, false>::call(args...);
}

template <int D, bool kCausal>
struct Fwd {
  template <typename... Args>
  static cudaError_t call(Args... args) {
    return fwd<D, kCausal>(args...);
  }
};
template <int D, bool kCausal>
struct BwdDq {
  template <typename... Args>
  static cudaError_t call(Args... args) {
    return bwd_dq<D, kCausal>(args...);
  }
};
template <int D, bool kCausal>
struct BwdDkv {
  template <typename... Args>
  static cudaError_t call(Args... args) {
    return bwd_dkv<D, kCausal>(args...);
  }
};

bool bad_args(int bh, int sq, int sk, int d, int causal, int dtype) {
  return bh < 1 || bh > 65535 || sq < 1 || sk < 1 ||
         (d != 64 && d != 128) || (dtype != 0 && dtype != 1) ||
         (causal && sq != sk);
}

}  // namespace

// q, o: [bh, sq, d]; k, v: [bh, sk, d], row-major, one dtype (0 f32,
// 1 bf16); lse: [bh, sq] f32. Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int sq, int sk,
                             int d, float scale, int causal, int dtype,
                             void* stream) {
  if (bad_args(bh, sq, sk, d, causal, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Fwd>(
      d, causal, dtype, q, k, v, o, lse, bh, sq, sk, scale,
      static_cast<cudaStream_t>(stream)));
}

// dout, dq as q; lse, delta: [bh, sq] f32 (delta = rowsum(dO * O)).
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int sq,
                                int sk, int d, float scale, int causal,
                                int dtype, void* stream) {
  if (bad_args(bh, sq, sk, d, causal, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<BwdDq>(
      d, causal, dtype, q, k, v, dout, lse, delta, dq, bh, sq, sk, scale,
      static_cast<cudaStream_t>(stream)));
}

// dk, dv as k and v.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int sq, int sk,
                                 int d, float scale, int causal, int dtype,
                                 void* stream) {
  if (bad_args(bh, sq, sk, d, causal, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<BwdDkv>(
      d, causal, dtype, q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, scale,
      static_cast<cudaStream_t>(stream)));
}
