// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels (dq; dk and dv), causal or not, bf16 or f32, head_dim 64 or
// 128, over [B*H, S, D] row-major tensors.
//
// Replaces: paddle_tpu/incubate/nn/attention_pallas.py
//   `_fa_fwd_kernel` (:97), launched by `_flash_fwd_impl` (:179):
//     `fa_fwd_wgmma` (bf16), `fa_fwd_f32`;
//   `_fa_bwd_dq_kernel` (:215), launched by `_flash_bwd_impl` (:345):
//     `fa_bwd_dq_wgmma` (bf16), `fa_bwd_dq_f32`;
//   `_fa_bwd_dkv_kernel` (:257), launched by `_flash_bwd_impl` (:365):
//     `fa_bwd_dkv_wgmma` (bf16), `fa_bwd_dkv_f32`.
//
// What bounds them on an H100 at the training shape (B 4, H 16, S 1024,
// D 64, causal, bf16): the forward does 8.6 GFLOP against 33.8 MB of
// q/k/v/o and lse, about 254 operations per byte, just under the ~295
// where the bf16 tensor cores take over from memory: its bound is the
// bytes, 0.01009 ms. The backward kernels recompute the scores and do 3
// (dq) and 4 (dk/dv) products: both are bound by the tensor cores, dq
// 12.9 GFLOP in 0.01304 ms, dk/dv 17.2 GFLOP in 0.01739 ms. The [S, S]
// score matrix never reaches device memory.
//
// Design. The TPU walks KV tiles as a sequential grid axis and carries
// the online-softmax state in VMEM scratch between grid steps. CTAs on
// the card run in parallel with nothing carried between them, so that
// axis is a loop inside one work item: the forward and the dq kernel
// own a (batch*head, q tile) and loop over KV tiles; the dk/dv kernel
// owns a (batch*head, key tile) and loops over q tiles. Nothing is
// accumulated across work items, so there are no atomics and the
// gradients are deterministic.
//
// bf16 forward, dq and dk/dv (`fa_fwd_wgmma`, `fa_bwd_dq_wgmma`,
// `fa_bwd_dkv_wgmma`): three warpgroups a CTA. The first is the producer: it
// gives up registers (setmaxnreg) and one thread issues TMA loads (hopper.cuh).
// The other two are consumers with 64 rows each (the forward's and dq's 128 q
// rows; dk/dv's 128 keys), so every streamed tile is staged once for 128 rows.
// The kernels are persistent: one CTA an SM walks the work items (`fwd_item`,
// `dkv_item`), the causal heavy ones first and in a snake, so one CTA's next
// item is loading while it finishes the last. The stationary tiles (forward: Q;
// dq: Q and dO, each consumer row's lse and delta in registers; dk/dv: K and V)
// are loaded once an item into one of two slots. The streamed tiles (forward: K
// and V, 128 keys; dq: K and V, 128 keys at D 64, 64 at D 128; dk/dv: Q and dO,
// 64 rows, with the rows' lse and delta) go through a ring of shared-memory
// stages, each with a full and an empty mbarrier, so the loads of the next
// tiles are in flight while the consumers compute. TMA reads a 3-D map [B*H, S,
// D], so rows past a ragged end arrive as zeros and never as the next head's.
// Every product is a `wgmma`: the scores (S = Q.K^T; dq: also dP = dO.V^T;
// dk/dv: S^T = K.Q^T and dP^T = V.dO^T) with both operands in shared memory,
// and the accumulations (O += P.V; dQ += dS.K; dV += P^T.dO, dK += dS^T.Q) with
// P or dS from registers and the second operand read MN-major. The wgmma m64
// accumulator gives each warp the layout of an m16n8 accumulator, which is also
// the register-A layout, so p and ds go from one product into the next without
// leaving registers (`to_a`).
// The softmax works in base 2: scale * log2(e) is folded into one FFMA
// before exp2f, and the forward writes the natural-log lse. Only tiles
// that cross the causal diagonal or a ragged end run the mask.
//
// f32 forward, dq and dk/dv (`fa_fwd_f32`, `fa_bwd_dq_f32`,
// `fa_bwd_dkv_f32`; ERNIE's path, whose O2 stream is f32): every product
// on the tensor cores at f32 grade, 3xTF32 (CUTLASS's fast f32): each
// operand x split as hi = x rounded to tf32 and lo = x - hi, and a.b =
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b by `mma.sync` m16n8k8 (`mma_tf32`,
// hopper.cuh). Not `wgmma`: on tf32 it takes only K-major operands, and
// O += P.V, dQ += dS.K, dV += P^T.dO and dK += dS^T.Q reduce along the
// rows of V, K, dO and Q, which would need transposed hi and lo copies
// of every streamed tile in shared memory. A CTA of 4 warps owns 64 rows
// (forward and dq: q rows; dk/dv: keys), a warp 16, and streams the
// other side in tiles (forward and dq: K and V, 64 keys; dk/dv: Q and dO
// with the rows' lse and delta, 64 rows, 32 at D 128) through a
// two-stage cp.async ring, the next tile loading while this one
// computes; at D 64 two CTAs share an SM. Causal, the q tiles with the
// most KV tiles launch first. S = Q.K^T and dP = dO.V^T (dk/dv: S^T =
// K.Q^T, dP^T = V.dO^T) stay in registers, and so do p and ds, which
// are the A operand of the next product: an m16n8 accumulator's lane
// holds columns 2t and 2t + 1 where the tf32 A fragment wants k = t and
// t + 4, so k is permuted and B's rows are loaded in the same order
// (`mma_xb`), with no shuffles. The forward's online softmax is the bf16
// forward's (`softmax_tile`, in registers, base 2) and rescales O in
// registers. Operands are split as their fragments load (ldmatrix for
// the tiles read along their rows), not once a tile into hi and lo
// tiles in shared memory, which would double the tiles and their reads
// and leave one CTA an SM. The tensor cores truncate as they accumulate,
// so each tile's P.V, dQ, dK and dV products are summed from 0 and added
// to the accumulators in f32. Bound at ERNIE's shape (B 12, H 12, S 512,
// D 64): three tf32 products for each f32 one, forward 29.0, dq 43.5
// and dk/dv 58.0 GFLOP, 0.0586, 0.088 and 0.117 ms at the 495 TFLOP/s
// of `wgmma` (`mma.sync`'s own tf32 ceiling is not measured). The
// kernels also spend issue slots on the splits, the fragment loads and
// the softmax (PERF.md §6).
//
// All follow the TPU kernel's casts: the un-normalised p = exp(s - m) is
// rounded to v's dtype before P.V (:137-139), ds to k's dtype before
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

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kNegInf = -1e30f;  // `_NEG_INF`: exp underflows to 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // RNE
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Element i of n8 tile nt of a warp's 16-row accumulator (mma.sync
// m16n8, or the warp's quarter of a wgmma m64 one) sits at row
// (lane / 4) + 8 * (i / 2), column 8 * nt + 2 * (lane % 4) + i % 2; two
// neighbouring tiles form one A fragment of the next product.
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int i) {
  return 8 * nt + 2 * (threadIdx.x & 3) + (i & 1);
}

// a 16 x 8NT f32 accumulator, rounded to bf16, as NT / 2 A fragments
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4],
                                     const float (&x)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
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

// ---------------------------------------------------------------------
// bf16 forward and dk/dv: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------

constexpr int kWsThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr int kWgRows = 64;         // rows of a consumer warpgroup
constexpr int kStages = 2;          // depth of the ring
constexpr int kBox = 64 * 64;       // bf16 elements of a 64-row half box

// the 1024-byte-aligned start of dynamic shared memory (the swizzle's
// period); every layout below reserves 1024 bytes for it
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// a 64-row slab of a [D/64 halves][rows][64] tile: `half` picks the
// 64-column half, `part` the 64 rows
__device__ __forceinline__ const bf16* slab(const bf16* tile, int rows,
                                            int half, int part) {
  return tile + (half * rows + part * 64) * 64;
}

// forward: 128 q rows a work item, KV tiles of 128 keys
constexpr int kFwdRows = 2 * kWgRows;
constexpr int kFwdKeys = 128;

template <int D>
struct FwdLayout {
  static constexpr int q_bytes = kFwdRows * D * 2;  // [D/64][128][64]
  static constexpr int kv_bytes = kFwdKeys * D * 2;
  static constexpr int q = 0;  // q + i * q_bytes: slot i of 2
  static constexpr int k = q + 2 * q_bytes;  // k + s * kv_bytes: stage s
  static constexpr int v = k + kStages * kv_bytes;
  // q_full[2], q_empty[2], k_full[kStages], v_full[kStages],
  // empty[kStages]
  static constexpr int bar = v + kStages * kv_bytes;
  static constexpr size_t bytes = bar + 8 * (4 + 3 * kStages) + 1024;
};

// The persistent walk: a CTA on every SM takes the work items (a
// batch*head and a 128-row q tile; heads fastest, the causal q tiles
// from the last, which has the most KV tiles) in rounds of gridDim.x,
// running the rounds in a snake, forward then backward, so the heavy
// and light causal items even out. One CTA carries on from item to
// item: the producer loads the next item's Q and first KV tiles while
// the consumers finish the last one.
struct FwdItem {
  int bh, q0, n_kv;
};

template <bool kCausal, int kKeys = kFwdKeys>
__device__ __forceinline__ bool fwd_item(int round, int n_bh, int n_qt,
                                         int sk, FwdItem& it) {
  const int g = gridDim.x, c = blockIdx.x;
  const int w = round * g + ((round & 1) ? g - 1 - c : c);
  if (w >= n_bh * n_qt) return false;
  it.bh = w % n_bh;
  const int t = w / n_bh;
  it.q0 = (kCausal ? n_qt - 1 - t : t) * kFwdRows;
  // causal: KV tiles past the q tile's last row are all masked
  it.n_kv = (sk + kKeys - 1) / kKeys;
  if (kCausal) it.n_kv = min(it.n_kv, (it.q0 + kFwdRows - 1) / kKeys + 1);
  return true;
}

// online softmax over a warp's 16 x 8NT score tile, an m16n8
// accumulator (:130-141), in base 2: m is the running max of s * scale *
// log2(e); leaves p = exp2(s * sl2 - m) in s, and the rescale of the
// running sums in alpha. kMask: the tile crosses the causal diagonal or
// the end of k, so masked scores become -1e30 first. The bf16 forward
// takes 128 keys a tile (NT 16), the f32 forward 64 (NT 8).
template <bool kMask, bool kCausal, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row0,
                                             int k0, int sk, float sl2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kMask) {
        const int qp = row0 + frag_row(i), kp = k0 + frag_col(nt, i);
        if (!(kp < sk && (!kCausal || qp >= kp))) s[nt][i] = kNegInf;
      }
      mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a row's 8NT scores are spread over the 4 lanes of a quad
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * sl2);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = exp2f(fmaf(s[nt][i], sl2, -m[i >> 1]));
      l[i >> 1] += s[nt][i];  // this lane's part of the row sum
    }
}

// the online softmax's end for the warp's rows g and g + 8 (:143-149):
// l summed over the quad and floored at 1e-30, lse = m + log(l) (m back
// from base 2) into lse[row] for the rows before sq
__device__ __forceinline__ void finish_rows(float (&l)[2],
                                            const float (&m)[2], float* lse,
                                            int row0, int sq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    const int qp = row0 + frag_row(2 * h);
    if ((threadIdx.x & 3) == 0 && qp < sq) lse[qp] = m[h] * kLn2 + logf(l[h]);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    fa_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int n_bh,
                 int sq, int sk, float sl2) {
  using L = FwdLayout<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  const int n_qt = (sq + kFwdRows - 1) / kFwdRows;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      FwdItem item;
      int j = 0;  // KV tiles loaded, over all items: the ring's position
      for (int n = 0; fwd_item<kCausal>(n, n_bh, n_qt, sk, item); ++n) {
        // a fresh barrier passes a wait on parity 1: slots start empty
        mbar_wait(&q_empty[n & 1], ((n >> 1) & 1) ^ 1);
        bf16* sQ = reinterpret_cast<bf16*>(smem + L::q +
                                           (n & 1) * L::q_bytes);
        mbar_arrive_expect_tx(&q_full[n & 1], L::q_bytes);
        for (int h = 0; h < kHalves; ++h)
          tma_load_3d(sQ + h * kFwdRows * 64, &tq, &q_full[n & 1], h * 64,
                      item.q0, item.bh);
        for (int t = 0; t < item.n_kv; ++t, ++j) {
          const int s = j % kStages;
          mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
          bf16* sK = reinterpret_cast<bf16*>(smem + L::k + s * L::kv_bytes);
          bf16* sV = reinterpret_cast<bf16*>(smem + L::v + s * L::kv_bytes);
          mbar_arrive_expect_tx(&k_full[s], L::kv_bytes);
          for (int h = 0; h < kHalves; ++h)
            tma_load_3d(sK + h * kFwdKeys * 64, &tk, &k_full[s], h * 64,
                        t * kFwdKeys, item.bh);
          mbar_arrive_expect_tx(&v_full[s], L::kv_bytes);
          for (int h = 0; h < kHalves; ++h)
            tma_load_3d(sV + h * kFwdKeys * 64, &tv, &v_full[s], h * 64,
                        t * kFwdKeys, item.bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // consumer 0 or 1: rows [64 cw, 64 cw + 64)
  const int wr = ((threadIdx.x >> 5) & 3) * 16;  // the warp's 16 rows
  const bool lane0 = (threadIdx.x & 31) == 0;
  FwdItem item;
  int j = 0;  // the ring position of the item's first KV tile
  for (int n = 0; fwd_item<kCausal>(n, n_bh, n_qt, sk, item);
       ++n, j += item.n_kv) {
    const int row0 = item.q0 + cw * kWgRows;  // the warpgroup's rows
    const int wrow0 = row0 + wr;
    const bf16* sQ = reinterpret_cast<const bf16*>(smem + L::q +
                                                   (n & 1) * L::q_bytes);
    const bf16* sK = reinterpret_cast<const bf16*>(smem + L::k);
    const bf16* sV = reinterpret_cast<const bf16*>(smem + L::v);
    constexpr int kStage = L::kv_bytes / 2;  // bf16 elements a stage
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8
    mbar_wait(&q_full[n & 1], (n >> 1) & 1);
    for (int t = 0; t < item.n_kv; ++t) {
      const int s = (j + t) % kStages;
      const uint32_t parity = ((j + t) / kStages) & 1;
      const int k0 = t * kFwdKeys;
      // S = Q K^T: 64 rows x 128 keys, k16 steps along D
      float sc[16][4];
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(sc, desc_b128(slab(sQ, kFwdRows, h, cw) + kk * 16),
                        desc_b128(sK + s * kStage + h * kFwdKeys * 64 +
                                  kk * 16),
                        h > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);
      float alpha[2];
      if ((kCausal && k0 + kFwdKeys - 1 > row0) || k0 + kFwdKeys > sk)
        softmax_tile<true, kCausal>(sc, m, l, alpha, wrow0, k0, sk, sl2);
      else
        softmax_tile<false, kCausal>(sc, m, l, alpha, wrow0, k0, sk, sl2);
      uint32_t p[8][4];
      to_a<16>(p, sc);  // p in v's dtype
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];
      // O += P V: k16 steps along the 128 keys, one n64 product a half
      mbar_wait(&v_full[s], parity);
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&acc[8 * h]),
                       p[kk],
                       desc_b128(sV + s * kStage + h * kFwdKeys * 64 +
                                 kk * 16 * 64),
                       1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      if (lane0) mbar_arrive(&empty[s]);  // the stage may be refilled
    }
    if (lane0) mbar_arrive(&q_empty[n & 1]);  // and the Q slot
    // o = acc / l, and lse
    finish_rows(l, m, lse + static_cast<size_t>(item.bh) * sq, wrow0, sq);
    store_rows<D>(o + static_cast<size_t>(item.bh) * sq * D, acc, wrow0, sq,
                  l[0], l[1]);
  }
}

// dk/dv: 128 keys a work item, q tiles of 64 rows
constexpr int kDkvKeys = 2 * kWgRows;
constexpr int kDkvRows = 64;

template <int D>
struct DkvLayout {
  static constexpr int kv_bytes = kDkvKeys * D * 2;  // [D/64][128][64]
  static constexpr int t_bytes = kDkvRows * D * 2;   // [D/64][64][64]
  static constexpr int k = 0;  // k + 2 i * kv_bytes: slot i of 2
  static constexpr int v = k + kv_bytes;  // v + 2 i * kv_bytes
  static constexpr int q = k + 4 * kv_bytes;  // q + s * t_bytes: stage s
  static constexpr int dO = q + kStages * t_bytes;
  // lse * log2(e) and delta of the stage's rows, f32 [kStages][64] each
  static constexpr int lse = dO + kStages * t_bytes;
  static constexpr int delta = lse + kStages * kDkvRows * 4;
  // kv_full[2], kv_empty[2], full[kStages], empty[kStages]
  static constexpr int bar = delta + kStages * kDkvRows * 4;
  static constexpr size_t bytes = bar + 8 * (4 + 2 * kStages) + 1024;
};

// The dk/dv kernel's persistent walk, as the forward's (`fwd_item`):
// items are a batch*head and a 128-key tile, heads fastest, key tiles
// ascending (the causal first key tiles see the most q tiles).
struct DkvItem {
  int bh, k0, t0, n_t;  // q tiles [t0, t0 + n_t)
};

template <bool kCausal>
__device__ __forceinline__ bool dkv_item(int round, int n_bh, int n_kt,
                                         int sq, DkvItem& it) {
  const int g = gridDim.x, c = blockIdx.x;
  const int w = round * g + ((round & 1) ? g - 1 - c : c);
  if (w >= n_bh * n_kt) return false;
  it.bh = w % n_bh;
  it.k0 = w / n_bh * kDkvKeys;
  // causal: q tiles that end at or before this key tile are all masked
  it.t0 = kCausal ? it.k0 / kDkvRows : 0;
  it.n_t = (sq + kDkvRows - 1) / kDkvRows - it.t0;
  return true;
}

// p^T = exp2(s^T * sl2 - lse2) and ds^T = p^T * (dp^T - delta) * scale
// over a tile of keys x 8NT q rows (:283-295), columns the q rows. kMask:
// the tile crosses the causal diagonal or the end of q; masked p is 0
// (the -1e30 score's weight), so rows past the end of q add exactly 0.
template <bool kMask, bool kCausal, int NT>
__device__ __forceinline__ void dkv_tile(float (&st)[NT][4],
                                         float (&dpt)[NT][4],
                                         const float* s_lse2,
                                         const float* s_delta, int key0,
                                         int q0, int sq, float sl2,
                                         float scale) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(nt, i);
      float p = exp2f(fmaf(st[nt][i], sl2, -s_lse2[c]));
      if (kMask) {
        const int kp = key0 + frag_row(i), qp = q0 + c;
        if (!(qp < sq && (!kCausal || qp >= kp))) p = 0.f;
      }
      st[nt][i] = p;
      dpt[nt][i] = p * (dpt[nt][i] - s_delta[c]) * scale;
    }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    fa_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int n_bh,
                     int sq, int sk, float sl2, float scale) {
  using L = DkvLayout<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sLse2 = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + kStages;
  const int n_kt = (sk + kDkvKeys - 1) / kDkvKeys;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one warp
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      DkvItem item;
      int j = 0;  // q tiles loaded, over all items: the ring's position
      for (int n = 0; dkv_item<kCausal>(n, n_bh, n_kt, sq, item); ++n) {
        if (lane == 0) {
          // a fresh barrier passes a wait on parity 1: slots start empty
          mbar_wait(&kv_empty[n & 1], ((n >> 1) & 1) ^ 1);
          bf16* sK = reinterpret_cast<bf16*>(smem + L::k +
                                             (n & 1) * 2 * L::kv_bytes);
          bf16* sV = reinterpret_cast<bf16*>(smem + L::v +
                                             (n & 1) * 2 * L::kv_bytes);
          mbar_arrive_expect_tx(&kv_full[n & 1], 2 * L::kv_bytes);
          for (int h = 0; h < kHalves; ++h) {
            tma_load_3d(sK + h * kDkvKeys * 64, &tk, &kv_full[n & 1], h * 64,
                        item.k0, item.bh);
            tma_load_3d(sV + h * kDkvKeys * 64, &tv, &kv_full[n & 1], h * 64,
                        item.k0, item.bh);
          }
        }
        const float* lse_bh = lse + static_cast<size_t>(item.bh) * sq;
        const float* delta_bh = delta + static_cast<size_t>(item.bh) * sq;
        for (int t = item.t0; t < item.t0 + item.n_t; ++t, ++j) {
          const int s = j % kStages;
          const int q0 = t * kDkvRows;
          mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
          // the rows' lse (in base 2) and delta; rows past the end get 0
          for (int r = lane; r < kDkvRows; r += 32) {
            const bool ok = q0 + r < sq;
            sLse2[s * kDkvRows + r] = ok ? lse_bh[q0 + r] * kLog2e : 0.f;
            sDelta[s * kDkvRows + r] = ok ? delta_bh[q0 + r] : 0.f;
          }
          if (lane == 0) {
            bf16* sQ = reinterpret_cast<bf16*>(smem + L::q + s * L::t_bytes);
            bf16* sDO =
                reinterpret_cast<bf16*>(smem + L::dO + s * L::t_bytes);
            mbar_arrive_expect_tx(&full[s], 2 * L::t_bytes);
            for (int h = 0; h < kHalves; ++h) {
              tma_load_3d(sQ + h * kBox, &tq, &full[s], h * 64, q0, item.bh);
              tma_load_3d(sDO + h * kBox, &tdo, &full[s], h * 64, q0,
                          item.bh);
            }
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // consumer 0 or 1: keys [64 cw, 64 cw + 64)
  const int wr = ((threadIdx.x >> 5) & 3) * 16;  // the warp's 16 keys
  const bool lane0 = (threadIdx.x & 31) == 0;
  DkvItem item;
  int j = 0;  // the ring position of the item's first q tile
  for (int n = 0; dkv_item<kCausal>(n, n_bh, n_kt, sq, item);
       ++n, j += item.n_t) {
    const int key0 = item.k0 + cw * kWgRows;  // the warpgroup's keys
    const int wkey0 = key0 + wr;
    const bf16* sK = reinterpret_cast<const bf16*>(smem + L::k +
                                                   (n & 1) * 2 * L::kv_bytes);
    const bf16* sV = reinterpret_cast<const bf16*>(smem + L::v +
                                                   (n & 1) * 2 * L::kv_bytes);
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
    mbar_wait(&kv_full[n & 1], (n >> 1) & 1);
    for (int t = 0; t < item.n_t; ++t) {
      const int s = (j + t) % kStages;
      const int q0 = (item.t0 + t) * kDkvRows;
      const bf16* sQ =
          reinterpret_cast<const bf16*>(smem + L::q + s * L::t_bytes);
      const bf16* sDO =
          reinterpret_cast<const bf16*>(smem + L::dO + s * L::t_bytes);
      mbar_wait(&full[s], ((j + t) / kStages) & 1);
      // transposed scores: rows this warpgroup's keys, columns the q tile
      float st[8][4], dpt[8][4];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_n64(st, desc_b128(slab(sK, kDkvKeys, h, cw) + kk * 16),
                       desc_b128(sQ + h * kBox + kk * 16), h > 0 || kk > 0);
          wgmma_ss_n64(dpt, desc_b128(slab(sV, kDkvKeys, h, cw) + kk * 16),
                       desc_b128(sDO + h * kBox + kk * 16), h > 0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(st);
      fence_operand(dpt);
      const float* l2 = sLse2 + s * kDkvRows;
      const float* dl = sDelta + s * kDkvRows;
      if ((kCausal && q0 < key0 + kWgRows) || q0 + kDkvRows > sq)
        dkv_tile<true, kCausal>(st, dpt, l2, dl, wkey0, q0, sq, sl2, scale);
      else
        dkv_tile<false, kCausal>(st, dpt, l2, dl, wkey0, q0, sq, sl2, scale);
      uint32_t pa[4][4], dsa[4][4];
      to_a<8>(pa, st);    // p in dO's dtype
      to_a<8>(dsa, dpt);  // ds in q's dtype
      fence_operand(dk_acc);
      fence_operand(dv_acc);
      wgmma_fence();
      // dv += p^T dO (:290), dk += ds^T q (:297): k16 steps along the q
      // rows, one n64 product a half
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&dv_acc[8 * h]),
                       pa[kk], desc_b128(sDO + h * kBox + kk * 16 * 64), 1);
          wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&dk_acc[8 * h]),
                       dsa[kk], desc_b128(sQ + h * kBox + kk * 16 * 64), 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dk_acc);
      fence_operand(dv_acc);
      if (lane0) mbar_arrive(&empty[s]);  // the stage may be refilled
    }
    if (lane0) mbar_arrive(&kv_empty[n & 1]);  // and the K/V slot
    const size_t base = static_cast<size_t>(item.bh) * sk * D;
    store_rows<D>(dk + base, dk_acc, wkey0, sk, 1.f, 1.f);
    store_rows<D>(dv + base, dv_acc, wkey0, sk, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------
// bf16 dq: TMA ring, wgmma, warp specialisation
// ---------------------------------------------------------------------

// dq: 128 q rows a work item (the forward's items, `fwd_item`), K and V
// tiles of 128 keys at D 64 and of 64 keys at D 128, where two slots of
// Q and dO (128 KB) and a ring of 128-key tiles (128 KB) would not fit
// in shared memory, nor 128-key scores beside a D-128 accumulator in
// registers
template <int D>
struct DqLayout {
  static constexpr int keys = D == 64 ? 128 : 64;
  static constexpr int q_bytes = kFwdRows * D * 2;  // [D/64][128][64]
  static constexpr int kv_bytes = keys * D * 2;
  static constexpr int q = 0;  // q + 2 i * q_bytes: slot i of 2
  static constexpr int dO = q + q_bytes;  // dO + 2 i * q_bytes
  static constexpr int k = q + 4 * q_bytes;  // k + s * kv_bytes: stage s
  static constexpr int v = k + kStages * kv_bytes;
  // q_full[2], q_empty[2], k_full[kStages], v_full[kStages],
  // empty[kStages]
  static constexpr int bar = v + kStages * kv_bytes;
  static constexpr size_t bytes = bar + 8 * (4 + 3 * kStages) + 1024;
};

// d (+)= A . B^T for one m64 x N x k16 step, both K-major in shared
// memory, N 128 or 64
template <int N>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[N / 8][4], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, accumulate);
  else
    wgmma_ss_n64(d, a, b, accumulate);
}

// p = exp2(s * sl2 - lse2) and ds = p * (dp - delta) * scale over one
// 64-row x 8NT-key tile (:243-247), ds left in dp. kMask: the tile
// crosses the causal diagonal or the end of k; masked p is 0 (the -1e30
// score's weight), so keys past the end add exactly 0.
template <bool kMask, bool kCausal, int NT>
__device__ __forceinline__ void dq_tile(const float (&sc)[NT][4],
                                        float (&dp)[NT][4],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], int row0,
                                        int k0, int sk, float sl2,
                                        float scale) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = exp2f(fmaf(sc[nt][i], sl2, -lse2[i >> 1]));
      if (kMask) {
        const int qp = row0 + frag_row(i), kp = k0 + frag_col(nt, i);
        if (!(kp < sk && (!kCausal || qp >= kp))) p = 0.f;
      }
      dp[nt][i] = p * (dp[nt][i] - dl[i >> 1]) * scale;
    }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWsThreads, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int n_bh, int sq, int sk, float sl2, float scale) {
  using L = DqLayout<D>;
  constexpr int kHalves = D / 64;
  constexpr int kKeys = L::keys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  const int n_qt = (sq + kFwdRows - 1) / kFwdRows;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      FwdItem item;
      int j = 0;  // KV tiles loaded, over all items: the ring's position
      for (int n = 0; fwd_item<kCausal, kKeys>(n, n_bh, n_qt, sk, item);
           ++n) {
        // a fresh barrier passes a wait on parity 1: slots start empty
        mbar_wait(&q_empty[n & 1], ((n >> 1) & 1) ^ 1);
        bf16* sQ = reinterpret_cast<bf16*>(smem + L::q +
                                           (n & 1) * 2 * L::q_bytes);
        bf16* sDO = reinterpret_cast<bf16*>(smem + L::dO +
                                            (n & 1) * 2 * L::q_bytes);
        mbar_arrive_expect_tx(&q_full[n & 1], 2 * L::q_bytes);
        for (int h = 0; h < kHalves; ++h) {
          tma_load_3d(sQ + h * kFwdRows * 64, &tq, &q_full[n & 1], h * 64,
                      item.q0, item.bh);
          tma_load_3d(sDO + h * kFwdRows * 64, &tdo, &q_full[n & 1], h * 64,
                      item.q0, item.bh);
        }
        for (int t = 0; t < item.n_kv; ++t, ++j) {
          const int s = j % kStages;
          mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
          bf16* sK = reinterpret_cast<bf16*>(smem + L::k + s * L::kv_bytes);
          bf16* sV = reinterpret_cast<bf16*>(smem + L::v + s * L::kv_bytes);
          mbar_arrive_expect_tx(&k_full[s], L::kv_bytes);
          for (int h = 0; h < kHalves; ++h)
            tma_load_3d(sK + h * kKeys * 64, &tk, &k_full[s], h * 64,
                        t * kKeys, item.bh);
          mbar_arrive_expect_tx(&v_full[s], L::kv_bytes);
          for (int h = 0; h < kHalves; ++h)
            tma_load_3d(sV + h * kKeys * 64, &tv, &v_full[s], h * 64,
                        t * kKeys, item.bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // consumer 0 or 1: rows [64 cw, 64 cw + 64)
  const int wr = ((threadIdx.x >> 5) & 3) * 16;  // the warp's 16 rows
  const bool lane0 = (threadIdx.x & 31) == 0;
  FwdItem item;
  int j = 0;  // the ring position of the item's first KV tile
  for (int n = 0; fwd_item<kCausal, kKeys>(n, n_bh, n_qt, sk, item);
       ++n, j += item.n_kv) {
    const int row0 = item.q0 + cw * kWgRows;  // the warpgroup's rows
    const int wrow0 = row0 + wr;
    const bf16* sQ = reinterpret_cast<const bf16*>(smem + L::q +
                                                   (n & 1) * 2 * L::q_bytes);
    const bf16* sDO = reinterpret_cast<const bf16*>(
        smem + L::dO + (n & 1) * 2 * L::q_bytes);
    const bf16* sK = reinterpret_cast<const bf16*>(smem + L::k);
    const bf16* sV = reinterpret_cast<const bf16*>(smem + L::v);
    constexpr int kStage = L::kv_bytes / 2;  // bf16 elements a stage
    // the rows' lse (in base 2) and delta, held over the item; rows past
    // the end get 0
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = wrow0 + frag_row(2 * h);
      const size_t at = static_cast<size_t>(item.bh) * sq + qp;
      lse2[h] = qp < sq ? lse[at] * kLog2e : 0.f;
      dl[h] = qp < sq ? delta[at] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    mbar_wait(&q_full[n & 1], (n >> 1) & 1);
    for (int t = 0; t < item.n_kv; ++t) {
      const int s = (j + t) % kStages;
      const uint32_t par = ((j + t) / kStages) & 1;
      const int k0 = t * kKeys;
      mbar_wait(&k_full[s], par);
      if (kCausal && k0 >= row0 + kWgRows) {  // every key past these rows
        mbar_wait(&v_full[s], par);
        if (lane0) mbar_arrive(&empty[s]);
        continue;
      }
      // S = Q K^T and dP = dO V^T: 64 rows x kKeys keys, k16 steps
      // along D
      float sc[kKeys / 8][4], dp[kKeys / 8][4];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n<kKeys>(sc,
                            desc_b128(slab(sQ, kFwdRows, h, cw) + kk * 16),
                            desc_b128(sK + s * kStage + h * kKeys * 64 +
                                      kk * 16),
                            h > 0 || kk > 0);
      mbar_wait(&v_full[s], par);
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n<kKeys>(dp,
                            desc_b128(slab(sDO, kFwdRows, h, cw) + kk * 16),
                            desc_b128(sV + s * kStage + h * kKeys * 64 +
                                      kk * 16),
                            h > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      if ((kCausal && k0 + kKeys - 1 > row0) || k0 + kKeys > sk)
        dq_tile<true, kCausal>(sc, dp, lse2, dl, wrow0, k0, sk, sl2, scale);
      else
        dq_tile<false, kCausal>(sc, dp, lse2, dl, wrow0, k0, sk, sl2, scale);
      uint32_t dsa[kKeys / 16][4];
      to_a<kKeys / 8>(dsa, dp);  // ds in k's dtype
      // dQ += dS K: k16 steps along the keys, K read MN-major, one n64
      // product a half (the forward's O += P V with K for V)
      fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&acc[8 * h]),
                       dsa[kk],
                       desc_b128(sK + s * kStage + h * kKeys * 64 +
                                 kk * 16 * 64),
                       1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      if (lane0) mbar_arrive(&empty[s]);  // the stage may be refilled
    }
    if (lane0) mbar_arrive(&q_empty[n & 1]);  // and the Q/dO slot
    store_rows<D>(dq + static_cast<size_t>(item.bh) * sq * D, acc, wrow0, sq,
                  1.f, 1.f);
  }
}

// ---------------------------------------------------------------------
// f32 forward and backward: 3xTF32 products on the tensor cores
// (mma.sync)
// ---------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcRows = 64;      // a CTA's stationary rows, 16 a warp

// x as hi + lo: hi = x rounded to tf32, lo = x - hi (exact in f32,
// |lo| <= 2^-11 |x|), left unrounded: `mma_tf32` reads its top 19 bits,
// which truncates it to within 2^-21 of |x|, one instruction for what
// rounding it first would take two
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += A . B at f32 grade from three tf32 products (3xTF32, CUTLASS's
// fast f32): the two small terms first, the large one last; lo . lo,
// under 2^-22 of |a b|, is dropped
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Fragments from shared f32 tiles of pitch P (D + 4 floats: the rows of
// an 8 x 4 block fall on 32 distinct banks), split as they load.
// A: rows [0, 16), columns [c0, c0 + 8) of a row-major tile, one
// ldmatrix: blocks (rows 0-7, columns c0..c0 + 3), (8-15, same), (0-7,
// c0 + 4..), (8-15, c0 + 4..) are the fragment's four registers
template <int P>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* a, int c0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4(r, a + ((l & 7) + 8 * ((l >> 3) & 1)) * P + c0 + 4 * (l >> 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[i], lo[i]);
}

// B(k, n) = b[n * P + c0 + k] for n tiles nt and nt + 1 (rows [0, 16) of
// the tile, which are B's columns: K in Q.K^T), one ldmatrix
template <int P>
__device__ __forceinline__ void frag_bt2(uint32_t (&hi)[2][2],
                                         uint32_t (&lo)[2][2], const float* b,
                                         int c0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4(r, b + ((l & 7) + 8 * (l >> 4)) * P + c0 + 4 * ((l >> 3) & 1));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split(__uint_as_float(r[i]), hi[i >> 1][i & 1], lo[i >> 1][i & 1]);
}

// B(k, n) = b[r(k) * P + n] with k = t read from row 2t and k = t + 4
// from row 2t + 1: the k order of an accumulator taken as A (`mma_xb`)
template <int P>
__device__ __forceinline__ void frag_bp(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                        const float* b) {
  const float* p = b + 2 * (threadIdx.x & 3) * P + ((threadIdx.x & 31) >> 2);
  split(p[0], hi[0], lo[0]);
  split(p[P], hi[1], lo[1]);
}

// d = A . B^T over D columns: A the warp's 16 rows of one shared tile, B
// N rows of another
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&d)[N / 8][4], const float* a,
                                        const float* b) {
  constexpr int P = D + 4;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a<P>(ah, al, a, 8 * kk);
#pragma unroll
    for (int nt = 0; nt < N / 8; nt += 2) {
      uint32_t bh[2][2], bl[2][2];
      frag_bt2<P>(bh, bl, b + 8 * nt * P, 8 * kk);
      mma3(d[nt], ah, al, bh[0], bl[0]);
      mma3(d[nt + 1], ah, al, bh[1], bl[1]);
    }
  }
}

// d += X . B: X the warp's 16 x N accumulator (p or ds) as A, B rows [0,
// N) by D columns of a shared tile. An accumulator's lane holds columns
// 2t and 2t + 1 of an n8 tile where the A fragment wants t and t + 4, so
// k is permuted: X's column 2t is k = t, 2t + 1 is k = t + 4, and B's
// rows are read in the same order (`frag_bp`); no shuffles. The tensor
// cores truncate as they accumulate, which over a whole sequence's tiles
// drifts past f32 grade (2e-5 of max|dk| at S 1000 on the card), so the
// tile's product is summed from 0, 64 columns at a time, and added to d
// in f32
template <int D, int N>
__device__ __forceinline__ void mma_xb(float (&d)[D / 8][4],
                                       const float (&x)[N / 8][4],
                                       const float* b) {
  constexpr int P = D + 4;
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    float part[8][4] = {};
#pragma unroll
    for (int kt = 0; kt < N / 8; ++kt) {
      uint32_t ah[4], al[4];
      split(x[kt][0], ah[0], al[0]);
      split(x[kt][2], ah[1], al[1]);
      split(x[kt][1], ah[2], al[2]);
      split(x[kt][3], ah[3], al[3]);
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        uint32_t bh[2], bl[2];
        frag_bp<P>(bh, bl, b + 8 * kt * P + 64 * c + 8 * nd);
        mma3(part[nd], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[8 * c + nd][i] += part[nd][i];
  }
}

// rows [row0, row0 + R) of a [rows, D] f32 matrix into a shared tile of
// pitch D + 4 by cp.async, 16 bytes a thread step; rows past the end are
// zero-filled (source size 0), never read
template <int R, int D>
__device__ __forceinline__ void cp_tile(float* dst, const float* src,
                                        int row0, int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < R * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = row0 + r < rows;
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
            smem_u32(dst + r * (D + 4) + c)),
        "l"(src + static_cast<size_t>(ok ? row0 + r : 0) * D + c),
        "r"(ok ? 16 : 0)
        : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the warp's 16 x D accumulator into rows [row0, row0 + 16) of a [rows,
// D] f32 matrix; rows past the end are not written
template <int D>
__device__ __forceinline__ void store_f32(float* dst,
                                          const float (&x)[D / 8][4],
                                          int row0, int rows) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + frag_row(2 * half);
    if (r >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * D +
                                 frag_col(nt, 0)) =
          make_float2(x[nt][2 * half], x[nt][2 * half + 1]);
  }
}

// forward: a CTA owns 64 q rows of a batch*head (a warp 16) and streams K
// and V in tiles of 64 keys through a two-stage ring, as dq does without
// dO; shared memory in floats (85 KB at D 64: two CTAs an SM; 165 KB at
// D 128)
template <int D>
struct FwdF32 {
  static constexpr int P = D + 4;
  static constexpr int keys = 64;
  static constexpr int q = 0;                 // Q [64][P]
  static constexpr int kv = q + kTcRows * P;  // stage s: K, V [keys][P]
  static constexpr int stage = 2 * keys * P;
  static constexpr size_t bytes = sizeof(float) * (kv + 2 * stage);
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float sl2) {
  using L = FwdF32<D>;
  constexpr int P = L::P, kKeys = L::keys;
  extern __shared__ __align__(16) float fsmem[];
  const int bh = blockIdx.x;
  const int qt = static_cast<int>(blockIdx.y);
  // causal: the q tiles with the most KV tiles launch first
  const int q0 =
      (kCausal ? static_cast<int>(gridDim.y) - 1 - qt : qt) * kTcRows;
  const int r0 = q0 + 16 * (threadIdx.x >> 5);  // the warp's rows
  const size_t qo = static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  // causal: KV tiles past the q tile's last row are all masked
  const int kv_end = kCausal ? min(sk, q0 + kTcRows) : sk;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  cp_tile<kTcRows, D>(fsmem + L::q, q + qo, q0, sq);
  cp_tile<kKeys, D>(fsmem + L::kv, kb, 0, sk);
  cp_tile<kKeys, D>(fsmem + L::kv + kKeys * P, vb, 0, sk);
  cp_commit();
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const float* sQ = fsmem + L::q + (r0 - q0) * P;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      // the next tile into the other stage, free since the last sync
      float* nxt = fsmem + L::kv + ((t + 1) & 1) * L::stage;
      cp_tile<kKeys, D>(nxt, kb, (t + 1) * kKeys, sk);
      cp_tile<kKeys, D>(nxt + kKeys * P, vb, (t + 1) * kKeys, sk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile t has landed, for every thread
    const float* sK = fsmem + L::kv + (t & 1) * L::stage;
    const float* sV = sK + kKeys * P;
    const int k0 = t * kKeys;
    // S = Q K^T: 16 rows x 64 keys a warp, in registers
    float sc[kKeys / 8][4];
    mma_abt<D, kKeys>(sc, sQ, sK);
    float alpha[2];
    if ((kCausal && k0 + kKeys - 1 > r0) || k0 + kKeys > sk)
      softmax_tile<true, kCausal>(sc, m, l, alpha, r0, k0, sk, sl2);
    else
      softmax_tile<false, kCausal>(sc, m, l, alpha, r0, k0, sk, sl2);
    // O = alpha O + P V; p is not rounded, v being f32 (:137-139)
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];
    mma_xb<D, kKeys>(acc, sc, sV);
    __syncthreads();  // the stage may be refilled
  }
  // o = acc / l, and lse
  finish_rows(l, m, lse + static_cast<size_t>(bh) * sq, r0, sq);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] /= l[i >> 1];
  store_f32<D>(o + qo, acc, r0, sq);
}

// dq: a CTA owns 64 q rows of a batch*head (a warp 16) and streams K and
// V in tiles of 64 keys through a two-stage ring; shared memory in floats
template <int D>
struct DqF32 {
  static constexpr int P = D + 4;
  static constexpr int keys = 64;
  static constexpr int q = 0;                  // Q [64][P]
  static constexpr int dO = q + kTcRows * P;   // dO [64][P]
  static constexpr int kv = dO + kTcRows * P;  // stage s: K, V [keys][P]
  static constexpr int stage = 2 * keys * P;
  static constexpr size_t bytes = sizeof(float) * (kv + 2 * stage);
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int sq, int sk, float sl2, float scale) {
  using L = DqF32<D>;
  constexpr int P = L::P, kKeys = L::keys;
  extern __shared__ __align__(16) float fsmem[];
  const int bh = blockIdx.x;
  const int qt = static_cast<int>(blockIdx.y);
  // causal: the q tiles with the most KV tiles launch first
  const int q0 =
      (kCausal ? static_cast<int>(gridDim.y) - 1 - qt : qt) * kTcRows;
  const int r0 = q0 + 16 * (threadIdx.x >> 5);  // the warp's rows
  const size_t qo = static_cast<size_t>(bh) * sq * D;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  // causal: KV tiles past the q tile's last row are all masked
  const int kv_end = kCausal ? min(sk, q0 + kTcRows) : sk;
  const int n_kv = (kv_end + kKeys - 1) / kKeys;
  cp_tile<kTcRows, D>(fsmem + L::q, q + qo, q0, sq);
  cp_tile<kTcRows, D>(fsmem + L::dO, dout + qo, q0, sq);
  cp_tile<kKeys, D>(fsmem + L::kv, kb, 0, sk);
  cp_tile<kKeys, D>(fsmem + L::kv + kKeys * P, vb, 0, sk);
  cp_commit();
  // the rows' lse (in base 2) and delta; rows past the end get 0
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = r0 + frag_row(2 * h);
    const size_t at = static_cast<size_t>(bh) * sq + qp;
    lse2[h] = qp < sq ? lse[at] * kLog2e : 0.f;
    dl[h] = qp < sq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  const float* sQ = fsmem + L::q + (r0 - q0) * P;
  const float* sDO = fsmem + L::dO + (r0 - q0) * P;
  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      // the next tile into the other stage, free since the last sync
      float* nxt = fsmem + L::kv + ((t + 1) & 1) * L::stage;
      cp_tile<kKeys, D>(nxt, kb, (t + 1) * kKeys, sk);
      cp_tile<kKeys, D>(nxt + kKeys * P, vb, (t + 1) * kKeys, sk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile t has landed, for every thread
    const float* sK = fsmem + L::kv + (t & 1) * L::stage;
    const float* sV = sK + kKeys * P;
    const int k0 = t * kKeys;
    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[kKeys / 8][4], dps[kKeys / 8][4];
    mma_abt<D, kKeys>(s, sQ, sK);
    mma_abt<D, kKeys>(dps, sDO, sV);
    if ((kCausal && k0 + kKeys - 1 > r0) || k0 + kKeys > sk)
      dq_tile<true, kCausal>(s, dps, lse2, dl, r0, k0, sk, sl2, scale);
    else
      dq_tile<false, kCausal>(s, dps, lse2, dl, r0, k0, sk, sl2, scale);
    mma_xb<D, kKeys>(acc, dps, sK);  // dQ += dS K
    __syncthreads();  // the stage may be refilled
  }
  store_f32<D>(dq + qo, acc, r0, sq);
}

// dk/dv: a CTA owns 64 keys of a batch*head (a warp 16) and streams Q and
// dO in tiles of 64 rows (32 at D 128, where two D-wide accumulators fill
// the registers) with the rows' lse and delta through a two-stage ring;
// shared memory in floats
template <int D>
struct DkvF32 {
  static constexpr int P = D + 4;
  static constexpr int rows = D == 64 ? 64 : 32;
  static constexpr int k = 0;                  // K [64][P]
  static constexpr int v = k + kTcRows * P;    // V [64][P]
  // stage s: Q, dO [rows][P], lse * log2(e) [rows], delta [rows]
  static constexpr int ring = v + kTcRows * P;
  static constexpr int stage = 2 * rows * P + 2 * rows;
  static constexpr size_t bytes = sizeof(float) * (ring + 2 * stage);
};

// q rows [q0, q0 + rows) into stage `at` of the dk/dv ring: Q and dO by
// cp.async, lse (in base 2) and delta by the threads (rows past the end
// get 0)
template <int D>
__device__ __forceinline__ void dkv_stage(float* at, const float* q,
                                          const float* dout,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int sq) {
  using L = DkvF32<D>;
  cp_tile<L::rows, D>(at, q, q0, sq);
  cp_tile<L::rows, D>(at + L::rows * L::P, dout, q0, sq);
  float* sl = at + 2 * L::rows * L::P;
  for (int r = threadIdx.x; r < L::rows; r += kTcThreads) {
    const bool ok = q0 + r < sq;
    sl[r] = ok ? lse[q0 + r] * kLog2e : 0.f;
    sl[L::rows + r] = ok ? delta[q0 + r] : 0.f;
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    fa_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int sq, int sk, float sl2,
                   float scale) {
  using L = DkvF32<D>;
  constexpr int P = L::P, R = L::rows;
  extern __shared__ __align__(16) float fsmem[];
  const int bh = blockIdx.x;
  // key tiles in order: causal, the first see the most q tiles
  const int k0 = static_cast<int>(blockIdx.y) * kTcRows;
  const int key0 = k0 + 16 * (threadIdx.x >> 5);  // the warp's keys
  const size_t qo = static_cast<size_t>(bh) * sq * D;
  const size_t ko = static_cast<size_t>(bh) * sk * D;
  const float* lb = lse + static_cast<size_t>(bh) * sq;
  const float* db = delta + static_cast<size_t>(bh) * sq;
  // causal: q tiles that end before this key tile are all masked
  const int t0 = kCausal ? k0 / R : 0;
  const int n_t = (sq + R - 1) / R - t0;
  cp_tile<kTcRows, D>(fsmem + L::k, k + ko, k0, sk);
  cp_tile<kTcRows, D>(fsmem + L::v, v + ko, k0, sk);
  dkv_stage<D>(fsmem + L::ring, q + qo, dout + qo, lb, db, t0 * R, sq);
  cp_commit();
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
  const float* sK = fsmem + L::k + (key0 - k0) * P;
  const float* sV = fsmem + L::v + (key0 - k0) * P;
  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) {
      // the next tile into the other stage, free since the last sync
      dkv_stage<D>(fsmem + L::ring + ((t + 1) & 1) * L::stage, q + qo,
                   dout + qo, lb, db, (t0 + t + 1) * R, sq);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile t has landed, for every thread
    const float* sQ = fsmem + L::ring + (t & 1) * L::stage;
    const float* sDO = sQ + R * P;
    const float* sl = sDO + R * P;
    const int q0 = (t0 + t) * R;
    // S^T = K Q^T and dP^T = V dO^T: 16 keys x R q rows a warp
    float st[R / 8][4], dpt[R / 8][4];
    mma_abt<D, R>(st, sK, sQ);
    mma_abt<D, R>(dpt, sV, sDO);
    if ((kCausal && q0 < key0 + 16) || q0 + R > sq)
      dkv_tile<true, kCausal>(st, dpt, sl, sl + R, key0, q0, sq, sl2, scale);
    else
      dkv_tile<false, kCausal>(st, dpt, sl, sl + R, key0, q0, sq, sl2,
                               scale);
    mma_xb<D, R>(dv_acc, st, sDO);  // dV += P^T dO
    mma_xb<D, R>(dk_acc, dpt, sQ);  // dK += dS^T Q
    __syncthreads();  // the stage may be refilled
  }
  store_f32<D>(dk + ko, dk_acc, key0, sk);
  store_f32<D>(dv + ko, dv_acc, key0, sk);
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

// the kernel's dynamic shared memory limit, set once per instantiation
template <auto Kern>
cudaError_t smem_limit(size_t bytes) {
  static const cudaError_t e = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  return e;
}

template <auto Kern, typename... Args>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  const cudaError_t e = smem_limit<Kern>(smem);
  if (e != cudaSuccess) return e;
  Kern<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// SMs of the current device (read once): the persistent kernels' grid
int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <int D, bool kCausal>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* o, void* lse, int bh, int sq, int sk, float scale,
                cudaStream_t st) {
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    CUtensorMap tq, tk, tv;
    cudaError_t e = make_map(&tq, q, D, sq, bh, kFwdRows);
    if (e == cudaSuccess) e = make_map(&tk, k, D, sk, bh, kFwdKeys);
    if (e == cudaSuccess) e = make_map(&tv, v, D, sk, bh, kFwdKeys);
    if (e != cudaSuccess) return e;
    return launch<fa_fwd_wgmma<D, kCausal>>(
        dim3(min(bh * cdiv(sq, kFwdRows), sm_count())), kWsThreads,
        FwdLayout<D>::bytes, st, tq, tk, tv, static_cast<bf16*>(o), l, bh,
        sq, sk, scale * kLog2e);
  }
  return launch<fa_fwd_f32<D, kCausal>>(
      dim3(bh, cdiv(sq, kTcRows)), kTcThreads, FwdF32<D>::bytes, st,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), l, sq, sk,
      scale * kLog2e);
}

template <int D, bool kCausal>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, float scale,
                   cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1) {
    constexpr int kKeys = DqLayout<D>::keys;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t e = make_map(&tq, q, D, sq, bh, kFwdRows);
    if (e == cudaSuccess) e = make_map(&tdo, dout, D, sq, bh, kFwdRows);
    if (e == cudaSuccess) e = make_map(&tk, k, D, sk, bh, kKeys);
    if (e == cudaSuccess) e = make_map(&tv, v, D, sk, bh, kKeys);
    if (e != cudaSuccess) return e;
    return launch<fa_bwd_dq_wgmma<D, kCausal>>(
        dim3(min(bh * cdiv(sq, kFwdRows), sm_count())), kWsThreads,
        DqLayout<D>::bytes, st, tq, tk, tv, tdo, l, dl,
        static_cast<bf16*>(dq), bh, sq, sk, scale * kLog2e, scale);
  }
  return launch<fa_bwd_dq_f32<D, kCausal>>(
      dim3(bh, cdiv(sq, kTcRows)), kTcThreads, DqF32<D>::bytes, st,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
      static_cast<float*>(dq), sq, sk, scale * kLog2e, scale);
}

template <int D, bool kCausal>
cudaError_t bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, float scale,
                    cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1) {
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t e = make_map(&tq, q, D, sq, bh, kDkvRows);
    if (e == cudaSuccess) e = make_map(&tdo, dout, D, sq, bh, kDkvRows);
    if (e == cudaSuccess) e = make_map(&tk, k, D, sk, bh, kDkvKeys);
    if (e == cudaSuccess) e = make_map(&tv, v, D, sk, bh, kDkvKeys);
    if (e != cudaSuccess) return e;
    return launch<fa_bwd_dkv_wgmma<D, kCausal>>(
        dim3(min(bh * cdiv(sk, kDkvKeys), sm_count())), kWsThreads,
        DkvLayout<D>::bytes, st, tq, tk, tv, tdo, l, dl,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, sq, sk,
        scale * kLog2e, scale);
  }
  return launch<fa_bwd_dkv_f32<D, kCausal>>(
      dim3(bh, cdiv(sk, kTcRows)), kTcThreads, DkvF32<D>::bytes, st,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk,
      scale * kLog2e, scale);
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
