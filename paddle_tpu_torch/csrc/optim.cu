// Fused multi-tensor optimizer updates for Hopper (sm_90a): Adam / AdamW,
// SGD and Momentum (plain or Nesterov), each one launch over every
// parameter of an optimizer.
//
// Replaces: paddle_tpu/incubate/nn/pallas/optim.py `_adam_kernel` (:48),
// launched by `fused_adam_chunks` (:142); `_sgd_kernel` (:70), launched
// by `fused_sgd_chunks` (:170); `_momentum_kernel` (:79), launched by
// `fused_momentum_chunks` (:188).
//
// What bounds it on an H100: memory. Every element is read once and
// written once, in place. AdamW with an f32 master weight moves 28 bytes
// an element (master read and written 8, bf16 gradient 2, m and v read
// and written 16, bf16 parameter written 2), Momentum 20 and SGD 12,
// against about 15 floating-point operations for Adam: far below the ~20
// operations per byte where the f32 rate would take over. GPT-2 345M
// (354,871,296 elements) is 9.94 GB for AdamW, 2.97 ms at 3.35 TB/s.
//
// Design: a multi-tensor apply. The TPU kernel packs every tensor into
// one zero-padded (chunks, 256, 128) buffer, because a Pallas grid walks
// one array; that copies every tensor twice per step. Here nothing is
// packed: the wrapper passes a table of per-tensor entries (pointers,
// element count, per-tensor scalars) BY VALUE as the kernel's parameter
// (30 KB for 384 entries: CUDA 12.1 and later take up to 32,764 bytes of
// parameters on sm_70 and later), so a step costs no host-to-device
// copy, and one more launch follows only for a list of more than
// kMaxTensors tensors (BERT-base's 206 and GPT-2's 16 take one). An
// O2 model's bf16 parameters with f32 masters and its f32 LayerNorm
// parameters without masters are entries of the same table, so they go
// in the same launch. The grid walks (tensor, chunk) pairs: block b
// finds its tensor by a binary search over the table's first-chunk
// offsets and updates kChunk elements of it. Each thread moves 16 bytes
// of an f32 stream per access (float4; 4 bf16 values of a bf16 stream);
// a tensor's ragged end is a scalar tail, and a tensor whose pointers
// are not all vector-aligned (a view at an odd offset) takes a scalar
// path.
//
// Rounding: bit-identical to the plain per-tensor rule in PyTorch
// (paddle_tpu_torch/incubate/nn/kernels/optim.py). Every multiply, add,
// subtract, divide and square root is an explicitly rounded intrinsic,
// so nvcc cannot contract a*b + c into an FMA; the bias corrections are
// divided, never multiplied by a reciprocal (:61-64); the constants
// (1 - b1), (1 - b2) and AdamW's 1 - lr*wd are rounded to f32 on the
// host, as the rule forms them. Adam's beta powers are per-tensor f32
// scalars in device memory that every block of a tensor reads, so
// advancing them inside the main kernel would race: a one-block kernel
// advances them first, on the same stream. A bf16 parameter is
// re-derived from its f32 master (round to nearest even) in the same
// pass that writes the master.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt_optim {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kIters = 8;
constexpr int kChunk = kThreads * kVec * kIters;  // 8192 elements a block
constexpr int kMaxTensors = 384;

enum Kind { kSgd = 0, kMomentum = 1, kNesterov = 2, kAdam = 3 };
// entry flags
constexpr int kBaseBf16 = 1;  // the update base is a bf16 parameter
constexpr int kGradBf16 = 2;
constexpr int kAligned = 4;   // every pointer allows vector accesses

// The table's types are those of the C entry point, so they live
// outside the anonymous namespace: a function taking a type of internal
// linkage gets internal linkage too, and would not be exported.

// One tensor of the table; mirrored by ctypes in kernels/optim.py.
struct Entry {
  void* base;            // f32 master, or the parameter itself (f32, bf16)
  const void* grad;      // f32 or bf16
  float* m;              // Adam moment1, Momentum velocity
  float* v;              // Adam moment2
  __nv_bfloat16* half;   // bf16 parameter re-derived from the master
  float* pow1;           // Adam beta1^t and beta2^t (0-d f32)
  float* pow2;
  long long n;           // elements
  float decay;           // AdamW: 1 - lr*wd in f32; else 1
  float l2;              // coupled L2 coefficient; else 0
  int flags;
  int chunk0;            // this tensor's first chunk in the grid
};

struct Scalars {
  float lr, b1, b2, c1, c2, eps, mu;  // c1 = f32(1 - b1), c2 = f32(1 - b2)
  int kind;
};

struct Table {
  Scalars s;
  int count;
  int chunks;
  Entry t[kMaxTensors];
};
static_assert(sizeof(Entry) == 80, "Entry layout is shared with ctypes");
static_assert(sizeof(Scalars) == 32, "Scalars layout is shared with ctypes");
static_assert(sizeof(Table) <= 32764, "the table rides as a kernel parameter");

}  // namespace ptt_optim

namespace {

using namespace ptt_optim;

__device__ __forceinline__ void load4(const float* p, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint2 a;
  *reinterpret_cast<__nv_bfloat162*>(&a.x) =
      __halves2bfloat162(__float2bfloat16(x[0]), __float2bfloat16(x[1]));
  *reinterpret_cast<__nv_bfloat162*>(&a.y) =
      __halves2bfloat162(__float2bfloat16(x[2]), __float2bfloat16(x[3]));
  *reinterpret_cast<uint2*>(p) = a;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// The rule of one element, in the order of the plain per-tensor rule
// (and of optim.py:48-89). p is the f32 update base, g the f32 gradient.
template <int K>
__device__ __forceinline__ void rule(const Scalars& s, float decay, float l2,
                                     float d1, float d2, float& p, float g,
                                     float& m, float& v) {
  if (l2 != 0.f) g = __fadd_rn(g, __fmul_rn(l2, p));  // coupled L2
  if (K == kAdam) {
    if (decay != 1.f) p = __fmul_rn(p, decay);       // decoupled (AdamW)
    m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
    v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.c2, g), g));
    const float mhat = __fdiv_rn(m, d1);
    const float vhat = __fdiv_rn(v, d2);
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, mhat),
                               __fadd_rn(__fsqrt_rn(vhat), s.eps)));
  } else if (K == kSgd) {
    p = __fsub_rn(p, __fmul_rn(s.lr, g));
  } else {
    m = __fadd_rn(__fmul_rn(m, s.mu), g);
    const float step = K == kNesterov ? __fadd_rn(g, __fmul_rn(s.mu, m)) : m;
    p = __fsub_rn(p, __fmul_rn(s.lr, step));
  }
}

// Elements [start, end) of one tensor.
template <int K, typename PT, typename GT>
__device__ __forceinline__ void update_range(const Scalars& s, const Entry& e,
                                             float d1, float d2,
                                             long long start, long long end) {
  PT* __restrict__ p = static_cast<PT*>(e.base);
  const GT* __restrict__ g = static_cast<const GT*>(e.grad);
  float* __restrict__ m = e.m;
  float* __restrict__ v = e.v;
  __nv_bfloat16* __restrict__ h = e.half;
  constexpr bool kM = K != kSgd;
  constexpr bool kV = K == kAdam;
  long long first_scalar = start;
  if (e.flags & kAligned) {
    const long long nvec = (end - start) / kVec;
    for (long long j = threadIdx.x; j < nvec; j += kThreads) {
      const long long i = start + j * kVec;
      float pv[kVec], gv[kVec], mv[kVec] = {}, vv[kVec] = {};
      load4(p + i, pv);
      load4(g + i, gv);
      if (kM) load4(m + i, mv);
      if (kV) load4(v + i, vv);
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        rule<K>(s, e.decay, e.l2, d1, d2, pv[q], gv[q], mv[q], vv[q]);
      store4(p + i, pv);
      if (kM) store4(m + i, mv);
      if (kV) store4(v + i, vv);
      if (h != nullptr) store4(h + i, pv);
    }
    first_scalar = start + nvec * kVec;
  }
  for (long long i = first_scalar + threadIdx.x; i < end; i += kThreads) {
    float pv = load1(p + i), mv = 0.f, vv = 0.f;
    if (kM) mv = m[i];
    if (kV) vv = v[i];
    rule<K>(s, e.decay, e.l2, d1, d2, pv, load1(g + i), mv, vv);
    store1(p + i, pv);
    if (kM) m[i] = mv;
    if (kV) v[i] = vv;
    if (h != nullptr) store1(h + i, pv);
  }
}

// Largest i with t[i].chunk0 <= c: the tensor that holds chunk c (a
// zero-size tensor has no chunk, and the search passes over it).
__device__ __forceinline__ int find_tensor(const Table& T, int c) {
  int lo = 0, hi = T.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (T.t[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_optim_kernel(const __grid_constant__ Table T) {
  __shared__ Entry e;
  __shared__ float d[2];
  const int c = blockIdx.x;
  if (threadIdx.x == 0) {
    e = T.t[find_tensor(T, c)];
    if (K == kAdam) {  // this step's bias-correction denominators
      d[0] = __fsub_rn(1.f, *e.pow1);
      d[1] = __fsub_rn(1.f, *e.pow2);
    } else {
      d[0] = d[1] = 1.f;
    }
  }
  __syncthreads();
  const long long start = static_cast<long long>(c - e.chunk0) * kChunk;
  const long long end = start + kChunk < e.n ? start + kChunk : e.n;
  switch (e.flags & (kBaseBf16 | kGradBf16)) {
    case 0:
      update_range<K, float, float>(T.s, e, d[0], d[1], start, end);
      break;
    case kGradBf16:
      update_range<K, float, __nv_bfloat16>(T.s, e, d[0], d[1], start, end);
      break;
    case kBaseBf16:
      update_range<K, __nv_bfloat16, float>(T.s, e, d[0], d[1], start, end);
      break;
    default:
      update_range<K, __nv_bfloat16, __nv_bfloat16>(T.s, e, d[0], d[1], start,
                                                    end);
  }
}

// beta1^t *= b1, beta2^t *= b2 for every tensor of the table, before the
// main kernel reads them.
__global__ void advance_beta_pows_kernel(const __grid_constant__ Table T) {
  const int i = threadIdx.x;
  if (i < T.count) {
    *T.t[i].pow1 = __fmul_rn(*T.t[i].pow1, T.s.b1);
    *T.t[i].pow2 = __fmul_rn(*T.t[i].pow2, T.s.b2);
  }
}

}  // namespace

using namespace ptt_optim;

extern "C" int ptt_optim_entry_size() { return sizeof(Entry); }

extern "C" int ptt_optim_max_tensors() { return kMaxTensors; }

extern "C" int ptt_optim_chunk() { return kChunk; }

// One launch over `count` (1..kMaxTensors) table entries; Adam advances
// the beta powers first. Returns cudaGetLastError().
extern "C" int ptt_fused_optim(const Scalars* s, const Entry* entries,
                               int count, void* stream) {
  if (count < 1 || count > kMaxTensors) return cudaErrorInvalidValue;
  Table T;
  T.s = *s;
  T.count = count;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    T.t[i] = entries[i];
    T.t[i].chunk0 = static_cast<int>(chunks);
    chunks += (entries[i].n + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return cudaErrorInvalidValue;
  }
  T.chunks = static_cast<int>(chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s->kind == kAdam)
    advance_beta_pows_kernel<<<1, kMaxTensors, 0, st>>>(T);
  if (chunks > 0) {
    switch (s->kind) {
      case kSgd:
        multi_tensor_optim_kernel<kSgd><<<T.chunks, kThreads, 0, st>>>(T);
        break;
      case kMomentum:
        multi_tensor_optim_kernel<kMomentum><<<T.chunks, kThreads, 0, st>>>(T);
        break;
      case kNesterov:
        multi_tensor_optim_kernel<kNesterov><<<T.chunks, kThreads, 0, st>>>(T);
        break;
      case kAdam:
        multi_tensor_optim_kernel<kAdam><<<T.chunks, kThreads, 0, st>>>(T);
        break;
      default:
        return cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
