// Blockwise int8 quantize and dequantize for Hopper (sm_90a): the wire
// format of the quantized gradient allreduce.
//
// Replaces: paddle_tpu/distributed/compress/kernels.py `_quant_i8_kernel`
// (:108), launched by `_quantize_pallas_i8` (:122), and
// `_dequant_i8_kernel` (:117), launched by `_dequantize_pallas_i8` (:142).
//
// What bounds it on an H100: memory. Quantize reads 4 bytes and writes 1
// byte an element, plus a 4-byte scale a block; dequantize reads 1 and
// writes 4. Each does a handful of operations an element, far below the
// f32 rate. GPT-2 345M's packed gradient (354,871,296 elements, block
// 1024) is 1.776 GB either way: 0.530 ms at 3.35 TB/s.
//
// Design. quantize_i8_kernel: one warp per scale block, kWarps warps per
// CTA, so a CTA needs nothing from another (the TPU kernel's grid step is
// one block too). A block is a multiple of 128 floats, so each lane reads
// block/128 float4s, neighbouring lanes on neighbouring 16 bytes. Blocks
// up to 1024 floats (8 float4s a lane) stay in registers between the
// abs-max and the encode, and all their loads are in flight at once;
// larger blocks are read a second time, from L2. The abs-max is a warp
// shuffle reduction; codes leave as char4, 4 bytes a lane.
// dequantize_i8_kernel: elementwise, one thread a group of 4 codes
// (char4 in, float4 out, one scale read a group; a group never
// straddles two blocks).
//
// Rounding: bit-identical to the plain version in PyTorch
// (paddle_tpu_torch/distributed/compress/kernels.py `quantize_ref`,
// `dequantize_ref`), which is bit-identical to the JAX package's eager
// `quantize_ref`:
//   - the abs-max propagates NaN (fmaxf alone would drop it);
//   - scale = amax > 0 ? amax / 127 : 1, a true division (NaN gives 1,
//     Inf gives inf). XLA under jit rewrites the division by a constant
//     as a multiplication by f32(1/127), one ulp away on some blocks; the
//     port keeps the division the source writes;
//   - code = clamp(rint(x / scale), -127, 127): a true division, rounded
//     half to even; a NaN quotient (a NaN element, 0/0, inf/inf) is code
//     0, written explicitly, since a float-to-int conversion of NaN is
//     not 0 on the card and fminf/fmaxf would clamp it to -127;
//   - dequantize is float(code) * scale, one rounding.
// Every division and multiplication is an explicitly rounded intrinsic,
// so nvcc cannot contract or approximate anything; no flag flushes
// subnormals.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // scale blocks a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVec = 8;             // float4s a lane kept in registers
constexpr int kDequantThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void absmax4(const float4 v, float& m,
                                        bool& nan) {
  const float a[4] = {fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    nan |= a[j] != a[j];
    m = fmaxf(m, a[j]);
  }
}

__device__ __forceinline__ signed char encode(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;
  return static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ char4 encode4(const float4 v, float scale) {
  return make_char4(encode(v.x, scale), encode(v.y, scale),
                    encode(v.z, scale), encode(v.w, scale));
}

__global__ void __launch_bounds__(kThreads)
quantize_i8_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                   float* __restrict__ scales, long long nblocks,
                   int block) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= nblocks) return;            // the whole warp leaves together
  const int nvec = block >> 7;         // float4s a lane
  const long long base = b * (block >> 2) + lane;  // in float4s
  float m = 0.f;
  bool nan = false;
  float4 v[kMaxVec];
  if (nvec <= kMaxVec) {
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      if (i < nvec) {
        v[i] = x[base + 32 * i];
        absmax4(v[i], m, nan);
      }
    }
  } else {
    for (int i = 0; i < nvec; ++i) absmax4(x[base + 32 * i], m, nan);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  nan = __any_sync(kFull, nan);
  const float scale = (!nan && m > 0.f) ? __fdiv_rn(m, 127.f) : 1.f;
  if (lane == 0) scales[b] = scale;
  if (nvec <= kMaxVec) {
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
      if (i < nvec) q[base + 32 * i] = encode4(v[i], scale);
  } else {
    for (int i = 0; i < nvec; ++i)
      q[base + 32 * i] = encode4(x[base + 32 * i], scale);
  }
}

// One thread a group of 4 codes. The index is 32-bit: the wrapper
// refuses 2^31 groups or more (34 GB of f32 out, more than the card).
__global__ void __launch_bounds__(kDequantThreads)
dequantize_i8_kernel(const char4* __restrict__ q,
                     const float* __restrict__ scales,
                     float4* __restrict__ out, unsigned groups,
                     unsigned block4) {
  const unsigned g = blockIdx.x * kDequantThreads + threadIdx.x;
  if (g >= groups) return;
  const char4 c = q[g];
  const float s = scales[g / block4];
  out[g] = make_float4(__fmul_rn(static_cast<float>(c.x), s),
                       __fmul_rn(static_cast<float>(c.y), s),
                       __fmul_rn(static_cast<float>(c.z), s),
                       __fmul_rn(static_cast<float>(c.w), s));
}

}  // namespace

// x: nblocks * block f32 (16-byte aligned) -> q: int8 codes, scales: f32
// (nblocks). block is a positive multiple of 128. Returns
// cudaGetLastError().
extern "C" int ptt_quantize_i8(const float* x, int8_t* q, float* scales,
                               long long nblocks, int block, void* stream) {
  if (nblocks <= 0 || block <= 0 || block % 128) return cudaErrorInvalidValue;
  const long long ctas = (nblocks + kWarps - 1) / kWarps;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  quantize_i8_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<char4*>(q),
      scales, nblocks, block);
  return static_cast<int>(cudaGetLastError());
}

// q: n int8 codes (4-byte aligned, n < 2^33), scales: n / block f32 ->
// out: n f32. Returns cudaGetLastError().
extern "C" int ptt_dequantize_i8(const int8_t* q, const float* scales,
                                 float* out, long long n, int block,
                                 void* stream) {
  if (n <= 0 || block <= 0 || block % 128 || n % block)
    return cudaErrorInvalidValue;
  const long long groups = n / 4;
  if (groups >= (1ll << 31)) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(
      (groups + kDequantThreads - 1) / kDequantThreads);
  dequantize_i8_kernel<<<grid, kDequantThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char4*>(q), scales,
      reinterpret_cast<float4*>(out), static_cast<unsigned>(groups),
      static_cast<unsigned>(block / 4));
  return static_cast<int>(cudaGetLastError());
}
