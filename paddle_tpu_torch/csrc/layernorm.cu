// Fused LayerNorm for Hopper (sm_90a): the forward, with an optional
// residual-add prologue and an optional GeLU epilogue, and its backward.
//
// Replaces: paddle_tpu/incubate/nn/pallas/layernorm.py `_ln_fwd_kernel`
// (:83), launched by `_ln_fwd_impl` (:113), and `_ln_bwd_kernel` (:156),
// launched by `_ln_bwd_impl` (:182), for `fused_layer_norm` and
// `fused_residual_layer_norm`.
//
// What bounds it on an H100: memory. Each element is read once (x, and
// the residual) and written once (y, and the sum s), against about ten
// floating-point operations, far below the ~20 operations per byte
// where the card's f32 rate would take over. A GPT-2 345M decode step
// calls it on 8 rows of 1024, so at serving shapes it is bounded by
// launch latency more than by either. The backward reads dy, s (and
// ds) and writes dx, again a few operations per byte.
//
// Forward design: one CTA of 256 threads per row, for any H up to
// 4096. The row is read from device memory once, widened to f32 and
// kept in shared memory (16 KB at H = 4096), so the mean pass, the
// variance pass and the output pass never re-read it. Reductions are
// warp shuffles followed by one exchange of per-warp partials.
// Statistics are f32: mean, then the variance as mean((s - mean)^2) as
// the TPU kernel does (:100-102), then rstd = rsqrt(var + eps). With a
// residual, s = x + residual is rounded to the INPUT dtype before the
// statistics, exactly as the unfused `x + residual` would be (:86-91),
// and written out as the next block's residual. The mean and rstd of
// every row are written as f32 for the backward kernel.
//
// Backward design: the bound is the bytes (dy, s, ds read, dx written:
// 33.5 MB at the training shape, 4096 rows of 1024 bf16 with a
// residual), so the kernel aims at bytes in flight and few instructions
// a byte. A lane owns one or two 16-byte vectors of a row (8 bf16 or 4
// f32 columns each), so one warp owns a row of up to 512 bf16 (256 f32)
// columns, and wider rows are shared by 2 to 16 warps that exchange
// their two sums once through shared memory (one named barrier of the
// row's warps); the row's two means (:172-174) are one shuffle tree for
// both, with no CTA barrier. The vectors a lane are a template
// parameter, so registers are sized for the hidden size run. Each warp
// stages its rows through a two-row ring in shared memory with
// cp.async, its next row's loads issued before the current row is
// reduced; the grid is persistent (as many CTAs of 16 warps as fit on
// the card: one an SM at the training shape, so one partial row stands
// for 16 warps' rows). w and b are staged once a CTA in shared memory
// while the first rows load. A hidden size that is no multiple of the
// vector, or a row tensor that is not 16-byte aligned, takes the same
// kernel one element at a time, reading global memory directly. Each
// thread sums its columns' dw and db over its rows in registers; at the
// end the CTA adds its warps' sums in a fixed order in shared memory
// and writes one partial row [dw | db], and a second small kernel
// (`ln_bwd_sum`) adds the partial rows in a fixed order, as
// `_ln_bwd_impl` sums its per-block partials outside the kernel
// (:217-218). No float atomics, so dw and db are the same from run to
// run. The GeLU epilogue's gradient follows `_gelu_grad` (:67-76); with
// a residual the sum's own cotangent ds is added in f32 before dx is
// cast to dy's dtype (:175-179).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHidden = 4096;

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
  return __float2bfloat16(v);  // round to nearest even
}

// Sum over the CTA; every thread gets the total. `red` holds one
// partial per warp and is free again when this returns.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (kThreads >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();
  return t;
}

// kAct: 0 none, 1 tanh GeLU (jax.nn.gelu's default), 2 erf GeLU
template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if (kAct == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (kAct == 2) return 0.5f * v * (1.f + erff(v / 1.4142135623730951f));
  return v;
}

template <typename T, bool kResidual, int kAct>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ w, const float* __restrict__ b,
                  T* __restrict__ y, T* __restrict__ s_out,
                  float* __restrict__ mean, float* __restrict__ rstd, int h,
                  float eps) {
  extern __shared__ float row[];  // h values of s, widened to f32
  __shared__ float red[kThreads >> 5];
  const size_t base = static_cast<size_t>(blockIdx.x) * h;

  float part = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    T v = x[base + i];
    if (kResidual) {
      // one rounding of the exact sum, in the input dtype
      v = from_f32<T>(to_f32(v) + to_f32(res[base + i]));
      s_out[base + i] = v;
    }
    const float f = to_f32(v);
    row[i] = f;
    part += f;
  }
  const float mu = block_sum(part, red) / h;

  part = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float d = row[i] - mu;
    part += d * d;
  }
  const float var = block_sum(part, red) / h;
  const float rs = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float xhat = (row[i] - mu) * rs;
    y[base + i] = from_f32<T>(activate<kAct>(xhat * w[i] + b[i]));
  }
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd[blockIdx.x] = rs;
  }
}

template <typename T, bool kResidual>
void launch_act(int act, dim3 grid, size_t smem, cudaStream_t st,
                const T* x, const T* res, const float* w, const float* b,
                T* y, T* s, float* mean, float* rstd, int h, float eps) {
  switch (act) {
    case 0:
      ln_fwd_kernel<T, kResidual, 0><<<grid, kThreads, smem, st>>>(
          x, res, w, b, y, s, mean, rstd, h, eps);
      break;
    case 1:
      ln_fwd_kernel<T, kResidual, 1><<<grid, kThreads, smem, st>>>(
          x, res, w, b, y, s, mean, rstd, h, eps);
      break;
    default:
      ln_fwd_kernel<T, kResidual, 2><<<grid, kThreads, smem, st>>>(
          x, res, w, b, y, s, mean, rstd, h, eps);
      break;
  }
}

template <typename T>
void launch(const void* x, const void* res, const void* w, const void* b,
            void* y, void* s, void* mean, void* rstd, int n, int h,
            float eps, int act, cudaStream_t st) {
  const dim3 grid(n);
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  float* mt = static_cast<float*>(mean);
  float* rt = static_cast<float*>(rstd);
  if (res != nullptr) {
    launch_act<T, true>(act, grid, smem, st, xt, static_cast<const T*>(res),
                        wt, bt, static_cast<T*>(y), static_cast<T*>(s), mt,
                        rt, h, eps);
  } else {
    launch_act<T, false>(act, grid, smem, st, xt, nullptr, wt, bt,
                         static_cast<T*>(y), nullptr, mt, rt, h, eps);
  }
}

// -- backward ------------------------------------------------------------

constexpr int kBwdThreads = 512;  // 16 warps a CTA
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdStages = 2;  // a warp's rows in shared memory: this, next

// d activate<kAct>(v) / dv, as `_gelu_grad` computes it (:67-76)
template <int kAct>
__device__ __forceinline__ float activate_grad(float v) {
  if (kAct == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float t = tanhf(c * (v + 0.044715f * v * v * v));
    const float du = c * (1.f + 0.134145f * v * v);  // 3 * 0.044715
    return 0.5f * (1.f + t) + 0.5f * v * (1.f - t * t) * du;
  }
  if (kAct == 2) {
    const float cdf = 0.5f * (1.f + erff(v / 1.4142135623730951f));
    const float pdf = expf(-0.5f * v * v) / 2.5066282746310002f;
    return cdf + v * pdf;
  }
  return 1.f;
}

// VW contiguous values of T at p, widened to f32: one 16-byte access
// when VW * sizeof(T) is 16, else one element
template <typename T, int VW>
__device__ __forceinline__ void load_vec(float (&o)[VW], const T* p) {
  if constexpr (VW == 1) {
    o[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
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

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VW]) {
  if constexpr (VW == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b2 =
          __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // RNE
      u[i] = *reinterpret_cast<const uint32_t*>(&b2);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// VW f32 values of a shared row (w or b) at p
template <int VW>
__device__ __forceinline__ void load_f32(float (&o)[VW], const float* p) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VW; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x;
      o[i + 1] = v.y;
      o[i + 2] = v.z;
      o[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) o[i] = p[i];
  }
}

// 16 bytes from global to shared memory, asynchronously, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the `count` threads of the warps sharing a row meet at barrier `id`
__device__ __forceinline__ void row_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared memory of the backward kernel, in bytes: w and b (`wb` floats
// each), then, per warp, a ring of kBwdStages rows of dy, s (and ds), kV
// 16-byte vectors a lane each (vector path only); the ring's space then
// holds the CTA's per-group dw and db sums.
__host__ __device__ constexpr int bwd_wb(int h) { return (h + 3) & ~3; }

template <bool kResidual, int VW, int kV>
__host__ __device__ constexpr int bwd_ring_bytes() {
  return VW == 1 ? 0
                 : kBwdWarps * kBwdStages * (kResidual ? 3 : 2) * kV * 32 *
                       16;
}

// the most any instantiation takes: 128 KB at h = 4096 (32 KB of w and
// b, a 96 KB ring)
constexpr int kBwdMaxSmem = 128 * 1024;

template <bool kResidual, int VW, int kV>
size_t bwd_smem(int h, int wpr) {
  const size_t sums = sizeof(float) * 2 * (kBwdWarps / wpr) * h;
  const size_t ring = bwd_ring_bytes<kResidual, VW, kV>();
  return sizeof(float) * 2 * bwd_wb(h) + (ring > sums ? ring : sums);
}

// One row is shared by `wpr` warps (a group; kBwdWarps / wpr groups a
// CTA); lane `lane` of the group's warp `wig` owns columns
// ((j * wpr + wig) * 32 + lane) * VW + [0, VW) for j < kV, so each warp
// access covers 32 neighbouring 16-byte vectors. Groups walk rows
// blockIdx.x * groups + grp, then every gridDim.x * groups; the grid is
// persistent (as many CTAs as fit on the card at once).
template <typename T, bool kResidual, int kAct, int VW, int kV>
__global__ void __launch_bounds__(kBwdThreads)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ ds,
                  const T* __restrict__ s, const float* __restrict__ w,
                  const float* __restrict__ b,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ part, int n, int h, int wpr) {
  constexpr bool kAsync = VW > 1;  // 16-byte vectors staged by cp.async
  constexpr int kArrays = kResidual ? 3 : 2;  // dy, s (, ds) in the ring
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][kBwdWarps][2];  // p1, p2 a warp, by row parity
  float* sW = smem;
  float* sB = smem + bwd_wb(h);
  auto* ring = reinterpret_cast<unsigned char*>(smem + 2 * bwd_wb(h));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kBwdWarps / wpr;
  const int grp = warp / wpr, wig = warp % wpr;
  unsigned char* wring =
      ring + warp * (bwd_ring_bytes<kResidual, VW, kV>() / kBwdWarps);
  // this lane's 16 bytes of array a, vector j, ring stage st: a lane
  // reads back only what its own cp.async wrote
  auto staged = [&](int st, int a, int j) {
    return reinterpret_cast<T*>(
        wring + (((st * kArrays + a) * kV + j) * 32 + lane) * 16);
  };
  auto col = [&](int j) { return ((j * wpr + wig) * 32 + lane) * VW; };
  auto issue = [&](int row, int st) {
    const size_t base = static_cast<size_t>(row) * h;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = col(j);
      if (c < h) {
        cp_async16(staged(st, 0, j), dy + base + c);
        cp_async16(staged(st, 1, j), s + base + c);
        if (kResidual) cp_async16(staged(st, 2, j), ds + base + c);
      }
    }
  };

  float dw[kV][VW], db[kV][VW];
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int e = 0; e < VW; ++e) dw[j][e] = db[j][e] = 0.f;

  // the first row's loads go out before w and b are staged
  const int stride = gridDim.x * groups;
  int row = blockIdx.x * groups + grp;
  if (kAsync && row < n) issue(row, 0);
  if (kAsync) cp_async_commit();
  float mu_next = row < n ? mean[row] : 0.f;
  float rs_next = row < n ? rstd[row] : 0.f;
  for (int i = threadIdx.x; i < h; i += kBwdThreads) {
    sW[i] = w[i];
    sB[i] = b[i];
  }
  __syncthreads();
  for (int k = 0; row < n; ++k, row += stride) {
    // the next row's loads go out before this row is reduced
    const int next = row + stride;
    const float mu = mu_next, rs = rs_next;
    if (next < n) {
      if (kAsync) issue(next, (k + 1) % kBwdStages);
      mu_next = mean[next];
      rs_next = rstd[next];
    }
    if (kAsync) {
      cp_async_commit();
      cp_async_wait<kBwdStages - 1>();  // this row's group has landed
    }
    const int st = k % kBwdStages;
    const size_t base = static_cast<size_t>(row) * h;

    // pass 1: the row's two means (:172-174), and dw, db
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = col(j);
      if (c >= h) continue;
      float sv[VW], gv[VW], wv[VW], bv[VW];
      if constexpr (kAsync) {
        load_vec<T, VW>(sv, staged(st, 1, j));
        load_vec<T, VW>(gv, staged(st, 0, j));
      } else {
        load_vec<T, VW>(sv, s + base + c);
        load_vec<T, VW>(gv, dy + base + c);
      }
      load_f32<VW>(wv, sW + c);
      if (kAct != 0) load_f32<VW>(bv, sB + c);
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xh = (sv[e] - mu) * rs;
        float g = gv[e];
        if (kAct != 0) g *= activate_grad<kAct>(xh * wv[e] + bv[e]);
        dw[j][e] += g * xh;
        db[j][e] += g;
        const float dxh = g * wv[e];
        p1 += dxh;
        p2 += dxh * xh;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      p2 += __shfl_xor_sync(0xffffffffu, p2, o);
    }
    if (wpr > 1) {  // the row's warps exchange their sums once
      if (lane == 0) {
        red[k & 1][warp][0] = p1;
        red[k & 1][warp][1] = p2;
      }
      row_barrier(1 + grp, wpr * 32);
      p1 = p2 = 0.f;
      for (int i = 0; i < wpr; ++i) {
        p1 += red[k & 1][grp * wpr + i][0];
        p2 += red[k & 1][grp * wpr + i][1];
      }
    }
    const float m1 = p1 / h, m2 = p2 / h;

    // pass 2: dx = rstd * (dxhat - m1 - xhat * m2) (+ ds), cast once
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int c = col(j);
      if (c >= h) continue;
      float sv[VW], gv[VW], wv[VW], bv[VW], rv[VW];
      if constexpr (kAsync) {
        load_vec<T, VW>(sv, staged(st, 1, j));
        load_vec<T, VW>(gv, staged(st, 0, j));
        if (kResidual) load_vec<T, VW>(rv, staged(st, 2, j));
      } else {
        load_vec<T, VW>(sv, s + base + c);
        load_vec<T, VW>(gv, dy + base + c);
        if (kResidual) load_vec<T, VW>(rv, ds + base + c);
      }
      load_f32<VW>(wv, sW + c);
      if (kAct != 0) load_f32<VW>(bv, sB + c);
      float out[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xh = (sv[e] - mu) * rs;
        float g = gv[e];
        if (kAct != 0) g *= activate_grad<kAct>(xh * wv[e] + bv[e]);
        float v = rs * (g * wv[e] - m1 - xh * m2);
        if (kResidual) v += rv[e];
        out[e] = v;
      }
      store_vec<T, VW>(dx + base + c, out);
    }
  }

  // the CTA's dw and db: each group's sums, then the groups added in a
  // fixed order into one partial row [dw | db] of `part`
  if (kAsync) cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring
  float* sums = smem + 2 * bwd_wb(h);  // [groups][2][h]
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int c = col(j) + e;
      if (c < h) {
        sums[(grp * 2) * h + c] = dw[j][e];
        sums[(grp * 2 + 1) * h + c] = db[j][e];
      }
    }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * h; c += kBwdThreads) {
    const int a = c >= h ? 1 : 0;
    float v = 0.f;
#pragma unroll 8
    for (int g = 0; g < groups; ++g) v += sums[(g * 2 + a) * h + c - a * h];
    part[static_cast<size_t>(blockIdx.x) * 2 * h + c] = v;
  }
}

// out[c] = sum over the `rows` partial rows of part[r][c], in a fixed
// order: a CTA takes 32 columns in 32 row slices, each slice's rows in 4
// interleaved sums (loads in flight), then lane c of the first warp adds
// column c's slices in order
constexpr int kSumThreads = 1024;

__global__ void __launch_bounds__(kSumThreads)
    ln_bwd_sum(const float* __restrict__ part, float* __restrict__ out,
               int rows, int cols) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float v4[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < cols) {
    int r = k;
    for (; r + 96 < rows; r += 128)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v4[i] += part[static_cast<size_t>(r + 32 * i) * cols + c];
    for (; r < rows; r += 32)
      v4[0] += part[static_cast<size_t>(r) * cols + c];
  }
  red[k][lane] = (v4[0] + v4[1]) + (v4[2] + v4[3]);
  __syncthreads();
  if (k == 0 && c < cols) {
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) s4[i & 3] += red[i][lane];
    out[c] = (s4[0] + s4[1]) + (s4[2] + s4[3]);
  }
}

int sm_count() {  // SMs of the current device, read once
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

struct BwdArgs {
  const void *dy, *ds, *s, *w, *b, *mean, *rstd;
  void *dx, *part, *out;
  int n, h, grid;
  cudaStream_t st;
  int* groups;  // plan only: rows a CTA works on at once
  int* ctas;    // plan only: CTAs resident on the card at once
};

// plan (a.groups set) or launch one instantiation with `wpr` warps a row
template <typename T, bool kResidual, int kAct, int VW, int kV>
cudaError_t bwd_run(const BwdArgs& a, int wpr) {
  auto* const kern = &ln_bwd_kernel<T, kResidual, kAct, VW, kV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = bwd_smem<kResidual, VW, kV>(a.h, wpr);
  if (smem > kBwdMaxSmem) return cudaErrorInvalidValue;
  const int groups = kBwdWarps / wpr;
  if (a.groups != nullptr) {
    int occ = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kern, kBwdThreads, smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    *a.groups = groups;
    *a.ctas = occ * sm_count();
    return cudaSuccess;
  }
  if (a.grid < 1 || a.grid > cdiv(a.n, groups))
    return cudaErrorInvalidValue;
  kern<<<a.grid, kBwdThreads, smem, a.st>>>(
      static_cast<const T*>(a.dy), static_cast<const T*>(a.ds),
      static_cast<const T*>(a.s), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.mean),
      static_cast<const float*>(a.rstd), static_cast<T*>(a.dx),
      static_cast<float*>(a.part), a.n, a.h, wpr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ln_bwd_sum<<<cdiv(2 * a.h, 32), kSumThreads, 0, a.st>>>(
      static_cast<const float*>(a.part), static_cast<float*>(a.out), a.grid,
      2 * a.h);
  return cudaGetLastError();
}

// the instantiation for h: 16-byte vectors (`vec`), at most 2 a lane, so
// a warp spans 32 * VW * 2 columns (bf16 512, f32 256), else one element
// at a time, 8 a lane (256 columns); as many warps a row (1, 2, 4, 8,
// 16) as the row needs. At the training shape (1024 bf16) two warps
// share a row: each pair walks about 4 rows, so loads and stores
// overlap, where one warp a row with 4 vectors a lane walks 2 (slower,
// as are 4 warps a row; PERF.md)
template <typename T, bool kResidual, int kAct>
cudaError_t bwd_shape(const BwdArgs& a, bool vec) {
  constexpr int VW = 16 / static_cast<int>(sizeof(T));
  int wpr = 1;
  if (vec) {
    while (32 * VW * 2 * wpr < a.h) wpr *= 2;
    if (32 * VW * wpr >= a.h)
      return bwd_run<T, kResidual, kAct, VW, 1>(a, wpr);
    return bwd_run<T, kResidual, kAct, VW, 2>(a, wpr);
  }
  while (32 * 8 * wpr < a.h) wpr *= 2;
  return bwd_run<T, kResidual, kAct, 1, 8>(a, wpr);
}

template <typename T, bool kResidual>
cudaError_t bwd_act(const BwdArgs& a, int act, bool vec) {
  if (act == 0) return bwd_shape<T, kResidual, 0>(a, vec);
  if (act == 1) return bwd_shape<T, kResidual, 1>(a, vec);
  return bwd_shape<T, kResidual, 2>(a, vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t bwd(const BwdArgs& a, int act, int dtype, bool residual,
                bool vec) {
  if (a.h < 1 || a.h > kMaxHidden || act < 0 || act > 2 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  // the 16-byte path needs whole vectors in every row and aligned rows
  const int vw = dtype == 0 ? 4 : 8;
  if (vec && (a.h % vw != 0 ||
              (a.groups == nullptr &&
               !(aligned16(a.dy) && aligned16(a.s) && aligned16(a.dx) &&
                 (!residual || aligned16(a.ds))))))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return residual ? bwd_act<float, true>(a, act, vec)
                    : bwd_act<float, false>(a, act, vec);
  return residual ? bwd_act<__nv_bfloat16, true>(a, act, vec)
                  : bwd_act<__nv_bfloat16, false>(a, act, vec);
}

}  // namespace

// x, res, y, s: [n, h] in the dtype named by `dtype` (0 f32, 1 bf16),
// contiguous; res and s are NULL without a residual. w, b: [h] f32.
// mean, rstd: [n] f32. Launches on `stream`, allocates nothing, does
// not synchronise; returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd(const void* x, const void* res,
                                  const void* w, const void* b, void* y,
                                  void* s, void* mean, void* rstd, int n,
                                  int h, float eps, int act, int dtype,
                                  void* stream) {
  if (h < 1 || h > kMaxHidden || act < 0 || act > 2 || n < 0 ||
      (res == nullptr) != (s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, res, w, b, y, s, mean, rstd, n, h, eps, act, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, res, w, b, y, s, mean, rstd, n, h, eps, act,
                          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's launch plan for hidden size h: `groups`, the rows a
// CTA works on at once, and `ctas`, the CTAs that fit on the card at
// once (the persistent grid's most). `residual` says whether ds is
// given; `vec` asks for the 16-byte path (h a multiple of 8 bf16 or 4
// f32 values, every row tensor 16-byte aligned). Returns a cudaError_t.
extern "C" int ptt_layer_norm_bwd_plan(int h, int act, int dtype,
                                       int residual, int vec, int* groups,
                                       int* ctas) {
  if (groups == nullptr || ctas == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.h = h;
  a.groups = groups;
  a.ctas = ctas;
  return static_cast<int>(bwd(a, act, dtype, residual != 0, vec != 0));
}

// dy, ds, s, dx: [n, h] in the dtype named by `dtype` (0 f32, 1 bf16),
// contiguous; ds is NULL without a residual. w, b: [h] f32; mean,
// rstd: [n] f32 (the forward's). part: [grid, 2h] f32 scratch, one
// partial row [dw | db] per CTA; dwdb: [2h] f32, dw then db, their sum
// over the grid. `grid` is at most what ptt_layer_norm_bwd_plan allows
// (ctas, and no more CTAs than ceil(n / groups)); `vec` as there.
// Launches the row kernel and the partials' sum on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
extern "C" int ptt_layer_norm_bwd(const void* dy, const void* ds,
                                  const void* s, const void* w,
                                  const void* b, const void* mean,
                                  const void* rstd, void* dx, void* part,
                                  void* dwdb, int n, int h, int grid,
                                  int act, int dtype, int vec,
                                  void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{dy,   ds, s,    w, b, mean, rstd, dx, part, dwdb,
            n,    h,  grid, static_cast<cudaStream_t>(stream),
            nullptr, nullptr};
  return static_cast<int>(bwd(a, act, dtype, ds != nullptr, vec != 0));
}
