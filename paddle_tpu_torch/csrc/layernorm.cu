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
// Backward design: a fixed grid of CTAs (the wrapper picks it from the
// row count alone), each walking its rows in turn; every thread keeps
// its columns' values of one row in registers (up to 16 at H = 4096),
// so dy and s are read once and the two row means of the dx formula
// (:172-174) are two block reductions. Each CTA sums its rows' dw and
// db contributions in registers in a fixed order and writes one f32
// partial row of each; the wrapper sums the partials with one plain
// reduction, as `_ln_bwd_impl` sums its per-block partials outside the
// kernel (:217-218). No float atomics, so dw and db are the same from
// run to run. The GeLU epilogue's gradient follows `_gelu_grad`
// (:67-76); with a residual the sum's own cotangent ds is added in f32
// before dx is cast to dy's dtype (:175-179).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

constexpr int kPerThread = kMaxHidden / kThreads;  // columns per thread

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

template <typename T, bool kResidual, int kAct>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ ds,
                  const T* __restrict__ s, const float* __restrict__ w,
                  const float* __restrict__ b,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part,
                  int n, int h) {
  __shared__ float red[kThreads >> 5];
  float dw[kPerThread], db[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) dw[j] = db[j] = 0.f;

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * h;
    const float mu = mean[row], rs = rstd[row];
    float xhat[kPerThread], dxhat[kPerThread];
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      xhat[j] = dxhat[j] = 0.f;
      if (i < h) {
        const float xh = (to_f32(s[base + i]) - mu) * rs;
        float g = to_f32(dy[base + i]);
        if (kAct != 0) g *= activate_grad<kAct>(xh * w[i] + b[i]);
        dw[j] += g * xh;
        db[j] += g;
        xhat[j] = xh;
        dxhat[j] = g * w[i];
        p1 += dxhat[j];
        p2 += dxhat[j] * xh;
      }
    }
    const float m1 = block_sum(p1, red) / h;
    const float m2 = block_sum(p2, red) / h;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < h) {
        float v = rs * (dxhat[j] - m1 - xhat[j] * m2);
        if (kResidual) v += to_f32(ds[base + i]);
        dx[base + i] = from_f32<T>(v);
      }
    }
  }
  const size_t part = static_cast<size_t>(blockIdx.x) * h;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < h) {
      dw_part[part + i] = dw[j];
      db_part[part + i] = db[j];
    }
  }
}

template <typename T, bool kResidual>
void launch_bwd_act(int act, int grid, cudaStream_t st, const T* dy,
                    const T* ds, const T* s, const float* w, const float* b,
                    const float* mean, const float* rstd, T* dx, float* dwp,
                    float* dbp, int n, int h) {
  switch (act) {
    case 0:
      ln_bwd_kernel<T, kResidual, 0><<<grid, kThreads, 0, st>>>(
          dy, ds, s, w, b, mean, rstd, dx, dwp, dbp, n, h);
      break;
    case 1:
      ln_bwd_kernel<T, kResidual, 1><<<grid, kThreads, 0, st>>>(
          dy, ds, s, w, b, mean, rstd, dx, dwp, dbp, n, h);
      break;
    default:
      ln_bwd_kernel<T, kResidual, 2><<<grid, kThreads, 0, st>>>(
          dy, ds, s, w, b, mean, rstd, dx, dwp, dbp, n, h);
      break;
  }
}

template <typename T>
void launch_bwd(const void* dy, const void* ds, const void* s, const void* w,
                const void* b, const void* mean, const void* rstd, void* dx,
                void* dwp, void* dbp, int n, int h, int grid, int act,
                cudaStream_t st) {
  const T* dyt = static_cast<const T*>(dy);
  const T* st_ = static_cast<const T*>(s);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  const float* mt = static_cast<const float*>(mean);
  const float* rt = static_cast<const float*>(rstd);
  T* dxt = static_cast<T*>(dx);
  float* dwt = static_cast<float*>(dwp);
  float* dbt = static_cast<float*>(dbp);
  if (ds != nullptr) {
    launch_bwd_act<T, true>(act, grid, st, dyt, static_cast<const T*>(ds),
                            st_, wt, bt, mt, rt, dxt, dwt, dbt, n, h);
  } else {
    launch_bwd_act<T, false>(act, grid, st, dyt, nullptr, st_, wt, bt, mt,
                             rt, dxt, dwt, dbt, n, h);
  }
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

// dy, ds, s, dx: [n, h] in the dtype named by `dtype` (0 f32, 1 bf16),
// contiguous; ds is NULL without a residual. w, b: [h] f32; mean,
// rstd: [n] f32 (the forward's). dw_part, db_part: [grid, h] f32, one
// partial row per CTA, to be summed over the grid by the caller.
// Launches `grid` CTAs on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int ptt_layer_norm_bwd(const void* dy, const void* ds,
                                  const void* s, const void* w,
                                  const void* b, const void* mean,
                                  const void* rstd, void* dx, void* dw_part,
                                  void* db_part, int n, int h, int grid,
                                  int act, int dtype, void* stream) {
  if (h < 1 || h > kMaxHidden || act < 0 || act > 2 || n < 1 || grid < 1 ||
      grid > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(dy, ds, s, w, b, mean, rstd, dx, dw_part, db_part, n,
                      h, grid, act, st);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(dy, ds, s, w, b, mean, rstd, dx, dw_part,
                              db_part, n, h, grid, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
