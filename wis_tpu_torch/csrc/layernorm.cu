// LayerNorm over the last axis, f32 statistics — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/layernorm.py `layer_norm_pallas`
// (body `_ln_kernel`): mean and variance in f32 (variance as the mean of
// squared deviations), eps, affine with f32 gamma/beta, output rounded to
// the input dtype.
//
// Bound on the H100: device-memory bytes. Each element is read once from
// HBM and written once (2 + 2 bytes in bf16); there is no reuse and no
// tensor-core work. The design keeps it to that: one warp per row, the
// row held in registers after one pass of 16-byte loads (a 1280-wide bf16
// row is 40 values a lane), every load of the row issued before the first
// reduction, the two statistics from registers by warp shuffles, gamma
// and beta read as float4, 16-byte stores. Rows wider than 12 vectors a
// lane (3072 bf16, 1536 f32) take the statistics in two passes and the
// affine in a third, re-reading the row from L1/L2. The decode steps'
// LayerNorm prologue (decode_step.cuh) shares the helpers (common.cuh).
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::Vec16;

// two rows per block: 750 blocks of 64 threads at 1500 rows, all resident at
// once on 132 SMs, no SM more than a row past the mean
constexpr int kWarpsPerBlock = 2;

// y[c .. c + N) = T(((v − mean)·rstd)·γ + β), γ and β read as float4
template <typename T>
__device__ __forceinline__ void affine_store(T* yr, const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int c, float* v,
                                             float mean, float rstd) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(gamma + c + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(beta + c + i));
    v[i] = (v[i] - mean) * rstd * g.x + b.x;
    v[i + 1] = (v[i + 1] - mean) * rstd * g.y + b.y;
    v[i + 2] = (v[i + 2] - mean) * rstd * g.z + b.z;
    v[i + 3] = (v[i + 3] - mean) * rstd * g.w + b.w;
  }
  Vec16<T>::store(yr + c, v);
}

// One row per warp. Rows of up to wis::kLnRegs vectors a lane stay in
// registers after one pass of 16-byte loads (wis::ln_load, every load
// issued before the first reduction); wider rows take the statistics in
// two passes and are read a third time for the affine.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y, int rows, int d, float eps) {
  constexpr int V = Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  float mean, rstd;
  if (d <= 32 * V * wis::kLnRegs) {
    float v[wis::kLnRegs][V];
    wis::ln_load(xr, d, lane, v);
    wis::ln_stats(v, d, lane, eps, mean, rstd);
#pragma unroll
    for (int j = 0; j < wis::kLnRegs; ++j) {
      const int c = (j * 32 + lane) * V;
      if (c < d) affine_store(yr, gamma, beta, c, v[j], mean, rstd);
    }
    return;
  }
  wis::ln_stats_passes(xr, d, lane, eps, mean, rstd);
  for (int c = lane * V; c < d; c += 32 * V) {
    float v[V];
    Vec16<T>::load(xr + c, v);
    affine_store(yr, gamma, beta, c, v, mean, rstd);
  }
}

template <typename T>
void launch(const void* x, const void* gamma, const void* beta, void* y, int rows, int d,
            float eps, cudaStream_t s) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  layer_norm_kernel<T><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), rows, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d must be a multiple of 8 (bf16) or
// 4 (f32) and every pointer 16-byte aligned; the Python wrapper checks.
extern "C" int wis_layer_norm(const void* x, const void* gamma, const void* beta,
                              void* y, int rows, int d, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__nv_bfloat16>(x, gamma, beta, y, rows, d, eps, s);
  } else if (dtype == 0) {
    launch<float>(x, gamma, beta, y, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
