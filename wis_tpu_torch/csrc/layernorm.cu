// LayerNorm over the last axis, f32 statistics — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/layernorm.py `layer_norm_pallas`
// (body `_ln_kernel`): mean and variance in f32 (variance as the mean of
// squared deviations), eps, affine with f32 gamma/beta, output rounded to
// the input dtype.
//
// Bound on the H100: device-memory bytes. Each element is read once from
// HBM and written once (2 + 2 bytes in bf16); there is no reuse and no
// tensor-core work. The design keeps it to that: one warp per row, 16-byte
// vector loads and stores (8 bf16 or 4 f32 per lane per access), warp
// shuffles for the two reductions. The row's later passes (variance,
// normalize) re-read it from L1/L2 rather than HBM: a 1280-wide bf16 row
// is 2.5 KB.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::warp_sum;

constexpr int kWarpsPerBlock = 4;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  int rows, int d, float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  float v[V];

  float s = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    Vec<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[i];
  }
  const float mu = warp_sum(s) / d;

  float ss = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    Vec<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float t = v[i] - mu;
      ss += t * t;
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / d + eps);

  for (int c = lane * V; c < d; c += 32 * V) {
    Vec<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (v[i] - mu) * rstd * gamma[c + i] + beta[c + i];
    Vec<T>::store(yr + c, v);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d must be a multiple of 8 (bf16) or
// 4 (f32) and every pointer 16-byte aligned; the Python wrapper checks.
extern "C" int wis_layer_norm(const void* x, const void* gamma, const void* beta,
                              void* y, int rows, int d, float eps, int dtype,
                              void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    layer_norm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), rows, d, eps);
  } else if (dtype == 0) {
    layer_norm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(y), rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
