// The epilogue of a product: bias, then optional GELU, then optional
// residual, in one pass — Hopper (sm_90a).
//
//   out = T(residual + T(act(T(f32(y) + f32(b)))))
//
// Replaces no TPU kernel: on the TPU, XLA fused this chain into the
// products it follows (wis_tpu/models/whisper/model.py `_linear`, `_mlp`,
// stem.py's convs). Without it the port ran the chain as separate PyTorch
// passes over f32 temporaries: three for the bias, about seventeen for the
// GELU polynomial, one for the residual, each reading and writing the
// whole (rows, N) tensor.
//
// Bound on the H100: device-memory bytes. Each element of y is read once
// (2 bytes bf16, 4 in the stem's f32 product), the residual once (2) and
// the output written once (2); the bias row stays in L1/L2. At the
// encoder's (B·1500, 5120) w1 product that is 4 bytes an element, 30.7 MB
// a window, 9.2 us at 3.35 TB/s. The design keeps to one pass: 8 elements
// a thread as 16-byte loads and stores (two for f32), neighbouring
// threads on neighbouring addresses; the bias read through the read-only
// path; a grid-stride loop over as many blocks as are resident on the
// card's SMs at once, each thread's bias column and residual offset
// stepped by the stride without a division; no allocation (the wrapper
// makes the output) and no synchronisation, so that it can be captured
// into a CUDA graph.
//
// Arithmetic: the plain PyTorch chain's (ops/bias_act.py
// `bias_act_plain`), op for op, each op rounded as PyTorch's separate
// kernels round it: __fadd_rn / __fmul_rn, so that nvcc contracts nothing
// into an FMA; the constants rounded double → float as PyTorch rounds a
// Python scalar; tanhf from CUDA's math library; the output type's
// rounding after the bias, after the GELU and after the residual.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::Vec16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread handles per step

// ops/gelu.py's constants, double → float as PyTorch rounds a Python float
constexpr float kC1 = static_cast<float>(7.97674780e-01);
constexpr float kC3 = static_cast<float>(3.67492532e-02);
constexpr float kC5 = static_cast<float>(-2.60437574e-04);
constexpr float kC7 = static_cast<float>(-8.21175498e-06);

// 8 consecutive elements (16 bytes of bf16, 32 of f32) as floats
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
#pragma unroll
  for (int i = 0; i < kVec; i += Vec16<T>::N) Vec16<T>::load(p + i, v + i);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
#pragma unroll
  for (int i = 0; i < kVec; i += Vec16<T>::N) Vec16<T>::store(p + i, v + i);
}

// v as T, back to float: what `.to(T)` leaves
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return wis::bf16_round(v); }

// ops/gelu.py `gelu` in f32, in its order of operations
__device__ __forceinline__ float gelu_poly(float x) {
  const float xc = x != x ? x : fminf(fmaxf(x, -6.f), 6.f);  // torch.clamp keeps a NaN
  const float u = __fmul_rn(xc, xc);
  float p = __fadd_rn(kC5, __fmul_rn(u, kC7));
  p = __fadd_rn(kC3, __fmul_rn(u, p));
  p = __fadd_rn(kC1, __fmul_rn(u, p));
  p = __fmul_rn(xc, p);
  const float y = __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(p)));
  return x > 6.f ? x : (x < -6.f ? 0.f : y);
}

// T: output and residual; Y: the product; B: the bias
template <typename T, typename Y, typename B>
__global__ void __launch_bounds__(kThreads, 4)
bias_act_kernel(const Y* __restrict__ y, const B* __restrict__ bias,
                const T* __restrict__ res, T* __restrict__ out, long long n, int cols,
                long long res_n, int gelu) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kVec;
  long long e = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (e >= n) return;
  // the bias column and residual offset of e, stepped by the stride
  int c = static_cast<int>(e % cols);
  const int c_step = static_cast<int>(stride % cols);
  long long r = res ? e % res_n : 0;
  const long long r_step = res ? stride % res_n : 0;
  for (; e < n; e += stride) {
    float v[kVec], b[kVec];
    load8(y + e, v);
    load8(bias + c, b);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = round_to<T>(__fadd_rn(v[i], b[i]));
    if (gelu) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = round_to<T>(gelu_poly(v[i]));
    }
    if (res) {
      float rv[kVec];
      load8(res + r, rv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = __fadd_rn(rv[i], v[i]);
      r += r_step;
      if (r >= res_n) r -= res_n;
    }
    store8(out + e, v);
    c += c_step;
    if (c >= cols) c -= cols;
  }
}

template <typename T, typename Y, typename B>
int launch(const void* y, const void* b, const void* res, void* out, long long n, int cols,
           long long res_n, int gelu, int sms, cudaStream_t s) {
  // as many blocks as stay resident at once: every block then walks the
  // same number of steps, with no second wave
  static const int per_sm = [] {
    int k = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, bias_act_kernel<T, Y, B>, kThreads, 0)
        != cudaSuccess || k < 1)
      k = 1;
    return k;
  }();
  const long long blocks = (n / kVec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < static_cast<long long>(per_sm) * sms
                                        ? blocks : static_cast<long long>(per_sm) * sms);
  bias_act_kernel<T, Y, B><<<grid, kThreads, 0, s>>>(
      static_cast<const Y*>(y), static_cast<const B*>(b), static_cast<const T*>(res),
      static_cast<T*>(out), n, cols, res_n, gelu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Y>
int by_bias(int b_dtype, const void* y, const void* b, const void* res, void* out, long long n,
            int cols, long long res_n, int gelu, int sms, cudaStream_t s) {
  if (b_dtype == 1)
    return launch<T, Y, __nv_bfloat16>(y, b, res, out, n, cols, res_n, gelu, sms, s);
  if (b_dtype == 0) return launch<T, Y, float>(y, b, res, out, n, cols, res_n, gelu, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16; the output (and residual) bf16 or
// f32, the product the output's type or f32, the bias either. n elements
// of y and out, rows of `cols` (cols a multiple of 8); res (nullable) holds
// res_n elements, a multiple of cols dividing n, repeated over the rows
// (positions over a batch); every pointer 16-byte aligned. The Python
// wrapper checks.
extern "C" int wis_bias_act(const void* y, const void* b, const void* res, void* out,
                            long long n, int cols, long long res_n, int gelu, int out_dtype,
                            int y_dtype, int b_dtype, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (out_dtype == 1 && y_dtype == 1)
    return by_bias<__nv_bfloat16, __nv_bfloat16>(b_dtype, y, b, res, out, n, cols, res_n, gelu,
                                                 sms, s);
  if (out_dtype == 1 && y_dtype == 0)
    return by_bias<__nv_bfloat16, float>(b_dtype, y, b, res, out, n, cols, res_n, gelu, sms, s);
  if (out_dtype == 0 && y_dtype == 0)
    return by_bias<float, float>(b_dtype, y, b, res, out, n, cols, res_n, gelu, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
