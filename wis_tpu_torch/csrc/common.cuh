// Device helpers shared by the kernels in this directory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wis {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A float's bits mapped so that unsigned order is the value's order (−0
// as +0, so that equal values compare equal), and back.
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

enum ReduceOp { kSum = 0, kMax = 1, kMin = 2 };

// Block-wide sum, max or min over a block of NW warps; every thread gets
// the same value. `red` holds NW floats; the leading barrier also
// publishes earlier shared writes.
template <int OP, int NW>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = OP == kSum ? warp_sum(v) : OP == kMax ? warp_max(v) : warp_min(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i)
    t = OP == kSum ? t + red[i] : OP == kMax ? fmaxf(t, red[i]) : fminf(t, red[i]);
  return t;
}

// Output columns of one product strip: a block owns kColTile columns of a
// (K, N) matrix, two threads per k-row (8 columns each).
constexpr int kColTile = 16;

// Sums the 16 k-rows a warp holds of one strip (lanes of equal parity
// hold the same column half) and lanes 0 and 1 write the two halves to
// dst[0, 16).
__device__ __forceinline__ void strip_warp_sum(float (&acc)[8], float* dst, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[j] = v;
  }
  if (lane < 2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[lane * 8 + j] = acc[j];
  }
}

// 8 bf16 in 16 bytes → 8 floats (element 0 in the low half of word 0).
__device__ __forceinline__ void bf16x8_to_float(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 int8 in one 32-bit word → 4 exact floats (byte 0 first): the byte,
// biased to unsigned, becomes the low mantissa byte of 2^23, and one
// subtract removes 2^23 and the bias.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

// 16 int8 in 16 bytes → 16 exact floats.
__device__ __forceinline__ void int8x16_to_float(uint4 v, float* f) {
  int8x4_to_float(v.x, f);
  int8x4_to_float(v.y, f + 4);
  int8x4_to_float(v.z, f + 8);
  int8x4_to_float(v.w, f + 12);
}

// D += A·B for one 16×8 tile: bf16 operands, f32 accumulators (the
// m16n8k16 fragment layout: lane = 4·g + t4 holds rows g and g + 8,
// columns 2·t4 and 2·t4 + 1).
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// two adjacent bf16 (4-byte aligned) as one fragment register
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of a row as floats: 4 f32 or 8 bf16 (element 0 first).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    v.x = pack_bf16(in[0], in[1]); v.y = pack_bf16(in[2], in[3]);
    v.z = pack_bf16(in[4], in[5]); v.w = pack_bf16(in[6], in[7]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// LayerNorm statistics of one row by one warp, as the TPU kernels take
// them: the mean, then the mean of squared deviations, eps, f32.
//
// Rows of up to kLnRegs 16-byte vectors a lane (1536 f32, 3072 bf16; d a
// multiple of the vector) are held in registers: ln_load issues every load
// of the row before the first reduction (v[j] holds columns
// (j·32 + lane)·N .. + N, zero past d), ln_stats reduces the registers.
// Wider rows take ln_stats_passes, two passes over the row.
constexpr int kLnRegs = 12;

template <typename T>
__device__ __forceinline__ void ln_load(const T* __restrict__ xr, int d, int lane,
                                        float (&v)[kLnRegs][Vec16<T>::N]) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int j = 0; j < kLnRegs; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      Vec16<T>::load(xr + c, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j][i] = 0.f;
    }
  }
}

template <int V>
__device__ __forceinline__ void ln_stats(const float (&v)[kLnRegs][V], int d, int lane, float eps,
                                         float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kLnRegs; ++j)
#pragma unroll
    for (int i = 0; i < V; i += 4) s += (v[j][i] + v[j][i + 1]) + (v[j][i + 2] + v[j][i + 3]);
  mean = warp_sum(s) / d;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kLnRegs; ++j) {
    if ((j * 32 + lane) * V < d) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float a0 = v[j][i] - mean, a1 = v[j][i + 1] - mean;
        const float a2 = v[j][i + 2] - mean, a3 = v[j][i + 3] - mean;
        ss += (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3);
      }
    }
  }
  rstd = rsqrtf(warp_sum(ss) / d + eps);
}

template <typename T>
__device__ __forceinline__ void ln_stats_passes(const T* __restrict__ xr, int d, int lane,
                                                float eps, float& mean, float& rstd) {
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
  mean = warp_sum(s) / d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = to_f32(xr[c]) - mean;
    ss += t * t;
  }
  rstd = rsqrtf(warp_sum(ss) / d + eps);
}

// LayerNorm of one f32 row by one warp (two passes, any width), eps 1e-5,
// affine; rounded once to bf16 and stored with stride `step`.
__device__ __forceinline__ void ln_row_bf16(const float* __restrict__ xr, const float* __restrict__ g,
                                            const float* __restrict__ b, int d,
                                            __nv_bfloat16* dst, int step, int lane) {
  float mean, rstd;
  ln_stats_passes(xr, d, lane, 1e-5f, mean, rstd);
  for (int c = lane; c < d; c += 32)
    dst[static_cast<size_t>(c) * step] = __float2bfloat16_rn((xr[c] - mean) * rstd * g[c] + b[c]);
}

// Asynchronous 16-byte copy global → shared (cp.async, L2 only), and its
// commit and wait: wait_group<N> returns once at most N of this thread's
// committed groups are still in flight.
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

// Asynchronous 4-byte copy global → shared (cp.async through L1): any
// 4-byte aligned address, for rows that 16-byte copies cannot take.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// ---- thread-block clusters -----------------------------------------------

constexpr int kMaxSplits = 8;  // blocks of one cluster (the portable size)

// Launches `kernel` with blocks of `threads` threads in clusters of
// `cluster` blocks along `axis` (1: y, 2: z) of the grid, which must hold a
// whole number of them.
template <typename... Args>
cudaError_t launch_clustered(void (*kernel)(Args...), dim3 grid, int threads, size_t smem,
                             int axis, int cluster, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = axis == 1 ? cluster : 1;
  attr[0].val.clusterDim.z = axis == 2 ? cluster : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace wis
