// The decode-step building blocks shared by the Whisper step
// (fused_decode.cu) and the XTTS GPT step (fused_gpt.cu), so both launch
// the same code — Hopper (sm_90a):
//
//   int8_product_kernel   out = epilogue(bf16(src or LN(x)) · W_int8), one
//                         16-column strip of one (K, N) chunk per block;
//                         epilogues: store f32, gelu → bf16, add into the
//                         f32 residual, add with a deferred scale
//   self_attention_kernel one (head, row) per block over the time-major
//                         cache, with an explicit self column; writes the
//                         step's K/V column first
//
// The design notes are at the top of fused_decode.cu. Everything here has
// internal linkage: each translation unit that includes this header gets
// its own copy of the kernels, and the ctypes library links them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::bf16_round;
using wis::bf16x8_to_float;
using wis::block_reduce;
using wis::int8x4_to_float;
using wis::kColTile;
using wis::kMax;
using wis::kSum;
using wis::ln_row_bf16;
using wis::strip_warp_sum;
using wis::warp_sum;

constexpr float NEG = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kRowGroup = 8;            // activation rows staged per pass
constexpr int kKLanes = kThreads / 2;   // k rows in flight per block
constexpr int kMaxRows = 32;
constexpr size_t kSmemDefault = 48 * 1024;

enum Epilogue { kStoreF32 = 0, kGeluBf16 = 1, kResidual = 2, kResidualDeferred = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): the tanh formula, in its order
  const float c = 0.7978845608028654f;
  const float cdf = 0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

struct ProductArgs {
  const __nv_bfloat16* src;  // (rows, K) bf16 activations (no LN prologue)
  const float* x;            // (rows, K) f32 residual: the LN prologue's input
  const float* ln_g;
  const float* ln_b;
  const int8_t* w;           // chunk y at w + y·w_chunk, (K, N) row-major
  long long w_chunk;
  const float* s;            // chunk y's scales / biases at + y·sb_chunk
  const float* b;
  int sb_chunk;
  float* out_f32;            // kStoreF32: (rows, ld_out), column y·N + n
  __nv_bfloat16* out_bf16;   // kGeluBf16: the same, bf16
  int ld_out;
  float* xres;               // residual modes: (rows, N) f32, updated in place
  int rows, K, N;
};

// out[r, n] = epilogue(Σ_k bf16(src[r, k]) · w[k, n]). Grid (N / 16, chunks),
// dynamic shared memory 16·K bytes (the activations, [k][8] bf16).
template <int RB, int MODE, bool LN>
__global__ void __launch_bounds__(kThreads) int8_product_kernel(ProductArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* srcT = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float red[kWarps][kRowGroup][kColTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = tid & 1, kl = tid >> 1;
  const int chunk = blockIdx.y;
  const int n0 = blockIdx.x * kColTile;
  const int8_t* wp = p.w + chunk * p.w_chunk + n0 + 8 * half;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (int r0 = 0; r0 < p.rows; r0 += RB) {
    const int nr = min(RB, p.rows - r0);
    if (LN) {
      if (warp < nr) {
        ln_row_bf16(p.x + static_cast<size_t>(r0 + warp) * p.K, p.ln_g, p.ln_b, p.K,
                    srcT + warp, kRowGroup, lane);
      } else {
        for (int k = lane; k < p.K; k += 32) srcT[k * kRowGroup + warp] = zero;
      }
    } else {
      for (int i = tid; i < p.K * kRowGroup; i += kThreads) {
        const int r = i / p.K, k = i - r * p.K;
        srcT[k * kRowGroup + r] = r < nr ? p.src[static_cast<size_t>(r0 + r) * p.K + k] : zero;
      }
    }
    __syncthreads();

    float acc[RB][8];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll 4
    for (int k = kl; k < p.K; k += kKLanes) {
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(k) * p.N));
      float wf[8], sf[8];
      int8x4_to_float(wv.x, wf);
      int8x4_to_float(wv.y, wf + 4);
      bf16x8_to_float(*reinterpret_cast<const uint4*>(srcT + k * kRowGroup), sf);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(sf[r], wf[j], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) strip_warp_sum(acc[r], red[warp][r], lane);
    __syncthreads();
    if (tid < RB * kColTile) {
      const int r = tid / kColTile, c = tid % kColTile;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][r][c];
      if (r < nr) {
        const int row = r0 + r, n = n0 + c;
        const float sc = p.s[chunk * p.sb_chunk + n], bi = p.b[chunk * p.sb_chunk + n];
        const size_t o = static_cast<size_t>(row) * p.ld_out + chunk * p.N + n;
        if (MODE == kStoreF32) {
          p.out_f32[o] = sum * sc + bi;
        } else if (MODE == kGeluBf16) {
          p.out_bf16[o] = __float2bfloat16_rn(gelu_tanh(sum * sc + bi));
        } else if (MODE == kResidual) {
          float* xr = p.xres + static_cast<size_t>(row) * p.N + n;
          *xr = *xr + (sum * sc + bi);
        } else {
          float* xr = p.xres + static_cast<size_t>(row) * p.N + n;
          *xr = (*xr + sum * sc) + bi;
        }
      }
    }
    __syncthreads();  // srcT and red are rewritten by the next row group
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int RB, int MODE, bool LN>
cudaError_t launch_product_rb(const ProductArgs& p, int chunks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.K) * kRowGroup * sizeof(__nv_bfloat16);
  cudaError_t e = allow_smem(int8_product_kernel<RB, MODE, LN>, smem);
  if (e != cudaSuccess) return e;
  int8_product_kernel<RB, MODE, LN><<<dim3(p.N / kColTile, chunks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Rows per pass: BK itself up to 8 (no multiply-adds on padding rows),
// else passes of 8.
template <int MODE, bool LN>
cudaError_t launch_product(const ProductArgs& p, int chunks, cudaStream_t stream) {
  switch (p.rows < kRowGroup ? p.rows : kRowGroup) {
    case 1: return launch_product_rb<1, MODE, LN>(p, chunks, stream);
    case 2: return launch_product_rb<2, MODE, LN>(p, chunks, stream);
    case 3: return launch_product_rb<3, MODE, LN>(p, chunks, stream);
    case 4: return launch_product_rb<4, MODE, LN>(p, chunks, stream);
    case 5: return launch_product_rb<5, MODE, LN>(p, chunks, stream);
    case 6: return launch_product_rb<6, MODE, LN>(p, chunks, stream);
    case 7: return launch_product_rb<7, MODE, LN>(p, chunks, stream);
    default: return launch_product_rb<8, MODE, LN>(p, chunks, stream);
  }
}

// Self-attention of row r, head h (grid (H, BK)) over the time-major
// cache of one layer (D, BK·T): scores bf16(q)·K in f32 × scale where
// sel > 0, else -1e30; the self column q·k in f32; e = exp(s − m) rounded
// to bf16 for P·V while the denominator sums the f32 e. Writes this row's
// bf16 K/V column at pos·BK + r first. Columns that sel excludes (the
// one at pos among them) are never read. Dynamic shared: BK·T floats.
__global__ void __launch_bounds__(kThreads)
self_attention_kernel(const float* __restrict__ qkv, __nv_bfloat16* kc, __nv_bfloat16* vc,
                      const float* __restrict__ sel, __nv_bfloat16* __restrict__ out,
                      int bk, int D, int bkt, int pos, float scale) {
  extern __shared__ float scores[];
  __shared__ float qb[kHeadDim], vself[kHeadDim], qk[kHeadDim], red[kWarps];
  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = qkv + static_cast<size_t>(r) * 3 * D + h * kHeadDim;
  if (tid < kHeadDim) {
    const float q = row[tid], k = row[D + tid], v = row[2 * D + tid];
    qb[tid] = bf16_round(q);
    vself[tid] = v;
    qk[tid] = q * k;
    const size_t col = static_cast<size_t>(h * kHeadDim + tid) * bkt + pos * bk + r;
    kc[col] = __float2bfloat16_rn(k);
    vc[col] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  const float s_self = warp_sum(qk[lane] + qk[lane + 32]) * scale;

  const __nv_bfloat16* kh = kc + static_cast<size_t>(h) * kHeadDim * bkt;
  const __nv_bfloat16* vh = vc + static_cast<size_t>(h) * kHeadDim * bkt;
  const float* selr = sel + static_cast<size_t>(r) * bkt;
  float mx = NEG;
  for (int c = tid; c < bkt; c += kThreads) {
    float s = NEG;
    if (selr[c] > 0.f) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < kHeadDim; ++d)
        dot = fmaf(qb[d], __bfloat162float(kh[static_cast<size_t>(d) * bkt + c]), dot);
      s = dot * scale;
    }
    scores[c] = s;
    mx = fmaxf(mx, s);
  }
  const float m = fmaxf(block_reduce<kMax, kWarps>(mx, red), s_self);
  float sum = 0.f;
  for (int c = tid; c < bkt; c += kThreads) {
    const float e = expf(scores[c] - m);
    sum += e;
    scores[c] = bf16_round(e);
  }
  const float e_self = expf(s_self - m);
  const float denom = block_reduce<kSum, kWarps>(sum, red) + e_self;
  for (int d = warp; d < kHeadDim; d += kWarps) {
    float acc = 0.f;
    for (int c = lane; c < bkt; c += 32) {
      const float e = scores[c];
      if (e != 0.f) acc = fmaf(e, __bfloat162float(vh[static_cast<size_t>(d) * bkt + c]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0)
      out[static_cast<size_t>(r) * D + h * kHeadDim + d] =
          __float2bfloat16_rn((acc + e_self * vself[d]) / denom);
  }
}

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

}  // namespace
