// The decode step's head: final LayerNorm, logits over the vocabulary,
// per-beam top-k and logsumexp — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/fused_logits.py
// `build_fused_logits_topk` (without its timestamp-grammar mode):
//
//   xn       = bf16(LN(x))                               (BK, D)
//   dot      = xn · emb^T  (× the per-row int8 scale)    (BK, V) f32
//   logits   = dot + sup;  lse over logits, or over dot with full_lse
//   top-k of logits per row, ties to the lower token id
//
// Bound on the H100: device-memory bytes — the (V, D) embedding is read
// once (133 MB bf16, 66 MB int8 on large-v2) and nothing of size V is
// written. Two kernels: the first spreads the vocabulary over blocks of
// 128 rows (406 blocks at V = 51865); each block normalizes x itself into
// shared memory, gives one warp to a vocabulary row at a time (16-byte
// loads along D, all BK rows against the loaded vector), keeps the chunk's
// logits in shared memory, and writes only the chunk's top-k candidates
// and its (max, Σexp) partial per row. The second, one block per row,
// folds the partials into the logsumexp and picks the top-k among the
// chunks' candidates in chunk order, so equal values go to the lower id
// as `jax.lax.top_k` orders them.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::bf16x8_to_float;
using wis::int8x4_to_float;
using wis::ln_row_bf16;
using wis::warp_max;
using wis::warp_sum;

constexpr float NEG = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;   // vocabulary rows per block
constexpr int kMaxRows = 32;
constexpr int kMaxK = 8;
constexpr size_t kSmemDefault = 48 * 1024;

// (value, position) of the larger value, the lower position on a tie
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    better(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
}

__device__ __forceinline__ void int8x16_to_float(uint4 v, float* f) {
  int8x4_to_float(v.x, f);
  int8x4_to_float(v.y, f + 4);
  int8x4_to_float(v.z, f + 8);
  int8x4_to_float(v.w, f + 12);
}

// Per chunk c of kChunk vocabulary rows: logits, the chunk's top-k per
// row (cand_* (nch, BK, k)), and per row the max and Σexp of the
// logsumexp's source over the chunk's real columns (part_* (nch, BK)).
// Dynamic shared: xn (BK, D) bf16, then logits and raw dots (BK, kChunk).
template <bool INT8>
__global__ void __launch_bounds__(kThreads)
logits_chunk_kernel(const float* __restrict__ x, const float* __restrict__ ln,
                    const void* __restrict__ emb, const float* __restrict__ emb_s,
                    const float* __restrict__ sup, int bk, int D, int V, int k, int full_lse,
                    float* __restrict__ cand_val, int* __restrict__ cand_idx,
                    float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* lg = reinterpret_cast<float*>(smem_raw + ((static_cast<size_t>(bk) * D * 2 + 15) & ~15));
  float* raw = lg + bk * kChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, v0 = c * kChunk;

  // the final LayerNorm: f32 statistics, rounded once to bf16
  for (int r = warp; r < bk; r += kWarps)
    ln_row_bf16(x + static_cast<size_t>(r) * D, ln, ln + D, D, xn + static_cast<size_t>(r) * D, 1,
                lane);
  __syncthreads();

  constexpr int kVec = INT8 ? 16 : 8;  // elements per 16-byte load
  const int nvec = D / kVec;
  for (int j = warp; j < kChunk; j += kWarps) {
    const int v = v0 + j;
    if (v >= V) {  // pad columns, as the TPU kernel holds them
      if (lane < bk) {
        lg[lane * kChunk + j] = NEG;
        raw[lane * kChunk + j] = NEG;
      }
      continue;
    }
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
    const uint4* row = reinterpret_cast<const uint4*>(
        static_cast<const char*>(emb) + static_cast<size_t>(v) * D * (INT8 ? 1 : 2));
    for (int i = lane; i < nvec; i += 32) {
      float e[kVec];
      if (INT8) int8x16_to_float(__ldg(row + i), e);
      else bf16x8_to_float(__ldg(row + i), e);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < bk) {
          const uint4* xr = reinterpret_cast<const uint4*>(xn + static_cast<size_t>(r) * D + i * kVec);
#pragma unroll
          for (int h = 0; h < kVec / 8; ++h) {
            float xf[8];
            bf16x8_to_float(xr[h], xf);
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[r] = fmaf(xf[t], e[8 * h + t], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < bk) {
        float dot = warp_sum(acc[r]);
        if (INT8) dot = dot * emb_s[v];
        if (lane == 0) {
          lg[r * kChunk + j] = dot + sup[v];
          raw[r * kChunk + j] = dot;
        }
      }
    }
  }
  __syncthreads();

  const int nreal = min(kChunk, V - v0);
  for (int r = warp; r < bk; r += kWarps) {
    const float* src = (full_lse ? raw : lg) + r * kChunk;
    float m = -INFINITY;
    for (int j = lane; j < nreal; j += 32) m = fmaxf(m, src[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < nreal; j += 32) s += expf(src[j] - m);
    s = warp_sum(s);
    if (lane == 0) {
      part_m[c * bk + r] = m;
      part_s[c * bk + r] = s;
    }
    float* row = lg + r * kChunk;
    for (int t = 0; t < k; ++t) {
      float best = -INFINITY;
      int bj = kChunk;
      for (int j = lane; j < kChunk; j += 32) better(best, bj, row[j], j);
      warp_argmax(best, bj);
      if (lane == 0) {
        const size_t o = (static_cast<size_t>(c) * bk + r) * k + t;
        cand_val[o] = best;
        cand_idx[o] = v0 + bj;
        row[bj] = -INFINITY;  // taken
      }
      __syncwarp();
    }
  }
}

// One block per row r: lse = M + log(max(Σ_c s_c·exp(m_c − M), 1e-30)),
// and the top-k of the nch·k candidates in chunk order. Dynamic shared:
// nch·k floats.
__global__ void __launch_bounds__(kThreads)
logits_combine_kernel(const float* __restrict__ cand_val, const int* __restrict__ cand_idx,
                      const float* __restrict__ part_m, const float* __restrict__ part_s,
                      int bk, int nch, int k, float* __restrict__ out_val,
                      long long* __restrict__ out_tok, float* __restrict__ lse) {
  extern __shared__ float vals[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float m = -INFINITY;
  for (int c = tid; c < nch; c += kThreads) m = fmaxf(m, part_m[c * bk + r]);
  m = warp_max(m);
  if (lane == 0) red_v[warp] = m;
  __syncthreads();
  float M = red_v[0];
  for (int i = 1; i < kWarps; ++i) M = fmaxf(M, red_v[i]);
  __syncthreads();
  float s = 0.f;
  for (int c = tid; c < nch; c += kThreads) s += part_s[c * bk + r] * expf(part_m[c * bk + r] - M);
  s = warp_sum(s);
  if (lane == 0) red_v[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float S = red_v[0];
    for (int i = 1; i < kWarps; ++i) S += red_v[i];
    lse[r] = M + logf(fmaxf(S, 1e-30f));
  }

  const int n = nch * k;
  for (int p = tid; p < n; p += kThreads) {
    const int c = p / k, t = p - c * k;
    vals[p] = cand_val[(static_cast<size_t>(c) * bk + r) * k + t];
  }
  __syncthreads();
  for (int t = 0; t < k; ++t) {
    float best = -INFINITY;
    int bp = n;
    for (int p = tid; p < n; p += kThreads) better(best, bp, vals[p], p);
    warp_argmax(best, bp);
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bp;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < kWarps; ++i) better(best, bp, red_v[i], red_i[i]);
      // thread 0 is lane 0 of warp 0: its (best, bp) is warp 0's result
      const int c = bp / k, tt = bp - c * k;
      out_val[r * k + t] = best;
      out_tok[r * k + t] = cand_idx[(static_cast<size_t>(c) * bk + r) * k + tt];
      vals[bp] = -INFINITY;
    }
    __syncthreads();
  }
}

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

int n_chunks(int V) { return (V + kChunk - 1) / kChunk; }

}  // namespace

// Scratch bytes for the per-chunk candidates and partials.
extern "C" long long wis_fused_logits_workspace_bytes(int bk, int V, int k) {
  if (bk < 1 || bk > kMaxRows || k < 1 || k > kMaxK || V < 1) return 0;
  const size_t nch = n_chunks(V);
  return static_cast<long long>(2 * align256(sizeof(float) * nch * bk * k) +
                                2 * align256(sizeof(float) * nch * bk));
}

// x (BK, D) f32; ln (2, D) f32 (gamma, beta); emb (V, D) bf16, or int8
// with emb_s (V,) f32 row scales (emb_int8 = 1); sup (V,) f32. Outputs:
// out_val (BK, k) f32 suppressed logits, out_tok (BK, k) int64, lse (BK,)
// f32. D a multiple of 16, BK ≤ 32, k ≤ 8; the wrapper checks.
extern "C" int wis_fused_logits_topk(const void* x, const void* ln, const void* emb,
                                     const void* emb_s, const void* sup, int bk, int D, int V,
                                     int k, int full_lse, int emb_int8, void* ws, void* out_val,
                                     void* out_tok, void* lse, void* stream) {
  if (bk < 1 || bk > kMaxRows || k < 1 || k > kMaxK || D % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = n_chunks(V);
  char* p = static_cast<char*>(ws);
  float* cand_val = reinterpret_cast<float*>(p);
  p += align256(sizeof(float) * nch * bk * k);
  int* cand_idx = reinterpret_cast<int*>(p);
  p += align256(sizeof(float) * nch * bk * k);
  float* part_m = reinterpret_cast<float*>(p);
  p += align256(sizeof(float) * nch * bk);
  float* part_s = reinterpret_cast<float*>(p);

  const size_t smem = ((static_cast<size_t>(bk) * D * 2 + 15) & ~static_cast<size_t>(15)) +
                      2 * sizeof(float) * bk * kChunk;
  cudaError_t e = cudaSuccess;
  if (emb_int8) {
    if (smem > kSmemDefault)
      e = cudaFuncSetAttribute(logits_chunk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    logits_chunk_kernel<true><<<nch, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln), emb,
        static_cast<const float*>(emb_s), static_cast<const float*>(sup), bk, D, V, k, full_lse,
        cand_val, cand_idx, part_m, part_s);
  } else {
    if (smem > kSmemDefault)
      e = cudaFuncSetAttribute(logits_chunk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    logits_chunk_kernel<false><<<nch, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln), emb, nullptr,
        static_cast<const float*>(sup), bk, D, V, k, full_lse, cand_val, cand_idx, part_m,
        part_s);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const size_t csmem = sizeof(float) * nch * k;
  if (csmem > kSmemDefault &&
      (e = cudaFuncSetAttribute(logits_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(csmem))) != cudaSuccess)
    return static_cast<int>(e);
  logits_combine_kernel<<<bk, kThreads, csmem, st>>>(
      cand_val, cand_idx, part_m, part_s, bk, nch, k, static_cast<float*>(out_val),
      static_cast<long long*>(out_tok), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
