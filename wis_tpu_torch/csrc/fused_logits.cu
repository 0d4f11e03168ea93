// The decode step's head: final LayerNorm, logits over the vocabulary,
// per-beam top-k and logsumexp, with whisper's timestamp grammar as an
// option — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/fused_logits.py
// `build_fused_logits_topk`:
//
//   xn       = bf16(LN(x))                               (BK, D)
//   dot      = xn · emb^T  (× the per-row int8 scale)    (BK, V) f32
//   logits   = dot + sup;  lse over logits, or over dot with full_lse
//   top-k of logits per row, ties to the lower token id
//
// Grammar mode (ts_state (BK, 4) int32: need_ts, need_text, min_ts, pad)
// sets a row's logits to NEG where need_ts and id < eot, where need_text
// and id ≥ ts_base, and where ts_base ≤ id < min_ts. It also keeps, per
// row, the logsumexp of the timestamp region (a fully masked chunk adds
// exactly zero), the best text logit and a second top-k restricted to
// timestamps; where the region's logsumexp beats the best text logit
// (whisper's "force a timestamp" rule) the row takes the timestamp
// candidates and, unless full_lse, the region's logsumexp.
//
// Bound on the H100: device-memory bytes — the (V, D) embedding is read
// once (133 MB bf16, 66 MB int8 on large-v2) and nothing of size V is
// written. Two kernels: the first spreads the vocabulary over blocks of
// 128 rows (406 blocks at V = 51865); each block normalizes x itself into
// shared memory, gives one warp to a vocabulary row at a time (16-byte
// loads along D, all BK rows against the loaded vector), keeps the chunk's
// logits in shared memory, and writes only the chunk's top-k candidates
// and its partials per row. The second, one block per row, folds the
// partials into the logsumexp and picks the top-k among the chunks'
// candidates in chunk order, so equal values go to the lower id as
// `jax.lax.top_k` orders them. A chunk's top-k marks a taken column NEG,
// as the TPU kernel does, so a chunk with fewer than k live columns fills
// its slots with its lowest NEG column.
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
using wis::block_reduce;
using wis::int8x16_to_float;
using wis::kMax;
using wis::kSum;
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

// The grammar's per-chunk outputs: timestamp-only candidates (nch, BK, k)
// and, per row, the timestamp region's max and Σexp and the best text
// logit (nch, BK).
struct Grammar {
  const int* ts_state;  // (BK, 4), null outside grammar mode
  int ts_base, eot;
  float* cand_val;
  int* cand_idx;
  float* part_m;
  float* part_s;
  float* part_text;
};

// One warp's top-k of row[0, kChunk) into (val, idx)[0, k): the largest,
// the lower column on a tie; a taken column becomes NEG.
__device__ __forceinline__ void chunk_topk(float* row, int k, int v0, int lane, float* val,
                                           int* idx) {
  for (int t = 0; t < k; ++t) {
    float best = -INFINITY;
    int bj = kChunk;
    for (int j = lane; j < kChunk; j += 32) better(best, bj, row[j], j);
    warp_argmax(best, bj);
    if (lane == 0) {
      val[t] = best;
      idx[t] = v0 + bj;
      row[bj] = NEG;
    }
    __syncwarp();
  }
}

// Per chunk c of kChunk vocabulary rows: logits, the chunk's top-k per
// row (cand_* (nch, BK, k)), and per row the max and Σexp of the
// logsumexp's source over the chunk's real columns (part_* (nch, BK)).
// Dynamic shared: xn (BK, D) bf16, then logits and raw dots (BK, kChunk),
// and in grammar mode the timestamp-only logits (BK, kChunk).
template <bool INT8>
__global__ void __launch_bounds__(kThreads)
logits_chunk_kernel(const float* __restrict__ x, const float* __restrict__ ln,
                    const void* __restrict__ emb, const float* __restrict__ emb_s,
                    const float* __restrict__ sup, int bk, int D, int V, int k, int full_lse,
                    float* __restrict__ cand_val, int* __restrict__ cand_idx,
                    float* __restrict__ part_m, float* __restrict__ part_s, Grammar gr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* lg = reinterpret_cast<float*>(smem_raw + ((static_cast<size_t>(bk) * D * 2 + 15) & ~15));
  float* raw = lg + bk * kChunk;
  float* tsv = raw + bk * kChunk;
  const bool grammar = gr.ts_state != nullptr;
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
          float l = dot + sup[v];
          if (grammar) {
            const int* ts = gr.ts_state + 4 * r;
            const bool bad = (ts[0] > 0 && v < gr.eot) || (ts[1] > 0 && v >= gr.ts_base) ||
                             (v >= gr.ts_base && v < ts[2]);
            if (bad) l = NEG;
          }
          lg[r * kChunk + j] = l;
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
    const size_t o = (static_cast<size_t>(c) * bk + r) * k;
    if (grammar) {
      // timestamp-only logits, the region's (max, Σexp over live
      // columns) and the best text logit; pad columns count as
      // timestamps and are NEG
      float* tv = tsv + r * kChunk;
      float mt = NEG, mx = NEG;
      for (int j = lane; j < kChunk; j += 32) {
        const bool is_ts = v0 + j >= gr.ts_base;
        tv[j] = is_ts ? row[j] : NEG;
        if (is_ts) mt = fmaxf(mt, row[j]);
        else mx = fmaxf(mx, row[j]);
      }
      mt = warp_max(mt);
      mx = warp_max(mx);
      float st = 0.f;
      for (int j = lane; j < kChunk; j += 32)
        if (tv[j] > NEG * 0.5f) st += expf(tv[j] - mt);
      st = warp_sum(st);
      if (lane == 0) {
        gr.part_m[c * bk + r] = mt;
        gr.part_s[c * bk + r] = st;
        gr.part_text[c * bk + r] = mx;
      }
      __syncwarp();
      chunk_topk(tv, k, v0, lane, gr.cand_val + o, gr.cand_idx + o);
    }
    chunk_topk(row, k, v0, lane, cand_val + o, cand_idx + o);
  }
}

// One block per row r: lse = M + log(max(Σ_c s_c·exp(m_c − M), 1e-30)),
// the same for the timestamp region in grammar mode, and the top-k of the
// nch·k candidates (the timestamp-only ones where the row is forced) in
// chunk order. Dynamic shared: nch·k floats.
__global__ void __launch_bounds__(kThreads)
logits_combine_kernel(const float* __restrict__ cand_val, const int* __restrict__ cand_idx,
                      const float* __restrict__ part_m, const float* __restrict__ part_s,
                      int bk, int nch, int k, int full_lse, Grammar gr,
                      float* __restrict__ out_val, long long* __restrict__ out_tok,
                      float* __restrict__ lse) {
  extern __shared__ float vals[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // (max, Σexp) partials of a region → its logsumexp
  auto region_lse = [&](const float* pm, const float* ps) {
    float m = -INFINITY;
    for (int c = tid; c < nch; c += kThreads) m = fmaxf(m, pm[c * bk + r]);
    const float M = block_reduce<kMax, kWarps>(m, red_v);
    float s = 0.f;
    for (int c = tid; c < nch; c += kThreads) s += ps[c * bk + r] * expf(pm[c * bk + r] - M);
    const float S = block_reduce<kSum, kWarps>(s, red_v);
    return M + logf(fmaxf(S, 1e-30f));
  };
  float row_lse = region_lse(part_m, part_s);
  bool force = false;
  if (gr.ts_state != nullptr) {
    const float lse_ts = region_lse(gr.part_m, gr.part_s);
    float mx = -INFINITY;
    for (int c = tid; c < nch; c += kThreads) mx = fmaxf(mx, gr.part_text[c * bk + r]);
    force = lse_ts > block_reduce<kMax, kWarps>(mx, red_v);
    if (force && !full_lse) row_lse = lse_ts;
  }
  if (tid == 0) lse[r] = row_lse;
  const float* cv = force ? gr.cand_val : cand_val;
  const int* ci = force ? gr.cand_idx : cand_idx;

  const int n = nch * k;
  for (int p = tid; p < n; p += kThreads) {
    const int c = p / k, t = p - c * k;
    vals[p] = cv[(static_cast<size_t>(c) * bk + r) * k + t];
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
      out_tok[r * k + t] = ci[(static_cast<size_t>(c) * bk + r) * k + tt];
      vals[bp] = -INFINITY;
    }
    __syncthreads();
  }
}

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

int n_chunks(int V) { return (V + kChunk - 1) / kChunk; }

}  // namespace

// Scratch bytes for the per-chunk candidates and partials (twice the
// candidates and two more partials in grammar mode).
extern "C" long long wis_fused_logits_workspace_bytes(int bk, int V, int k, int grammar) {
  if (bk < 1 || bk > kMaxRows || k < 1 || k > kMaxK || V < 1) return 0;
  const size_t nch = n_chunks(V);
  const size_t cand = 2 * align256(sizeof(float) * nch * bk * k);
  const size_t part = align256(sizeof(float) * nch * bk);
  return static_cast<long long>(grammar ? 2 * cand + 5 * part : cand + 2 * part);
}

// x (BK, D) f32; ln (2, D) f32 (gamma, beta); emb (V, D) bf16, or int8
// with emb_s (V,) f32 row scales (emb_int8 = 1); sup (V,) f32; ts_state
// (BK, 4) int32 for grammar mode, or null. Outputs: out_val (BK, k) f32
// suppressed logits, out_tok (BK, k) int64, lse (BK,) f32. D a multiple of
// 16, BK ≤ 32, k ≤ 8; the wrapper checks.
extern "C" int wis_fused_logits_topk(const void* x, const void* ln, const void* emb,
                                     const void* emb_s, const void* sup, const void* ts_state,
                                     int bk, int D, int V, int k, int full_lse, int emb_int8,
                                     int ts_base, int eot, void* ws, void* out_val,
                                     void* out_tok, void* lse, void* stream) {
  if (bk < 1 || bk > kMaxRows || k < 1 || k > kMaxK || D % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = n_chunks(V);
  const bool grammar = ts_state != nullptr;
  const size_t cand = align256(sizeof(float) * nch * bk * k);
  const size_t part = align256(sizeof(float) * nch * bk);
  char* p = static_cast<char*>(ws);
  float* cand_val = reinterpret_cast<float*>(p);
  int* cand_idx = reinterpret_cast<int*>(p + cand);
  float* part_m = reinterpret_cast<float*>(p + 2 * cand);
  float* part_s = reinterpret_cast<float*>(p + 2 * cand + part);
  Grammar gr{static_cast<const int*>(ts_state), ts_base, eot, nullptr, nullptr,
             nullptr, nullptr, nullptr};
  if (grammar) {
    p += 2 * cand + 2 * part;
    gr.cand_val = reinterpret_cast<float*>(p);
    gr.cand_idx = reinterpret_cast<int*>(p + cand);
    gr.part_m = reinterpret_cast<float*>(p + 2 * cand);
    gr.part_s = reinterpret_cast<float*>(p + 2 * cand + part);
    gr.part_text = reinterpret_cast<float*>(p + 2 * cand + 2 * part);
  }

  const size_t smem = ((static_cast<size_t>(bk) * D * 2 + 15) & ~static_cast<size_t>(15)) +
                      (grammar ? 3 : 2) * sizeof(float) * bk * kChunk;
  cudaError_t e = cudaSuccess;
  if (emb_int8) {
    if (smem > kSmemDefault)
      e = cudaFuncSetAttribute(logits_chunk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    logits_chunk_kernel<true><<<nch, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln), emb,
        static_cast<const float*>(emb_s), static_cast<const float*>(sup), bk, D, V, k, full_lse,
        cand_val, cand_idx, part_m, part_s, gr);
  } else {
    if (smem > kSmemDefault)
      e = cudaFuncSetAttribute(logits_chunk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    logits_chunk_kernel<false><<<nch, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln), emb, nullptr,
        static_cast<const float*>(sup), bk, D, V, k, full_lse, cand_val, cand_idx, part_m,
        part_s, gr);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const size_t csmem = sizeof(float) * nch * k;
  if (csmem > kSmemDefault &&
      (e = cudaFuncSetAttribute(logits_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(csmem))) != cudaSuccess)
    return static_cast<int>(e);
  logits_combine_kernel<<<bk, kThreads, csmem, st>>>(
      cand_val, cand_idx, part_m, part_s, bk, nch, k, full_lse, gr,
      static_cast<float*>(out_val), static_cast<long long*>(out_tok), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
