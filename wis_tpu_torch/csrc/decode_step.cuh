// The decode-step building blocks shared by the Whisper step
// (fused_decode.cu) and the XTTS GPT step (fused_gpt.cu), so both launch
// the same code — Hopper (sm_90a):
//
//   int8_product_kernel   out = epilogue(bf16(src or LN(x)) · W_int8) on
//                         the tensor cores: one 64-column strip of one
//                         (K, N) chunk and one split of K per block, the
//                         block's whole weight slab requested (cp.async,
//                         four stages) before its LayerNorm prologue runs;
//                         the splits of a strip are one thread-block
//                         cluster and sum their partials in order through
//                         distributed shared memory, then apply the
//                         epilogue: store f32, gelu → bf16, add into the
//                         f32 residual, add with a deferred scale
//   self_attention_kernel one (head, time split) per block over every row
//                         of the step: each selected cache column read
//                         once, coalesced, into shared memory; each row's
//                         selected columns compacted into a list; the
//                         splits of a head are one cluster and merge
//                         their softmax partials with the self column the
//                         same way; the split 0 block writes the step's
//                         K/V columns
//
// The design notes are at the top of fused_decode.cu. Everything here has
// internal linkage: each translation unit that includes this header gets
// its own copy of the kernels, and the ctypes library links them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using wis::bf16_round;
using wis::int8x4_to_float;
using wis::kMaxSplits;
using wis::launch_clustered;
using wis::warp_max;
using wis::warp_sum;

constexpr float NEG = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kRowGroup = 8;          // activation rows per compute pass
constexpr int kMaxRows = 32;
constexpr int kStrip = 64;            // output columns per product block
constexpr int kStages = 4;            // weight stages of a block's slab
constexpr int kKStep = 64;            // K is split in whole steps of 64 rows
constexpr int kSelfCols = 256;        // cache columns per self-attention tile
constexpr int kTileStride = kSelfCols + 10;  // bf16 per tile row: 8 spare, 133 words, odd

enum Epilogue { kStoreF32 = 0, kGeluBf16 = 1, kResidual = 2, kResidualDeferred = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): the tanh formula, in its order
  const float c = 0.7978845608028654f;
  const float cdf = 0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Lets `kernel` take up to kMaxSmem of shared memory (static and dynamic
// together; above 48 KB needs the opt-in). Once per kernel and device:
// each caller keeps its own device mask.
constexpr int kMaxSmem = 200 * 1024;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned long long* done) {
  return wis::set_attribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem,
                            done);
}

// ---- the splits' merge through distributed shared memory -------------------

// After the cluster barrier that publishes every block's partials: block
// rank q takes items [total·q/splits, total·(q + 1)/splits) of `part` (each
// block's own partials, at the same offset in every block) and calls
// emit(item, Σ_z part_z[item]·weight(z, item)), the sum taken over ranks
// z = 0, 1, ... in order, so two calls give the same bits. Ends with the
// barrier that keeps every block until no other reads its partials.
template <typename Weight, typename Emit>
__device__ __forceinline__ void merge_splits(cg::cluster_group& cluster, float* part, int total,
                                             Weight weight, Emit emit) {
  const int splits = static_cast<int>(cluster.num_blocks()), q = cluster.block_rank();
  const int hi = total * (q + 1) / splits;
  for (int item = total * q / splits + threadIdx.x; item < hi; item += blockDim.x) {
    float v[kMaxSplits];
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z) v[z] = z < splits ? cluster.map_shared_rank(part, z)[item] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < splits) sum += v[z] * weight(z, item);
    emit(item, sum);
  }
  cluster.sync();
}

// The split softmax's merge factors, after the same barrier, for `rows`
// rows whose split statistics (max m_z, sum l_z) every block keeps in m
// and l: the row maximum M over the splits (and m_self[r], a column every
// split leaves out, where m_self is given), each split's factor
// e^(m_z − M) in fz[z·rows + r] (0 for a split with l_z = 0, which saw
// no column), e^(m_self − M) in e_self[r], and the denominator
// Σ_z l_z·e^(m_z − M) (+ e_self) in den[r]. fz and lz hold
// kMaxSplits·rows floats each.
__device__ __forceinline__ void softmax_merge_factors(cg::cluster_group& cluster, float* m,
                                                      float* l, const float* m_self, int rows,
                                                      float* fz, float* lz, float* e_self,
                                                      float* den) {
  const int splits = static_cast<int>(cluster.num_blocks());
  for (int i = threadIdx.x; i < splits * rows; i += blockDim.x) {
    const int z = i / rows, r = i - z * rows;
    fz[i] = cluster.map_shared_rank(m, z)[r];
    lz[i] = cluster.map_shared_rank(l, z)[r];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = m_self ? m_self[r] : NEG;
    for (int z = 0; z < splits; ++z) mx = fmaxf(mx, fz[z * rows + r]);
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float f = lz[z * rows + r] > 0.f ? expf(fz[z * rows + r] - mx) : 0.f;
      sum += lz[z * rows + r] * f;
      fz[z * rows + r] = f;
    }
    if (m_self) {
      e_self[r] = expf(m_self[r] - mx);
      sum += e_self[r];
    }
    den[r] = sum;
  }
  __syncthreads();
}

// ---- the int8 product ------------------------------------------------------

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
  int kr;                    // k rows per split (a multiple of kKStep)
};

// The splits of K for a product of `strips` column strips: as many as
// keep to one block per SM (a second block on an SM doubles that SM's
// share of the slab and of the LayerNorm prologue, PERF.md), but
// slabs of at most kMaxSlabSteps steps (one block streams 40 KB at most:
// more splits, up to kMaxSplits (one cluster), for a deep K), whole
// kKStep steps.
constexpr int kMaxSlabSteps = 10;

struct SplitPlan {
  int splits, kr;
};

SplitPlan plan_product(int strips, int K) {
  const int steps = K / kKStep;
  const int want = std::max(1, std::min({kMaxSplits, sm_count() / strips, steps}));
  const int per = std::max(cdiv(steps, kMaxSplits), std::min(cdiv(steps, want), kMaxSlabSteps));
  return {cdiv(steps, per), per * kKStep};
}

// LayerNorm of the product's prologue, one f32 row of d columns by one
// warp: statistics over the whole row (common.cuh: from registers up to
// 128·kLnRegs columns, in two passes above), the affine values of columns
// [k0, k0 + n) only, rounded once to bf16 and stored at dst[c − k0]. k0
// and n are multiples of 64, so a float4 is wholly inside the range or
// outside.
using LnRow = float[wis::kLnRegs][4];

__device__ __forceinline__ bool ln_in_regs(int d) { return d <= 128 * wis::kLnRegs && d % 4 == 0; }

__device__ __forceinline__ void ln_finish(const LnRow& v, const float* __restrict__ g,
                                          const float* __restrict__ b, int d, int k0, int n,
                                          __nv_bfloat16* dst, int lane) {
  float mean, rstd;
  wis::ln_stats(v, d, lane, 1e-5f, mean, rstd);
#pragma unroll
  for (int j = 0; j < wis::kLnRegs; ++j) {
    const int c = (j * 32 + lane) * 4;
    if (c >= k0 && c < k0 + n) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + c));
      const float4 bv = __ldg(reinterpret_cast<const float4*>(b + c));
      uint2 o;
      o.x = wis::pack_bf16((v[j][0] - mean) * rstd * gv.x + bv.x, (v[j][1] - mean) * rstd * gv.y + bv.y);
      o.y = wis::pack_bf16((v[j][2] - mean) * rstd * gv.z + bv.z, (v[j][3] - mean) * rstd * gv.w + bv.w);
      *reinterpret_cast<uint2*>(dst + c - k0) = o;
    }
  }
}

__device__ __forceinline__ void ln_slice_bf16(const float* __restrict__ xr,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b, int d, int k0, int n,
                                              __nv_bfloat16* dst, int lane) {
  if (ln_in_regs(d)) {
    LnRow v;
    wis::ln_load(xr, d, lane, v);
    ln_finish(v, g, b, d, k0, n, dst, lane);
    return;
  }
  float mean, rstd;
  wis::ln_stats_passes(xr, d, lane, 1e-5f, mean, rstd);
  for (int c = lane; c < n; c += 32)
    dst[c] = __float2bfloat16_rn((xr[k0 + c] - mean) * rstd * g[k0 + c] + b[k0 + c]);
}

template <int MODE>
__device__ __forceinline__ void product_out(const ProductArgs& p, int row, int chunk, int n,
                                            float sum) {
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

template <int S>
__device__ __forceinline__ void wait_stage() {
  wis::cp_async_wait<kStages - 1 - S>();
  __syncthreads();
}

// the slab's rows are 64 bytes of weight and 16 of padding, so that the
// A-fragment loads of the 4 k rows a warp reads at once hit 4 bank groups
constexpr int kSlabStride = kStrip + 16;

size_t product_smem(int kr, int rows) {
  const int groups = (rows + kRowGroup - 1) / kRowGroup;
  return static_cast<size_t>(kr) * kSlabStride +
         sizeof(__nv_bfloat16) * groups * kRowGroup * (kr + 8) + sizeof(float) * rows * kStrip;
}

// the int8 weights W[k][c], W[k + 1][c], W[k][c + 1], W[k + 1][c + 1] of a
// slab (c even) as the bf16 pairs (k, k + 1) of columns c and c + 1
__device__ __forceinline__ void a_pairs(const int8_t* wsm, int k, int c, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t r0 = *reinterpret_cast<const uint16_t*>(wsm + k * kSlabStride + c);
  const uint32_t r1 = *reinterpret_cast<const uint16_t*>(wsm + (k + 1) * kSlabStride + c);
  float f[4];
  int8x4_to_float(__byte_perm(r0, r1, 0x5140), f);
  lo = wis::pack_bf16(f[0], f[1]);
  hi = wis::pack_bf16(f[2], f[3]);
}

// out[r, n] = epilogue(Σ_k bf16(src[r, k]) · w[k, n]). Grid (chunks·N/64,
// splits), one cluster of all splits per strip. Dynamic shared memory: the
// block's weight slab [kr][80] int8 (64 used), its activations
// [8·G][kr + 8] bf16 (row-major, zero past the step's rows), its partial
// sums [rows][64] f32.
//
// The tensor cores run mma.m16n8k16 (bf16, f32 accumulators) on
// outᵀ = Wᵀ·actᵀ: the weight is the A operand, widened exactly from int8
// in registers (A row g of an m-tile is strip column 2g, row g + 8 column
// 2g + 1, so one 16-bit load gives a thread both of its columns at one k),
// the activations the B operand, eight rows per n8 group. Warp w takes
// m-tile w % 4 (16 columns) over every other k16 step of the slab (half
// w / 4); the two halves, then the splits in order z = 0, 1, ... (split z
// is block rank z of the cluster) are summed in a fixed order, each block
// summing and storing its share of the strip's outputs.
template <int G, int MODE, bool LN>
__global__ void __launch_bounds__(kThreads, 2) int8_product_kernel(ProductArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[4][G][4][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strips = p.N / kStrip;
  const int chunk = blockIdx.x / strips, n0 = (blockIdx.x - chunk * strips) * kStrip;
  const int k0 = blockIdx.y * p.kr, nk = min(p.K - k0, p.kr);
  const int astride = p.kr + 8;
  int8_t* wsm = reinterpret_cast<int8_t*>(smem_raw);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem_raw + p.kr * kSlabStride);
  float* mine = reinterpret_cast<float*>(act + G * kRowGroup * astride);

  // each warp's first LayerNorm row is requested before the weight, so its
  // loads do not queue behind the slab's
  LnRow xv;
  const bool early = LN && ln_in_regs(p.K) && warp < p.rows;
  if (early) wis::ln_load(p.x + static_cast<size_t>(warp) * p.K, p.K, lane, xv);

  // the weight stream: the slab's four stages in flight at once
  const int8_t* wg = p.w + chunk * p.w_chunk + static_cast<size_t>(k0) * p.N + n0;
  const int sr = nk / kStages;  // a multiple of 16
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    for (int i = tid; i < sr * 4; i += kThreads) {
      const int k = s * sr + (i >> 2), c = (i & 3) * 16;
      wis::cp_async16(wsm + k * kSlabStride + c, wg + static_cast<size_t>(k) * p.N + c);
    }
    wis::cp_async_commit();
  }

  // then the activations of rows k0 .. k0 + nk while the weight arrives
  if (LN) {
    for (int r = warp; r < G * kRowGroup; r += kWarps) {
      __nv_bfloat16* dst = act + r * astride;
      if (r == warp && early) {
        ln_finish(xv, p.ln_g, p.ln_b, p.K, k0, nk, dst, lane);
      } else if (r < p.rows) {
        ln_slice_bf16(p.x + static_cast<size_t>(r) * p.K, p.ln_g, p.ln_b, p.K, k0, nk, dst, lane);
      } else {
        for (int k = 2 * lane; k < nk; k += 64) *reinterpret_cast<uint32_t*>(dst + k) = 0u;
      }
    }
  } else {
    // 16-byte loads, four in flight per thread, then 16-byte stores
    const int nv = nk / 8;
    for (int i0 = tid; i0 < G * kRowGroup * nv; i0 += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads, r = i / nv, k = (i - r * nv) * 8;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < G * kRowGroup * nv && r < p.rows)
          v[u] = __ldg(reinterpret_cast<const uint4*>(p.src + static_cast<size_t>(r) * p.K + k0 + k));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads, r = i / nv, k = (i - r * nv) * 8;
        if (i < G * kRowGroup * nv) *reinterpret_cast<uint4*>(act + r * astride + k) = v[u];
      }
    }
  }

  const int mt = warp & 3, kh = warp >> 2, g = lane >> 2, t = lane & 3;
  const int col = mt * 16 + 2 * g;  // this thread's A columns: col, col + 1
  float acc[G][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s == 0) wait_stage<0>();  // also: the activations are in
    else if (s == 1) wait_stage<1>();
    else if (s == 2) wait_stage<2>();
    else wait_stage<3>();
#pragma unroll 2
    for (int k = s * sr + 16 * kh; k < (s + 1) * sr; k += 32) {
      uint32_t a[4];
      a_pairs(wsm, k + 2 * t, col, a[0], a[1]);
      a_pairs(wsm, k + 2 * t + 8, col, a[2], a[3]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const __nv_bfloat16* brow = act + (gi * kRowGroup + g) * astride + k + 2 * t;
        wis::mma_bf16_16816(acc[gi], a, wis::load_pair(brow), wis::load_pair(brow + 8));
      }
    }
  }
  // the two k halves in order; acc[gi][e] is column col + (e >> 1) of row
  // 8·gi + 2t + (e & 1)
  if (kh == 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[mt][gi][e][lane] = acc[gi][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gi * kRowGroup + 2 * t + (e & 1);
        if (row < p.rows) mine[row * kStrip + col + (e >> 1)] = acc[gi][e] + red[mt][gi][e][lane];
      }
  }

  // the splits' sum through distributed shared memory, in order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  merge_splits(
      cluster, mine, p.rows * kStrip, [](int, int) { return 1.f; },
      [&](int e, float sum) { product_out<MODE>(p, e / kStrip, chunk, n0 + e % kStrip, sum); });
}

template <int G, int MODE, bool LN>
cudaError_t launch_product_g(const ProductArgs& p, int chunks, int splits, cudaStream_t stream) {
  static unsigned long long opted = 0;
  cudaError_t e = allow_smem(int8_product_kernel<G, MODE, LN>, &opted);
  if (e != cudaSuccess) return e;
  return launch_clustered(int8_product_kernel<G, MODE, LN>, dim3(chunks * p.N / kStrip, splits),
                          kThreads, product_smem(p.kr, p.rows), 1, splits, stream, p);
}

// One n8 group of the mma per eight rows of the step (1 to 4).
template <int MODE, bool LN>
cudaError_t launch_product(ProductArgs p, int chunks, cudaStream_t stream) {
  if (p.N % kStrip || p.K % kKStep) return cudaErrorInvalidValue;
  const SplitPlan sp = plan_product(chunks * p.N / kStrip, p.K);
  p.kr = sp.kr;
  switch ((p.rows + kRowGroup - 1) / kRowGroup) {
    case 1: return launch_product_g<1, MODE, LN>(p, chunks, sp.splits, stream);
    case 2: return launch_product_g<2, MODE, LN>(p, chunks, sp.splits, stream);
    case 3: return launch_product_g<3, MODE, LN>(p, chunks, sp.splits, stream);
    default: return launch_product_g<4, MODE, LN>(p, chunks, sp.splits, stream);
  }
}

// ---- self-attention ------------------------------------------------------

struct SelfArgs {
  const float* qkv;      // (bk, 3D) f32: q | k | v of this step
  __nv_bfloat16* kc;     // one layer's (D, bk·T) time-major cache
  __nv_bfloat16* vc;
  const float* sel;      // (bk, bk·T) f32
  __nv_bfloat16* out;    // (bk, D)
  int bk, D, t_cache, pos;
  int tt;                // time steps per tile
  float scale;
};

size_t self_smem(int bk) {
  return 2 * sizeof(unsigned short) * kHeadDim * kTileStride +
         sizeof(float) * (bk * (kHeadDim + 1) + 3 + bk * kSelfCols + 6 * kMaxRows) +
         sizeof(uint32_t) * (kSelfCols + 4) + sizeof(int) * kMaxRows + bk * kSelfCols +
         2 * sizeof(float) * bk * kHeadDim;
}

// Self-attention of every row of head h (grid (H, splits), one cluster of
// all splits per head) over tiles of tt time steps (at most kSelfCols
// columns), split z taking tiles z, z + splits, ..., so that the selected
// part of the cache (sel's history lies before pos) spreads over every
// split; a tile no row selects from is left after the sel scan. Each
// tile's selected columns (those some row's sel picks) are read once,
// coalesced, into shared memory; each row's selected columns are listed
// and scored, bf16(q)·K in f32 × scale; e = exp(s − m_tile) rounded to
// bf16 for P·V; the block keeps a running (m, Σ e, P·V) per row, rescaled
// tile by tile.
// The splits then merge in order z = 0, 1, ... with the self column q·k
// (f32) through distributed shared memory, each block storing its share:
// out = (Σ_z P·V_z·e^(m_z−M) + e_self·v) / (Σ_z l_z·e^(m_z−M) + e_self).
// The split 0 block writes this step's K/V columns at pos·bk + r. Columns
// no row selects are never used (a 16-byte load carries them in only
// beside a selected one).
__global__ void __launch_bounds__(kThreads) self_attention_kernel(SelfArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kItems = kMaxRows * kHeadDim / kThreads;  // (row, dim) per thread
  const int h = blockIdx.x, z = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bk = a.bk, D = a.D, bkt = bk * a.t_cache;
  unsigned short* ks = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* vs = ks + kHeadDim * kTileStride;
  float* qb = reinterpret_cast<float*>(vs + kHeadDim * kTileStride);  // [bk][65]
  float* sc = qb + ((bk * (kHeadDim + 1) + 3) & ~3);                  // [bk][kSelfCols], 16-byte aligned
  float* m_run = sc + bk * kSelfCols;                                  // [kMaxRows] each
  float* l_run = m_run + kMaxRows;
  float* alpha = l_run + kMaxRows;
  float* beta = alpha + kMaxRows;
  float* s_self = beta + kMaxRows;
  float* den = s_self + kMaxRows;
  uint32_t* cm = reinterpret_cast<uint32_t*>(den + kMaxRows);          // [kSelfCols + 4]
  int* cnt = reinterpret_cast<int*>(cm + kSelfCols + 4);               // [kMaxRows]
  uint8_t* list = reinterpret_cast<uint8_t*>(cnt + kMaxRows);          // [bk][kSelfCols]
  float* v_self = reinterpret_cast<float*>(list + bk * kSelfCols);     // [bk][64]
  float* k_self = v_self + bk * kHeadDim;                              // [bk][64]

  // this head's q, k, v, up to four rows a warp with all their loads in
  // flight: bf16(q) for the scores, v and the self column's score q·k
  // (f32) for the merge, k and v for split 0 to write into the cache
  {
    float qv[4][2], kv[4][2], vv[4][2];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp + rr * kWarps;
      if (r < bk) {
        const float* row = a.qkv + static_cast<size_t>(r) * 3 * D + h * kHeadDim;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          qv[rr][u] = row[lane + 32 * u];
          kv[rr][u] = row[D + lane + 32 * u];
          vv[rr][u] = row[2 * D + lane + 32 * u];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= bk) break;
      const float s = warp_sum(qv[rr][0] * kv[rr][0] + qv[rr][1] * kv[rr][1]) * a.scale;
      if (lane == 0) s_self[r] = s;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int d = lane + 32 * u;
        qb[r * (kHeadDim + 1) + d] = bf16_round(qv[rr][u]);
        v_self[r * kHeadDim + d] = vv[rr][u];
        k_self[r * kHeadDim + d] = kv[rr][u];
      }
    }
  }
  if (tid < kMaxRows) {
    m_run[tid] = NEG;
    l_run[tid] = 0.f;
  }
  float o_run[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) o_run[k] = 0.f;

  const unsigned short* kh =
      reinterpret_cast<const unsigned short*>(a.kc) + static_cast<size_t>(h) * kHeadDim * bkt;
  const unsigned short* vh =
      reinterpret_cast<const unsigned short*>(a.vc) + static_cast<size_t>(h) * kHeadDim * bkt;
  const int splits_t = gridDim.y, tiles = cdiv(a.t_cache, a.tt);
  // 16-byte loads: every row of the cache and of sel starts on 16 bytes,
  // as bk·T is a multiple of 8 (the C functions check)
  for (int tile = z; tile < tiles; tile += splits_t) {
    const int t0 = tile * a.tt;
    const int c0 = t0 * bk, nc = (min(a.t_cache, t0 + a.tt) - t0) * bk;
    // the rows that select each column: sel rows read as float4 from the
    // tile's first column rounded down to 4 (cm index − off)
    const int off = c0 & 3, nsel = (off + nc + 3) / 4;
    for (int i = tid; i < nc + off; i += kThreads) cm[i] = 0u;
    __syncthreads();  // also: the last tile's shared memory is free
    int picked = 0;
    for (int u0 = tid; u0 < bk * nsel; u0 += 4 * kThreads) {
      float4 v[4];  // four loads in flight per thread
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + e * kThreads, r = u / nsel, j = u - r * nsel;
        v[e] = u < bk * nsel ? __ldg(reinterpret_cast<const float4*>(
                                   a.sel + static_cast<size_t>(r) * bkt + c0 - off) + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + e * kThreads, r = u / nsel, j = u - r * nsel;
        const float f[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          if (u < bk * nsel && f[c] > 0.f && i >= off && i < off + nc) {
            atomicOr(&cm[i], 1u << r);
            picked = 1;
          }
        }
      }
    }
    if (!__syncthreads_or(picked)) continue;  // no row selects a column of this tile
    // each row's selected columns, in column order
    for (int r = warp; r < bk; r += kWarps) {
      int n = 0;
      for (int i0 = 0; i0 < nc; i0 += 32) {
        const int i = i0 + lane;
        const bool on = i < nc && ((cm[off + i] >> r) & 1u);
        const uint32_t bal = __ballot_sync(0xffffffffu, on);
        if (on) list[r * kSelfCols + n + __popc(bal & ((1u << lane) - 1u))] = static_cast<uint8_t>(i);
        n += __popc(bal);
      }
      if (lane == 0) cnt[r] = n;
    }
    // the K and V of the tile's selected columns, coalesced along the
    // time-major rows: 16-byte loads (8 columns from the tile's first
    // column rounded down to 8) of every vector that holds a selected
    // column, four of each in flight per thread, into [d][i] at column
    // offset o8
    const int o8 = c0 & 7, nv = (o8 + nc + 7) / 8;
    for (int u0 = tid; u0 < kHeadDim * nv; u0 += 4 * kThreads) {
      uint4 kv[4], vv[4];
      int at[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + e * kThreads, d = u / nv, j = u - d * nv;
        bool any = false;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = 8 * j + c - o8;
          any |= i >= 0 && i < nc && cm[off + i] != 0u;
        }
        at[e] = u < kHeadDim * nv && any ? d * kTileStride + 8 * j : -1;
        if (at[e] >= 0) {
          const size_t gi = static_cast<size_t>(d) * bkt + c0 - o8 + 8 * j;
          kv[e] = __ldg(reinterpret_cast<const uint4*>(kh + gi));
          vv[e] = __ldg(reinterpret_cast<const uint4*>(vh + gi));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (at[e] < 0) continue;
        uint32_t* kd = reinterpret_cast<uint32_t*>(ks + at[e]);
        uint32_t* vd = reinterpret_cast<uint32_t*>(vs + at[e]);
        kd[0] = kv[e].x; kd[1] = kv[e].y; kd[2] = kv[e].z; kd[3] = kv[e].w;
        vd[0] = vv[e].x; vd[1] = vv[e].y; vd[2] = vv[e].z; vd[3] = vv[e].w;
      }
    }
    __syncthreads();
    // scores, one thread per (row, listed column): bf16(q)·K in four
    // chains over d
    int most = 0;
    for (int r = 0; r < bk; ++r) most = max(most, cnt[r]);
    for (int u = tid; u < bk * most; u += kThreads) {
      const int r = u / most, j = u - r * most;
      if (j >= cnt[r]) continue;
      const float* q = qb + r * (kHeadDim + 1);
      const int i = list[r * kSelfCols + j] + o8;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < kHeadDim; d += 4)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dot[e] = fmaf(q[d + e],
                        __uint_as_float(static_cast<uint32_t>(ks[(d + e) * kTileStride + i]) << 16),
                        dot[e]);
      sc[r * kSelfCols + j] = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * a.scale;
    }
    __syncthreads();
    // the tile's softmax statistics and the running rescale, eight lanes
    // per row (four rows a warp)
    {
      const int r = warp * 4 + (lane >> 3), gl = lane & 7;
      const int n = r < bk ? cnt[r] : 0;
      float* sr = sc + r * kSelfCols;
      float mx = NEG;
      for (int j = gl; j < n; j += 8) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = gl; j < n; j += 8) {
        const float e = expf(sr[j] - mx);
        sum += e;
        sr[j] = bf16_round(e);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (gl == 0 && r < bk) {
        const float m_old = m_run[r], m_new = fmaxf(m_old, mx);
        const float fa = expf(m_old - m_new), fb = expf(mx - m_new);
        m_run[r] = m_new;
        l_run[r] = l_run[r] * fa + (n ? sum : 0.f) * fb;
        alpha[r] = fa;
        beta[r] = fb;
      }
    }
    __syncthreads();
    // the tile's P·V into the running sums, one thread per (row, dim)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int item = tid + k * kThreads;
      if (item < bk * kHeadDim) {
        const int r = item / kHeadDim, d = item - r * kHeadDim;
        const int n = cnt[r];
        const float* er = sc + r * kSelfCols;
        const uint8_t* lr = list + r * kSelfCols;
        const unsigned short* vd = vs + d * kTileStride + o8;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains over the list
        int j = 0;
#pragma unroll 2
        for (; j + 4 <= n; j += 4) {  // four list entries and four e per load
          const uint32_t l4 = *reinterpret_cast<const uint32_t*>(lr + j);
          const float4 e4 = *reinterpret_cast<const float4*>(er + j);
          const float e[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float v = __uint_as_float(static_cast<uint32_t>(vd[(l4 >> (8 * u)) & 0xffu]) << 16);
            acc[u] = e[u] != 0.f ? fmaf(e[u], v, acc[u]) : acc[u];
          }
        }
        for (; j < n; ++j) {
          const float e = er[j];
          if (e != 0.f) acc[0] = fmaf(e, __uint_as_float(static_cast<uint32_t>(vd[lr[j]]) << 16), acc[0]);
        }
        o_run[k] = o_run[k] * alpha[r] + ((acc[0] + acc[1]) + (acc[2] + acc[3])) * beta[r];
      }
    }
  }
  __syncthreads();
  float* o_sm = reinterpret_cast<float*>(ks);  // [bk][64]: the tiles are no longer needed
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int item = tid + k * kThreads;
    if (item < bk * kHeadDim) o_sm[item] = o_run[k];
  }

  // the merge through distributed shared memory with the self column:
  // out = (Σ_z P·V_z·e^(m_z − M) + e_self·v) / den
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* fz = sc;                     // [kMaxSplits][bk]
  float* lz = sc + kMaxSplits * bk;   // [kMaxSplits][bk]
  softmax_merge_factors(cluster, m_run, l_run, s_self, bk, fz, lz, alpha, den);
  merge_splits(
      cluster, o_sm, bk * kHeadDim,
      [&](int zz, int item) { return fz[zz * bk + item / kHeadDim]; },
      [&](int item, float num) {
        const int r = item / kHeadDim, d = item - r * kHeadDim;
        a.out[static_cast<size_t>(r) * D + h * kHeadDim + d] =
            __float2bfloat16_rn((num + alpha[r] * v_self[item]) / den[r]);
      });
  // split 0 writes this step's K/V columns pos·bk + r last, where no
  // barrier waits for the stores: the bk columns of a cache row are
  // adjacent, so consecutive threads store consecutive columns
  if (z == 0) {
    for (int i = tid; i < bk * kHeadDim; i += kThreads) {
      const int d = i / bk, r = i - d * bk;
      const size_t col = static_cast<size_t>(h * kHeadDim + d) * bkt + a.pos * bk + r;
      a.kc[col] = __float2bfloat16_rn(k_self[r * kHeadDim + d]);
      a.vc[col] = __float2bfloat16_rn(v_self[r * kHeadDim + d]);
    }
  }
}

cudaError_t launch_self(SelfArgs a, int H, cudaStream_t st) {
  const int want = std::max(1, std::min({kMaxSplits, cdiv(2 * sm_count(), H), a.t_cache}));
  a.tt = std::min(kSelfCols / a.bk, cdiv(a.t_cache, want));
  const int splits = std::min(want, cdiv(a.t_cache, a.tt));
  static unsigned long long opted = 0;
  cudaError_t e = allow_smem(self_attention_kernel, &opted);
  if (e != cudaSuccess) return e;
  return launch_clustered(self_attention_kernel, dim3(H, splits), kThreads, self_smem(a.bk), 1,
                          splits, st, a);
}

}  // namespace
