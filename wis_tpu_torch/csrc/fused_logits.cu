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
// row, the logsumexp of the timestamp region, the best text logit and a
// second top-k over the logits with every text id at NEG; where the
// region's logsumexp beats the best text logit (whisper's "force a
// timestamp" rule) the row takes that second top-k and, unless full_lse,
// the region's logsumexp.
//
// Bound on the H100: device-memory bytes — the (V, D) table is read once
// (66 MB int8, 133 MB bf16 on large-v2), nothing of size V is written, and
// 2·BK·V·D operations are a few µs of tensor-core time. One launch of one
// persistent block of 512 threads per SM (at most), each block a contiguous
// range of 64-row vocabulary tiles:
//
//   - the table streams through a ring of kStages cp.async stages (64 rows
//     × 256 bytes each, the tile's sup and row scales riding with its last
//     slice); the first stages are requested
//     after the LayerNorm's own loads (x, gamma, beta) and before its
//     arithmetic, which each block runs once (≈132 times a call, not once
//     per tile);
//   - the product runs on the tensor cores (mma.m16n8k16, bf16, f32
//     accumulators): the table tile is the A operand (vocabulary rows as M,
//     D as K, row-major as stored; an int8 tile widened exactly to bf16 in
//     registers), the LN'd rows the B operand, BK padded to 8·G; the k
//     order inside each 32-byte chunk is permuted alike in both operands so
//     that each comes in with one 8- or 16-byte shared load. Of the 16
//     warps, warp w takes m-tile w % 4 and k quarter w / 4, the quarters
//     summed in a fixed order;
//   - the epilogue, one warp per row: the row scale, sup and the grammar
//     masks; each lane keeps its own running (max, Σexp) pairs, merged
//     across the warp once at the end; the block's running top-k of the
//     row lives across the warp's lanes (lane u holds entry u, sorted by
//     value desc, id asc), and a tile's column goes in (a ballot for its
//     place, a shuffle down) only where it comes before the k-th entry, so
//     masked columns at NEG fill what live columns do not, lowest id
//     first, as the plain version's stable sort does;
//   - each block stores its lists and pairs, counts itself in (one int32
//     counter, put back to 0), and the last block folds them, one warp a
//     row: the pairs in block order, then every block's list staged in
//     shared memory, the entries at or above the best of the blocks' k-th
//     entries compacted and sorted across the warp (or, past 64 of them,
//     merged into the warp's list): the top-k under a total order, the
//     same bits call to call.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using wis::warp_max;

constexpr float NEG = -1e30f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // vocabulary rows per tile
constexpr int kSliceBytes = 256;    // table bytes per row and stage
constexpr int kRowStride = kSliceBytes + 32;  // 72 words: conflict-free 8-byte A loads
constexpr int kSide = 2 * kTile * 4;          // the tile's sup and row scales
constexpr int kStageBytes = kTile * kRowStride + kSide;
constexpr int kStages = 6;
constexpr int kMaxRows = 32;
constexpr int kMaxK = 8;
constexpr int kMaxGrid = 144;    // blocks the fold takes: at most 5 a lane
constexpr int kQuarters = 4;     // k quarters of a slice, one per four warps
constexpr int kLgStride = kTile + 4;  // conflict-free stores of the C fragments

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

__host__ __device__ __forceinline__ int n_tiles(int V) { return (V + kTile - 1) / kTile; }

int n_blocks(int V) { return std::min(n_tiles(V), kMaxGrid); }

// (a, ia) before (b, ib) in the top-k order: larger value, then lower id
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// A logsumexp pair (max, Σexp(· − max)); m = −inf is the empty pair.
struct Pair {
  float m, s;
};

// the pair of both
__device__ __forceinline__ Pair lse_merge(Pair a, Pair b) {
  const float M = fmaxf(a.m, b.m);
  if (M == -INFINITY) return a;
  return {M, (a.m == -INFINITY ? 0.f : a.s * expf(a.m - M)) +
                 (b.m == -INFINITY ? 0.f : b.s * expf(b.m - M))};
}

// the warp's pairs merged (commutative: every lane gets the same bits)
__device__ __forceinline__ Pair warp_lse(Pair p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p = lse_merge(p, {__shfl_xor_sync(0xffffffffu, p.m, off),
                      __shfl_xor_sync(0xffffffffu, p.s, off)});
  return p;
}

// 16 bytes global → shared, of which the first `n` are read and the rest
// zero-filled (cp.async with a source size)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(n)
               : "memory");
}

// A running top-k list of one row across a warp: lane u < k holds entry u
// (value v, id i), sorted by `before`; lanes from k on hold (−inf, max).
struct Entry {
  float v;
  int i;
};

// (cv, ci) into the list, the k-th entry dropped: lanes from its position
// on shift down by one.
__device__ __forceinline__ void list_insert(float& v, int& i, float cv, int ci, int k, int lane) {
  const int pos = __popc(__ballot_sync(0xffffffffu, lane < k && before(v, i, cv, ci)));
  const float uv = __shfl_up_sync(0xffffffffu, v, 1);
  const int ui = __shfl_up_sync(0xffffffffu, i, 1);
  if (lane == pos) {
    v = cv;
    i = ci;
  } else if (lane > pos && lane < k) {
    v = uv;
    i = ui;
  }
}

// Merge a tile's columns (lane holds c0, c1 with ids i0, i1) into the
// list: each column that comes before the k-th entry goes in, in lane
// order (the result is the top-k of both whatever the order).
__device__ __forceinline__ Entry merge_tile(Entry e, int k, float c0, int i0, float c1, int i1,
                                            int lane) {
  float& v = e.v;
  int& i = e.i;
  float tv = __shfl_sync(0xffffffffu, v, k - 1);
  int ti = __shfl_sync(0xffffffffu, i, k - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float c = h ? c1 : c0;
    const int ci = h ? i1 : i0;
    unsigned m = __ballot_sync(0xffffffffu, before(c, ci, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float bv = __shfl_sync(0xffffffffu, c, src);
      const int bi = __shfl_sync(0xffffffffu, ci, src);
      if (!before(bv, bi, tv, ti)) continue;  // an insertion raised the k-th entry
      list_insert(v, i, bv, bi, k, lane);
      tv = __shfl_sync(0xffffffffu, v, k - 1);
      ti = __shfl_sync(0xffffffffu, i, k - 1);
    }
  }
  return e;
}

// 64 keys, two a lane (element 2·lane + h), sorted descending across the
// warp (bitonic: the first pass inside each lane, the rest by shuffles).
__device__ __forceinline__ void warp_sort64_desc(unsigned long long (&key)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 1) {
        const bool desc = ((2 * lane) & size) == 0;
        if (desc ? key[0] < key[1] : key[0] > key[1]) {
          const unsigned long long t = key[0];
          key[0] = key[1];
          key[1] = t;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * lane + h;
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[h], stride / 2);
        // the lower element of a descending pair keeps the larger key
        key[h] = ((e & size) == 0) == ((e & stride) == 0) ? max(key[h], o) : min(key[h], o);
      }
    }
  }
}

struct Args {
  const float* x;          // (bk, D) f32
  const float* ln;         // (2, D) f32
  const uint8_t* emb;      // (V, D) bf16 or int8
  const float* emb_s;      // (V,) f32 row scales (int8)
  const float* sup;        // (V,) f32
  const int* ts_state;     // (bk, 4) int32, null outside grammar mode
  int bk, D, V, k, full_lse, ts_base, eot;
  int row_bytes, slices;   // D·(1 or 2); stages per tile
  // per row r and block b (row-major): the lists (vals, ids) and pairs
  float* pv; int* pi; float* pm; float* ps;
  float* qv; int* qi; float* qm; float* qs; float* qx;  // grammar
  int* sem;
  float* out_val;
  long long* out_tok;
  float* lse;
};

// the block's running state of one row
// a row's grammar state (ts_state)
struct RowState {
  int need_ts, need_text, min_ts;
};

// a lane's running logsumexp pair ← one more live column v (NEG adds
// nothing to the sum)
__device__ __forceinline__ void lse_add(float& m, float& s, float v) {
  if (v > m) {
    s = m == -INFINITY ? 0.f : s * expf(m - v);
    m = v;
  }
  if (v > NEG * 0.5f) s += expf(v - m);
}

template <bool INT8, int G>
__global__ void __launch_bounds__(kThreads, 1) logits_topk_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float lg[kQuarters][G * 8][kLgStride];  // the tile's dots per k quarter
  __shared__ RowState rs[kMaxRows];
  __shared__ int last;
  constexpr int ES = INT8 ? 1 : 2;
  constexpr int NS = G == 4 ? kStages - 1 : kStages;  // 25-32 rows' LN'd copy takes one
  constexpr int kRowIters = kMaxRows / kWarps;  // rows per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool grammar = a.ts_state != nullptr;
  const int D = a.D, xstride = D + (INT8 ? 32 : 16);  // conflict-free B loads
  uint8_t* ring = smem_raw;
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw + NS * kStageBytes);

  const int ntiles = n_tiles(a.V), nb = gridDim.x, blk = blockIdx.x;
  const int t0 = static_cast<int>(static_cast<long long>(ntiles) * blk / nb);
  const int t1 = static_cast<int>(static_cast<long long>(ntiles) * (blk + 1) / nb);
  const int total = (t1 - t0) * a.slices;

  // The next stage to request: tile it, slice jt, into slot qt % NS (the
  // stages of the block's tiles in order, slices of a tile in order). A
  // slice of a whole 256 bytes a row is 64 × 16 chunks of 16 bytes, two a
  // thread at fixed offsets; a narrower last slice takes the general path.
  int qt = 0, it = t0, jt = 0;
  auto issue = [&]() {
    if (qt < total) {
      const int v0 = it * kTile, b0 = jt * kSliceBytes;
      uint8_t* st = ring + (qt % NS) * kStageBytes;
      const uint8_t* src = a.emb + static_cast<size_t>(v0) * a.row_bytes + b0;
      if (b0 + kSliceBytes <= a.row_bytes) {
#pragma unroll
        for (int u = 0; u < kTile * 16 / kThreads; ++u) {
          const int i = tid + u * kThreads, r = i >> 4, c = i & 15;
          const bool live = v0 + r < a.V;
          cp_async16_n(st + r * kRowStride + 16 * c,
                       live ? src + r * a.row_bytes + 16 * c : a.emb, live ? 16 : 0);
        }
      } else {
        const int cpr = (a.row_bytes - b0) / 16;  // 16-byte chunks a row
        for (int i = tid; i < kTile * cpr; i += kThreads) {
          const int r = i / cpr, c = i - r * cpr;
          const bool live = v0 + r < a.V;
          cp_async16_n(st + r * kRowStride + 16 * c,
                       live ? src + r * a.row_bytes + 16 * c : a.emb, live ? 16 : 0);
        }
      }
      if (jt == a.slices - 1 && tid < (INT8 ? 32 : 16)) {
        // sup (16 chunks), then the row scales: bytes past V zero-filled
        const float* side = tid < 16 ? a.sup : a.emb_s;
        const int c = tid & 15, v = v0 + 4 * c;
        const int n = v < a.V ? 4 * min(4, a.V - v) : 0;
        cp_async16_n(st + kTile * kRowStride + (tid < 16 ? 0 : kTile * 4) + 16 * c,
                     n ? side + v : side, n);
      }
      ++qt;
      if (++jt == a.slices) {
        jt = 0;
        ++it;
      }
    }
    wis::cp_async_commit();
  };

  // the final LayerNorm, one warp a row, the row in registers (every load
  // in flight before the first reduction): f32 statistics, rounded once.
  // Nothing it reads queues behind the table: each warp's first row is
  // requested first, and gamma, beta and ts_state go to the ring's last
  // slot (free until the loop's first issue) as the first cp.async group.
  float xv[wis::kLnRegs][4];
  if (warp < a.bk) wis::ln_load(a.x + static_cast<size_t>(warp) * D, D, lane, xv);
  float* lnp = reinterpret_cast<float*>(ring + (NS - 1) * kStageBytes);  // (2, D)
  int* tsp = reinterpret_cast<int*>(lnp + 2 * D);                       // (bk, 4)
  for (int i = tid; i < D / 2; i += kThreads) cp_async16_n(lnp + 4 * i, a.ln + 4 * i, 16);
  if (grammar && tid < a.bk) cp_async16_n(tsp + 4 * tid, a.ts_state + 4 * tid, 16);
  wis::cp_async_commit();
  for (int q = 0; q < NS - 1; ++q) issue();
  wis::cp_async_wait<NS - 1>();
  __syncthreads();
  for (int r = warp; r < G * 8; r += kWarps) {
    __nv_bfloat16* dst = xn + r * xstride;
    float mean = 0.f, rstd = 0.f;
    if (r < a.bk) {
      if (r != warp) wis::ln_load(a.x + static_cast<size_t>(r) * D, D, lane, xv);
      wis::ln_stats(xv, D, lane, 1e-5f, mean, rstd);
    }
#pragma unroll
    for (int j = 0; j < wis::kLnRegs; ++j) {
      const int c = (j * 32 + lane) * 4;
      if (c < D) {
        uint2 o = make_uint2(0u, 0u);  // pad rows are zero
        if (r < a.bk) {
          const float4 gv = *reinterpret_cast<const float4*>(lnp + c);
          const float4 bv = *reinterpret_cast<const float4*>(lnp + D + c);
          o.x = wis::pack_bf16((xv[j][0] - mean) * rstd * gv.x + bv.x,
                               (xv[j][1] - mean) * rstd * gv.y + bv.y);
          o.y = wis::pack_bf16((xv[j][2] - mean) * rstd * gv.z + bv.z,
                               (xv[j][3] - mean) * rstd * gv.w + bv.w);
        }
        *reinterpret_cast<uint2*>(dst + c) = o;
      }
    }
    if (grammar && r < a.bk && lane == 0)
      rs[r] = RowState{tsp[4 * r], tsp[4 * r + 1], tsp[4 * r + 2]};
  }
  // this lane's running pairs of its rows r = warp + 16·i, and its entries
  // of their lists (the logits'; the timestamp-forced logits')
  float lm[kRowIters], ls[kRowIters], tm[kRowIters], ts[kRowIters], tx[kRowIters];
  float av[kRowIters], bv[kRowIters];
  int ai[kRowIters], bi[kRowIters];
#pragma unroll
  for (int i = 0; i < kRowIters; ++i) {
    lm[i] = tm[i] = tx[i] = av[i] = bv[i] = -INFINITY;
    ls[i] = ts[i] = 0.f;
    ai[i] = bi[i] = 0x7fffffff;
  }

  // The tensor cores take the k values of a 32-byte chunk of a table row in
  // a permuted order, the same in both operands: thread t's mma k pairs
  // (2t, 2t + 1) and (2t + 8, 2t + 9) are the chunk's columns 8t .. 8t + 3
  // (int8: and 8t + 4 .. 8t + 7 for a second k16 step) or 4t .. 4t + 3
  // (bf16), so each operand comes in with one 8- or 16-byte load. Warp w
  // takes m-tile w % 4 and the chunks ≡ w / 4 (mod 4) of each slice.
  const int mt = warp & 3, kq = warp >> 2, g = lane >> 2, t = lane & 3;
  const int arow = (mt * 16 + g) * kRowStride;  // this thread's A rows: arow, + 8 rows
  float acc[G][4];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;

  int tile = t0, j = 0;  // stage q's tile and slice
  for (int q = 0; q < total; ++q, j = j + 1 == a.slices ? 0 : j + 1, tile += j == 0) {
    wis::cp_async_wait<NS - 2>();
    __syncthreads();  // stage q is in for every thread; stage q − 1's slot is free
    issue();          // stage q + NS − 1
    const uint8_t* st = ring + (q % NS) * kStageBytes;
    const int b0 = j * kSliceBytes, chunks = min(kSliceBytes, a.row_bytes - b0) / 32;
    const __nv_bfloat16* xb = xn + g * xstride + b0 / ES;
#pragma unroll
    for (int cc = 0; cc < kSliceBytes / 32 / kQuarters; ++cc) {
      const int ch = kQuarters * cc + kq;
      if (ch < chunks) {
        const uint2 r0 = *reinterpret_cast<const uint2*>(st + arow + 32 * ch + 8 * t);
        const uint2 r1 =
            *reinterpret_cast<const uint2*>(st + arow + 8 * kRowStride + 32 * ch + 8 * t);
        if (INT8) {
          float f0[4], f1[4], h0[4], h1[4];
          wis::int8x4_to_float(r0.x, f0);
          wis::int8x4_to_float(r1.x, f1);
          wis::int8x4_to_float(r0.y, h0);
          wis::int8x4_to_float(r1.y, h1);
          const uint32_t a0[4] = {wis::pack_bf16(f0[0], f0[1]), wis::pack_bf16(f1[0], f1[1]),
                                  wis::pack_bf16(f0[2], f0[3]), wis::pack_bf16(f1[2], f1[3])};
          const uint32_t a1[4] = {wis::pack_bf16(h0[0], h0[1]), wis::pack_bf16(h1[0], h1[1]),
                                  wis::pack_bf16(h0[2], h0[3]), wis::pack_bf16(h1[2], h1[3])};
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const uint4 bq =
                *reinterpret_cast<const uint4*>(xb + gi * 8 * xstride + 32 * ch + 8 * t);
            wis::mma_bf16_16816(acc[gi], a0, bq.x, bq.y);
            wis::mma_bf16_16816(acc[gi], a1, bq.z, bq.w);
          }
        } else {
          const uint32_t af[4] = {r0.x, r1.x, r0.y, r1.y};
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const uint2 bq =
                *reinterpret_cast<const uint2*>(xb + gi * 8 * xstride + 16 * ch + 4 * t);
            wis::mma_bf16_16816(acc[gi], af, bq.x, bq.y);
          }
        }
      }
    }
    if (j != a.slices - 1) continue;

    // ---- the tile's epilogue ------------------------------------------------
    // acc[gi][e] is vocabulary row mt·16 + g + 8·(e >> 1) of x row
    // 8·gi + 2t + (e & 1); each k quarter into its own buffer, summed below
    // in the order 0, 1, 2, 3
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lg[kq][gi * 8 + 2 * t + (e & 1)][mt * 16 + g + 8 * (e >> 1)] = acc[gi][e];
        acc[gi][e] = 0.f;
      }
    __syncthreads();

    const float* side = reinterpret_cast<const float*>(st + kTile * kRowStride);
    const int v0 = tile * kTile;
#pragma unroll
    for (int i = 0; i < kRowIters; ++i) {
      const int r = warp + kWarps * i;
      if (r >= a.bk) break;
      const RowState s = grammar ? rs[r] : RowState{};
      float l[2], fl[2];
      int id[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, v = v0 + c;
        id[h] = v;
        float dot = ((lg[0][r][c] + lg[1][r][c]) + lg[2][r][c]) + lg[3][r][c];
        if (INT8) dot = dot * side[kTile + c];
        l[h] = dot + side[c];
        const bool is_ts = v >= a.ts_base;
        if (grammar && ((s.need_ts > 0 && v < a.eot) || (s.need_text > 0 && is_ts) ||
                        (is_ts && v < s.min_ts)))
          l[h] = NEG;
        fl[h] = is_ts ? l[h] : NEG;  // the timestamp-forced logits
        if (v < a.V) {
          lse_add(lm[i], ls[i], a.full_lse ? dot : l[h]);
          if (grammar) {
            if (is_ts) lse_add(tm[i], ts[i], l[h]);
            else tx[i] = fmaxf(tx[i], l[h]);
          }
        } else {
          l[h] = fl[h] = -INFINITY;  // past V: never a candidate
          id[h] = 0x7fffffff;
        }
      }
      if (grammar) {
        const Entry e = merge_tile({bv[i], bi[i]}, a.k, fl[0], id[0], fl[1], id[1], lane);
        bv[i] = e.v;
        bi[i] = e.i;
      }
      const Entry e = merge_tile({av[i], ai[i]}, a.k, l[0], id[0], l[1], id[1], lane);
      av[i] = e.v;
      ai[i] = e.i;
    }
  }

  // ---- the block's lists and pairs out; the last block folds them ----------
  // each row's pairs, the lanes' merged; its lists padded to kMaxK entries
  const int bk = a.bk, k = a.k;
#pragma unroll
  for (int i = 0; i < kRowIters; ++i) {
    const int r = warp + kWarps * i;
    if (r >= bk) break;
    const Pair pl = warp_lse({lm[i], ls[i]});
    const Pair pt = grammar ? warp_lse({tm[i], ts[i]}) : Pair{-INFINITY, 0.f};
    tx[i] = warp_max(tx[i]);
    const size_t o = static_cast<size_t>(r) * nb + blk;  // row-major: a row's are adjacent
    if (lane < kMaxK) {
      a.pv[o * kMaxK + lane] = av[i];
      a.pi[o * kMaxK + lane] = ai[i];
      if (grammar) {
        a.qv[o * kMaxK + lane] = bv[i];
        a.qi[o * kMaxK + lane] = bi[i];
      }
    }
    if (lane == 0) {
      a.pm[o] = pl.m;
      a.ps[o] = pl.s;
      if (grammar) {
        a.qm[o] = pt.m;
        a.qs[o] = pt.s;
        a.qx[o] = tx[i];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.sem, 1) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The fold, one warp a row.
  constexpr int kPerLane = (kMaxGrid + 31) / 32;
  constexpr int kNone = 0x7fffffff;  // a padding entry: after every real one
  float* room_v = reinterpret_cast<float*>(smem_raw) + static_cast<size_t>(warp) * nb * 2 * kMaxK;
  int* room_i = reinterpret_cast<int*>(room_v + nb * kMaxK);
#pragma unroll 1
  for (int r = warp; r < bk; r += kWarps) {
    // the pairs: lane takes blocks lane + 32·j in order, then the lanes
    float pm[kPerLane], ps[kPerLane], qm[kPerLane], qs[kPerLane], qx[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int b = lane + 32 * j;
      const size_t o = static_cast<size_t>(r) * nb + b;
      const bool in = b < nb;
      pm[j] = in ? __ldcg(a.pm + o) : -INFINITY;
      ps[j] = in ? __ldcg(a.ps + o) : 0.f;
      qm[j] = in && grammar ? __ldcg(a.qm + o) : -INFINITY;
      qs[j] = in && grammar ? __ldcg(a.qs + o) : 0.f;
      qx[j] = in && grammar ? __ldcg(a.qx + o) : -INFINITY;
    }
    Pair row{-INFINITY, 0.f}, ts_pair{-INFINITY, 0.f};
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      row = lse_merge(row, {pm[j], ps[j]});
      if (grammar) ts_pair = lse_merge(ts_pair, {qm[j], qs[j]});
      mx = fmaxf(mx, qx[j]);
    }
    row = warp_lse(row);
    float row_lse = row.m + logf(fmaxf(row.s, 1e-30f));
    bool force = false;
    if (grammar) {
      ts_pair = warp_lse(ts_pair);
      const float lse_ts = ts_pair.m + logf(fmaxf(ts_pair.s, 1e-30f));
      force = lse_ts > warp_max(mx);
      if (force && !a.full_lse) row_lse = lse_ts;
    }
    if (lane == 0) a.lse[r] = row_lse;
    // the chosen lists of every block, staged into this warp's room of
    // shared memory (the ring and the LN'd rows are free now)
    const float* lv = force ? a.qv : a.pv;
    const int* li = force ? a.qi : a.pi;
    __syncwarp();  // the warp's last row is read out of the room
#pragma unroll 4
    for (int u = lane; u < nb * 2; u += 32) {
      const size_t o = static_cast<size_t>(r) * nb * 2 + u;
      reinterpret_cast<float4*>(room_v)[u] = __ldcg(reinterpret_cast<const float4*>(lv) + o);
      reinterpret_cast<int4*>(room_i)[u] = __ldcg(reinterpret_cast<const int4*>(li) + o);
    }
    __syncwarp();
    // a floor of the k-th best: the best of the blocks' k-th entries (that
    // block alone holds k entries at or above it). The entries at or above
    // it (those of slots below k) are compacted to the front of the room
    // in entry order — each pass's entries are read before any is written,
    // and none is written past them.
    float floor_k = -INFINITY;
    for (int b = lane; b < nb; b += 32) floor_k = fmaxf(floor_k, room_v[b * kMaxK + k - 1]);
    floor_k = warp_max(floor_k);
    int n = 0;
#pragma unroll 1
    for (int e0 = 0; e0 < nb * kMaxK; e0 += 64) {
      const int e = e0 + 2 * lane;
      const bool in = e < nb * kMaxK;
      const float2 v = in ? *reinterpret_cast<const float2*>(room_v + e)
                          : make_float2(-INFINITY, -INFINITY);
      const int2 id = in ? *reinterpret_cast<const int2*>(room_i + e) : make_int2(0, 0);
      const bool keep0 = in && e % kMaxK < k && v.x >= floor_k;
      const bool keep1 = in && e % kMaxK + 1 < k && v.y >= floor_k;
      const unsigned m0 = __ballot_sync(0xffffffffu, keep0);
      const unsigned m1 = __ballot_sync(0xffffffffu, keep1);
      __syncwarp();
      const unsigned below = (1u << lane) - 1u;
      const int at = n + __popc(m0 & below) + __popc(m1 & below);
      if (keep0) {
        room_v[at] = v.x;
        room_i[at] = id.x;
      }
      if (keep1) {
        room_v[at + keep0] = v.y;
        room_i[at + keep0] = id.y;
      }
      n += __popc(m0) + __popc(m1);
    }
    __syncwarp();
    if (n <= 64) {
      // at most 64 candidates: sorted across the warp, two a lane, as keys
      // (value, then the lower id first)
      unsigned long long key[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * lane + h;
        key[h] = e < n ? (static_cast<unsigned long long>(wis::ordered(room_v[e])) << 32) |
                             static_cast<uint32_t>(kNone - room_i[e])
                       : 0ull;
      }
      warp_sort64_desc(key, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * lane + h;
        if (e < k) {
          a.out_val[r * k + e] = wis::from_ordered(static_cast<uint32_t>(key[h] >> 32));
          a.out_tok[r * k + e] = kNone - static_cast<int>(key[h] & 0x7fffffffu);
        }
      }
    } else {
      // more (ties at the floor): merged 64 a pass into the warp's list
      Entry f{-INFINITY, kNone};
#pragma unroll 1
      for (int e0 = 0; e0 < n; e0 += 64) {
        const int e = e0 + 2 * lane;
        f = merge_tile(f, k, e < n ? room_v[e] : -INFINITY, e < n ? room_i[e] : kNone,
                       e + 1 < n ? room_v[e + 1] : -INFINITY, e + 1 < n ? room_i[e + 1] : kNone,
                       lane);
      }
      if (lane < k) {
        a.out_val[r * k + lane] = f.v;
        a.out_tok[r * k + lane] = f.i;
      }
    }
  }
  if (tid == 0) *a.sem = 0;  // ready for the next launch
}

template <bool INT8, int G>
cudaError_t launch_g(const Args& a, int nb, size_t smem, cudaStream_t st) {
  static size_t opted = 0;  // the opt-in above 48 KB, raised as needed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        logits_topk_kernel<INT8, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  logits_topk_kernel<INT8, G><<<nb, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool INT8>
cudaError_t launch(const Args& a, int nb, size_t smem, cudaStream_t st) {
  switch ((a.bk + 7) / 8) {
    case 1: return launch_g<INT8, 1>(a, nb, smem, st);
    case 2: return launch_g<INT8, 2>(a, nb, smem, st);
    case 3: return launch_g<INT8, 3>(a, nb, smem, st);
    default: return launch_g<INT8, 4>(a, nb, smem, st);
  }
}

}  // namespace

// Scratch bytes for every block's lists and pairs (twice the lists and
// three more pairs in grammar mode).
extern "C" long long wis_fused_logits_workspace_bytes(int bk, int V, int k, int grammar) {
  if (bk < 1 || bk > kMaxRows || k < 1 || k > kMaxK || V < 1) return 0;
  const size_t nb = n_blocks(V);
  const size_t list = align256(sizeof(float) * nb * bk * kMaxK);
  const size_t pair = align256(sizeof(float) * nb * bk);
  return static_cast<long long>(grammar ? 4 * list + 5 * pair : 2 * list + 2 * pair);
}

// x (BK, D) f32; ln (2, D) f32 (gamma, beta); emb (V, D) bf16, or int8
// with emb_s (V,) f32 row scales (emb_int8 = 1); sup (V,) f32; ts_state
// (BK, 4) int32 for grammar mode, or null. Outputs: out_val (BK, k) f32
// suppressed logits, out_tok (BK, k) int64, lse (BK,) f32. ws holds
// wis_fused_logits_workspace_bytes; sem is one int32 counter, 0 before the
// first launch (each launch leaves it at 0), that no other launch uses at
// the same time. D a multiple of 32 up to the shared memory's room (BK 32:
// D ≤ 1472), BK ≤ 32, k ≤ 8 and k ≤ V; the wrapper checks.
extern "C" int wis_fused_logits_topk(const void* x, const void* ln, const void* emb,
                                     const void* emb_s, const void* sup, const void* ts_state,
                                     int bk, int D, int V, int k, int full_lse, int emb_int8,
                                     int ts_base, int eot, void* ws, void* out_val,
                                     void* out_tok, void* lse, void* stream, void* sem) {
  if (bk < 1 || bk > kMaxRows || k < 1 || k > kMaxK || k > V || D < 32 || D % 32 ||
      D > 128 * wis::kLnRegs || !sem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (bk + 7) / 8;
  const int nb = std::min(n_blocks(V), sm_count());
  // the ring and the LN'd rows; the last block's fold reuses them as one
  // room of every block's lists per warp with a row
  const size_t smem = std::max(
      static_cast<size_t>(G == 4 ? kStages - 1 : kStages) * kStageBytes +
          sizeof(__nv_bfloat16) * G * 8 * (D + (emb_int8 ? 32 : 16)),
      static_cast<size_t>(std::min(bk, kWarps)) * nb * 2 * kMaxK * sizeof(float));
  const bool grammar = ts_state != nullptr;
  const size_t nbs = n_blocks(V);  // the workspace's blocks: nb or more
  const size_t list = align256(sizeof(float) * nbs * bk * kMaxK);
  const size_t pair = align256(sizeof(float) * nbs * bk);
  char* p = static_cast<char*>(ws);
  Args a{};
  a.x = static_cast<const float*>(x);
  a.ln = static_cast<const float*>(ln);
  a.emb = static_cast<const uint8_t*>(emb);
  a.emb_s = static_cast<const float*>(emb_s);
  a.sup = static_cast<const float*>(sup);
  a.ts_state = static_cast<const int*>(ts_state);
  a.bk = bk;
  a.D = D;
  a.V = V;
  a.k = k;
  a.full_lse = full_lse;
  a.ts_base = ts_base;
  a.eot = eot;
  a.row_bytes = D * (emb_int8 ? 1 : 2);
  a.slices = (a.row_bytes + kSliceBytes - 1) / kSliceBytes;
  a.pv = reinterpret_cast<float*>(p);
  a.pi = reinterpret_cast<int*>(p + list);
  a.pm = reinterpret_cast<float*>(p + 2 * list);
  a.ps = reinterpret_cast<float*>(p + 2 * list + pair);
  if (grammar) {
    p += 2 * list + 2 * pair;
    a.qv = reinterpret_cast<float*>(p);
    a.qi = reinterpret_cast<int*>(p + list);
    a.qm = reinterpret_cast<float*>(p + 2 * list);
    a.qs = reinterpret_cast<float*>(p + 2 * list + pair);
    a.qx = reinterpret_cast<float*>(p + 2 * list + 2 * pair);
  }
  a.sem = static_cast<int*>(sem);
  a.out_val = static_cast<float*>(out_val);
  a.out_tok = static_cast<long long*>(out_tok);
  a.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = emb_int8 ? launch<true>(a, nb, smem, st) : launch<false>(a, nb, smem, st);
  return static_cast<int>(e);
}
