// One beam-decode token through all Whisper decoder layers — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/fused_decode.py
// `build_fused_decode_step` (its pallas_call runs all L layers in one
// launch; oracle `fused_decode_step_reference`). Per layer, as the TPU
// kernel computes it:
//
//   h  = bf16(LN1(x));  q, k, v = h·W{q,k,v} · s + b          (f32)
//   self-attention over the time-major cache with the `sel` mask and an
//   explicit self column; this step's bf16 K/V written at pos·BK + row
//   x += bf16(attn)·Wo · s + b
//   h  = bf16(LN2(x));  qc = h·Wcq · s + b
//   cross-attention over bf16 or per-column int8 K/V (scales outside the
//   contraction), pad columns and other sequences' windows masked
//   x += bf16(ctx)·Wco · s + b
//   h  = bf16(LN3(x));  g_i = bf16(gelu_tanh(h·W1_i · s + b))  (i < 4)
//   x  = (x + (Σ_i g_i·W2_i) · s) + b
//
// Bound on the H100: device-memory bytes. Each token streams the 14 int8
// (D, D) weight chunks of every layer (734 MB on large-v2), the cross-KV
// and the selected cache columns once; activations are a few KB. A layer
// is eight launches: three products with a LayerNorm prologue (q/k/v,
// cross q, W1 with gelu), self-attention, cross-attention, and three
// products that add into the f32 residual (Wo, Wco, W2 with its one
// deferred scale). What each keeps to (decode_step.cuh holds the
// products and self-attention):
//
//   - products: a block owns a 64-column strip of one chunk and one split
//     of K, at most one block per SM (a slab of at most 40 KB). Each
//     warp's first LayerNorm row is requested first, then the whole weight
//     slab (64-byte rows: two full sectors each) is put in flight with
//     cp.async in four stages; the LayerNorm prologue over the block's k
//     range runs while the weight arrives, and the product starts on stage
//     0 while the rest lands. The tensor cores do the multiply-adds
//     (mma.m16n8k16 bf16, f32 accumulators) on outᵀ = Wᵀ·actᵀ: the int8
//     weight is the A operand, widened exactly in registers (one byte
//     permute and one add per value), the step's rows the B operand, eight
//     per n8 group. The splits of a strip (at most 8) are one thread-block
//     cluster: each keeps its f32 partial sums in shared memory and, after
//     a cluster barrier, each sums its share of the strip over all the
//     splits in order through distributed shared memory and applies the
//     epilogue — no global partials, atomics or second launch.
//   - self-attention: one block per (head, time split) for every row of
//     the step, so a column that several rows select is read once, and
//     the columns are read coalesced along the time-major cache rows; sel
//     is turned into a per-column row mask, each row's selected columns
//     into a list, so the scores and P·V touch only those. The splits of
//     a head are one cluster and merge their (max, sum, P·V) in order with
//     the self column the same way.
//   - cross-attention: one block per (head, window, column split); the
//     tile's K and V columns are loaded into shared memory once and scored
//     for every row of the window on the tensor cores, so each layer's
//     cross-KV is read once; the splits merge as above. Pad columns and
//     other windows' columns are never read.
//
// Rounding: both attentions round the unnormalised e (cross-attention: e
// times the V column scale) to bf16 for P·V and divide once after the
// merge; the TPU kernel's cross-attention divides before rounding.
// Everything else rounds where the TPU kernel does. Split sums run in a
// fixed order, so two calls on the same inputs give the same bits.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_step.cuh"

namespace {

constexpr int NC = 14;
constexpr int QW = 0, OW = 3, CQW = 4, COW = 5, W1_0 = 6, W2_0 = 10;

struct CrossArgs {
  const float* q;            // (bk, D) f32
  const void* xk;            // one layer's (H, 64, sx) int8 or bf16
  const void* xv;
  const __nv_bfloat16* xs;   // int8: one layer's (2H, sx) column scales
  __nv_bfloat16* out;        // (bk, D)
  int D, sx, s_pad, s_audio, rpw, cw;
  float scale;
};

// Shared memory of one cross-attention block: the K and V tiles [64][cw]
// (rows padded to an odd number of words), the column scales, the f32
// scores [rpw][cw], bf16(q) [8·G][72] and P [8·G][cw + 8] as the tensor
// cores' B operands, the split's P·V [rpw][64] and its row statistics.
struct CrossSmem {
  int row_bytes, kt, vt, ksc, vsc, sc, q16, p16, o, red, stats, bytes;
  __host__ __device__ CrossSmem(int rpw, int cw, bool int8) {
    const int G = (rpw + kRowGroup - 1) / kRowGroup;
    row_bytes = cw * (int8 ? 1 : 2) + 4;
    kt = 0;
    vt = kt + kHeadDim * row_bytes;
    ksc = (vt + kHeadDim * row_bytes + 15) & ~15;
    vsc = ksc + 4 * cw;
    sc = vsc + 4 * cw;
    q16 = sc + 4 * rpw * cw;
    p16 = q16 + 2 * G * kRowGroup * (kHeadDim + 8);
    o = p16 + 2 * G * kRowGroup * (cw + 8);
    red = o + 4 * rpw * kHeadDim;
    stats = red + 4 * 4 * G * 4 * 32;
    bytes = stats + 4 * 3 * kMaxRows;
  }
};

// the longest window the cross-attention takes (Whisper's is 1500):
// kMaxSplits splits of 256 columns, whose block fits at every row count
// (136 KB at 32 rows of bf16 cross-KV)
constexpr int kMaxAudio = 2048;

// columns per cross-attention block (a multiple of 32): about two blocks
// per SM over the heads and windows, at most kMaxSplits splits (one
// cluster), and more splits where a block would not fit in kMaxSmem
// (many windows over few heads: 768 bf16 columns take 217 KB at one row)
int plan_cross(int H, int n_seq, int rpw, bool int8, int s_audio) {
  const auto cols = [s_audio](int splits) { return cdiv(cdiv(s_audio, splits), 32) * 32; };
  int want = std::max(1, std::min(kMaxSplits, cdiv(2 * sm_count(), H * n_seq)));
  while (want < kMaxSplits && CrossSmem(rpw, cols(want), int8).bytes > kMaxSmem) ++want;
  return cols(want);
}

// the A-operand pairs (k, k + 1) of columns c and c + 1 (c even) from two
// tile rows k and k + 1 (int8 widened exactly, or bf16 as stored)
template <bool INT8>
__device__ __forceinline__ void tile_pairs(const unsigned char* r0, const unsigned char* r1, int c,
                                           uint32_t& lo, uint32_t& hi) {
  if (INT8) {
    const uint32_t a = *reinterpret_cast<const uint16_t*>(r0 + c);
    const uint32_t b = *reinterpret_cast<const uint16_t*>(r1 + c);
    float f[4];
    int8x4_to_float(__byte_perm(a, b, 0x5140), f);
    lo = wis::pack_bf16(f[0], f[1]);
    hi = wis::pack_bf16(f[2], f[3]);
  } else {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(r0 + 2 * c);
    const uint32_t b = *reinterpret_cast<const uint32_t*>(r1 + 2 * c);
    lo = __byte_perm(a, b, 0x5410);
    hi = __byte_perm(a, b, 0x7632);
  }
}

// the A-operand pair (c, c + 1) of one tile row (c even)
template <bool INT8>
__device__ __forceinline__ uint32_t row_pair(const unsigned char* r, int c) {
  if (INT8) {
    float f[4];
    int8x4_to_float(*reinterpret_cast<const uint16_t*>(r + c), f);
    return wis::pack_bf16(f[0], f[1]);
  }
  return *reinterpret_cast<const uint32_t*>(r + 2 * c);
}

// Cross-attention of head h, window w, columns [z·cw, z·cw + cw) of the
// window's first s_audio (grid (H, n_seq, splits)): the tile of K and V
// columns is loaded into shared memory once and scored for every row of
// the window. Scores bf16(q)·K × scale, then × the K column scales
// (int8); e = exp(s − m_z); the split keeps m_z, Σ e (f32) and
// P·V with P = bf16(e × the V column scale) (int8) or bf16(e); the splits
// of (h, w) are one cluster and merge in order z = 0, 1, ... through
// distributed shared memory, dividing once. Both products run on the
// tensor cores (mma.m16n8k16 bf16, f32 accumulators; the int8 K and V
// widened exactly in registers): Sᵀ = Kᵀ·qᵀ with m = the tile's columns,
// k = the head dims, n = the rows, and (P·V)ᵀ = V·Pᵀ with m = the head
// dims, k = the columns. Pad columns (≥ s_audio) and other windows'
// columns are never read.
template <bool INT8, int G>
__global__ void __launch_bounds__(kThreads) cross_attention_kernel(CrossArgs a) {
  constexpr int E = INT8 ? 1 : 2;  // bytes per element
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, w = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cw = a.cw, rpw = a.rpw;
  const int j0 = z * cw, n = min(cw, a.s_audio - j0), n16 = (n + 15) & ~15;
  const CrossSmem L(rpw, cw, INT8);
  const int row_bytes = L.row_bytes, qs = kHeadDim + 8, ps = cw + 8;
  unsigned char* kt = smem_raw + L.kt;
  unsigned char* vt = smem_raw + L.vt;
  float* ksc = reinterpret_cast<float*>(smem_raw + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem_raw + L.vsc);
  float* sc = reinterpret_cast<float*>(smem_raw + L.sc);                      // [rpw][cw]
  __nv_bfloat16* q16 = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q16);    // [8G][72]
  __nv_bfloat16* p16 = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.p16);    // [8G][cw + 8]
  float* o_sm = reinterpret_cast<float*>(smem_raw + L.o);                     // [rpw][64]
  float* red = reinterpret_cast<float*>(smem_raw + L.red);                    // [4][G][4][32]
  float* m_sm = reinterpret_cast<float*>(smem_raw + L.stats);                 // [kMaxRows] each
  float* l_sm = m_sm + kMaxRows;
  float* den = l_sm + kMaxRows;

  const size_t col0 = static_cast<size_t>(w) * a.s_pad + j0;
  const unsigned char* xk = static_cast<const unsigned char*>(a.xk) +
                            (static_cast<size_t>(h) * kHeadDim * a.sx + col0) * E;
  const unsigned char* xv = static_cast<const unsigned char*>(a.xv) +
                            (static_cast<size_t>(h) * kHeadDim * a.sx + col0) * E;
  // the tile: 16-byte loads inside the real columns, four of each in
  // flight per thread, single elements at the ragged end, zeros past it to
  // a whole k16 step (never loaded)
  const int vec = n * E / 16, rb = n16 * E;
  for (int i0 = tid; i0 < kHeadDim * vec; i0 += 4 * kThreads) {
    uint4 kv[4], vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, d = i / vec, c = (i - d * vec) * 16;
      if (i < kHeadDim * vec) {
        kv[u] = __ldg(reinterpret_cast<const uint4*>(xk + static_cast<size_t>(d) * a.sx * E + c));
        vv[u] = __ldg(reinterpret_cast<const uint4*>(xv + static_cast<size_t>(d) * a.sx * E + c));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, d = i / vec, c = (i - d * vec) * 16;
      if (i >= kHeadDim * vec) continue;
      uint32_t* kd = reinterpret_cast<uint32_t*>(kt + d * row_bytes + c);
      uint32_t* vd = reinterpret_cast<uint32_t*>(vt + d * row_bytes + c);
      kd[0] = kv[u].x; kd[1] = kv[u].y; kd[2] = kv[u].z; kd[3] = kv[u].w;
      vd[0] = vv[u].x; vd[1] = vv[u].y; vd[2] = vv[u].z; vd[3] = vv[u].w;
    }
  }
  const int tail = rb - vec * 16;
  for (int i = tid; i < kHeadDim * tail; i += kThreads) {
    const int d = i / tail, c = vec * 16 + (i - d * tail);
    const bool real = c < n * E;
    kt[d * row_bytes + c] = real ? xk[static_cast<size_t>(d) * a.sx * E + c] : 0;
    vt[d * row_bytes + c] = real ? xv[static_cast<size_t>(d) * a.sx * E + c] : 0;
  }
  for (int j = tid; j < n16; j += kThreads) {
    ksc[j] = INT8 && j < n ? __bfloat162float(a.xs[static_cast<size_t>(2 * h) * a.sx + col0 + j]) : 1.f;
    vsc[j] = INT8 && j < n ? __bfloat162float(a.xs[static_cast<size_t>(2 * h + 1) * a.sx + col0 + j]) : 1.f;
  }
  for (int i = tid; i < G * kRowGroup * (kHeadDim / 2); i += kThreads) {
    const int r = i / (kHeadDim / 2), d = (i - r * (kHeadDim / 2)) * 2;
    float2 q = make_float2(0.f, 0.f);
    if (r < rpw)
      q = *reinterpret_cast<const float2*>(a.q + static_cast<size_t>(w * rpw + r) * a.D +
                                           h * kHeadDim + d);
    *reinterpret_cast<uint32_t*>(q16 + r * qs + d) = wis::pack_bf16(q.x, q.y);
  }
  __syncthreads();

  // Sᵀ = Kᵀ·qᵀ: warp w takes the column m-tiles w, w + 8, ...; A row g of
  // an m-tile is column 2g, row g + 8 column 2g + 1
  for (int mt = warp; mt < n16 / 16; mt += kWarps) {
    const int col = mt * 16 + 2 * g;
    float acc[G][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kHeadDim; kb += 16) {
      uint32_t af[4];
      const unsigned char* r0 = kt + (kb + 2 * t) * row_bytes;
      tile_pairs<INT8>(r0, r0 + row_bytes, col, af[0], af[1]);
      tile_pairs<INT8>(r0 + 8 * row_bytes, r0 + 9 * row_bytes, col, af[2], af[3]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const __nv_bfloat16* br = q16 + (gi * kRowGroup + g) * qs + kb + 2 * t;
        wis::mma_bf16_16816(acc[gi], af, wis::load_pair(br), wis::load_pair(br + 8));
      }
    }
    // acc[gi][e]: column col + (e >> 1), row 8·gi + 2t + (e & 1)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gi * kRowGroup + 2 * t + (e & 1), j = col + (e >> 1);
        if (r < rpw) {
          float s = acc[gi][e] * a.scale;
          if (INT8) s = s * ksc[j];
          sc[r * cw + j] = s;
        }
      }
  }
  __syncthreads();
  // each row's split softmax: m_z, Σ e and P (zero past n), one warp per row
  for (int r = warp; r < G * kRowGroup; r += kWarps) {
    __nv_bfloat16* pr = p16 + r * ps;
    if (r >= rpw) {
      for (int j = lane; j < n16; j += 32) pr[j] = __float2bfloat16_rn(0.f);
      continue;
    }
    const float* sr = sc + r * cw;
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n16; j += 32) {
      float p = 0.f;
      if (j < n) {
        const float e = expf(sr[j] - mx);
        sum += e;
        p = INT8 ? e * vsc[j] : e;
      }
      pr[j] = __float2bfloat16_rn(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_sm[r] = mx;
      l_sm[r] = sum;
    }
  }
  __syncthreads();
  // (P·V)ᵀ = V·Pᵀ: warp w takes head-dim m-tile w % 4 over every other k16
  // step of the columns (half w / 4); the halves are summed in order
  {
    const int mt = warp & 3, kh = warp >> 2;
    float acc[G][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
    const unsigned char* v0 = vt + (mt * 16 + g) * row_bytes;
    const unsigned char* v8 = v0 + 8 * row_bytes;
    for (int kb = 16 * kh; kb < n16; kb += 32) {
      uint32_t af[4];
      af[0] = row_pair<INT8>(v0, kb + 2 * t);
      af[1] = row_pair<INT8>(v8, kb + 2 * t);
      af[2] = row_pair<INT8>(v0, kb + 2 * t + 8);
      af[3] = row_pair<INT8>(v8, kb + 2 * t + 8);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const __nv_bfloat16* br = p16 + (gi * kRowGroup + g) * ps + kb + 2 * t;
        wis::mma_bf16_16816(acc[gi], af, wis::load_pair(br), wis::load_pair(br + 8));
      }
    }
    float* rw = red + mt * G * 4 * 32;
    if (kh == 1) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < 4; ++e) rw[(gi * 4 + e) * 32 + lane] = acc[gi][e];
    }
    __syncthreads();
    if (kh == 0) {
      // acc[gi][e]: head dim mt·16 + g + 8·(e >> 1), row 8·gi + 2t + (e & 1)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = gi * kRowGroup + 2 * t + (e & 1), d = mt * 16 + g + 8 * (e >> 1);
          if (r < rpw) o_sm[r * kHeadDim + d] = acc[gi][e] + rw[(gi * 4 + e) * 32 + lane];
        }
    }
  }

  // the merge through distributed shared memory: out = Σ_z P·V_z·e^(m_z − M) / den
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* fz = sc;                      // [kMaxSplits][rpw]
  float* lz = sc + kMaxSplits * rpw;   // [kMaxSplits][rpw]
  softmax_merge_factors(cluster, m_sm, l_sm, nullptr, rpw, fz, lz, nullptr, den);
  merge_splits(
      cluster, o_sm, rpw * kHeadDim,
      [&](int zz, int item) { return fz[zz * rpw + item / kHeadDim]; },
      [&](int item, float num) {
        const int r = item / kHeadDim, d = item - r * kHeadDim;
        a.out[static_cast<size_t>(w * rpw + r) * a.D + h * kHeadDim + d] =
            __float2bfloat16_rn(num / den[r]);
      });
}

// the instance for the row groups of a window (opted in to the shared
// memory it may need, once each)
template <bool INT8, int G>
cudaError_t cross_instance(void (**k)(CrossArgs)) {
  static bool opted = false;
  *k = cross_attention_kernel<INT8, G>;
  return allow_smem(*k, &opted);
}

cudaError_t cross_kernel(bool int8, int rpw, void (**k)(CrossArgs)) {
  switch ((rpw + kRowGroup - 1) / kRowGroup) {
    case 1: return int8 ? cross_instance<true, 1>(k) : cross_instance<false, 1>(k);
    case 2: return int8 ? cross_instance<true, 2>(k) : cross_instance<false, 2>(k);
    case 3: return int8 ? cross_instance<true, 3>(k) : cross_instance<false, 3>(k);
    default: return int8 ? cross_instance<true, 4>(k) : cross_instance<false, 4>(k);
  }
}

struct Workspace {
  float* qkv;            // (BK, 3D) f32
  float* qc;             // (BK, D) f32
  __nv_bfloat16* attn;   // (BK, D)
  __nv_bfloat16* ctx;    // (BK, D)
  __nv_bfloat16* g;      // (BK, 4D)
  size_t bytes;
};

Workspace carve(void* base, int D, int bk) {
  Workspace w{};
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](size_t n) {
    char* q = p ? p + off : nullptr;
    off += align256(n);
    return q;
  };
  w.qkv = reinterpret_cast<float*>(take(sizeof(float) * bk * 3 * D));
  w.qc = reinterpret_cast<float*>(take(sizeof(float) * bk * D));
  w.attn = reinterpret_cast<__nv_bfloat16*>(take(2 * bk * D));
  w.ctx = reinterpret_cast<__nv_bfloat16*>(take(2 * bk * D));
  w.g = reinterpret_cast<__nv_bfloat16*>(take(2 * bk * 4 * D));
  w.bytes = off;
  return w;
}

}  // namespace

// Bytes of scratch one step needs (0 for shapes the kernels do not take).
extern "C" long long wis_fused_decode_workspace_bytes(int D, int bk) {
  if (D <= 0 || D % 64 || bk < 1 || bk > kMaxRows) return 0;
  return static_cast<long long>(carve(nullptr, D, bk).bytes);
}

// One decode step through all L layers. x (BK, D) f32 holds x_emb on entry
// and x_out on return; k/v_cache (L, D, BK·T) bf16 are written in place at
// columns pos·BK + row; xa_k/xa_v (L, H, 64, n_seq·s_pad) bf16, or int8
// with xa_s (L, 2H, n_seq·s_pad) bf16 scales (xa_s null for bf16); sel
// (BK, BK·T) f32. w (L, 14, D, D) int8, s/b (L, 14, D) f32, ln (L, 6, D)
// f32. Head dim 64, D a multiple of 64, BK ≤ 32, BK·T a multiple of 8,
// s_audio ≤ 2048; the wrapper checks.
extern "C" int wis_fused_decode_step(const void* w, const void* s, const void* b,
                                     const void* ln, void* x, void* k_cache, void* v_cache,
                                     const void* xa_k, const void* xa_v, const void* xa_s,
                                     const void* sel, int pos, void* ws, int L, int D, int H,
                                     int bk, int t_cache, int n_seq, int s_pad, int s_audio,
                                     void* stream) {
  if (D != H * kHeadDim || D % 64 || bk < 1 || bk > kMaxRows || n_seq < 1 || bk % n_seq ||
      s_audio < 1 || s_audio > s_pad || s_audio > kMaxAudio || pos < 0 || pos >= t_cache ||
      bk * t_cache % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace wk = carve(ws, D, bk);
  const int bkt = bk * t_cache, sx = n_seq * s_pad, rpw = bk / n_seq;
  const bool xa_int8 = xa_s != nullptr;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const size_t dd = static_cast<size_t>(D) * D;
  float* xf = static_cast<float*>(x);
  const int cw = plan_cross(H, n_seq, rpw, xa_int8, s_audio), cross_splits = cdiv(s_audio, cw);
  const dim3 cross_grid(H, n_seq, cross_splits);
  const size_t csmem = CrossSmem(rpw, cw, xa_int8).bytes;
  if (csmem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  void (*cross)(CrossArgs) = nullptr;
  cudaError_t e = cross_kernel(xa_int8, rpw, &cross);
  if (e != cudaSuccess) return static_cast<int>(e);

  for (int l = 0; l < L && e == cudaSuccess; ++l) {
    const int8_t* wl = static_cast<const int8_t*>(w) + l * NC * dd;
    const float* sl = static_cast<const float*>(s) + static_cast<size_t>(l) * NC * D;
    const float* bl = static_cast<const float*>(b) + static_cast<size_t>(l) * NC * D;
    const float* lnl = static_cast<const float*>(ln) + static_cast<size_t>(l) * 6 * D;
    __nv_bfloat16* kcl = static_cast<__nv_bfloat16*>(k_cache) + static_cast<size_t>(l) * D * bkt;
    __nv_bfloat16* vcl = static_cast<__nv_bfloat16*>(v_cache) + static_cast<size_t>(l) * D * bkt;

    ProductArgs p{};
    p.rows = bk;
    p.K = D;
    p.N = D;
    p.w_chunk = static_cast<long long>(dd);
    p.sb_chunk = D;

    // q, k, v = LN1(x)·W{q,k,v}
    p.x = xf; p.ln_g = lnl; p.ln_b = lnl + D;
    p.w = wl + QW * dd; p.s = sl + QW * D; p.b = bl + QW * D;
    p.out_f32 = wk.qkv; p.ld_out = 3 * D;
    e = launch_product<kStoreF32, true>(p, 3, st);
    if (e != cudaSuccess) break;

    SelfArgs sa{};
    sa.qkv = wk.qkv; sa.kc = kcl; sa.vc = vcl; sa.sel = static_cast<const float*>(sel);
    sa.out = wk.attn;
    sa.bk = bk; sa.D = D; sa.t_cache = t_cache; sa.pos = pos; sa.scale = scale;
    e = launch_self(sa, H, st);
    if (e != cudaSuccess) break;

    // x += attn·Wo
    ProductArgs r = p;
    r.src = wk.attn; r.x = nullptr;
    r.w = wl + OW * dd; r.s = sl + OW * D; r.b = bl + OW * D;
    r.xres = xf;
    e = launch_product<kResidual, false>(r, 1, st);
    if (e != cudaSuccess) break;

    // qc = LN2(x)·Wcq
    p.ln_g = lnl + 2 * D; p.ln_b = lnl + 3 * D;
    p.w = wl + CQW * dd; p.s = sl + CQW * D; p.b = bl + CQW * D;
    p.out_f32 = wk.qc; p.ld_out = D;
    e = launch_product<kStoreF32, true>(p, 1, st);
    if (e != cudaSuccess) break;

    const size_t xa_layer = static_cast<size_t>(H) * kHeadDim * sx * (xa_int8 ? 1 : 2);
    CrossArgs ca{};
    ca.q = wk.qc;
    ca.xk = static_cast<const char*>(xa_k) + l * xa_layer;
    ca.xv = static_cast<const char*>(xa_v) + l * xa_layer;
    ca.xs = xa_int8 ? static_cast<const __nv_bfloat16*>(xa_s) + static_cast<size_t>(l) * 2 * H * sx
                    : nullptr;
    ca.out = wk.ctx;
    ca.D = D; ca.sx = sx; ca.s_pad = s_pad; ca.s_audio = s_audio; ca.rpw = rpw; ca.cw = cw;
    ca.scale = scale;
    e = launch_clustered(cross, cross_grid, kThreads, csmem, 2, cross_splits, st, ca);
    if (e != cudaSuccess) break;

    // x += ctx·Wco
    r.src = wk.ctx;
    r.w = wl + COW * dd; r.s = sl + COW * D; r.b = bl + COW * D;
    e = launch_product<kResidual, false>(r, 1, st);
    if (e != cudaSuccess) break;

    // g_i = gelu(LN3(x)·W1_i), i < 4
    p.ln_g = lnl + 4 * D; p.ln_b = lnl + 5 * D;
    p.w = wl + W1_0 * dd; p.s = sl + W1_0 * D; p.b = bl + W1_0 * D;
    p.out_f32 = nullptr; p.out_bf16 = wk.g; p.ld_out = 4 * D;
    e = launch_product<kGeluBf16, true>(p, 4, st);
    if (e != cudaSuccess) break;

    // x = (x + (g·W2)·s) + b: the four W2 chunks are one (4D, D) matrix
    // with the deferred scale and bias of slot W2_0 + 3
    r.src = wk.g; r.K = 4 * D;
    r.w = wl + W2_0 * dd; r.s = sl + (W2_0 + 3) * D; r.b = bl + (W2_0 + 3) * D;
    e = launch_product<kResidualDeferred, false>(r, 1, st);
  }
  return static_cast<int>(e);
}
