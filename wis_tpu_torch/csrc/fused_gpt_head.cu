// The XTTS GPT sampling head for one row — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/fused_gpt_head.py
// `build_fused_gpt_head`: double final LayerNorm, the (D, V_pad) audio-code
// logits, the stop-token floor, the repetition penalty on the caller's
// hit-mask, temperature, top-k and top-p thresholds and the draw.
//
// One launch of one thread-block cluster (16 blocks where the card
// schedules such a cluster, else 8):
//
//   - every block loads x, then issues the loads of its column strip of the
//     head (V_pad / cluster columns, 16-byte loads along a row, at XTTS
//     v2's width every row in flight at once), then runs both LayerNorms
//     at the TPU kernel's rounding points (x → bf16, each LN → bf16), then
//     the strip's product (f32 sums in a fixed order) and its logits
//     bf16(bf16(dot) + bf16(bias)), pad lanes -1e30, which it writes into
//     the leader block's shared memory through distributed shared memory;
//   - after the cluster barrier the leader alone selects: the floor,
//     penalty and temperature, then (value, index) keys ordered by value
//     descending and equal values by index descending (jnp.sort's reversed
//     stable order, which the plain version's prefix masses follow). For
//     top_k below 128 a radix select finds the k-th value and one warp
//     sorts the keys at or above it; otherwise a bitonic sort of every key
//     over the next power of two ≥ V_pad, held in registers (passes inside
//     a thread, across lanes by shuffles, across warps through shared
//     memory). The softmax's numerators are summed by rank; the
//     k-th largest is the value at rank min(k, V_pad) − 1, the prefix
//     masses an exclusive scan of the probabilities in sorted order, the
//     p-th largest the value at rank max(#{prefix < p}, 1) − 1; then the
//     masked logits and the argmax of l + gumbel or of l, lowest index on
//     ties.
//
// Bound on the H100: the head's 2.4 MB of bf16 at XTTS v2's width (D =
// 1024, V_pad = 1152), under a microsecond at 3.35 TB/s; the row's latency
// is the strip's stream on 16 SMs, the cluster barrier and the selection
// (four radix passes and a sort of at most 128 keys, or for large top_k
// 66 bitonic passes over 2048 keys). The TPU kernel's formulation,
// which counts for every token the values above it (V_pad² ≈ 1.3 M steps
// on one SM here), is what the sort replaces.
//
// Plain C interface for ctypes; returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using wis::bf16_round;
using wis::bf16x8_to_float;
using wis::cp_async16;
using wis::block_reduce;
using wis::kSum;
using wis::ordered;

constexpr float NEG = -1e30f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVp = 4096;
constexpr int kBatch = 20;  // head rows in flight per thread (every one at XTTS v2's width)
constexpr int kMaxD = 4096;

// LayerNorm of one f32 row (f32 mean and mean squared deviation, eps
// 1e-5, affine) by the whole block, each output rounded to bf16.
__device__ void ln_row_block(const float* in, const float* __restrict__ g,
                             const float* __restrict__ b, float* out, int d, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) s += in[c];
  const float mean = block_reduce<kSum, kWarps>(s, red) / d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float t = in[c] - mean;
    ss += t * t;
  }
  const float rstd = rsqrtf(block_reduce<kSum, kWarps>(ss, red) / d + 1e-5f);
  for (int c = threadIdx.x; c < d; c += kThreads)
    out[c] = bf16_round(((in[c] - mean) * rstd) * g[c] + b[c]);
  __syncthreads();
}


// Exclusive prefix sum over the block of one value per thread, in thread
// order; `red` holds kWarps floats.
__device__ __forceinline__ float block_exclusive_scan(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += red[w];
  return base + inc - v;
}

// The largest of every thread's v; `red` holds 2·kWarps u64 (this call's
// half of them are written).
__device__ __forceinline__ unsigned long long block_max_u64(unsigned long long v,
                                                            unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) v = max(v, red[w]);
  return v;
}

// the value of a key's high word
__device__ __forceinline__ float key_value(unsigned long long key) {
  return wis::from_ordered(static_cast<uint32_t>(key >> 32));
}

// Bitonic sort, descending, of P keys held KPT a thread (element
// e = tid·KPT + i; threads past P hold none), through sequences of up to
// `upto` keys: upto = P sorts them all; upto = 32·KPT sorts each warp's
// keys alone. Compare-exchanges inside a thread, then across a warp's
// lanes with shuffles, and across warps through `buf` (2·P u64, the two
// halves taken in turn, one barrier a pass). The passes are a loop, not
// unrolled: the code runs once a call, and straight-line code would be
// fetched from L2 instruction by instruction.
template <int KPT>
__device__ void sort_desc(unsigned long long (&v)[KPT], int P, int upto, unsigned long long* buf) {
  const int tid = threadIdx.x;
  const bool holds = tid * KPT < P;
  int half = 0;
#pragma unroll 1
  for (int size = 2; size <= upto; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride < KPT) {
        // inside the thread (the stride a constant of each unrolled copy,
        // so that v stays in registers)
#pragma unroll
        for (int sc = 1; sc < KPT; sc <<= 1) {
          if (sc != stride) continue;
#pragma unroll
          for (int i = 0; i < KPT; ++i) {
            if (i & sc) continue;
            const int j = i | sc;
            const bool desc = (((tid * KPT + i) & (upto - 1)) & size) == 0;
            if (desc ? v[i] < v[j] : v[i] > v[j]) {
              const unsigned long long t = v[i];
              v[i] = v[j];
              v[j] = t;
            }
          }
        }
        continue;
      }
      unsigned long long o[KPT];
      if (stride < 32 * KPT) {
#pragma unroll
        for (int i = 0; i < KPT; ++i) o[i] = __shfl_xor_sync(0xffffffffu, v[i], stride / KPT);
      } else {
        unsigned long long* b = buf + half * P;
        half ^= 1;
        if (holds)
#pragma unroll
          for (int i = 0; i < KPT; ++i) b[tid * KPT + i] = v[i];
        __syncthreads();
        if (holds)
#pragma unroll
          for (int i = 0; i < KPT; ++i) o[i] = b[(tid * KPT + i) ^ stride];
      }
      if (holds) {
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const int e = (tid * KPT + i) & (upto - 1);  // within its sequence
          // the lower element of a descending pair keeps the larger key
          const bool keep_max = ((e & size) == 0) == ((e & stride) == 0);
          v[i] = keep_max ? max(v[i], o[i]) : min(v[i], o[i]);
        }
      }
    }
  }
}

// The keys from rank 0 down to rank `rank` (and every key of the same
// value as that one), sorted descending, into keys[0, n), n returned; 0
// where they are more than kTop. A radix select over the value word, 8
// bits a pass from the top (a histogram of the keys that match the
// prefix found so far, then the bin that holds the rank), finds the
// value at the rank; the keys at or above it are gathered (in any order)
// and one warp sorts them. `hist` holds 256 + 2 ints.
constexpr int kTop = 128;

template <int KPT>
__device__ int top_sorted(const unsigned long long (&v)[KPT], int rank, int* hist,
                          unsigned long long* keys) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0, mask = 0;
  int need = rank + 1;  // keys still to count from the top of the prefix
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const uint32_t hi = static_cast<uint32_t>(v[i] >> 32);
      if (v[i] && (hi & mask) == prefix) atomicAdd(&hist[(hi >> shift) & 255], 1);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255 − 8l .. 248 − 8l; counts above each, from 255
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int above = sum;  // inclusive scan over the lanes, then exclusive
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, above, off);
        if (lane >= off) above += o;
      }
      above -= sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (above < need && need <= above + c[j]) {
          hist[256] = 255 - 8 * lane - j;
          hist[257] = above;
        }
        above += c[j];
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(hist[256]) << shift;
    mask |= 255u << shift;
    need -= hist[257];
  }
  // the keys at or above the value found
  if (tid == 0) hist[256] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (v[i] && static_cast<uint32_t>(v[i] >> 32) >= prefix) {
      const int at = atomicAdd(&hist[256], 1);
      if (at < kTop) keys[at] = v[i];
    }
  }
  __syncthreads();
  const int n = hist[256];
  if (n > kTop) return 0;
  if (tid < 32) {
    unsigned long long w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = lane * 4 + i < n ? keys[lane * 4 + i] : 0ull;
    sort_desc<4>(w, kTop, kTop, nullptr);  // one warp: no pass crosses warps
#pragma unroll
    for (int i = 0; i < 4; ++i) keys[lane * 4 + i] = w[i];
  }
  __syncthreads();
  return n;
}

// The leader's selection from the sorted keys (see the top of the file).
template <int KPT>
__device__ void select_sorted(float* l, unsigned long long* keys, float* red, int vp, int P,
                              int stop, const float* __restrict__ hist,
                              const float* __restrict__ gum, const float* __restrict__ knobs,
                              int32_t* __restrict__ tok, float* __restrict__ logits) {
  const int tid = threadIdx.x;
  const float temp = fmaxf(knobs[0], 1e-5f), kf = fmaxf(knobs[1], 1.0f), p = knobs[2];
  const float rp = knobs[3];
  const bool stop_blocked = knobs[4] > 0.f, sample = knobs[5] > 0.f;
  // floor, penalty, temperature, and the keys: (value, index), the index
  // ordering equal values by index descending
  unsigned long long v[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int t = tid * KPT + i;
    v[i] = 0ull;
    if (t < vp) {
      float lv = l[t];
      if (t == stop && stop_blocked) lv = NEG;
      if (hist[t] > 0.f) lv = lv > 0.f ? lv / rp : lv * rp;
      lv = lv / temp;
      l[t] = lv;
      v[i] = (static_cast<unsigned long long>(ordered(lv)) << 32) | t;
    }
  }
  // The k-th largest is rank min(k, V_pad) − 1. Where that is below kTop,
  // only the ranks down to it are sorted (top_sorted): the tokens past
  // rank k are masked whatever top-p says, so a p-threshold past the
  // ranks sorted masks nothing more. Else, or where ties at the k-th value
  // run past kTop, every key is sorted.
  const int rank_k = static_cast<int>(fminf(floorf(kf), static_cast<float>(vp))) - 1;
  int ranked = rank_k < kTop
                   ? top_sorted<KPT>(v, rank_k, reinterpret_cast<int*>(keys + kTop), keys)
                   : 0;  // ranks in keys
  if (ranked == 0) {
    sort_desc<KPT>(v, P, P, keys);
    __syncthreads();  // every read of the sort's room is done
    if (tid * KPT < P)
#pragma unroll
      for (int i = 0; i < KPT; ++i) keys[tid * KPT + i] = v[i];
    __syncthreads();
    ranked = vp;
  }

  // the softmax's numerators e = exp(l − max) (the max is rank 0) and
  // their total; the exclusive scan of the ranked ones, over the total,
  // is each one's prefix mass
  const float m = key_value(keys[0]);
  float all = 0.f;
  for (int t = tid; t < vp; t += kThreads) all += expf(l[t] - m);
  const float total = block_reduce<kSum, kWarps>(all, red);
  const int per = (ranked + kThreads - 1) / kThreads;
  const int r0 = min(ranked, tid * per), r1 = min(ranked, r0 + per);
  float own = 0.f;
  for (int r = r0; r < r1; ++r) own += expf(key_value(keys[r]) - m);
  float pre = block_exclusive_scan(own, red);
  float cnt = 0.f;
  for (int r = r0; r < r1; ++r) {
    cnt += pre / total < p ? 1.f : 0.f;
    pre += expf(key_value(keys[r]) - m);
  }
  const int n_p = static_cast<int>(block_reduce<kSum, kWarps>(cnt, red));
  const float kth = key_value(keys[rank_k]);
  const float pth = key_value(keys[min(max(n_p, 1), ranked) - 1]);

  // masked logits, then argmax of l + gumbel and of l, lowest index on
  // ties: the largest (value, −index) key of each
  unsigned long long ks = 0ull, kg = 0ull;
  for (int t = tid; t < vp; t += kThreads) {
    float lv = l[t];
    if (lv < kth) lv = NEG;
    if (lv < pth) lv = NEG;
    logits[t] = lv;
    const unsigned long long low = 0xffffffffull - t;
    ks = max(ks, (static_cast<unsigned long long>(ordered(lv + gum[t])) << 32) | low);
    kg = max(kg, (static_cast<unsigned long long>(ordered(lv)) << 32) | low);
  }
  ks = block_max_u64(ks, keys);  // the keys are read: their room is free
  kg = block_max_u64(kg, keys + kWarps);
  if (tid == 0)
    tok[0] = static_cast<int32_t>(0xffffffffull - ((sample ? ks : kg) & 0xffffffffull));
}

// Dynamic shared memory, the same layout in every block of the cluster:
// l (V_pad f32: the leader's gathers every block's logits), keys
// (max(2·P, 4·kThreads) u64: the sort's, in the leader; the product's
// partial sums before them), stage and hidden (2·D f32), the partials'
// second level (kThreads f32), the LayerNorm rows (4·D f32).
__global__ void __launch_bounds__(kThreads, 1)
gpt_head_kernel(const float* __restrict__ x, const float* __restrict__ ln4,
                const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ hist, const float* __restrict__ gum,
                const float* __restrict__ knobs, int32_t* __restrict__ tok,
                float* __restrict__ hidden_out, float* __restrict__ logits, int d, int v, int vp,
                int P, int stop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* l = reinterpret_cast<float*>(smem_raw);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(l + vp);
  float* part = reinterpret_cast<float*>(keys);
  float* stage = reinterpret_cast<float*>(keys + max(2 * P, kThreads * 4));
  float* hid = stage + d;
  float* part2 = hid + d;
  float* lnw = part2 + kThreads;  // the four LayerNorm rows
  __shared__ float red[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = static_cast<int>(cluster.block_rank());
  const int nc = vp / static_cast<int>(cluster.num_blocks()), n0 = rank * nc;

  // x (into `hid`) and the LayerNorm rows first, so that their loads do not
  // queue behind the head's
  for (int i = tid; i < d; i += kThreads) cp_async16(lnw + 4 * i, ln4 + 4 * i);
  for (int i = tid; i < d / 4; i += kThreads) cp_async16(hid + 4 * i, x + 4 * i);
  wis::cp_async_commit();
  // this thread's 8 columns (chunk c of the strip) and k rows kl, kl + K, ...
  // (K = klanes), a batch of kBatch rows in flight
  const int nch = nc / 8, klanes = kThreads / nch;
  const int c = tid % nch, kl = tid / nch;
  const bool active = kl < klanes;
  const __nv_bfloat16* wp = w + n0 + 8 * c;
  uint4 wv[kBatch];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kl + (i0 + u) * klanes;
      wv[u] = active && k < d ? __ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(k) * vp))
                              : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0);
  // this block has started: announced to the cluster, awaited before the
  // first write into the leader's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  wis::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < d; i += kThreads) stage[i] = bf16_round(hid[i]);
  __syncthreads();
  ln_row_block(stage, lnw, lnw + d, hid, d, red);            // h1 = bf16(LN(bf16(x)))
  ln_row_block(hid, lnw + 2 * d, lnw + 3 * d, stage, d, red);  // hidden = bf16(LN(h1))
  if (rank == 0)
    for (int i = tid; i < d; i += kThreads) hidden_out[i] = stage[i];

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  const int rows = (d + klanes - 1) / klanes;  // k rows of the most loaded thread
  for (int i0 = 0; i0 < rows; i0 += kBatch) {
    if (i0) load(i0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kl + (i0 + u) * klanes;
      if (active && k < d) {
        float wf[8];
        bf16x8_to_float(wv[u], wf);
        const float hk = stage[k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(hk, wf[j], acc[j]);
      }
    }
  }
  if (active)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[kl * nc + 8 * c + j] = acc[j];
  __syncthreads();
  // the k lanes' partials of each column in two levels, in a fixed order:
  // group j sums lanes j, j + groups, ..., then one thread the groups
  const int groups = kThreads / nc;
  if (tid < groups * nc) {
    const int col = tid % nc, j = tid / nc;
    float sum = 0.f;
    for (int i = j; i < klanes; i += groups) sum += part[i * nc + col];
    part2[j * nc + col] = sum;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* lead = cluster.map_shared_rank(l, 0);
  for (int col = tid; col < nc; col += kThreads) {
    float dot = 0.f;
    for (int j = 0; j < groups; ++j) dot += part2[j * nc + col];
    const int n = n0 + col;
    lead[n] = n < v ? bf16_round(bf16_round(dot) + bf16_round(bias[n])) : NEG;
  }
  cluster.sync();  // every strip is in the leader's l
  if (rank != 0) return;

  // ---- the leader selects: P keys over the threads, 1 to 8 each ------------
  if (P <= kThreads) select_sorted<1>(l, keys, red, vp, P, stop, hist, gum, knobs, tok, logits);
  else if (P == 2 * kThreads) select_sorted<2>(l, keys, red, vp, P, stop, hist, gum, knobs, tok, logits);
  else if (P == 4 * kThreads) select_sorted<4>(l, keys, red, vp, P, stop, hist, gum, knobs, tok, logits);
  else select_sorted<8>(l, keys, red, vp, P, stop, hist, gum, knobs, tok, logits);
}

size_t head_smem(int d, int vp, int P) {
  const size_t key_words = 2 * P > kThreads * 4 ? 2 * P : kThreads * 4;
  return sizeof(float) * vp + sizeof(unsigned long long) * key_words +
         sizeof(float) * (6 * d + kThreads);
}

// The cluster's size: 16 blocks where the card can schedule such a
// cluster of this kernel, else 8 (the portable size). Once per process.
int cluster_size(size_t smem) {
  static int n = [smem] {
    if (cudaFuncSetAttribute(gpt_head_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      cudaGetLastError();
      return 8;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(16);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 16;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, gpt_head_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();
      return 8;
    }
    return clusters > 0 ? 16 : 8;
  }();
  return n;
}

}  // namespace

// The head of one row. x (1, D) f32; ln4 (4, D) f32; head_w (D, VP) bf16;
// head_b, hist, gum (1, VP) f32; knobs (1, 8) f32 [temperature, top_k,
// top_p, repetition_penalty, stop_blocked, do_sample, 0, 0] → tok (1, 1)
// int32, hidden (1, D) f32, logits (1, VP) f32 masked; raw is not used
// (the logits meet in shared memory). D a multiple of 8 up to 4096, VP a
// multiple of 128 up to 4096, V ≤ VP.
extern "C" int wis_fused_gpt_head(const void* x, const void* ln4, const void* head_w,
                                  const void* head_b, const void* hist, const void* gum,
                                  const void* knobs, void* tok, void* hidden, void* logits,
                                  void* raw, int D, int V, int VP, int stop, void* stream) {
  (void)raw;
  if (D <= 0 || D % 8 || D > kMaxD || VP % 128 || VP > kMaxVp || V < 1 || V > VP || stop < 0 ||
      stop >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < VP) P <<= 1;
  const size_t smem = head_smem(D, VP, P);
  static unsigned long long opted = 0, wide = 0;  // per device
  cudaError_t set = wis::set_attribute(gpt_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(head_smem(4096, kMaxVp, kMaxVp)), &opted);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int cluster = cluster_size(head_smem(4096, kMaxVp, kMaxVp));
  if (cluster > 8) {  // cluster_size allowed it on the first device; each card needs it
    set = wis::set_attribute(gpt_head_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1,
                             &wide);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gpt_head_kernel, static_cast<const float*>(x), static_cast<const float*>(ln4),
      static_cast<const __nv_bfloat16*>(head_w), static_cast<const float*>(head_b),
      static_cast<const float*>(hist), static_cast<const float*>(gum),
      static_cast<const float*>(knobs), static_cast<int32_t*>(tok), static_cast<float*>(hidden),
      static_cast<float*>(logits), D, V, VP, P, stop);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
