// Beam self-attention that resolves ancestry at read time — Hopper
// (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/decode_attn.py `ancestry_attention`
// (body `_kernel`): for each beam row b and head h of one decode token,
//
//   out[b,h,:] = softmax_s(q[b,h,:]·K[anc[b,s],h,:,s]·Dh^-0.5) · V[anc[b,s],h,:,s]
//
// over the positions s ≤ pos, with scores, softmax and the weighted sum in
// f32 and one rounding of the output to bf16. anc[b, s] names the physical
// cache row that holds row b's history at position s, so beams never
// permute the (BK, H, Dh, T) caches; a negative entry reads a zero key and
// value, as the TPU kernel's one-hot selection does. Columns past pos are
// never used.
//
// Bound on the H100: bytes — the step reads the pos + 1 columns of every
// physical row's keys and values once (2·BK·H·Dh·(pos+1) bf16) and does
// 4·Dh operations per (row, column).
//
// Design. The TPU kernel holds all BK physical rows of a head in VMEM and
// lets each logical row select from them there; this one does the same
// per time split. The grid is (head, time split, group of logical rows):
// the splits of a head are one thread-block cluster, and rows come in
// groups of at most R (a grid dimension), so any BK fits. A block streams
// its split in units of CC columns × RT physical rows (every row in one
// unit unless BK is large) through a ring of stages; its first stages, the
// anc columns of its rows and its q rows are all requested before it waits
// for anything (q, as bf16, with the first stage), so a step with one
// unit a block pays one memory round trip. Keys and values come with
// 16-byte cp.async along the time-minor rows (each (row, d) run of a unit
// is contiguous); where T or a base is not a multiple of 8 elements a run
// starts mid-vector: the stage row then begins at the run's 16-byte vector
// and the kernel reads from its phase, and only a vector that would cross
// the start or end of a cache tensor is loaded element by element. anc
// comes with 4-byte cp.async.
//
// A unit runs in three phases over the whole block, each wide enough to
// keep the SM's warps busy (a first design gave each warp whole logical
// rows: long dependent chains on 5-20 warps, 0.090 against 0.031 ms at
// BK 20 on an NVIDIA H100 80GB HBM3 at 700 W): one thread per (logical
// row, column) takes the score's full dot over Dh from the stage in four
// chains (a warp reads consecutive columns) and writes the column's entry
// in a value table, its physical row in the stage or a row of zeros; CC
// lanes per row take the unit's softmax statistics and rescale the row's
// running (max, sum) online; one thread per (row, pair of d) adds the
// unit's P·V to its accumulators in shared memory through the table,
// without a branch, each lane starting at another column so that the 32
// d rows of a warp fall on different banks.
// The splits then merge through distributed shared memory behind one
// cluster barrier: each pushes its rows' (max, sum) and its P·V partials
// to the block that merges them, which sums in the fixed order z = 0, 1,
// ..., so two calls give the same bits. The split count keeps every
// cluster resident at once (cudaOccupancyMaxActiveClusters).
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;
constexpr int kStages = 2;
constexpr int kBudget = 200 * 1024;  // shared memory a block may plan for

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// What the host decides, and the block's shared memory, in bytes from its
// (16-byte aligned) start: the stages (each K: RT × Dh rows of S bf16; V:
// the same and one more row of zeros; anc: R × CC int32), then the unit's
// value table (R × CC int32), q (R × Dh bf16), the P·V accumulators
// (R × Dh f32), the unit's scores (R × CC f32), the row statistics m, l,
// alpha (R f32), and what the other splits push for the merge: P·V
// partials (R·Dh + kMaxSplits f32) and (m, l) of every row (kMaxSplits ×
// R f32 each).
struct Plan {
  int R, G, P, CS, CC, lcc, RT, S, ns;  // CC = 1 << lcc columns a unit, 8 to 32
  bool phased;  // some (row, d) run may start mid-vector: stage rows get 8 spare columns
  size_t kv, stage, vt, q, o, sc, m, l, alpha, recv_o, recv_m, recv_l, bytes;

  __host__ __device__ void layout(int dh) {
    kv = align16(size_t(RT) * dh * S * 2);
    stage = kv + align16(size_t(RT + 1) * dh * S * 2) + align16(size_t(R) * CC * 4);
    vt = ns * stage;
    q = vt + align16(size_t(R) * CC * 4);
    o = q + align16(size_t(R) * dh * 2);
    sc = o + align16(size_t(R) * dh * 4);
    m = sc + align16(size_t(R) * CC * 4);
    l = m + align16(size_t(R) * 4);
    alpha = l + align16(size_t(R) * 4);
    recv_o = alpha + align16(size_t(R) * 4);
    recv_m = recv_o + align16((size_t(R) * dh + wis::kMaxSplits) * 4);
    recv_l = recv_m + align16(size_t(wis::kMaxSplits) * R * 4);
    bytes = recv_l + align16(size_t(wis::kMaxSplits) * R * 4);
  }
  __host__ __device__ size_t anc_off(int dh) const {
    return kv + align16(size_t(RT + 1) * dh * S * 2);
  }
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* anc;
  __nv_bfloat16* out;
  int BK, H, dh, T, n;  // n = pos + 1 columns
  float scale;
  Plan p;
};

__device__ __forceinline__ float bf16_at(const unsigned short* p, int i) {
  return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
}

// q·K over d of one stage column: q is the row's bf16 q, kr points at
// (row, d = 0, column), rows S apart; the phase of d is (ph0 + d·T) & 7
// where runs start mid-vector.
template <bool PHASED>
__device__ __forceinline__ float dot_column(const unsigned short* __restrict__ q,
                                            const unsigned short* kr, int dh, int S,
                                            uint32_t ph0, int T) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int d = 0; d < dh; d += 4) {
    const uint2 qq = *reinterpret_cast<const uint2*>(q + d);
    float kx[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ph = PHASED ? static_cast<int>((ph0 + static_cast<uint32_t>((d + e) * T)) & 7u) : 0;
      kx[e] = bf16_at(kr, (d + e) * S + ph);
    }
    a0 = fmaf(__uint_as_float(qq.x << 16), kx[0], a0);
    a1 = fmaf(__uint_as_float(qq.x & 0xffff0000u), kx[1], a1);
    a2 = fmaf(__uint_as_float(qq.y << 16), kx[2], a2);
    a3 = fmaf(__uint_as_float(qq.y & 0xffff0000u), kx[3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// P·V of one unit for a pair of d values (d0 and d1) of row b: the CC
// columns from a lane-rotated start, each through the value table (entry
// (row·Dh·S + s)·8 + phase, a row of zeros where the column is not this
// tile's) and its weight e (0 there), without a branch.
template <bool PHASED>
__device__ __forceinline__ void pv_pair(const int* __restrict__ vt, const float* __restrict__ er,
                                        const unsigned short* vs, int cc, int rot, int dS0,
                                        int dS1, uint32_t dT0, uint32_t dT1, float& acc0,
                                        float& acc1) {
#pragma unroll 4
  for (int j = 0; j < cc; ++j) {
    const int s = (j + rot) & (cc - 1);
    const int pk = vt[s];
    const float e = er[s];
    int i0 = (pk >> 3) + dS0, i1 = (pk >> 3) + dS1;
    if (PHASED) {
      i0 += static_cast<int>((static_cast<uint32_t>(pk) + dT0) & 7u);
      i1 += static_cast<int>((static_cast<uint32_t>(pk) + dT1) & 7u);
    }
    acc0 = fmaf(e, bf16_at(vs, i0), acc0);
    acc1 = fmaf(e, bf16_at(vs, i1), acc1);
  }
}

__global__ void __launch_bounds__(kThreads) ancestry_attention_kernel(const Args args) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Plan p = args.p;
  const unsigned short* kg = reinterpret_cast<const unsigned short*>(args.k);
  const unsigned short* vg = reinterpret_cast<const unsigned short*>(args.v);
  const int* ancg = args.anc;
  const int BK = args.BK, H = args.H, dh = args.dh, T = args.T;
  const float scale = args.scale;
  const int h = blockIdx.x, z = blockIdx.y, b0 = blockIdx.z * p.R;
  const int rb = min(p.R, BK - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = dh >> 1;
  const int c_lo = z * p.CS, c_hi = min(args.n, c_lo + p.CS);
  const int tiles = cdiv(BK, p.RT);
  const int units = cdiv(c_hi - c_lo, p.CC) * tiles;
  const size_t total = static_cast<size_t>(BK) * H * dh * T;
  // element e of k (v) lies (phk + e) & 7 elements past a 16-byte boundary
  const uint32_t phk = (reinterpret_cast<uintptr_t>(kg) >> 1) & 7u;
  const uint32_t phv = (reinterpret_cast<uintptr_t>(vg) >> 1) & 7u;
  int* vt = reinterpret_cast<int*>(smem + p.vt);
  unsigned short* qs = reinterpret_cast<unsigned short*>(smem + p.q);
  float* os = reinterpret_cast<float*>(smem + p.o);
  float* sc = reinterpret_cast<float*>(smem + p.sc);
  float* m_sm = reinterpret_cast<float*>(smem + p.m);
  float* l_sm = reinterpret_cast<float*>(smem + p.l);
  float* al_sm = reinterpret_cast<float*>(smem + p.alpha);
  // the issue loop's (row, d): rows rpp apart, no division in the loop
  const int rpp = kThreads / dh, tr = tid / dh, td = tid - tr * dh;

  // Requests unit u into its stage: the K and V runs of physical rows
  // [r0, r0 + rt) over columns [c, c + cols), and the anc columns of the
  // block's rb logical rows. A run's vector j, [e - ph + 8j, + 8) of the
  // tensor (ph the run's phase), lands at stage row[8j].
  auto issue = [&](int u) {
    const int c = c_lo + (u / tiles) * p.CC, r0 = (u % tiles) * p.RT;
    const int cols = min(p.CC, c_hi - c), rt = min(p.RT, BK - r0);
    uint8_t* st = smem + (u % p.ns) * p.stage;
    unsigned short* ks = reinterpret_cast<unsigned short*>(st);
    unsigned short* vs = reinterpret_cast<unsigned short*>(st + p.kv);
    int* as = reinterpret_cast<int*>(st + p.anc_off(dh));
    if (tr < rpp) {
      for (int r = tr; r < rt; r += rpp) {
        const int run = r * dh + td;
        const size_t e = ((static_cast<size_t>(r0 + r) * H + h) * dh + td) * T + c;
        unsigned short* krow = ks + static_cast<size_t>(run) * p.S;
        unsigned short* vrow = vs + static_cast<size_t>(run) * p.S;
        if (!p.phased) {  // runs start on a vector and end inside their row
          for (int j = 0; 8 * j < cols; ++j) {
            wis::cp_async16(krow + 8 * j, kg + e + 8 * j);
            wis::cp_async16(vrow + 8 * j, vg + e + 8 * j);
          }
          continue;
        }
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const unsigned short* g = w ? vg : kg;
          unsigned short* row = w ? vrow : krow;
          const int ph = static_cast<int>(((w ? phv : phk) + static_cast<uint32_t>(e)) & 7u);
          for (int j = 0; 8 * j < ph + cols; ++j) {
            const long long v0 = static_cast<long long>(e) - ph + 8 * j;
            if (v0 >= 0 && v0 + 8 <= static_cast<long long>(total)) {
              wis::cp_async16(row + 8 * j, g + v0);
            } else {  // across the tensor's start or end: this run's elements only
              for (int x = max(8 * j, ph); x < min(8 * j + 8, ph + cols); ++x) row[x] = g[e - ph + x];
            }
          }
        }
      }
    }
    for (int i = tid; i < (rb << p.lcc); i += kThreads) {
      const int b = i >> p.lcc, s = i & (p.CC - 1);
      if (s < cols) wis::cp_async4(as + i, ancg + static_cast<size_t>(b0 + b) * T + c + s);
    }
  };

  // the first wave: q's rows (with the first stage's group), the first
  // stages, then the row state, the P·V accumulators and each stage's row
  // of zero values. Every block of the cluster arrives at the cluster
  // barrier now and waits before it first writes another's shared memory,
  // so all of them are running by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const unsigned short* qg = reinterpret_cast<const unsigned short*>(args.q);
  if ((reinterpret_cast<uintptr_t>(qg) & 15) == 0) {
    for (int i = tid; i < rb * dh / 8; i += kThreads) {
      const int b = i / (dh / 8), j = i - b * (dh / 8);
      wis::cp_async16(qs + b * dh + 8 * j, qg + (static_cast<size_t>(b0 + b) * H + h) * dh + 8 * j);
    }
  } else {
    for (int i = tid; i < rb * dh; i += kThreads) {
      const int b = i / dh;
      qs[i] = qg[(static_cast<size_t>(b0 + b) * H + h) * dh + i - b * dh];
    }
  }
  for (int u = 0; u < p.ns; ++u) {
    if (u < units) issue(u);
    wis::cp_async_commit();
  }
  for (int i = tid; i < rb * dh; i += kThreads) os[i] = 0.f;
  for (int b = tid; b < rb; b += kThreads) {
    m_sm[b] = -INFINITY;
    l_sm[b] = 0.f;
  }
  for (int u = 0; u < p.ns; ++u) {
    uint4* zr = reinterpret_cast<uint4*>(smem + u * p.stage + p.kv +
                                         size_t(p.RT) * dh * p.S * 2);
    for (int i = tid; i < dh * p.S / 8; i += kThreads) zr[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  for (int u = 0; u < units; ++u) {
    if (p.ns > 1)
      wis::cp_async_wait<1>();
    else
      wis::cp_async_wait<0>();
    __syncthreads();  // the unit's stage (and, at u = 0, q and the state) is in
    const int c = c_lo + (u / tiles) * p.CC, r0 = (u % tiles) * p.RT;
    const int cols = min(p.CC, c_hi - c), rt = min(p.RT, BK - r0);
    const uint8_t* st = smem + (u % p.ns) * p.stage;
    const unsigned short* ks = reinterpret_cast<const unsigned short*>(st);
    const unsigned short* vs = reinterpret_cast<const unsigned short*>(st + p.kv);
    const int* as = reinterpret_cast<const int*>(st + p.anc_off(dh));
    // the phase of (physical row an, d = 0) at column c; d adds d·T
    auto row_phase = [&](uint32_t ph0, int an) {
      return ph0 + static_cast<uint32_t>(((static_cast<size_t>(an) * H + h) * dh) * T + c);
    };

    // scores: one thread per (row, column); a column of a row of this
    // tile, or a negative entry (a zero key: score 0) counted with the
    // first tile, is in this unit's softmax, any other is -inf. The same
    // thread writes the column's value-table entry: its row of this tile,
    // else the row of zeros.
    for (int i = tid; i < (rb << p.lcc); i += kThreads) {
      const int b = i >> p.lcc, s = i & (p.CC - 1);
      float v = -INFINITY;
      int entry = (p.RT * dh * p.S + s) << 3;
      if (s < cols) {
        const int an = as[i];
        if (an >= r0 && an < r0 + rt) {
          const unsigned short* kr = ks + static_cast<size_t>(an - r0) * dh * p.S + s;
          v = (p.phased ? dot_column<true>(qs + b * dh, kr, dh, p.S, row_phase(phk, an), T)
                        : dot_column<false>(qs + b * dh, kr, dh, p.S, 0u, T)) *
              scale;
          entry = (((an - r0) * dh * p.S + s) << 3) |
                  static_cast<int>(p.phased ? row_phase(phv, an) & 7u : 0u);
        } else if (an < 0 && r0 == 0) {
          v = 0.f;
        }
      }
      sc[i] = v;
      vt[i] = entry;
    }
    __syncthreads();
    // the unit's softmax statistics, CC lanes a row: the running max and
    // sum rescaled online, the scores turned into e^(s - m)
    {
      const int per = 32 >> p.lcc;  // rows a warp takes at once
      const int sl = lane & (p.CC - 1);
      for (int bw = warp * per; bw < rb; bw += kWarps * per) {
        const int b = bw + (lane >> p.lcc);
        const bool row = b < rb;
        const float v = row ? sc[(b << p.lcc) + sl] : -INFINITY;
        float mx = v;
        for (int off = 1; off < p.CC; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float e = 0.f, alpha = 1.f, m_new = 0.f;
        if (mx != -INFINITY) {
          const float m_old = m_sm[b];
          m_new = fmaxf(m_old, mx);
          alpha = expf(m_old - m_new);
          e = expf(v - m_new);
        }
        float sum = e;
        for (int off = 1; off < p.CC; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (row) {
          sc[(b << p.lcc) + sl] = e;
          if (sl == 0) {
            al_sm[b] = alpha;
            if (mx != -INFINITY) {
              m_sm[b] = m_new;
              l_sm[b] = l_sm[b] * alpha + sum;
            }
          }
        }
      }
    }
    __syncthreads();
    // P·V: one thread per (row, pair of d), lanes starting at their own
    // column so that a warp's 32 d rows fall on different banks; the
    // accumulators (row, d) stay in shared memory
    for (int item = tid; item < rb * half; item += kThreads) {
      const int b = item / half, d0 = item - b * half, d1 = d0 + half;
      const float al = al_sm[b];
      float* o0 = os + b * dh + d0;
      float acc0 = o0[0] * al, acc1 = o0[half] * al;
      const int* vr = vt + (b << p.lcc);
      const float* er = sc + (b << p.lcc);
      const int rot = lane & (p.CC - 1);
      if (p.phased)
        pv_pair<true>(vr, er, vs, p.CC, rot, d0 * p.S, d1 * p.S,
                      static_cast<uint32_t>(d0 * T), static_cast<uint32_t>(d1 * T), acc0, acc1);
      else
        pv_pair<false>(vr, er, vs, p.CC, rot, d0 * p.S, d1 * p.S, 0u, 0u, acc0, acc1);
      o0[0] = acc0;
      o0[half] = acc1;
    }
    __syncthreads();  // the stage is free
    if (u + p.ns < units) issue(u + p.ns);
    wis::cp_async_commit();
  }
  wis::cp_async_wait<0>();

  // The splits' merge through distributed shared memory, one cluster
  // barrier: split z pushes each row's (m, l) to every block and the P·V
  // partial of item i = (row, d) to block i mod P, at [z][i / P]; after the
  // barrier block q merges its items q, q + P, ... from its own shared
  // memory: out = Σ_z o_z·f_z / Σ_z l_z·f_z, f_z = e^(m_z − M) (0 where
  // the split saw no column), the sums in the order z = 0, 1, ..., so two
  // calls give the same bits.
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int splits = static_cast<int>(cluster.num_blocks()), rank = cluster.block_rank();
  const int n_items = rb * dh, share = cdiv(n_items, splits);
  float* recv_o = reinterpret_cast<float*>(smem + p.recv_o);
  float* recv_m = reinterpret_cast<float*>(smem + p.recv_m);
  float* recv_l = reinterpret_cast<float*>(smem + p.recv_l);
  for (int i = tid; i < n_items; i += kThreads)
    cluster.map_shared_rank(recv_o, i % splits)[rank * share + i / splits] = os[i];
  for (int i = tid; i < splits * rb; i += kThreads) {
    const int to = i / rb, b = i - to * rb;
    cluster.map_shared_rank(recv_m, to)[rank * rb + b] = m_sm[b];
    cluster.map_shared_rank(recv_l, to)[rank * rb + b] = l_sm[b];
  }
  cluster.sync();
  for (int j = tid; rank + j * splits < n_items; j += kThreads) {
    const int item = rank + j * splits, b = item / dh;
    float mx = -1e30f;
    for (int zz = 0; zz < splits; ++zz) mx = fmaxf(mx, recv_m[zz * rb + b]);
    float num = 0.f, den = 0.f;
    for (int zz = 0; zz < splits; ++zz) {
      const float lz = recv_l[zz * rb + b];
      const float f = lz > 0.f ? expf(recv_m[zz * rb + b] - mx) : 0.f;
      den += lz * f;
      num += recv_o[zz * share + j] * f;
    }
    args.out[(static_cast<size_t>(b0 + b) * H + h) * dh + (item - b * dh)] =
        __float2bfloat16_rn(num / den);
  }
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

// The opt-in above 48 KB, once per device.
cudaError_t allow_smem() {
  static unsigned long long opted = 0;
  return wis::set_attribute(ancestry_attention_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, kBudget, &opted);
}

// Clusters of `splits` blocks of `smem` bytes the card holds at once (the
// SMs of a cluster share a GPC); remembered per (splits, smem).
int resident_clusters(int splits, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(splits, smem);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(ancestry_attention_kernel),
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();  // not a launch's error: plan as if every cluster fits
    n = 1 << 30;
  }
  return seen[key] = n;
}

// The block's rows, its split and its units. Columns per unit: 32, 16 or
// 8, the most for which two stages of every physical row fit in kBudget,
// else 8 columns of fewer physical rows. Splits: as many as keep every
// cluster resident at once (at most kMaxSplits), in whole vectors.
Plan make_plan(int BK, int H, int dh, int n, bool phased) {
  Plan p{};
  p.R = std::min(BK, std::min(128, 4096 / dh));
  p.G = cdiv(BK, p.R);
  p.phased = phased;
  p.ns = kStages;
  for (p.lcc = 5;; --p.lcc) {
    p.CC = 1 << p.lcc;
    p.S = p.CC + (phased ? 8 : 0);
    p.RT = BK;
    p.layout(dh);
    if (p.bytes <= kBudget || p.CC == 8) break;
  }
  while (p.bytes > kBudget && p.RT > 1) {
    p.RT = static_cast<int>(std::max<long long>(1, static_cast<long long>(p.RT) * kBudget /
                                                       static_cast<long long>(p.bytes)));
    p.layout(dh);
    if (p.bytes > kBudget && p.RT > 1) --p.RT, p.layout(dh);
  }
  const int per_sm = std::max(1, static_cast<int>((228 * 1024) / (p.bytes + 1024)));
  const long long clusters = static_cast<long long>(H) * p.G;
  int want = static_cast<int>(std::min<long long>(
      std::min(wis::kMaxSplits, cdiv(n, 8)), std::max<long long>(1, sm_count() * per_sm / clusters)));
  while (want > 1 && resident_clusters(want, p.bytes) < clusters) --want;
  p.CS = 8 * cdiv(cdiv(n, want), 8);
  p.P = cdiv(n, p.CS);
  while (p.CC > p.CS) --p.lcc, p.CC >>= 1;  // a split narrower than a unit
  p.S = p.CC + (phased ? 8 : 0);
  // one stage is enough where no block has a second unit
  if (cdiv(p.CS, p.CC) * cdiv(BK, p.RT) == 1) p.ns = 1;
  p.layout(dh);
  return p;
}

}  // namespace

// q (BK, H, Dh) bf16; k, v (BK, H, Dh, T) bf16; anc (BK, T) int32 global
// physical rows (negative: zero key and value); 0 ≤ pos < T; Dh a multiple
// of 8 up to 256; out (BK, H, Dh) bf16. All contiguous (the wrapper
// checks), k and v 2-byte aligned.
extern "C" int wis_ancestry_attention(const void* q, const void* k, const void* v,
                                      const void* anc, int BK, int H, int Dh, int T, int pos,
                                      float scale, void* out, void* stream) {
  if (BK <= 0 || H <= 0 || Dh <= 0 || Dh % 8 != 0 || Dh > kMaxDh || pos < 0 || pos >= T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool phased =
      T % 8 != 0 || (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(anc),
               static_cast<__nv_bfloat16*>(out), BK, H, Dh, T, pos + 1, scale,
               make_plan(BK, H, Dh, pos + 1, phased)};
  if (a.p.bytes > kBudget || a.p.G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  e = wis::launch_clustered(ancestry_attention_kernel, dim3(H, a.p.P, a.p.G), kThreads,
                            a.p.bytes, 1, a.p.P, static_cast<cudaStream_t>(stream), a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
