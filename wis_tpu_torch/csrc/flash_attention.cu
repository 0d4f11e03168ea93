// Flash attention for the encoder (unmasked self-attention), in both of the
// JAX package's layouts — Hopper (sm_90a).
//
// Replaces the TPU kernels wis_tpu/ops/flash.py `flash_attention_packed`
// (body `_kernel_packed`) and `flash_attention` (body `_kernel`):
// softmax(q·kᵀ/√Dh)·v per head, with an online softmax in f32 and keys at
// or past T masked. Each head width has one kernel body for both layouts;
// it is told where a (batch, head) starts:
//
//   packed (B, T, D), heads side by side along D: row stride D, head
//     offset h·Dh, batch offset b·T·D — no head transposes through memory;
//   head-major (B, H, T, Dh): row stride Dh, head offset h·T·Dh, batch
//     offset b·H·T·Dh.
//
// So the same numbers give bit-identical outputs in either layout.
//
// Bound on the H100: at the encoder's shapes (T=1500, Dh=64, H=20) the
// work is 4·T²·D ≈ 11.5 GFLOP per layer against ~15 MB of q/k/v/out, so
// it is bound by the tensor cores' operation rate, not by bytes; the T×T
// scores never leave the SM.
//
// Dh 64 and 128 (every Whisper size, and the packed gate) take the
// Hopper body, FlashAttention-3 in shape: a block of one or two consumer
// warpgroups, each owning 64 query rows, and one producer warp. The
// producer TMA-loads each warpgroup's Q tile once and keeps K and V tiles
// of 64 keys in flight in a ring of kKvStages stages ("full"/"empty"
// mbarriers), through 3-D tensor maps over (B, T, D) at column h·Dh
// (packed) or (B·H, T, Dh) (head-major), in the 128-byte swizzle; TMA
// zero-fills a ragged last key tile within its own batch and head, so no
// row of another batch is ever read. S = Q·Kᵀ is a wgmma with both
// operands in shared memory (K is Dh-contiguous: K-major); the online
// softmax runs on the S accumulators in f32 registers (log2 units, keys
// ≥ T masked); P is repacked to bf16 in registers as the A operand of
// O += P·V, whose B operand V is read N-major through the descriptor's
// transpose bit — V is never transposed. Two warpgroups share each K/V
// tile; where that leaves too few blocks to fill the SMs (H·B·⌈T/128⌉
// below the SM count) each block holds one.
//
// Other head widths (every multiple of 8 up to 256 the JAX gate takes)
// keep the first version's body: one block of 4 warps per 64 query rows,
// K and V through registers into shared memory (V transposed), bf16
// mma.sync.m16n8k16; a last 8-wide k-slice of Dh % 16 == 8 is zero in
// both operands' registers; key tiles of 64 up to Dh 128 and 32 above.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() (cudaErrorNotSupported where the CUDA
// driver cannot encode a tensor map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using wis::load_pair;
using wis::mma_bf16_16816;
using wis::pack_bf16;

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kWarps = 4;
constexpr int kPad = 8;       // bf16 elements of row padding (bank spread)
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

// ---- the mma.sync body: head widths other than 64 and 128 --------------

template <int DH, int BK>
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int T, long long row_stride,
             long long head_stride, long long batch_stride, float scale_log2) {
  constexpr int KS = (DH + 15) / 16;  // 16-wide slices of the contraction
  __shared__ alignas(16) __nv_bfloat16 ks[BK][DH + kPad];
  __shared__ alignas(16) __nv_bfloat16 vt[DH][BK + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // mma group: rows g and g + 8
  const int t4 = lane & 3;   // thread in group: columns 2·t4, 2·t4 + 1
  // element d of row t of this (batch, head) sits at base + t·row_stride + d
  const size_t base = static_cast<size_t>(blockIdx.z) * batch_stride +
                      static_cast<size_t>(blockIdx.y) * head_stride;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const __nv_bfloat16* q0 = q + base + static_cast<size_t>(r0) * row_stride;
  const __nv_bfloat16* q1 = q + base + static_cast<size_t>(r1) * row_stride;

  // this warp's Q rows as A fragments, one per 16-wide slice of DH; the
  // upper half of a last slice past DH is zero
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const bool hi = kk * 16 + 8 < DH;
    qa[kk][0] = r0 < T ? load_pair(q0 + c) : 0u;
    qa[kk][1] = r1 < T ? load_pair(q1 + c) : 0u;
    qa[kk][2] = hi && r0 < T ? load_pair(q0 + c + 8) : 0u;
    qa[kk][3] = hi && r1 < T ? load_pair(q1 + c + 8) : 0u;
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units), rows g / g+8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DH / 8; idx += kWarps * 32) {
      const int r = idx / (DH / 8);
      const int c = (idx % (DH / 8)) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        const size_t off = base + static_cast<size_t>(key) * row_stride + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[c + i][r] = ve[i];
    }
    __syncthreads();

    // S = Q·Kᵀ for 16 rows × BK keys: BK/8 accumulator tiles of 16×8
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kp = &ks[nt * 8 + g][kk * 16 + t4 * 2];
        const uint32_t b1 = kk * 16 + 8 < DH ? load_pair(kp + 8) : 0u;
        mma_bf16_16816(s[nt], qa[kk], load_pair(kp), b1);
      }
    }

    // scale into log2 units, mask keys >= T, row maxima over the group
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + nt * 8 + t4 * 2 + j < T;
        s[nt][j] = valid ? s[nt][j] * scale_log2 : kNegInf;
        s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : kNegInf;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = exp2f(s[nt][j] - mn0);
        s[nt][2 + j] = exp2f(s[nt][2 + j] - mn1);
        ps0 += s[nt][j];
        ps1 += s[nt][2 + j];
      }
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P·V: two adjacent S tiles form one bf16 A fragment (16 × 16 keys)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const __nv_bfloat16* vp = &vt[dt * 8 + g][kc * 16 + t4 * 2];
        mma_bf16_16816(acc[dt], pa, load_pair(vp), load_pair(vp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + base + static_cast<size_t>(r0) * row_stride;
  __nv_bfloat16* o1 = o + base + static_cast<size_t>(r1) * row_stride;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ---- the Hopper body: Dh 64 and 128 ------------------------------------

constexpr int kKeys = 64;     // keys per K/V tile
constexpr int kKvStages = 2;  // ring depth

template <int DH, int WGS>
struct Tile {
  static constexpr int kQBytes = 64 * DH * 2;      // one warpgroup's Q rows
  static constexpr int kKvBytes = kKeys * DH * 2;  // one K or V tile
  static constexpr int kHalf = 64 * 128;           // a 64-row, 64-column swizzled block
  static constexpr int kThreads = WGS * 128 + 32;
  static constexpr int kSmem =
      WGS * kQBytes + kKvStages * 2 * kKvBytes + (1 + 2 * kKvStages) * 8 + 1024;
};

// Tiles of 64 rows × DH in shared memory are DH/64 column blocks of
// 64 rows × 128 bytes (kHalf apart), each as TMA writes it in the 128-byte
// swizzle. The k16 slice kk of such a tile as a K-major operand starts
// kk/4 blocks and (kk % 4)·32 bytes in.
template <int DH, int WGS>
__global__ void __launch_bounds__(Tile<DH, WGS>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                   int T, int H, int packed, long long row_stride, long long head_stride,
                   long long batch_stride, float scale_log2) {
  using L = Tile<DH, WGS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wis::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* kv = smem + WGS * L::kQBytes;  // stage s: K, then V
  uint64_t* qfull = reinterpret_cast<uint64_t*>(kv + kKvStages * 2 * L::kKvBytes);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + kKvStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  // the tensor maps' column and third coordinate of this (batch, head)
  const int col0 = packed ? h * DH : 0, z = packed ? b : b * H + h;
  const int q0 = blockIdx.x * 64 * WGS;
  const int nk = (T + kKeys - 1) / kKeys;
  if (tid == 0) {
    wis::mbar_init(qfull, 1);
    for (int i = 0; i < kKvStages; ++i) {
      wis::mbar_init(&full[i], 1);
      wis::mbar_init(&empty[i], WGS);
    }
    wis::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's role, from lane 0, so the compiler sees it uniform per
  // warp (a branch it cannot prove uniform makes it serialise the wgmmas)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == WGS) {
    // producer: Q once, then K and V tiles through the ring
    if (tid == WGS * 128) {
      wis::mbar_expect_tx(qfull, WGS * L::kQBytes);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < DH / 64; ++c)
          wis::tma_load_3d(qs + w * L::kQBytes + c * L::kHalf, &qmap, qfull, col0 + c * 64,
                           q0 + w * 64, z);
      for (int i = 0; i < nk; ++i) {
        const int st = i % kKvStages;
        if (i >= kKvStages) wis::mbar_wait(&empty[st], (i / kKvStages - 1) & 1);
        uint8_t* ks = kv + st * 2 * L::kKvBytes;
        wis::mbar_expect_tx(&full[st], 2 * L::kKvBytes);
        for (int c = 0; c < DH / 64; ++c) {
          wis::tma_load_3d(ks + c * L::kHalf, &kmap, &full[st], col0 + c * 64, i * kKeys, z);
          wis::tma_load_3d(ks + L::kKvBytes + c * L::kHalf, &vmap, &full[st], col0 + c * 64,
                           i * kKeys, z);
        }
      }
    }
    return;
  }

  const int wg = role, t = tid & 127;
  const int w = t >> 5, g = (t & 31) >> 2, t4 = t & 3;
  const uint8_t* qw = qs + wg * L::kQBytes;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units), rows g / g+8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  wis::mbar_wait(qfull, 0);
  for (int i = 0; i < nk; ++i) {
    const int st = i % kKvStages;
    wis::mbar_wait(&full[st], (i / kKvStages) & 1);
    const uint8_t* ks = kv + st * 2 * L::kKvBytes;
    const uint8_t* vs = ks + L::kKvBytes;

    // S = Q·Kᵀ: 64 rows × 64 keys
    float s[kKeys / 2];
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j) s[j] = 0.f;
    wis::fence_regs(s);
    wis::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk >> 2) * L::kHalf + (kk & 3) * 32;
      wis::wgmma_ss_n64<0>(s, wis::desc_sw128(qw + off, 16, 1024),
                           wis::desc_sw128(ks + off, 16, 1024));
    }
    wis::wgmma_commit();
    wis::wgmma_wait<0>();
    wis::fence_regs(s);

    // scale into log2 units, mask keys >= T, row maxima over the quad
    const int k0 = i * kKeys;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + j * 8 + t4 * 2 + e < T;
        s[4 * j + e] = valid ? s[4 * j + e] * scale_log2 : kNegInf;
        s[4 * j + 2 + e] = valid ? s[4 * j + 2 + e] * scale_log2 : kNegInf;
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
        ps0 += s[4 * j + e];
        ps1 += s[4 * j + 2 + e];
      }
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }

    // O += P·V: P in registers, 16 keys per slice (two S column blocks)
    wis::fence_regs(acc);
    wis::wgmma_fence();
#pragma unroll
    for (int c = 0; c < kKeys / 16; ++c) {
      const uint32_t pa[4] = {
          pack_bf16(s[8 * c], s[8 * c + 1]), pack_bf16(s[8 * c + 2], s[8 * c + 3]),
          pack_bf16(s[8 * c + 4], s[8 * c + 5]), pack_bf16(s[8 * c + 6], s[8 * c + 7])};
      const uint64_t vd = wis::desc_sw128(vs + c * 2048, L::kHalf, 1024);
      wis::wgmma_rs<DH, 1>(acc, pa, vd);
    }
    wis::wgmma_commit();
    wis::wgmma_wait<0>();
    wis::fence_regs(acc);
    if (t == 0) wis::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + wg * 64 + w * 16 + g, r1 = r0 + 8;
  const size_t base = static_cast<size_t>(b) * batch_stride + static_cast<size_t>(h) * head_stride;
  __nv_bfloat16* o0 = o + base + static_cast<size_t>(r0) * row_stride;
  __nv_bfloat16* o1 = o + base + static_cast<size_t>(r1) * row_stride;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

// ---- host -------------------------------------------------------------

struct Launch {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int B, H, T;
  bool packed;
  long long row_stride, head_stride, batch_stride;
  float scale_log2;
  int wgs;  // consumer warpgroups of the Hopper body; 0: chosen here
  cudaStream_t stream;
};

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

template <int DH, int WGS>
int launch_wgmma(const Launch& a) {
  using L = Tile<DH, WGS>;
  // (columns, rows, batch·head or batch) over each of q, k, v
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.packed ? a.H * DH : DH),
                              static_cast<cuuint64_t>(a.T),
                              static_cast<cuuint64_t>(a.packed ? a.B : a.B * a.H)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t qbox[3] = {64, 64, 1};
  const cuuint32_t kvbox[3] = {64, kKeys, 1};
  CUtensorMap qm, km, vm;
  if (!wis::encode_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.q, dims, strides, qbox,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wis::encode_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.k, dims, strides, kvbox,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wis::encode_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.v, dims, strides, kvbox,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorNotSupported);
  static bool attr = false;  // the opt-in above 48 KB, once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((a.T + 64 * WGS - 1) / (64 * WGS), a.H, a.B);
  flash_wgmma_kernel<DH, WGS><<<grid, L::kThreads, L::kSmem, a.stream>>>(
      qm, km, vm, a.o, a.T, a.H, a.packed ? 1 : 0, a.row_stride, a.head_stride,
      a.batch_stride, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const Launch& a) {
  if constexpr (DH == 64 || DH == 128) {
    int wgs = a.wgs;
    if (wgs == 0)
      wgs = static_cast<long long>((a.T + 127) / 128) * a.H * a.B >= sm_count() ? 2 : 1;
    if (wgs == 1) return launch_wgmma<DH, 1>(a);
    if (wgs == 2) return launch_wgmma<DH, 2>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int BK = DH <= 128 ? 64 : 32;
    const dim3 grid((a.T + kBlockQ - 1) / kBlockQ, a.H, a.B);
    flash_mma_kernel<DH, BK><<<grid, kWarps * 32, 0, a.stream>>>(
        a.q, a.k, a.v, a.o, a.T, a.row_stride, a.head_stride, a.batch_stride, a.scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
}

// the instance for head width dh: one per multiple of 8 up to kMaxDh
template <int DH = 8>
int dispatch(int dh, const Launch& a) {
  if (dh == DH) return launch<DH>(a);
  if constexpr (DH < kMaxDh) {
    return dispatch<DH + 8>(dh, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(const void* q, const void* k, const void* v, void* o, int B, int H, int T, int dh,
        bool packed, long long row_stride, long long head_stride, long long batch_stride,
        float scale, int wgs, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || dh % 8 != 0 || wgs < 0 ||
      wgs > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                 B, H, T, packed, row_stride, head_stride, batch_stride,
                 scale * 1.4426950408889634f, wgs, static_cast<cudaStream_t>(stream)};
  return dispatch(dh, a);
}

}  // namespace

// q, k, v, o: (B, T, D) bf16, contiguous, 16-byte aligned; D = H · head_dim
// (the Python wrapper admits head_dim 64 or 128, the JAX package's packed
// gate). scale = head_dim^-0.5. wgs: consumer warpgroups per block of the
// Hopper body (1 or 2; 0 lets the kernel choose).
extern "C" int wis_flash_attention_packed(const void* q, const void* k,
                                          const void* v, void* o, int B, int T,
                                          int D, int H, float scale, int wgs,
                                          void* stream) {
  if (H <= 0 || D % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int dh = D / H;
  return run(q, k, v, o, B, H, T, dh, true, D, dh, static_cast<long long>(T) * D, scale, wgs,
             stream);
}

// q, k, v, o: (B, H, T, Dh) bf16, contiguous, 16-byte aligned; Dh a
// multiple of 8 up to 256. scale = Dh^-0.5; wgs as above.
extern "C" int wis_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int T, int Dh,
                                   float scale, int wgs, void* stream) {
  const long long head = static_cast<long long>(T) * Dh;
  return run(q, k, v, o, B, H, T, Dh, false, Dh, head, head * H, scale, wgs, stream);
}
