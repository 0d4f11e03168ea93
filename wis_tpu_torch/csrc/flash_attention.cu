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
// Every head width takes one Hopper body, FlashAttention-3 in shape: a
// block of one or two consumer warpgroups, each owning 64 query rows, and
// one producer warp. The producer TMA-loads each warpgroup's Q tile once
// and keeps K and V tiles of 64 keys in flight in a ring of kKvStages
// stages ("full"/"empty" mbarriers), through 3-D tensor maps over
// (B, T, D) at column h·Dh (packed) or (B·H, T, Dh) (head-major), in the
// 128-byte swizzle; TMA zero-fills a ragged last key tile within its own
// batch and head, so no row of another batch is ever read. S = Q·Kᵀ is a
// wgmma with both operands in shared memory (K is Dh-contiguous:
// K-major); the online softmax runs on the S accumulators in f32
// registers (log2 units, keys ≥ T masked); P is repacked to bf16 in
// registers as the A operand of O += P·V, whose B operand V is read
// N-major through the descriptor's transpose bit — V is never transposed.
// Two warpgroups share each K/V tile; where that leaves too few blocks to
// fill the SMs (H·B·⌈T/128⌉ below the SM count), and at DP 256, each
// block holds one.
//
// The body is compiled at a padded width DP = 64·⌈Dh/64⌉ (64, 128, 192 or
// 256) and told the real Dh at run time. The packed layout takes Dh 64
// and 128 only, the JAX package's packed gate (there DP = Dh). In the
// head-major layout the tensor maps' inner dimension is Dh, so the
// 64-column boxes of the last column block read real data up to Dh and
// TMA zero-fills columns Dh..DP-1 of Q, K and V in shared memory: the
// padded columns add exact zeros to S, the scale stays Dh^-0.5, and only
// Dh columns of O are stored. S runs all DP/16 k16 slices: skipping the
// all-zero slices past Dh behind a branch made every width slower (the
// wgmmas no longer issue back to back). At DP 64 and 128 the head-major
// and packed layouts run the same instructions, so the same numbers give
// bit-identical outputs.
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

using wis::pack_bf16;

constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

// ---- the Hopper body ---------------------------------------------------

constexpr int kKeys = 64;     // keys per K/V tile
constexpr int kKvStages = 2;  // ring depth

template <int DP, int WGS>
struct Tile {
  static constexpr int kQBytes = 64 * DP * 2;      // one warpgroup's Q rows
  static constexpr int kKvBytes = kKeys * DP * 2;  // one K or V tile
  static constexpr int kHalf = 64 * 128;           // a 64-row, 64-column swizzled block
  static constexpr int kThreads = WGS * 128 + 32;
  static constexpr int kSmem =
      WGS * kQBytes + kKvStages * 2 * kKvBytes + (1 + 2 * kKvStages) * 8 + 1024;
};

// Tiles of 64 rows × DP in shared memory are DP/64 column blocks of
// 64 rows × 128 bytes (kHalf apart), each as TMA writes it in the 128-byte
// swizzle. The k16 slice kk of such a tile as a K-major operand starts
// kk/4 blocks and (kk % 4)·32 bytes in. dh (≤ DP) is the real head width:
// columns dh..DP-1 of every tile are TMA's zeros.
template <int DP, int WGS>
__global__ void __launch_bounds__(Tile<DP, WGS>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                   int T, int H, int dh, int packed, long long row_stride,
                   long long head_stride, long long batch_stride, float scale_log2) {
  using L = Tile<DP, WGS>;
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
  const int col0 = packed ? h * dh : 0, z = packed ? b : b * H + h;
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
    // producer: Q once, then K and V tiles through the ring; a box counts
    // its zero-filled columns in the transaction bytes
    if (tid == WGS * 128) {
      wis::mbar_expect_tx(qfull, WGS * L::kQBytes);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < DP / 64; ++c)
          wis::tma_load_3d(qs + w * L::kQBytes + c * L::kHalf, &qmap, qfull, col0 + c * 64,
                           q0 + w * 64, z);
      for (int i = 0; i < nk; ++i) {
        const int st = i % kKvStages;
        if (i >= kKvStages) wis::mbar_wait(&empty[st], (i / kKvStages - 1) & 1);
        uint8_t* ks = kv + st * 2 * L::kKvBytes;
        wis::mbar_expect_tx(&full[st], 2 * L::kKvBytes);
        for (int c = 0; c < DP / 64; ++c) {
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
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
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
    for (int kk = 0; kk < DP / 16; ++kk) {
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
    for (int j = 0; j < DP / 8; ++j) {
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
      wis::wgmma_rs<DP, 1>(acc, pa, vd);
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
  for (int j = 0; j < DP / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    if (c >= dh) break;  // dh is a multiple of 8: a column pair is all in or all out
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
  int B, H, T, dh;
  bool packed;
  long long row_stride, head_stride, batch_stride;
  float scale_log2;
  int wgs;  // consumer warpgroups per block; 0: chosen here
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

template <int DP, int WGS>
int launch_wgmma(const Launch& a) {
  using L = Tile<DP, WGS>;
  // (columns, rows, batch·head or batch) over each of q, k, v: the
  // head-major maps end at column dh, so the boxes past it read zeros
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.packed ? a.H * a.dh : a.dh),
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
  static unsigned long long opted = 0;  // the opt-in above 48 KB, per instance and device
  const cudaError_t e = wis::set_attribute(
      flash_wgmma_kernel<DP, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem, &opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.T + 64 * WGS - 1) / (64 * WGS), a.H, a.B);
  flash_wgmma_kernel<DP, WGS><<<grid, L::kThreads, L::kSmem, a.stream>>>(
      qm, km, vm, a.o, a.T, a.H, a.dh, a.packed ? 1 : 0, a.row_stride, a.head_stride,
      a.batch_stride, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// DP 256 takes one consumer warpgroup: with two, nine warps share the
// SM's four register files, 168 registers a thread, and the O
// accumulator (128 a thread) spills.
template <int DP>
int launch(const Launch& a) {
  if constexpr (DP == 256) {
    return launch_wgmma<DP, 1>(a);
  } else {
    int wgs = a.wgs;
    if (wgs == 0)
      wgs = static_cast<long long>((a.T + 127) / 128) * a.H * a.B >= sm_count() ? 2 : 1;
    return wgs == 1 ? launch_wgmma<DP, 1>(a) : launch_wgmma<DP, 2>(a);
  }
}

int run(const void* q, const void* k, const void* v, void* o, int B, int H, int T, int dh,
        bool packed, long long row_stride, long long head_stride, long long batch_stride,
        float scale, int wgs, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || dh <= 0 || dh % 8 != 0 ||
      dh > kMaxDh || (packed && dh != 64 && dh != 128) || wgs < 0 || wgs > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                 B, H, T, dh, packed, row_stride, head_stride, batch_stride,
                 scale * 1.4426950408889634f, wgs, static_cast<cudaStream_t>(stream)};
  switch ((dh + 63) / 64) {  // the padded width DP
    case 1: return launch<64>(a);
    case 2: return launch<128>(a);
    case 3: return launch<192>(a);
    default: return launch<256>(a);
  }
}

}  // namespace

// q, k, v, o: (B, T, D) bf16, contiguous, 16-byte aligned; D = H · head_dim
// with head_dim 64 or 128 (the JAX package's packed gate). scale =
// head_dim^-0.5. wgs: consumer warpgroups per block (1 or 2; 0 lets the
// kernel choose).
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
