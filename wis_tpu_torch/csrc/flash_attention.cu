// Flash attention for the encoder (unmasked self-attention), in both of the
// JAX package's layouts — Hopper (sm_90a).
//
// Replaces the TPU kernels wis_tpu/ops/flash.py `flash_attention_packed`
// (body `_kernel_packed`) and `flash_attention` (body `_kernel`):
// softmax(q·kᵀ/√Dh)·v per head, with an online softmax in f32 and keys at
// or past T masked. One kernel body serves both layouts; it is told where a
// (batch, head) starts and how far apart two rows are:
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
// it is bound by the tensor cores' operation rate, not by bytes. The
// design therefore keeps the T×T scores out of device memory entirely
// and feeds the tensor cores: one block of 4 warps per (query tile of 64,
// head, batch); each warp owns 16 query rows whose Q fragments stay in
// registers; K and V tiles go through shared memory (V stored transposed
// so its fragments are 32-bit loads); S = Q·Kᵀ and O += P·V run as bf16
// mma.sync.m16n8k16 with f32 accumulators; the S accumulators are
// rescaled, exponentiated and repacked to bf16 in registers as the A
// operand of the P·V product (the FlashAttention-2 layout identity). The
// ragged last key tile (1500 is no multiple of 64) is zero-filled in
// shared memory and masked in registers; nothing is padded in device
// memory. This first version does not pipeline the tile loads (no
// cp.async/TMA) and uses mma.sync rather than wgmma.
//
// Head widths: every multiple of 8 up to 256 (the JAX gate takes any
// Dh % 8 == 0). Q·Kᵀ contracts over Dh in 16-wide slices; where
// Dh % 16 == 8 the upper half of the last slice is zero in both operands'
// registers (neither Q nor K is read there). Key tiles are 64 keys wide up
// to Dh = 128 and 32 above, which keeps the static shared memory under
// 48 KB and the score registers at 16 per thread.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::load_pair;
using wis::mma_bf16_16816;
using wis::pack_bf16;

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kWarps = 4;
constexpr int kPad = 8;       // bf16 elements of row padding (bank spread)
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

template <int DH, int BK>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,
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

struct Launch {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int B, H, T;
  long long row_stride, head_stride, batch_stride;
  float scale_log2;
  cudaStream_t stream;
};

template <int DH>
int launch(const Launch& a) {
  constexpr int BK = DH <= 128 ? 64 : 32;
  const dim3 grid((a.T + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_kernel<DH, BK><<<grid, kWarps * 32, 0, a.stream>>>(
      a.q, a.k, a.v, a.o, a.T, a.row_stride, a.head_stride, a.batch_stride, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
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

int run(const void* q, const void* k, const void* v, void* o, int B, int H, int T,
        int dh, long long row_stride, long long head_stride, long long batch_stride,
        float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || dh % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                 B, H, T, row_stride, head_stride, batch_stride,
                 scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream)};
  return dispatch(dh, a);
}

}  // namespace

// q, k, v, o: (B, T, D) bf16, contiguous, 16-byte aligned; D = H · head_dim
// (the Python wrapper admits head_dim 64 or 128, the JAX package's packed
// gate). scale = head_dim^-0.5.
extern "C" int wis_flash_attention_packed(const void* q, const void* k,
                                          const void* v, void* o, int B, int T,
                                          int D, int H, float scale,
                                          void* stream) {
  if (H <= 0 || D % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int dh = D / H;
  return run(q, k, v, o, B, H, T, dh, D, dh, static_cast<long long>(T) * D, scale,
             stream);
}

// q, k, v, o: (B, H, T, Dh) bf16, contiguous, 16-byte aligned; Dh a
// multiple of 8 up to 256. scale = Dh^-0.5.
extern "C" int wis_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int T, int Dh,
                                   float scale, void* stream) {
  const long long head = static_cast<long long>(T) * Dh;
  return run(q, k, v, o, B, H, T, Dh, Dh, head, head * H, scale, stream);
}
