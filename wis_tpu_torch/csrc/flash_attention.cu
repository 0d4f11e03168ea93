// Packed-layout flash attention (unmasked, encoder self-attention) —
// Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/flash.py `flash_attention_packed`
// (body `_kernel_packed`): softmax(q·kᵀ/√Dh)·v per head, with an online
// softmax in f32 and keys at or past T masked. q, k, v and the output are
// read and written in the packed (B, T, D) layout, heads side by side
// along D, so no head transposes go through device memory.
//
// Bound on the H100: at the encoder's shapes (T=1500, Dh=64, H=20) the
// work is 4·T²·D ≈ 11.5 GFLOP per layer against ~15 MB of q/k/v/out, so
// it is bound by the tensor cores' operation rate, not by bytes. The
// design therefore keeps the T×T scores out of device memory entirely
// and feeds the tensor cores: one block of 4 warps per (query tile of 64,
// head, batch); each warp owns 16 query rows whose Q fragments stay in
// registers; K and V tiles of 64 keys go through shared memory (V stored
// transposed so its fragments are 32-bit loads); S = Q·Kᵀ and O += P·V run
// as bf16 mma.sync.m16n8k16 with f32 accumulators; the S accumulators are
// rescaled, exponentiated and repacked to bf16 in registers as the A
// operand of the P·V product (the FlashAttention-2 layout identity). The
// ragged last key tile (1500 is no multiple of 64) is zero-filled in
// shared memory and masked in registers; nothing is padded in device
// memory. This first version does not pipeline the tile loads (no
// cp.async/TMA) and uses mma.sync rather than wgmma.
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
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kPad = 8;       // bf16 elements of row padding (bank spread)
constexpr float kNegInf = -1e30f;

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_packed_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int T, int D,
                    float scale_log2) {
  __shared__ alignas(16) __nv_bfloat16 ks[kBlockK][DH + kPad];
  __shared__ alignas(16) __nv_bfloat16 vt[DH][kBlockK + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // mma group: rows g and g + 8
  const int t4 = lane & 3;   // thread in group: columns 2·t4, 2·t4 + 1
  // element (b, t, h·DH + d) of a packed tensor sits at base + t·D + d
  const size_t base = static_cast<size_t>(blockIdx.z) * T * D +
                      static_cast<size_t>(blockIdx.y) * DH;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;

  // this warp's Q rows as A fragments, one per 16-wide slice of DH
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = r0 < T ? load_pair(q + base + static_cast<size_t>(r0) * D + c) : 0u;
    qa[kk][1] = r1 < T ? load_pair(q + base + static_cast<size_t>(r1) * D + c) : 0u;
    qa[kk][2] = r0 < T ? load_pair(q + base + static_cast<size_t>(r0) * D + c + 8) : 0u;
    qa[kk][3] = r1 < T ? load_pair(q + base + static_cast<size_t>(r1) * D + c + 8) : 0u;
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units), rows g / g+8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  for (int k0 = 0; k0 < T; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBlockK * DH / 8; idx += kWarps * 32) {
      const int r = idx / (DH / 8);
      const int c = (idx % (DH / 8)) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        const size_t off = base + static_cast<size_t>(key) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[c + i][r] = ve[i];
    }
    __syncthreads();

    // S = Q·Kᵀ for 16 rows × 64 keys: 8 accumulator tiles of 16×8
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kp = &ks[nt * 8 + g][kk * 16 + t4 * 2];
        mma_bf16_16816(s[nt], qa[kk], load_pair(kp), load_pair(kp + 8));
      }
    }

    // scale into log2 units, mask keys >= T, row maxima over the group
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
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
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
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
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
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
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + static_cast<size_t>(r0) * D + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + static_cast<size_t>(r1) * D + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

}  // namespace

// q, k, v, o: (B, T, D) bf16, contiguous, 16-byte aligned; D = H · head_dim
// with head_dim 64 or 128 (the Python wrapper checks). scale = head_dim^-0.5.
extern "C" int wis_flash_attention_packed(const void* q, const void* k,
                                          const void* v, void* o, int B, int T,
                                          int D, int H, float scale,
                                          void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dh = D / H;
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, H, B);
  const dim3 block(kWarps * 32);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (dh == 64) {
    flash_packed_kernel<64><<<grid, block, 0, s>>>(qp, kp, vp, op, T, D, scale_log2);
  } else if (dh == 128) {
    flash_packed_kernel<128><<<grid, block, 0, s>>>(qp, kp, vp, op, T, D, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
