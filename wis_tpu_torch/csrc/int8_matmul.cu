// W8A16 matrix product, y = (x · bf16(q)) · s — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/quant_pallas.py `int8_matmul` (body
// `_kernel`): x (M, K) bf16, q (K, N) int8 with one f32 scale per output
// column; the int8 weight becomes bf16 (exactly) on its way into shared
// memory, the product runs in bf16 with f32 accumulators, the f32 scale is
// applied once after the contraction, and y is stored once, in bf16 or f32.
//
// Bound on the H100: it depends on M. The decode step's and the prompt's
// products (M of 1 to 20 rows) read K·N weight bytes for 2·M·K·N
// operations: bound by bytes, so the grid must spread the weight over many
// blocks and keep many loads in flight. The cross-KV projection (M of 1500
// to 6000) is bound by the tensor cores. One simple tiling serves both and
// keeps the whole batch out of shared memory, unlike the TPU kernel, which
// holds every row resident: 64×64 output tiles, one block of 4 warps each,
// walking K in steps of 128 (12 16-byte loads per thread per step); each
// warp computes a 32×32 quarter with bf16 mma.sync.m16n8k16. Rows past M
// are zero-filled in shared memory and never stored. Where the output
// tiles alone would leave SMs idle (few rows: N/64 tiles of 64 rows), K
// is split over gridDim.z: each split stores its f32 partial tile and a
// second kernel sums the splits in a fixed order, scales and stores y.
// This first version does not pipeline the tile loads (no cp.async/TMA)
// and uses mma.sync rather than wgmma.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using wis::int8x16_to_float;
using wis::load_pair;
using wis::mma_bf16_16816;

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 128;  // contraction depth per shared-memory tile
constexpr int kThreads = 128;
constexpr int kPad = 8;   // bf16 elements of row padding (bank spread)
constexpr int kBlocksPerSm = 4;  // a split grid aims at this many blocks per SM

__device__ __forceinline__ void store_pair(void* y, size_t i, float a, float b, bool out_f32) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(y) + i) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + i) =
        __floats2bfloat162_rn(a, b);
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, void* __restrict__ y, float* __restrict__ part,
                   int M, int K, int N, int k_split, bool out_f32) {
  __shared__ alignas(16) __nv_bfloat16 xs[kBM][kBK + kPad];  // (m, k)
  __shared__ alignas(16) __nv_bfloat16 ws[kBN][kBK + kPad];  // (n, k): B fragments are k-pairs

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // this block's share of K: all of it, or one split's (part != nullptr)
  const int k_begin = blockIdx.z * k_split, k_end = min(K, k_begin + k_split);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // x tile: kBM rows × kBK columns, 16 bytes (8 bf16) per load
#pragma unroll
    for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&xs[r][c]) = v;
    }
    // weight tile: kBK k-rows × kBN columns of int8, 16 bytes per load,
    // converted and stored transposed
#pragma unroll
    for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
      const int kr = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      float f[16];
      int8x16_to_float(
          __ldg(reinterpret_cast<const uint4*>(q + static_cast<size_t>(k0 + kr) * N + n0 + c)), f);
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[c + j][kr] = __float2bfloat16_rn(f[j]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g, c = kk + t4 * 2;
        a[mi][0] = load_pair(&xs[r][c]);
        a[mi][1] = load_pair(&xs[r + 8][c]);
        a[mi][2] = load_pair(&xs[r][c + 8]);
        a[mi][3] = load_pair(&xs[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* bp = &ws[wn + ni * 8 + g][kk + t4 * 2];
        const uint32_t b0 = load_pair(bp), b1 = load_pair(bp + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: the f32 column scale and one rounding, or, for a split of
  // K, the unscaled f32 partial
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + t4 * 2;
    const float s0 = part ? 1.f : s[col], s1 = part ? 1.f : s[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r0 = m0 + wm + mi * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        if (r >= M) continue;
        const float a = acc[mi][ni][2 * h] * s0, b = acc[mi][ni][2 * h + 1] * s1;
        if (part)
          store_pair(part, (static_cast<size_t>(blockIdx.z) * M + r) * N + col, a, b, true);
        else
          store_pair(y, static_cast<size_t>(r) * N + col, a, b, out_f32);
      }
    }
  }
}

// y = (Σ_z part[z]) · s, the splits summed in order z = 0, 1, ...
__global__ void int8_matmul_combine(const float* __restrict__ part, const float* __restrict__ s,
                                    void* __restrict__ y, int M, int N, int splits,
                                    bool out_f32) {
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i >= mn) return;
  float a = 0.f, b = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float2 p = *reinterpret_cast<const float2*>(part + z * mn + i);
    a += p.x;
    b += p.y;
  }
  const int col = static_cast<int>(i % N);
  store_pair(y, i, a * s[col], b * s[col + 1], out_f32);
}

}  // namespace

// How many splits of K the product takes on a card with `sms` SMs: 1 when
// the output tiles cover the SMs, else enough whole kBK steps per split to
// come near kBlocksPerSm blocks per SM.
extern "C" int wis_int8_matmul_splits(int M, int K, int N, int sms) {
  const int tiles = (N / kBN) * ((M + kBM - 1) / kBM), steps = K / kBK;
  const int want = kBlocksPerSm * sms;
  if (tiles <= 0 || steps <= 0 || tiles >= sms) return 1;
  const int target = std::min(steps, (want + tiles - 1) / tiles);
  const int per = (steps + target - 1) / target;
  return (steps + per - 1) / per;
}

// x (M, K) bf16, q (K, N) int8, s (N,) f32, y (M, N) bf16 or, with
// out_f32, f32; all contiguous and 16-byte aligned, K a multiple of 128
// and N of 64 (the wrapper checks). With splits > 1, part holds
// splits·M·N f32 and splits must be wis_int8_matmul_splits(...) for some
// sms, so that every split has whole kBK steps.
extern "C" int wis_int8_matmul(const void* x, const void* q, const void* s, void* y, void* part,
                               int M, int K, int N, int splits, int out_f32, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK || N % kBN || (M + kBM - 1) / kBM > 65535 ||
      splits < 1 || (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = K / kBK, per = (steps + splits - 1) / splits;
  if ((steps + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM, splits);
  int8_matmul_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), y, splits > 1 ? static_cast<float*>(part) : nullptr, M, K,
      N, per * kBK, out_f32 != 0);
  if (splits > 1) {
    const size_t pairs = static_cast<size_t>(M) * N / 2;
    int8_matmul_combine<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(s), y, M, N, splits,
        out_f32 != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
