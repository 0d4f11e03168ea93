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
// never read.
//
// Bound on the H100: bytes — each (row, head) reads its pos + 1 selected
// key and value columns (2·Dh·(pos+1) bf16) once and does 4·Dh operations
// per column. One block per (head, row): the threads split the positions
// for the scores (consecutive positions on consecutive threads, so each
// key element of a row is one coalesced read across the block), keep them
// in shared memory, and then each warp takes a share of the Dh output
// elements with its lanes splitting the positions again.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::block_reduce;
using wis::kMax;
using wis::kSum;
using wis::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Dynamic shared: q (Dh) f32, then the pos + 1 scores f32.
__global__ void __launch_bounds__(kThreads)
ancestry_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ anc,
                          int H, int Dh, int T, int pos, float scale,
                          __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  float* qs = smem;
  float* sc = smem + Dh;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = pos + 1;
  const int* arow = anc + static_cast<size_t>(b) * T;

  for (int d = tid; d < Dh; d += kThreads)
    qs[d] = __bfloat162float(q[(static_cast<size_t>(b) * H + h) * Dh + d]);
  __syncthreads();

  float mx = -INFINITY;
  for (int s = tid; s < n; s += kThreads) {
    const int r = arow[s];
    float acc = 0.f;
    if (r >= 0) {
      const __nv_bfloat16* kp = k + (static_cast<size_t>(r) * H + h) * Dh * T + s;
      for (int d = 0; d < Dh; ++d)
        acc = fmaf(qs[d], __bfloat162float(kp[static_cast<size_t>(d) * T]), acc);
    }
    acc *= scale;
    sc[s] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = block_reduce<kMax, kWarps>(mx, red);
  float sum = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    sum += e;
  }
  // the reduction's barriers also publish the weights to every warp
  const float inv = 1.f / block_reduce<kSum, kWarps>(sum, red);

  for (int d = warp; d < Dh; d += kWarps) {
    float acc = 0.f;
    for (int s = lane; s < n; s += 32) {
      const int r = arow[s];
      if (r >= 0)
        acc = fmaf(sc[s], __bfloat162float(v[((static_cast<size_t>(r) * H + h) * Dh + d) * T + s]),
                   acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[(static_cast<size_t>(b) * H + h) * Dh + d] = __float2bfloat16_rn(acc * inv);
  }
}

}  // namespace

// q (BK, H, Dh) bf16; k, v (BK, H, Dh, T) bf16; anc (BK, T) int32 global
// physical rows (negative: zero key and value); 0 ≤ pos < T; out (BK, H,
// Dh) bf16. All contiguous (the wrapper checks).
extern "C" int wis_ancestry_attention(const void* q, const void* k, const void* v,
                                      const void* anc, int BK, int H, int Dh, int T, int pos,
                                      float scale, void* out, void* stream) {
  if (BK <= 0 || H <= 0 || Dh <= 0 || Dh > 1024 || pos < 0 || pos >= T || BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (Dh + pos + 1);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(ancestry_attention_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(e);
  ancestry_attention_kernel<<<dim3(H, BK), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(anc), H, Dh, T, pos, scale,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
