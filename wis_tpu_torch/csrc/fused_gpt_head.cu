// The XTTS GPT sampling head for one row — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/fused_gpt_head.py
// `build_fused_gpt_head`: double final LayerNorm, the (D, V_pad) audio-code
// logits, the stop-token floor, the repetition penalty on the caller's
// hit-mask, temperature, top-k and top-p thresholds and the draw.
//
// Two launches on the caller's stream:
//
//   gpt_head_logits_kernel  grid V_pad / 16: every block recomputes the two
//                           LayerNorms of the one row (bf16 staging as the
//                           TPU kernel: x → bf16, each LN → bf16) and one
//                           16-column strip of the bf16 product, f32
//                           accumulation, 128 k-rows in flight (two threads
//                           a row, 16-byte loads); logits
//                           bf16(bf16(dot) + bf16(bias)), pad lanes -1e30
//   gpt_head_select_kernel  one block of 1024 threads: the floor, penalty
//                           and temperature, the softmax, then for every
//                           token its count of greater values and its
//                           prefix mass (the tokens sorted before it, equal
//                           values in descending index order, as jnp.sort's
//                           reversed stable order puts them); the k-th and
//                           p-th thresholds, the masked logits, and the
//                           argmax of l + gumbel or of l, lowest index on
//                           ties
//
// Bound on the H100: the head's 2.4 MB of bf16 at XTTS v2's width (D =
// 1024, V_pad = 1152) is under a microsecond at 3.35 TB/s, so the row's
// latency is the two launches and the selection block's V_pad² ≈ 1.3 M
// comparisons (shared-memory broadcasts, a few microseconds). Splitting
// the product over 72 blocks keeps the bytes off the critical path; the
// selection stays in one block, as no other block needs its result.
//
// Plain C interface for ctypes; returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wis::bf16_round;
using wis::bf16x8_to_float;
using wis::block_reduce;
using wis::kColTile;
using wis::kMax;
using wis::kMin;
using wis::kSum;
using wis::strip_warp_sum;

constexpr float NEG = -1e30f;
constexpr float BIG = 1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKLanes = kThreads / 2;
constexpr int kSelThreads = 1024;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kMaxVp = 4096;

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

// Dynamic shared: 2·D floats (the staged row and the hidden state).
__global__ void __launch_bounds__(kThreads)
gpt_head_logits_kernel(const float* __restrict__ x, const float* __restrict__ ln4,
                       const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ hidden_out, float* __restrict__ raw, int d, int v,
                       int vp) {
  extern __shared__ float smem[];
  float* stage = smem;
  float* hid = smem + d;
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][kColTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < d; c += kThreads) stage[c] = bf16_round(x[c]);
  __syncthreads();
  ln_row_block(stage, ln4, ln4 + d, hid, d, red);            // h1 = bf16(LN(bf16(x)))
  ln_row_block(hid, ln4 + 2 * d, ln4 + 3 * d, stage, d, red);  // hidden = bf16(LN(h1))
  if (blockIdx.x == 0)
    for (int c = tid; c < d; c += kThreads) hidden_out[c] = stage[c];

  const int half = tid & 1, kl = tid >> 1;
  const int n0 = blockIdx.x * kColTile;
  const __nv_bfloat16* wp = w + n0 + 8 * half;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int k = kl; k < d; k += kKLanes) {
    float wf[8];
    bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(k) * vp)), wf);
    const float hk = stage[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(hk, wf[j], acc[j]);
  }
  strip_warp_sum(acc, part[warp], lane);
  __syncthreads();
  if (tid < kColTile) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) dot += part[i][tid];
    const int n = n0 + tid;
    raw[n] = n < v ? bf16_round(bf16_round(dot) + bf16_round(bias[n])) : NEG;
  }
}

// One block. Dynamic shared: l, probs (f32) and the greater-counts (int)
// of V_pad tokens.
__global__ void __launch_bounds__(kSelThreads)
gpt_head_select_kernel(const float* __restrict__ raw, const float* __restrict__ hist,
                       const float* __restrict__ gum, const float* __restrict__ knobs,
                       int32_t* __restrict__ tok, float* __restrict__ logits, int vp, int stop) {
  extern __shared__ float sel_smem[];
  float* l = sel_smem;
  float* probs = sel_smem + vp;
  int* gt = reinterpret_cast<int*>(sel_smem + 2 * vp);
  __shared__ float red[kSelWarps];
  const int tid = threadIdx.x;
  const float temp = fmaxf(knobs[0], 1e-5f), kf = fmaxf(knobs[1], 1.0f), p = knobs[2];
  const float rp = knobs[3];
  const bool stop_blocked = knobs[4] > 0.f, sample = knobs[5] > 0.f;

  float mx = NEG;
  for (int t = tid; t < vp; t += kSelThreads) {
    float lv = raw[t];
    if (t == stop && stop_blocked) lv = NEG;
    if (hist[t] > 0.f) lv = lv > 0.f ? lv / rp : lv * rp;
    lv = lv / temp;
    l[t] = lv;
    mx = fmaxf(mx, lv);
  }
  const float m = block_reduce<kMax, kSelWarps>(mx, red);
  float sum = 0.f;
  for (int t = tid; t < vp; t += kSelThreads) {
    const float e = expf(l[t] - m);
    probs[t] = e;
    sum += e;
  }
  const float total = block_reduce<kSum, kSelWarps>(sum, red);
  for (int t = tid; t < vp; t += kSelThreads) probs[t] = probs[t] / total;
  __syncthreads();

  // per token: #greater and the mass sorted before it; top-k candidates
  float kth_c = BIG, cnt = 0.f;
  for (int t = tid; t < vp; t += kSelThreads) {
    const float bc = l[t];
    int g = 0;
    float pre = 0.f;
    for (int u = 0; u < vp; ++u) {
      const float a = l[u];
      if (a > bc) {
        ++g;
        pre += probs[u];
      } else if (a == bc && u > t) {
        pre += probs[u];
      }
    }
    gt[t] = g;
    cnt += pre < p ? 1.f : 0.f;
    if (static_cast<float>(g) <= kf - 1.0f) kth_c = fminf(kth_c, bc);
  }
  const float kth = block_reduce<kMin, kSelWarps>(kth_c, red);
  const float cntc = fmaxf(block_reduce<kSum, kSelWarps>(cnt, red), 1.0f);
  float pth_c = BIG;
  for (int t = tid; t < vp; t += kSelThreads)
    if (static_cast<float>(gt[t]) <= cntc - 1.0f) pth_c = fminf(pth_c, l[t]);
  const float pth = block_reduce<kMin, kSelWarps>(pth_c, red);

  // masked logits, then argmax of l + gumbel and of l (lowest index)
  float ms = NEG * 2.f, mg = NEG * 2.f;
  for (int t = tid; t < vp; t += kSelThreads) {
    float lv = l[t];
    if (lv < kth) lv = NEG;
    if (lv < pth) lv = NEG;
    logits[t] = lv;
    l[t] = lv;
    ms = fmaxf(ms, lv + gum[t]);
    mg = fmaxf(mg, lv);
  }
  const float best_s = block_reduce<kMax, kSelWarps>(ms, red);
  const float best_g = block_reduce<kMax, kSelWarps>(mg, red);
  float is = static_cast<float>(vp + 1), ig = static_cast<float>(vp + 1);
  for (int t = tid; t < vp; t += kSelThreads) {
    if (l[t] + gum[t] >= best_s) is = fminf(is, static_cast<float>(t));
    if (l[t] >= best_g) ig = fminf(ig, static_cast<float>(t));
  }
  const float idx_s = block_reduce<kMin, kSelWarps>(is, red);
  const float idx_g = block_reduce<kMin, kSelWarps>(ig, red);
  if (tid == 0) tok[0] = static_cast<int32_t>(sample ? idx_s : idx_g);
}

}  // namespace

// The head of one row. x (1, D) f32; ln4 (4, D) f32; head_w (D, VP) bf16;
// head_b, hist, gum (1, VP) f32; knobs (1, 8) f32 [temperature, top_k,
// top_p, repetition_penalty, stop_blocked, do_sample, 0, 0] → tok (1, 1)
// int32, hidden (1, D) f32, logits (1, VP) f32 masked; raw (1, VP) f32 is
// scratch. D a multiple of 8, VP a multiple of 16 up to 4096, V ≤ VP.
extern "C" int wis_fused_gpt_head(const void* x, const void* ln4, const void* head_w,
                                  const void* head_b, const void* hist, const void* gum,
                                  const void* knobs, void* tok, void* hidden, void* logits,
                                  void* raw, int D, int V, int VP, int stop, void* stream) {
  if (D <= 0 || D % 8 || VP % kColTile || VP > kMaxVp || V < 1 || V > VP || stop < 0 ||
      stop >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t ln_smem = sizeof(float) * 2 * D, sel_smem = sizeof(float) * 3 * VP;
  cudaError_t e = cudaSuccess;
  if (ln_smem > 48 * 1024)
    e = cudaFuncSetAttribute(gpt_head_logits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ln_smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  gpt_head_logits_kernel<<<VP / kColTile, kThreads, ln_smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln4),
      static_cast<const __nv_bfloat16*>(head_w), static_cast<const float*>(head_b),
      static_cast<float*>(hidden), static_cast<float*>(raw), D, V, VP);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  gpt_head_select_kernel<<<1, kSelThreads, sel_smem, st>>>(
      static_cast<const float*>(raw), static_cast<const float*>(hist),
      static_cast<const float*>(gum), static_cast<const float*>(knobs),
      static_cast<int32_t*>(tok), static_cast<float*>(logits), VP, stop);
  return static_cast<int>(cudaGetLastError());
}
