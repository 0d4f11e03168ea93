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
// and the selected cache columns once; activations are a few KB. The
// design keeps the weights int8 all the way to the registers: each block
// of the int8 product owns a 16-column strip of one chunk, 128 k-rows in
// flight (8 bytes a thread, two threads a row), converts int8 to float by
// placing the biased byte in the mantissa of 2^23 (one byte-permute and
// one add per value), and multiplies with the BK activation rows staged
// transposed in shared memory (one 16-byte load gives 8 rows at one k).
// LayerNorm runs as the product's prologue inside each block and the
// scale/bias, gelu and residual add as its epilogue, so a layer is eight
// launches: three products with a LayerNorm prologue (q/k/v, cross q,
// W1 with gelu), self-attention, cross-attention, and three products that
// add into the f32 residual (Wo, Wco, W2 with its one deferred scale).
// The attention kernels take one (head, row) per block and skip the K/V
// reads of masked columns. No tensor cores: at BK = 5 a product does five
// multiply-adds per weight byte, well inside the CUDA cores' rate, and a
// decode step with one block per SM-sized strip is bound by how fast the
// weights arrive. wgmma, TMA and one persistent launch come later.
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

template <bool INT8>
__device__ __forceinline__ float load_xa(const void* p, size_t i) {
  if (INT8) return static_cast<float>(static_cast<const int8_t*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Cross-attention of row r, head h (grid (H, BK)) over one layer's
// (H, Dh, SX) cross-KV: row r reads only its sequence's first s_audio
// columns (pad columns and other windows are masked, exp(−1e30 − m) = 0).
// Scores bf16(q)·K × scale, then × the K column scales (int8); a
// normalized f32 softmax; × the V column scales (int8), rounded to bf16
// for the P·V contraction. Dynamic shared: s_audio floats.
template <bool INT8>
__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const float* __restrict__ q, const void* __restrict__ xk,
                       const void* __restrict__ xv, const __nv_bfloat16* __restrict__ xs,
                       __nv_bfloat16* __restrict__ out, int D, int sx, int s_pad, int s_audio,
                       int rows_per_seq, float scale) {
  extern __shared__ float w[];
  __shared__ float qb[kHeadDim], red[kWarps];
  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = (r / rows_per_seq) * s_pad;
  if (tid < kHeadDim) qb[tid] = bf16_round(q[static_cast<size_t>(r) * D + h * kHeadDim + tid]);
  __syncthreads();
  const size_t base = static_cast<size_t>(h) * kHeadDim * sx + c0;
  const __nv_bfloat16* ks = INT8 ? xs + static_cast<size_t>(2 * h) * sx + c0 : nullptr;
  const __nv_bfloat16* vs = INT8 ? xs + static_cast<size_t>(2 * h + 1) * sx + c0 : nullptr;
  float mx = NEG;
  for (int j = tid; j < s_audio; j += kThreads) {
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d)
      dot = fmaf(qb[d], load_xa<INT8>(xk, base + static_cast<size_t>(d) * sx + j), dot);
    float s = dot * scale;
    if (INT8) s = s * __bfloat162float(ks[j]);
    w[j] = s;
    mx = fmaxf(mx, s);
  }
  const float m = block_reduce<kMax, kWarps>(mx, red);
  float sum = 0.f;
  for (int j = tid; j < s_audio; j += kThreads) {
    const float e = expf(w[j] - m);
    w[j] = e;
    sum += e;
  }
  const float total = block_reduce<kSum, kWarps>(sum, red);
  for (int j = tid; j < s_audio; j += kThreads) {
    float a = w[j] / total;
    if (INT8) a = a * __bfloat162float(vs[j]);
    w[j] = bf16_round(a);
  }
  __syncthreads();
  for (int d = warp; d < kHeadDim; d += kWarps) {
    float acc = 0.f;
    for (int j = lane; j < s_audio; j += 32)
      acc = fmaf(w[j], load_xa<INT8>(xv, base + static_cast<size_t>(d) * sx + j), acc);
    acc = warp_sum(acc);
    if (lane == 0)
      out[static_cast<size_t>(r) * D + h * kHeadDim + d] = __float2bfloat16_rn(acc);
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
// f32. Head dim 64, D a multiple of 64, BK ≤ 32; the wrapper checks.
extern "C" int wis_fused_decode_step(const void* w, const void* s, const void* b,
                                     const void* ln, void* x, void* k_cache, void* v_cache,
                                     const void* xa_k, const void* xa_v, const void* xa_s,
                                     const void* sel, int pos, void* ws, int L, int D, int H,
                                     int bk, int t_cache, int n_seq, int s_pad, int s_audio,
                                     void* stream) {
  if (D != H * kHeadDim || D % 64 || bk < 1 || bk > kMaxRows || bk % n_seq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Workspace wk = carve(ws, D, bk);
  const int bkt = bk * t_cache, sx = n_seq * s_pad;
  const bool xa_int8 = xa_s != nullptr;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const size_t dd = static_cast<size_t>(D) * D;
  float* xf = static_cast<float*>(x);
  const size_t self_smem = sizeof(float) * bkt, cross_smem = sizeof(float) * s_audio;
  cudaError_t e = allow_smem(self_attention_kernel, self_smem);
  if (e == cudaSuccess && xa_int8) e = allow_smem(cross_attention_kernel<true>, cross_smem);
  if (e == cudaSuccess && !xa_int8) e = allow_smem(cross_attention_kernel<false>, cross_smem);
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

    self_attention_kernel<<<dim3(H, bk), kThreads, self_smem, st>>>(
        wk.qkv, kcl, vcl, static_cast<const float*>(sel), wk.attn, bk, D, bkt, pos, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) break;

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
    const char* xkl = static_cast<const char*>(xa_k) + l * xa_layer;
    const char* xvl = static_cast<const char*>(xa_v) + l * xa_layer;
    const __nv_bfloat16* xsl =
        xa_int8 ? static_cast<const __nv_bfloat16*>(xa_s) + static_cast<size_t>(l) * 2 * H * sx
                : nullptr;
    if (xa_int8)
      cross_attention_kernel<true><<<dim3(H, bk), kThreads, cross_smem, st>>>(
          wk.qc, xkl, xvl, xsl, wk.ctx, D, sx, s_pad, s_audio, bk / n_seq, scale);
    else
      cross_attention_kernel<false><<<dim3(H, bk), kThreads, cross_smem, st>>>(
          wk.qc, xkl, xvl, xsl, wk.ctx, D, sx, s_pad, s_audio, bk / n_seq, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) break;

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
