// One XTTS audio token through all GPT-2 layers — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/fused_gpt.py `build_fused_gpt_step`
// (its pallas_call runs all L layers in one launch; oracle
// `fused_gpt_step_reference`). Per layer, as the TPU kernel computes it:
//
//   h  = bf16(LN1(x));  q, k, v = h·W{q,k,v} · s + b          (f32)
//   self-attention over the time-major cache with the causal `sel` mask
//   and an explicit self column (scored with the f32 q and k); e rounded
//   to bf16 for P·V while the denominator sums the f32 e; out =
//   (P·V + e_self·v) / denom, rounded to bf16 (the kernel splits time and
//   merges the splits' partials: decode_step.cuh); this step's bf16 K/V
//   written at pos·bk + row
//   x += attn·Wo · s + b
//   h  = bf16(LN2(x));  g_i = bf16(gelu_tanh(h·W1_i · s + b))  (i < 4)
//   x  = (x + (Σ_i g_i·W2_i) · s) + b
//
// It is the Whisper step (fused_decode.cu) without cross-attention, and
// launches the same kernels (decode_step.cuh): five per layer — the q/k/v
// product with the LN1 prologue, self-attention, the Wo product into the
// residual, W1 with the LN2 prologue and the gelu epilogue, and W2 as one
// (4D, D) product with the deferred scale and bias of slot W2_0 + 3.
//
// Bound on the H100: device-memory bytes. Each token streams 12 int8
// (D, D) chunks per layer (377 MB at XTTS v2's 30 layers of D = 1024) and
// the selected cache columns once; the activations are a few KB. The
// products keep the weights int8 up to the registers and run on the
// tensor cores, one 64-column strip and one split of K per block;
// self-attention splits the cache's time steps over eight blocks per head
// (128 blocks at bk = 1). fused_decode.cu says how both keep to the bound.
// Columns that `sel` excludes, the stale one at pos among them, are never
// used.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_step.cuh"

namespace {

constexpr int NC = 12;
constexpr int QW = 0, OW = 3, W1_0 = 4, W2_0 = 8;

struct GptWorkspace {
  float* qkv;            // (bk, 3D) f32
  __nv_bfloat16* attn;   // (bk, D)
  __nv_bfloat16* g;      // (bk, 4D)
  size_t bytes;
};

GptWorkspace carve_gpt(void* base, int D, int bk) {
  GptWorkspace w{};
  char* p = static_cast<char*>(base);
  size_t off = 0;
  auto take = [&](size_t n) {
    char* q = p ? p + off : nullptr;
    off += align256(n);
    return q;
  };
  w.qkv = reinterpret_cast<float*>(take(sizeof(float) * bk * 3 * D));
  w.attn = reinterpret_cast<__nv_bfloat16*>(take(2 * bk * D));
  w.g = reinterpret_cast<__nv_bfloat16*>(take(2 * bk * 4 * D));
  w.bytes = off;
  return w;
}

}  // namespace

// Bytes of scratch one step needs (0 for shapes the kernels do not take).
extern "C" long long wis_fused_gpt_workspace_bytes(int D, int bk) {
  if (D <= 0 || D % 64 || bk < 1 || bk > kMaxRows) return 0;
  return static_cast<long long>(carve_gpt(nullptr, D, bk).bytes);
}

// One step through all L layers. x (bk, D) f32 holds x_emb on entry and
// x_out on return; k/v_cache (L, D, bk·T) bf16 are written in place at
// columns pos·bk + row; sel (bk, bk·T) f32. w (L, 12, D, D) int8, s/b
// (L, 12, D) f32, ln (L, 4, D) f32. Head dim 64, D a multiple of 64,
// bk ≤ 32, bk·T a multiple of 8; the wrapper checks. With `pos_dev` (one
// int in device memory) the kernels read pos there when they run, and
// `pos` is not used: a CUDA graph captured once then serves every
// position, its caller keeping pos inside the cache.
extern "C" int wis_fused_gpt_step(const void* w, const void* s, const void* b, const void* ln,
                                  void* x, void* k_cache, void* v_cache, const void* sel,
                                  int pos, void* ws, int L, int D, int H, int bk, int t_cache,
                                  void* stream, const void* pos_dev) {
  if (D != H * kHeadDim || D % 64 || bk < 1 || bk > kMaxRows ||
      (!pos_dev && (pos < 0 || pos >= t_cache)) || bk * t_cache % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GptWorkspace wk = carve_gpt(ws, D, bk);
  const int bkt = bk * t_cache;
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  const size_t dd = static_cast<size_t>(D) * D;
  float* xf = static_cast<float*>(x);
  cudaError_t e = cudaSuccess;

  for (int l = 0; l < L && e == cudaSuccess; ++l) {
    const int8_t* wl = static_cast<const int8_t*>(w) + l * NC * dd;
    const float* sl = static_cast<const float*>(s) + static_cast<size_t>(l) * NC * D;
    const float* bl = static_cast<const float*>(b) + static_cast<size_t>(l) * NC * D;
    const float* lnl = static_cast<const float*>(ln) + static_cast<size_t>(l) * 4 * D;
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

    SelfArgs sa{};
    sa.qkv = wk.qkv; sa.kc = kcl; sa.vc = vcl; sa.sel = static_cast<const float*>(sel);
    sa.out = wk.attn;
    sa.bk = bk; sa.D = D; sa.t_cache = t_cache; sa.pos = pos; sa.scale = scale;
    sa.pos_dev = static_cast<const int*>(pos_dev);
    e = launch_self(sa, H, st);
    if (e != cudaSuccess) break;

    // x += attn·Wo
    ProductArgs r = p;
    r.src = wk.attn; r.x = nullptr;
    r.w = wl + OW * dd; r.s = sl + OW * D; r.b = bl + OW * D;
    r.xres = xf;
    e = launch_product<kResidual, false>(r, 1, st);
    if (e != cudaSuccess) break;

    // g_i = gelu(LN2(x)·W1_i), i < 4
    p.ln_g = lnl + 2 * D; p.ln_b = lnl + 3 * D;
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
