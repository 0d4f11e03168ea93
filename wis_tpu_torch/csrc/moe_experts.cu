// Routed SwiGLU experts as two grouped products — Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs no sparse-expert model. It
// is the expert layer of Uni-MoE-2.0-Omni (wis_tpu_torch/models/unimoe/
// moe.py), where each token runs 0, 1 or 2 of 4 dynamic experts of width
// F 18944 at d 3584, as its router decided. The wrapper
// (wis_tpu_torch/ops/moe_experts.py) orders the (token, slot) pairs by
// expert on the device (`order`, with each expert's `counts` and `starts`
// in that order) and launches:
//
//   moe_gate_up_kernel: block (e, m, n) gathers rows m·BM … of expert e's
//     sorted pairs from h (N, D), runs them against the BN-unit tiles of
//     Wg_e and Wu_e (F, D) over the whole depth, and stores silu(g)·u,
//     rounded to bf16, at the pairs' sorted positions of act (pairs, F);
//   moe_down_kernel: the same rows of act against Wd_e (D, F), the depth
//     cut into gridDim.z parts (4 at decode: few rows still spread over
//     the SMs), each part scaled by its slot's router weight and stored in
//     f32 at (part, pair) of `part` (split, pairs, D); the wrapper sums the
//     parts and a token's slots.
//
// A block whose expert has no rows at m returns at once, so an expert no
// token chose reads none of its weights, and a null-routed pair (sorted
// past the last expert) costs nothing.
//
// Bound on the H100: at decode (≤ 16 pairs) the touched experts' weights,
// 407 MB an expert in bf16, streamed once — bytes; the design keeps
// weight tiles in flight on every SM (a ring of cp.async stages) and
// reads each weight element once. In the prefill (thousands of rows an
// expert) the products — tensor-core operations; there the block takes
// 128 rows, so each weight tile loaded serves 128 rows from shared
// memory. Products: mma.sync m16n8k16 bf16 with f32 accumulators,
// fragments by ldmatrix from rows padded by 16 bytes (no bank conflicts).
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// At or below this many tokens a call takes the decode tiles.
constexpr int kFewTokens = 64;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tiles {
  static constexpr int BM = BM_;  // rows (pairs) per block
  static constexpr int BN = BN_;  // output columns per block, of each weight
  static constexpr int BK = BK_;  // depth per stage
  static constexpr int WM = WM_, WN = WN_;  // warps along rows, along columns
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kLd = BK + 8;         // a stage row, padded by 16 bytes
  static constexpr int MT = BM / WM / 16;    // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;     // n8 tiles a warp, of each weight
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0 && BK % 16 == 0, "tiles");
  static constexpr int smem(int weights) { return STAGES * (BM + weights * BN) * kLd * 2; }
};

// decode: few rows stream the weights, 256 contiguous bytes of each
// weight row a stage, three stages in flight; prefill: 128 rows share each
// weight tile. (At d 3584, width 18944 on the H100, narrower or deeper
// decode tiles, more stages or more blocks an SM read no faster: 75-79%
// of the bytes' bound at 8 tokens, and 256 bytes a row beat 128.)
using GateUpFew = Tiles<16, 64, 128, 1, 4, 4>;
using DownFew = Tiles<16, 64, 128, 1, 4, 4>;
using GateUpMany = Tiles<128, 64, 64, 2, 4, 3>;
using DownMany = Tiles<128, 128, 64, 2, 4, 3>;
constexpr int kMaxSplit = 4;  // of the down product's depth, at decode

struct Args {
  const bf16* a;      // gate_up: h (N, D); down: act (pairs, F)
  const bf16* w0;     // gate_up: Wg (E, F, D); down: Wd (E, D, F)
  const bf16* w1;     // gate_up: Wu (E, F, D); down: unused
  void* out;          // gate_up: act (pairs, F) bf16; down: part (split, pairs, D) f32
  const int* order;   // (pairs,) the pairs (token·k_slots + slot) sorted by expert
  const int* counts;  // (E + 1,) pairs per expert
  const int* starts;  // (E + 1,) each expert's first position in `order`
  const float* wts;   // (pairs,) router weights (down only)
  int n_out;          // output columns: F (gate_up) or D (down)
  int depth;          // contraction: D (gate_up) or F (down)
  int k_slots, mblocks, part, pairs;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// One block's rows of one expert against NW weights (2: gate and up, 1:
// down) over its part of the depth; GATE_UP picks the gather, the
// epilogue and the output.
template <class T, bool GATE_UP>
__device__ __forceinline__ void grouped_body(const Args& p) {
  constexpr int NW = GATE_UP ? 2 : 1;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LD = T::kLd, S = T::STAGES;
  constexpr int MT = T::MT, NT = T::NT;
  const int e = blockIdx.x / p.mblocks, mb = blockIdx.x % p.mblocks;
  const int cnt = p.counts[e];
  if (mb * BM >= cnt) return;
  const int start = p.starts[e];
  const int n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * p.part;
  const int nk = (min(k_lo + p.part, p.depth) - k_lo) / BK;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);  // S × BM × LD
  bf16* sw = sa + S * BM * LD;                    // S × NW·BN × LD
  __shared__ int src[BM];  // each row's source row in p.a
  __shared__ int dst[BM];  // its output row (act position or pair), −1 past the expert's rows

  const int tid = threadIdx.x;
  for (int i = tid; i < BM; i += T::kThreads) {
    const int m = mb * BM + i;
    const int pos = start + (m < cnt ? m : mb * BM);  // a row past the end re-reads the first
    src[i] = GATE_UP ? p.order[pos] / p.k_slots : pos;
    dst[i] = m < cnt ? (GATE_UP ? pos : p.order[pos]) : -1;
  }
  __syncthreads();

  const bf16* wbase0 = p.w0 + (static_cast<size_t>(e) * p.n_out + n0) * p.depth;
  const bf16* wbase1 = GATE_UP ? p.w1 + (static_cast<size_t>(e) * p.n_out + n0) * p.depth : nullptr;
  auto load = [&](int stage, int kt) {
    const int k0 = k_lo + kt * BK;
    constexpr int CH = BK / 8;  // 16-byte chunks a row
    bf16* da = sa + stage * BM * LD;
    for (int c = tid; c < BM * CH; c += T::kThreads) {
      const int r = c / CH, q = c % CH;
      wis::cp_async16(da + r * LD + q * 8, p.a + static_cast<size_t>(src[r]) * p.depth + k0 + q * 8);
    }
    bf16* dw = sw + stage * NW * BN * LD;
    for (int c = tid; c < NW * BN * CH; c += T::kThreads) {
      const int r = c / CH, q = c % CH;
      const int n = r % BN;
      const bf16* w = (GATE_UP && r >= BN) ? wbase1 : wbase0;
      wis::cp_async16(dw + r * LD + q * 8, w + static_cast<size_t>(n) * p.depth + k0 + q * 8);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  float acc[NW][MT][NT][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[w][i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s);
    wis::cp_async_commit();
  }
  // ldmatrix addresses: A rows (lane & 15) at depth (lane >> 4)·8; B
  // matrices (lane >> 3): rows n (mi >> 1)·8 + (lane & 7) at depth (mi & 1)·8
  const int a_row = wm * MT * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int mi = lane >> 3;
  const int b_row = wn * NT * 8 + (mi >> 1) * 8 + (lane & 7), b_col = (mi & 1) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    wis::cp_async_wait<S - 2>();
    __syncthreads();  // stage kt is in, and every warp is done with stage kt − 1
    if (kt + S - 1 < nk) load((kt + S - 1) % S, kt + S - 1);
    wis::cp_async_commit();
    const bf16* ta = sa + (kt % S) * BM * LD;
    const bf16* tw = sw + (kt % S) * NW * BN * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldsm_x4(af[i], ta + (a_row + i * 16) * LD + kk + a_col);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, tw + (w * BN + b_row + j * 8) * LD + kk + b_col);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            wis::mma_bf16_16816(acc[w][i][j], af[i], b[0], b[1]);
            wis::mma_bf16_16816(acc[w][i][j + 1], af[i], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue: acc[.][i][j][c] is row wm·MT·16 + 16i + g + 8·(c ≥ 2), column
  // n0 + wn·NT·8 + 8j + 2·t4 + (c & 1)
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * MT * 16 + i * 16 + g + 8 * h;
      const int row = dst[r];
      if (row < 0) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * NT * 8 + j * 8 + 2 * t4;
        const float x0 = acc[0][i][j][2 * h], x1 = acc[0][i][j][2 * h + 1];
        if constexpr (GATE_UP) {
          const float u0 = acc[NW - 1][i][j][2 * h], u1 = acc[NW - 1][i][j][2 * h + 1];
          const float y0 = x0 / (1.f + __expf(-x0)) * u0, y1 = x1 / (1.f + __expf(-x1)) * u1;
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) +
                                             static_cast<size_t>(row) * p.n_out + col) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          const float wt = p.wts[row];
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) +
                                     (static_cast<size_t>(blockIdx.z) * p.pairs + row) * p.n_out +
                                     col) = make_float2(x0 * wt, x1 * wt);
        }
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads) moe_gate_up_kernel(const Args p) {
  grouped_body<T, true>(p);
}

template <class T>
__global__ void __launch_bounds__(T::kThreads) moe_down_kernel(const Args p) {
  grouped_body<T, false>(p);
}

template <class T>
int launch(void (*kernel)(const Args), int weights, Args p, int e_num, int n_tok, int split,
           unsigned long long* opted, cudaStream_t st) {
  const int smem = T::smem(weights);
  const cudaError_t e =
      wis::set_attribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.mblocks = (n_tok + T::BM - 1) / T::BM;  // an expert takes each token at most once
  const dim3 grid(e_num * p.mblocks, p.n_out / T::BN, split);
  kernel<<<grid, T::kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int n_tok, int e_num, int d, int f, int k_slots) {
  return n_tok > 0 && e_num > 0 && k_slots > 0 && d % 128 == 0 && f % 128 == 0 && d > 0 &&
         f > 0 && static_cast<long long>(e_num) * ((n_tok + 15) / 16) < (1ll << 31);
}

}  // namespace

// h (N, D) bf16, wg and wu (E, F, D) bf16, act (N·k_slots, F) bf16 out;
// order (N·k_slots,), counts and starts (E + 1,) int32 on the device (the
// wrapper's sort). D and F multiples of 128; all contiguous, 16-byte
// aligned.
extern "C" int wis_moe_gate_up(const void* h, const void* wg, const void* wu, void* act,
                               const void* order, const void* counts, const void* starts,
                               int n_tok, int e_num, int d, int f, int k_slots, void* stream) {
  if (!shapes_ok(n_tok, e_num, d, f, k_slots)) return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const bf16*>(h), static_cast<const bf16*>(wg),
         static_cast<const bf16*>(wu), act, static_cast<const int*>(order),
         static_cast<const int*>(counts), static_cast<const int*>(starts), nullptr,
         f, d, k_slots, 0, d, n_tok * k_slots};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static unsigned long long few = 0, many = 0;
  if (n_tok <= kFewTokens)
    return launch<GateUpFew>(moe_gate_up_kernel<GateUpFew>, 2, p, e_num, n_tok, 1, &few, st);
  return launch<GateUpMany>(moe_gate_up_kernel<GateUpMany>, 2, p, e_num, n_tok, 1, &many, st);
}

// Splits of the down product's depth F for n_tok tokens: at decode as
// many as kMaxSplit of whole stages (few rows still fill the SMs), 1 in
// the prefill.
extern "C" int wis_moe_down_splits(int n_tok, int f) {
  if (n_tok > kFewTokens) return 1;
  int split = kMaxSplit;
  while (split > 1 && f % (split * DownFew::BK)) split /= 2;
  return split;
}

// act (N·k_slots, F) bf16 from wis_moe_gate_up, wd (E, D, F) bf16, part
// (split, N·k_slots, D) f32 out (rows of unrouted pairs left as they
// were), wts (N·k_slots,) f32; split = wis_moe_down_splits(n_tok, f).
extern "C" int wis_moe_down(const void* act, const void* wd, void* part, const void* order,
                            const void* counts, const void* starts, const void* wts, int n_tok,
                            int e_num, int d, int f, int k_slots, int split, void* stream) {
  if (!shapes_ok(n_tok, e_num, d, f, k_slots) || split != wis_moe_down_splits(n_tok, f))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const bf16*>(act), static_cast<const bf16*>(wd), nullptr, part,
         static_cast<const int*>(order), static_cast<const int*>(counts),
         static_cast<const int*>(starts), static_cast<const float*>(wts),
         d, f, k_slots, 0, f / split, n_tok * k_slots};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static unsigned long long few = 0, many = 0;
  if (n_tok <= kFewTokens)
    return launch<DownFew>(moe_down_kernel<DownFew>, 1, p, e_num, n_tok, split, &few, st);
  return launch<DownMany>(moe_down_kernel<DownMany>, 1, p, e_num, n_tok, split, &many, st);
}
