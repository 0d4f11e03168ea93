// W8A16 matrix product, y = (x · bf16(q)) · s — Hopper (sm_90a).
//
// Replaces the TPU kernel wis_tpu/ops/quant_pallas.py `int8_matmul` (body
// `_kernel`): x (M, K) bf16, q (K, N) int8 with one f32 scale per output
// column; the int8 weight becomes bf16 (exactly) on its way into the
// tensor cores, the product runs in bf16 with f32 accumulators, the f32
// scale is applied once after the contraction, and y is stored once, in
// bf16 or f32.
//
// Bound on the H100: it depends on M. The prompt's and the eager step's
// products (M of 1 to 20 rows) read K·N weight bytes for 2·M·K·N
// operations: bound by bytes, so what matters is weight bytes in flight
// over every SM. The cross-KV projection (M of 1500 to 6000) and the XTTS
// prefill (289) are bound by the tensor cores. One warp-specialised body
// serves both, computing yᵀ = qᵀ·xᵀ so that the weight is the register
// operand of wgmma (the mixed-input layout):
//
//   - a producer warp keeps TMA loads of x tiles (bf16) and q tiles (int8,
//     as stored) in flight in a ring of stages ("full" and "empty"
//     mbarriers), both in the 128-byte swizzle;
//   - two consumer warpgroups, 64 output columns each, read their q bytes
//     straight from the stage into registers (16-bit loads that the
//     swizzle keeps free of bank conflicts), widen them exactly to bf16 in
//     registers as wgmma's A fragments — the weight is never written back
//     to shared memory, transposed or not — and run
//     wgmma.m64nNk16 bf16 with f32 accumulators against the x tile as
//     the B operand (x rows are K-contiguous: K-major, no transpose);
//     N is the block's x rows: 128 or 256 for many rows, 16, 32 or 64
//     for few, so few rows waste no tensor-core work on padding;
//   - the epilogue scales by the f32 column scale and rounds once.
//
// An A-fragment row r of warp w holds output column 16w + 2·(r % 8) + r / 8
// (two adjacent columns per thread), so one 16-bit load gives a thread
// both of its rows at one k, and its two stores per accumulator pair are
// adjacent columns.
//
// At most 64 rows K is split over gridDim.z so that one wave of blocks,
// one per SM, streams the weight; each split stores its f32 partial tile,
// and the last split of a tile to finish (a counter per tile, taken with
// an atomic and put back to 0) sums the splits in the order z = 0, 1, ...,
// scales and stores y, in the same launch. TMA zero-fills x rows past M
// and weight columns past N (N % 128 == 64); those are never stored.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() (cudaErrorNotSupported where the CUDA
// driver cannot encode a tensor map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using wis::pack_bf16;

constexpr int kBN = 128;      // output columns per block: two warpgroups of 64
constexpr int kBK = 64;       // contraction depth per stage (one 128-byte bf16 x row)
constexpr int kFewRows = 64;  // at or below: split K
constexpr int kThreads = 2 * 128 + 32;  // consumer warpgroups, then the producer warp
constexpr int kStageBudget = 200 * 1024;

template <int NM>  // x rows per block: the wgmma N
struct Tile {
  static constexpr int kXBytes = NM * kBK * 2;  // x stage
  static constexpr int kQBytes = kBK * kBN;     // int8 weight stage
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kStages = std::min(8, kStageBudget / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 16 + 1024;
  static_assert(kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ void store_pair(void* y, size_t i, float a, float b, bool out_f32) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(y) + i) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + i) =
        __floats2bfloat162_rn(a, b);
}

// the two int8 weights of output columns n, n + 1 at contraction row k of
// a stage (128 bytes per k row, 16-byte chunks XOR-ed with k mod 8)
__device__ __forceinline__ uint32_t q_pair(const uint8_t* qs, int k, int n) {
  return *reinterpret_cast<const uint16_t*>(qs + k * kBN + ((((n >> 4) ^ k) & 7) << 4) +
                                            (n & 15));
}

// A fragment (m64k16) of the k16 slice at kb: rows r ↔ columns (n, n + 1)
// of this thread; f32 widening is exact, so is the bf16 rounding
__device__ __forceinline__ void a_fragment(const uint8_t* qs, int kb, int n, int t4,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = kb + h * 8 + 2 * t4;
    // bytes: (k, n), (k + 1, n), (k, n + 1), (k + 1, n + 1)
    const uint32_t w = __byte_perm(q_pair(qs, k, n), q_pair(qs, k + 1, n), 0x5140);
    float f[4];
    wis::int8x4_to_float(w, f);
    a[2 * h] = pack_bf16(f[0], f[1]);
    a[2 * h + 1] = pack_bf16(f[2], f[3]);
  }
}

template <int NM>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap, const float* __restrict__ s,
                   void* __restrict__ y, float* __restrict__ part, int* __restrict__ sem,
                   int M, int N, int steps_per_split, int steps, bool out_f32) {
  using T = Tile<NM>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (wis::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::kStageBytes);
  uint64_t* empty = full + S;
  int* last = reinterpret_cast<int*>(empty + S);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * NM, n0 = blockIdx.x * kBN;
  const int first = blockIdx.z * steps_per_split;
  const int nk = min(steps, first + steps_per_split) - first;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      wis::mbar_init(&full[i], 1);
      wis::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    wis::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's role, from lane 0, so the compiler sees it uniform per
  // warp (a branch it cannot prove uniform makes it serialise the wgmmas)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    // producer: one thread keeps the ring's stages of x and q in flight
    if (tid == 256) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % S;
        if (i >= S) wis::mbar_wait(&empty[st], (i / S - 1) & 1);
        uint8_t* base = smem + st * T::kStageBytes;
        const int k = (first + i) * kBK;
        wis::mbar_expect_tx(&full[st], T::kStageBytes);
        wis::tma_load_2d(base, &xmap, &full[st], k, m0);
        wis::tma_load_2d(base + T::kXBytes, &qmap, &full[st], n0, k);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output columns n0 + 64·wg .. + 63; this
  // thread's A rows are columns nl and nl + 1 of the block
  const int wg = role, t = tid & 127;
  const int w = t >> 5, g = (t & 31) >> 2, t4 = t & 3;
  const int nl = wg * 64 + w * 16 + 2 * g;
  float acc[NM / 2];
#pragma unroll
  for (int i = 0; i < NM / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int st = i % S;
    wis::mbar_wait(&full[st], (i / S) & 1);
    const uint8_t* xs = smem + st * T::kStageBytes;
    const uint8_t* qs = xs + T::kXBytes;
    uint32_t a[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) a_fragment(qs, kk * 16, nl, t4, a[kk]);
    wis::fence_regs(acc);
    wis::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wis::wgmma_rs<NM, 0>(acc, a[kk], wis::desc_sw128(xs + kk * 32, 16, 1024));
    wis::wgmma_commit();
    // the A registers are reused next stage: let this stage's products end
    wis::wgmma_wait<0>();
    wis::fence_regs(acc);
    if (t == 0) wis::mbar_arrive(&empty[st]);
  }

  // epilogue: acc[4j + e] is y at row m0 + 8j + 2·t4 + (e & 1), column
  // n0 + nl + (e >> 1); the f32 column scale and one rounding, or, for a
  // split of K, the unscaled f32 partial, and the tile's last split sums
  // them all
  const int n = n0 + nl;
  if (n >= N && !part) return;
  const size_t mn = static_cast<size_t>(M) * N;
  const float s0 = n < N && !part ? s[n] : 1.f, s1 = n < N && !part ? s[n + 1] : 1.f;
#pragma unroll
  for (int j = 0; j < NM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = m0 + 8 * j + 2 * t4 + e;
      if (r >= M || n >= N) continue;
      const float lo = acc[4 * j + e] * s0, hi = acc[4 * j + 2 + e] * s1;
      if (part)
        *reinterpret_cast<float2*>(part + blockIdx.z * mn + static_cast<size_t>(r) * N + n) =
            make_float2(lo, hi);
      else
        store_pair(y, static_cast<size_t>(r) * N + n, lo, hi, out_f32);
    }
  }
  if (!part) return;
  // every partial store is in before thread 0, after its fence, counts
  // this split in (the fence is cumulative over what the barrier shows it)
  wis::named_barrier(1, 256);
  int* counter = sem + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    *last = atomicAdd(counter, 1) == static_cast<int>(gridDim.z) - 1;
  }
  wis::named_barrier(1, 256);
  if (!*last) return;
  __threadfence();
  // the last split: Σ_z part[z] in order, scaled, for this tile (all its
  // rows: M ≤ kFewRows ≤ NM here). Each thread owns kQuads groups of four
  // columns and keeps 16 loads in flight: kZ splits of each group at once.
  constexpr int kQuads = NM * (kBN / 4) / 256 < 8 ? NM * (kBN / 4) / 256 : 8;
  constexpr int kZ = 16 / kQuads;
  const int splits = static_cast<int>(gridDim.z);
  size_t at[kQuads];
  bool live[kQuads];
  float4 sum[kQuads];
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int e = tid + u * 256;
    const int r = m0 + e / (kBN / 4), col = n0 + (e % (kBN / 4)) * 4;
    live[u] = r < M && col < N;
    at[u] = live[u] ? static_cast<size_t>(r) * N + col : 0;
    sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int z0 = 0; z0 < splits; z0 += kZ) {
    float4 p[kQuads][kZ];
#pragma unroll
    for (int u = 0; u < kQuads; ++u)
#pragma unroll
      for (int z = 0; z < kZ; ++z)
        p[u][z] = live[u] && z0 + z < splits
                      ? __ldcg(reinterpret_cast<const float4*>(part + (z0 + z) * mn + at[u]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kQuads; ++u)
#pragma unroll
      for (int z = 0; z < kZ; ++z) {
        if (z0 + z < splits) {
          sum[u].x += p[u][z].x;
          sum[u].y += p[u][z].y;
          sum[u].z += p[u][z].z;
          sum[u].w += p[u][z].w;
        }
      }
  }
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    if (!live[u]) continue;
    const int col = n0 + ((tid + u * 256) % (kBN / 4)) * 4;
    store_pair(y, at[u], sum[u].x * s[col], sum[u].y * s[col + 1], out_f32);
    store_pair(y, at[u] + 2, sum[u].z * s[col + 2], sum[u].w * s[col + 3], out_f32);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <int NM>
int launch(const void* x, const void* q, const float* s, void* y, float* part, int* sem, int M,
           int K, int N, int splits, bool out_f32, cudaStream_t st) {
  using T = Tile<NM>;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {kBK, NM};
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t qstride[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t qbox[2] = {kBN, kBK};
  if (!wis::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wis::encode_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstride, qbox,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorNotSupported);
  static bool attr = false;  // the opt-in above 48 KB, once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_kernel<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int steps = K / kBK, per = (steps + splits - 1) / splits;
  const dim3 grid((N + kBN - 1) / kBN, (M + NM - 1) / NM, splits);
  int8_matmul_kernel<NM><<<grid, kThreads, T::kSmem, st>>>(
      xmap, qmap, s, y, splits > 1 ? part : nullptr, sem, M, N, per, steps, out_f32);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

}  // namespace

// How many splits of K the product takes on a card with `sms` SMs: 1 for
// more than kFewRows rows or where the column tiles fill the SMs, else as
// many as fit one wave of one block per SM, each of whole kBK steps, and
// no more than keep the f32 partials' bytes (splits·M·N·4) within the
// weight's (K·N).
extern "C" int wis_int8_matmul_splits(int M, int K, int N, int sms) {
  const int tiles = (N + kBN - 1) / kBN, steps = K / kBK;
  if (M <= 0 || M > kFewRows || tiles <= 0 || steps <= 0 || 2 * tiles > sms) return 1;
  const int target = std::max(1, std::min(sms / tiles, K / (4 * M)));
  const int per = (steps + target - 1) / target;
  return (steps + per - 1) / per;
}

// Int32 counters a split product needs: one per column tile, all 0 before
// the first launch (each launch puts them back to 0).
extern "C" int wis_int8_matmul_counters(int N) { return (N + kBN - 1) / kBN; }

// x (M, K) bf16, q (K, N) int8, s (N,) f32, y (M, N) bf16 or, with
// out_f32, f32; all contiguous and 16-byte aligned, K a multiple of 128
// and N of 64 (the wrapper checks). With splits > 1 (M ≤ 64 only), part
// holds splits·M·N f32, sem wis_int8_matmul_counters(N) zeroed int32 that
// no other launch uses at the same time, and splits must be
// wis_int8_matmul_splits(...) for some sms, so that every split has whole
// kBK steps. Rows per block: 16, 32 or 64 up to 64 rows; above, 256 where
// that still gives every SM a block, else 128.
extern "C" int wis_int8_matmul(const void* x, const void* q, const void* s, void* y, void* part,
                               void* sem, int M, int K, int N, int splits, int out_f32,
                               void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 128 || N % 64 || (M + 15) / 16 > 65535 || splits < 1 ||
      (splits > 1 && (!part || !sem || M > kFewRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = K / kBK, per = (steps + splits - 1) / splits;
  if ((steps + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  float* pt = static_cast<float*>(part);
  int* sm = static_cast<int*>(sem);
  const bool f32 = out_f32 != 0;
  if (M <= 16) return launch<16>(x, q, sc, y, pt, sm, M, K, N, splits, f32, st);
  if (M <= 32) return launch<32>(x, q, sc, y, pt, sm, M, K, N, splits, f32, st);
  if (M <= 64) return launch<64>(x, q, sc, y, pt, sm, M, K, N, splits, f32, st);
  const int tiles = (N + kBN - 1) / kBN;
  if (static_cast<long long>((M + 255) / 256) * tiles >= sm_count())
    return launch<256>(x, q, sc, y, pt, sm, M, K, N, splits, f32, st);
  return launch<128>(x, q, sc, y, pt, sm, M, K, N, splits, f32, st);
}
