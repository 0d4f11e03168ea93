#!/usr/bin/env python3
"""Phase traces of the two vocabulary heads and the eager decoder's
``ancestry_attention`` on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_trace.py

Builds copies of ``wis_tpu_torch/csrc/fused_logits.cu``,
``fused_gpt_head.cu`` and ``ancestry_attention.cu`` under ``build/trace/`` with markers added: thread 0 of
each block writes ``%globaltimer`` (ns) at phase boundaries into a device
array, read back after a call. Each head runs at the main path's shapes
(``chip_smoke.head_case``, ``chip_smoke.gpt_head_case``); the script prints
the call's time (CUDA-graph replay, ``chip_smoke._median_ms``) and, in µs
from the earliest block's start:

- the logits head: the LayerNorm prologue's end (median over blocks); per
  64-row tile the median over blocks of the stage loop (the tile's slices
  streamed and multiplied, from the previous tile's epilogue) and of warp
  0's epilogue rows; the blocks' median and last end of their own work;
  the last block's fold split into the pairs (lse and force rule), the
  lists' staging, their compaction (row 0's warp) and the end;
- the XTTS head: block 0 (the leader) at the LayerNorms' end, the strip's
  product, the partials merged, the cluster barrier, the keys, the sort,
  the thresholds and the argmax;
- ``ancestry_attention`` (``ancestry_attention.cu``, built the same way)
  at BK 5 and 20 and at the eager request's BK 5 over 36 columns: the
  medians over blocks of the first wave requested, the state set, each
  unit's data in, scores, statistics and P·V, the units done, the
  cluster's blocks running, the partials pushed and the merge done.

The markers cost a global store by one thread per phase. The kernels'
numerics are untouched; the copies are not the library the port loads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np

import chip_smoke

CSRC = os.path.join(chip_smoke.REPO, "wis_tpu_torch", "csrc")
OUT = os.path.join(chip_smoke.REPO, "build", "trace")
TIMER = (
    '#include "common.cuh"\n'
    "__device__ unsigned long long g_trace[256][64];\n"
    "__device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t;\n"
    '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
    "  return t;\n"
    "}\n"
    "#define TR(i) do { if (threadIdx.x == 0) g_trace[blockIdx.x + gridDim.x * (blockIdx.y + "
    "gridDim.y * blockIdx.z)][(i)] = gtime(); } while (0)\n"
)
READ = ('\nextern "C" int wis_trace_read(void* host) {\n'
        "  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n"
        'extern "C" int wis_trace_clear() {\n'
        "  static const unsigned long long zero[256][64] = {};\n"
        "  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));\n}\n")

#: (source, [(anchor, text inserted before it)]) — marker i at each anchor
LOGITS_MARKS = [
    ("  const int ntiles = n_tiles(a.V), nb = gridDim.x, blk = blockIdx.x;",
     "  TR(0);\n  int ntile = 0;\n"),
    ("  // this lane's running pairs of its rows r = warp + 16·i", "  TR(1);\n"),
    ("    // ---- the tile's epilogue", "    TR(2 + 2 * ntile);\n"),
    ("    const float* side = reinterpret_cast<const float*>(st + kTile * kRowStride);",
     "    TR(3 + 2 * ntile);\n    ++ntile;\n"),
    ("  // ---- the block's lists and pairs out; the last block folds them",
     "  __syncthreads();\n  TR(40);\n"),
    ("  if (!last) return;", "  TR(41);\n"),
    ("    // the chosen lists of every block, staged", "    if (r == 0) TR(43);\n"),
    ("    // a floor of the k-th best", "    if (r == 0) TR(44);\n"),
    ("    if (n <= 64) {", "    if (r == 0) TR(45);\n"),
    ("  if (tid == 0) *a.sem = 0;  // ready for the next launch", "  __syncthreads();\n  TR(42);\n"),
]
#: the end of tile t's epilogue rows (warp 0), after its last merge
LOGITS_ROWS_END = ("      av[i] = e.v;\n      ai[i] = e.i;\n    }\n", "    TR(20 + ntile - 1);\n")
GPT_MARKS = [
    ("  // x (into `hid`) and the LayerNorm rows first", "  TR(0);\n"),
    ("  float acc[8];\n", "  TR(1);\n"),
    ("  // the k lanes' partials of each column in two levels", "  TR(2);\n"),
    ("  float* lead = cluster.map_shared_rank(l, 0);", "  TR(3);\n"),
    ("  if (rank != 0) return;", "  TR(4);\n"),
    ("  // The k-th largest is rank min(k, V_pad)", "  __syncthreads();\n  TR(5);\n"),
    ("  // the softmax's numerators e = exp(l − max) (the max is rank 0) and", "  TR(6);\n"),
    ("  // masked logits, then argmax of l + gumbel and of l", "  TR(7);\n"),
    ("  if (tid == 0)\n    tok[0]", "  TR(8);\n"),
]
GPT_PHASES = ("LayerNorms", "product", "partials", "cluster barrier", "keys", "sort",
              "thresholds", "argmax")
#: ancestry_attention: the first wave requested (1), the state set (2);
#: per unit u < 4 its data in (3 + 4u), scores (4 + 4u), statistics
#: (5 + 4u), P·V (6 + 4u); the units done (20), the cluster's blocks
#: running (21), the partials pushed (22), the merge done (23)
ANC_MARKS = [
    ("  for (int i = tid; i < rb * dh; i += kThreads) os[i] = 0.f;", "  TR(1);\n"),
    ("  for (int u = 0; u < units; ++u) {\n    if (p.ns > 1)",
     "  __syncthreads();\n  TR(2);\n  int tu = 0;\n"),
    ("    const int c = c_lo + (u / tiles) * p.CC, r0 = (u % tiles) * p.RT;\n"
     "    const int cols = min(p.CC, c_hi - c), rt = min(p.RT, BK - r0);\n    const uint8_t* st",
     "    if (tu < 4) TR(3 + 4 * tu);\n"),
    ("    // the unit's softmax statistics, CC lanes a row", "    if (tu < 4) TR(4 + 4 * tu);\n"),
    ("    // P·V: one thread per (row, pair of d)", "    if (tu < 4) TR(5 + 4 * tu);\n"),
    ("    __syncthreads();  // the stage is free\n",
     "    __syncthreads();\n    if (tu < 4) TR(6 + 4 * tu);\n    ++tu;\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n  asm volatile(\"barrier.cluster.wait",
     "  __syncthreads();\n  TR(20);\n"),
    ("  const int n_items = rb * dh, share", "  TR(21);\n"),
    ("  cluster.sync();\n  for (int j = tid;", "  TR(22);\n"),
]
ANC_AFTER = [("  const Plan p = args.p;\n", "  TR(0);\n"),
             ("        __float2bfloat16_rn(num / den);\n  }\n", "  TR(23);\n")]
#: the eager request's own shape (BK 5, a cache of prompt + 32 columns,
#: T % 8 != 0) beside chip_smoke's two timed cases
ANC_TRACE_CASES = ((5, 128, 64), (20, 256, 200), (5, 36, 35))


def patched(name, marks, after=()):
    """The source with the markers in, or an error naming the anchor that
    the source no longer has."""
    with open(os.path.join(CSRC, name)) as f:
        src = f.read().replace('#include "common.cuh"', TIMER, 1)
    for anchor, text in marks:
        if anchor not in src:
            raise RuntimeError(f"{name}: marker anchor not found: {anchor!r}")
        src = src.replace(anchor, text + anchor, 1)
    for anchor, text in after:
        if anchor not in src:
            raise RuntimeError(f"{name}: marker anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + text, 1)
    return src + READ


def build():
    """The traced libraries, one nvcc each, in parallel → {name: CDLL}."""
    from wis_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "common.cuh"), OUT)
    srcs = {"fused_logits": patched("fused_logits.cu", LOGITS_MARKS, [LOGITS_ROWS_END]),
            "fused_gpt_head": patched("fused_gpt_head.cu", GPT_MARKS),
            "ancestry_attention": patched("ancestry_attention.cu", ANC_MARKS, ANC_AFTER)}
    procs = []
    for name, src in srcs.items():
        path = os.path.join(OUT, f"{name}_trace.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build.nvcc_path(), *[a for a in _build.NVCC_FLAGS if a != "-Xptxas=-v"],
               "-shared", "-o", os.path.join(OUT, f"lib{name}_trace.so"), path]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
    _build._run(procs)
    libs = {name: ctypes.CDLL(os.path.join(OUT, f"lib{name}_trace.so")) for name in srcs}
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["fused_logits"].wis_fused_logits_topk.argtypes = [p] * 6 + [i] * 8 + [p] * 6
    libs["fused_logits"].wis_fused_logits_workspace_bytes.argtypes = [i] * 4
    libs["fused_logits"].wis_fused_logits_workspace_bytes.restype = ctypes.c_longlong
    libs["fused_gpt_head"].wis_fused_gpt_head.argtypes = [p] * 11 + [i] * 4 + [p]
    libs["ancestry_attention"].wis_ancestry_attention.argtypes = (
        [p] * 4 + [i] * 5 + [ctypes.c_float, p, p])
    for lib in libs.values():
        lib.wis_trace_read.argtypes = [p]
    return libs


def read(torch, lib, blocks):
    """The markers of the last call → µs from the earliest block's start."""
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (256 * 64))()
    lib.wis_trace_read(ctypes.addressof(buf))
    tr = np.frombuffer(buf, dtype=np.uint64).reshape(256, 64)[:blocks].astype(np.int64)
    return (tr - tr[:, 0].min()) / 1000.0, tr > 0


def trace_logits(torch, dev, lib, cfg, bk, int8, grammar):
    from wis_tpu_torch.ops import _build

    case = chip_smoke.head_case(torch, dev, cfg, bk, int8, grammar)
    fn = chip_smoke.lib_logits_head(torch, lib, _build.check, case)
    ms = chip_smoke._median_ms(fn)
    fn()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(-(-cfg.n_vocab // 64), 144, sms)
    t, on = read(torch, lib, blocks)
    med = statistics.median
    stages, rows = [], []
    for tile in range(1, 8):
        done = on[:, 2 + 2 * tile] & on[:, 20 + tile - 1]
        if done.sum() > blocks // 2:
            stages.append(med((t[:, 2 + 2 * tile] - t[:, 20 + tile - 1])[done]))
            rows.append(med((t[:, 20 + tile] - t[:, 3 + 2 * tile])[done & on[:, 20 + tile]]))
    last = int(np.argmax(t[:, 42]))
    f = t[last]
    print(f"{case['name']}: {ms:.4f} ms a call; LayerNorm prologue {med(t[:, 1]):.2f} µs; per "
          f"tile stage loop {med(stages):.2f} µs, epilogue rows (warp 0) {med(rows):.2f} µs; "
          f"blocks' own work ends {med(t[:, 40]):.2f} (median) / {t[:, 40].max():.2f} µs "
          f"(last); fold {f[41]:.2f} → pairs {f[43]:.2f} → staged {f[44]:.2f} → compacted "
          f"{f[45]:.2f} → end {f[42]:.2f} µs")


def trace_gpt_head(torch, dev, lib):
    from wis_tpu_torch.models.xtts.gpt import GPTConfig

    cfg = GPTConfig()
    inputs = chip_smoke.gpt_head_case(torch, dev, cfg)
    fn = chip_smoke.lib_gpt_head(torch, lib, lambda rc, what: None, cfg, inputs)
    ms = chip_smoke._median_ms(fn)
    fn()
    t, _ = read(torch, lib, 1)
    lead = t[0]
    print(f"fused_gpt_head D={cfg.d_model} V_pad={inputs[2].shape[-1]}: {ms:.4f} ms a call; "
          "leader at " + ", ".join(f"{name} {lead[i + 1]:.2f}" for i, name in
                                   enumerate(GPT_PHASES)) + " µs")


def trace_ancestry(torch, dev, lib, bk, t, pos):
    """One ancestry_attention call at large-v2's self-attention shape
    (chip_smoke._anc_inputs): the medians over blocks of each phase's end."""
    from wis_tpu_torch.ops import _build

    q, kc, vc, anc = chip_smoke._anc_inputs(torch, dev, bk, t, pos, False, seed=bk + t)
    o = torch.empty_like(q)

    def fn():
        _build.check(lib.wis_ancestry_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), anc.data_ptr(), bk, 20, 64, t, pos,
            64 ** -0.5, o.data_ptr(), torch.cuda.current_stream().cuda_stream), "traced ancestry")

    ms = chip_smoke._median_ms(fn)
    torch.cuda.synchronize()
    lib.wis_trace_clear()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (256 * 64))()
    lib.wis_trace_read(ctypes.addressof(buf))
    raw = np.frombuffer(buf, dtype=np.uint64).reshape(256, 64).astype(np.int64)
    on = raw > 0
    live = on[:, 0] & on[:, 23]
    tr = (raw - raw[live, 0].min()) / 1000.0
    names = {1: "first wave requested", 2: "state set", 20: "units done",
             21: "cluster running", 22: "partials pushed", 23: "merged"}
    for u in range(4):
        names.update({3 + 4 * u: f"unit {u} in", 4 + 4 * u: f"scores {u}",
                      5 + 4 * u: f"statistics {u}", 6 + 4 * u: f"P·V {u}"})
    parts = [f"{name} {statistics.median(tr[live & on[:, i], i]):.2f}"
             for i, name in sorted(names.items()) if (live & on[:, i]).any()]
    print(f"ancestry_attention BK={bk} H=20 Dh=64 T={t} pos={pos}: {ms:.4f} ms a call, "
          f"{int(live.sum())} blocks; medians over blocks: " + ", ".join(parts) + " µs")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_trace: no CUDA device available", file=sys.stderr)
        return 1
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    libs = build()
    dev = torch.device("cuda")
    for bk, int8, grammar in chip_smoke.HEAD_CASES:
        trace_logits(torch, dev, libs["fused_logits"], WHISPER_CONFIGS["large"], bk, int8, grammar)
    trace_gpt_head(torch, dev, libs["fused_gpt_head"])
    for bk, t, pos in ANC_TRACE_CASES:
        trace_ancestry(torch, dev, libs["ancestry_attention"], bk, t, pos)
    return 0


if __name__ == "__main__":
    sys.exit(main())
