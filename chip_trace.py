#!/usr/bin/env python3
"""Phase traces of the two vocabulary heads on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_trace.py

Builds copies of ``wis_tpu_torch/csrc/fused_logits.cu`` and
``fused_gpt_head.cu`` under ``build/trace/`` with markers added: thread 0 of
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
  the thresholds and the argmax.

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
    "#define TR(i) do { if (threadIdx.x == 0) g_trace[blockIdx.x][(i)] = gtime(); } while (0)\n"
)
READ = ('\nextern "C" int wis_trace_read(void* host) {\n'
        "  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n")

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
    """Both traced libraries, one nvcc each, in parallel → {name: CDLL}."""
    from wis_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "common.cuh"), OUT)
    srcs = {"fused_logits": patched("fused_logits.cu", LOGITS_MARKS, [LOGITS_ROWS_END]),
            "fused_gpt_head": patched("fused_gpt_head.cu", GPT_MARKS)}
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
