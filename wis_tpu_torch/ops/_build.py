"""Build and load the hand-written Hopper kernels (``wis_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, in
parallel) and links them into one shared library with a plain C
interface, loaded with ctypes. The build runs at first use, on the
machine with the card, into ``build/wis_tpu_torch/<hash>/`` beside the
package (listed in ``.gitignore``), keyed by a hash of the sources, the
headers they share (``csrc/*.cuh``) and the flags, so a changed source
rebuilds and an unchanged one is reused. Each source's compiler output
(``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
beside the library as ``<source>.ptxas.txt``. The TMA kernels take
``cuTensorMapEncodeTiled`` from the CUDA driver through the runtime
(``cudaGetDriverEntryPoint``), so nothing links against ``libcuda``.
Nothing is built or imported when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "wis_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libwis_kernels.so"


def _run(procs) -> list:
    """Wait for every (command, Popen); raise with the first failure's
    output, else return each one's stdout + stderr."""
    failed, logs = None, []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}"
    if failed:
        raise RuntimeError(failed)
    return logs


def _compile(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        for src, log in zip(_sources(), _run(procs)):
            (out.parent / f"{src.stem}.ptxas.txt").write_text(log)
        lib = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            ll = ctypes.c_longlong
            lib.wis_layer_norm.argtypes = [p, p, p, p, i, i, f, i, p]
            lib.wis_layer_norm.restype = i
            lib.wis_flash_attention_packed.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
            lib.wis_flash_attention_packed.restype = i
            lib.wis_flash_attention.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
            lib.wis_flash_attention.restype = i
            lib.wis_fused_decode_workspace_bytes.argtypes = [i, i]
            lib.wis_fused_decode_workspace_bytes.restype = ll
            lib.wis_fused_decode_step.argtypes = [p] * 11 + [i, p] + [i] * 8 + [p]
            lib.wis_fused_decode_step.restype = i
            lib.wis_fused_logits_workspace_bytes.argtypes = [i, i, i, i]
            lib.wis_fused_logits_workspace_bytes.restype = ll
            lib.wis_fused_logits_topk.argtypes = [p] * 6 + [i] * 8 + [p] * 6
            lib.wis_fused_logits_topk.restype = i
            lib.wis_fused_gpt_workspace_bytes.argtypes = [i, i]
            lib.wis_fused_gpt_workspace_bytes.restype = ll
            lib.wis_fused_gpt_step.argtypes = [p] * 8 + [i, p] + [i] * 5 + [p, p]
            lib.wis_fused_gpt_step.restype = i
            lib.wis_fused_gpt_head.argtypes = [p] * 11 + [i] * 4 + [p]
            lib.wis_fused_gpt_head.restype = i
            lib.wis_int8_matmul_splits.argtypes = [i] * 4
            lib.wis_int8_matmul_splits.restype = i
            lib.wis_int8_matmul_counters.argtypes = [i]
            lib.wis_int8_matmul_counters.restype = i
            lib.wis_int8_matmul.argtypes = [p] * 6 + [i] * 5 + [p]
            lib.wis_int8_matmul.restype = i
            lib.wis_ancestry_attention.argtypes = [p] * 4 + [i] * 5 + [f, p, p]
            lib.wis_ancestry_attention.restype = i
            lib.wis_moe_down_splits.argtypes = [i, i]
            lib.wis_moe_down_splits.restype = i
            lib.wis_moe_gate_up.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.wis_moe_gate_up.restype = i
            lib.wis_moe_down.argtypes = [p] * 7 + [i] * 6 + [p]
            lib.wis_moe_down.restype = i
            lib.wis_bias_act.argtypes = [p] * 4 + [ll, i, ll] + [i] * 5 + [p]
            lib.wis_bias_act.restype = i
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
