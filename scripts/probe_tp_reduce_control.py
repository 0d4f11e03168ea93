"""Control for the tensor-parallel checks of ``dryrun_multichip``: can they
tell a row-parallel product whose partial sums are rounded to bf16 before
the all-reduce from the sound one (f32 partials, reduced in f32, rounded
once)?

Runs the full-width stages that hold it, large-v2 (``_stage_whisper_tp``)
and XTTS v2's GPT (``_stage_xtts_tp``), on two ranks sharing one card
over gloo, twice: as the port runs them, and with the fault put into
every row-parallel product (``parallel/axis.row_parallel`` then reduces
each rank's product already rounded to bf16). In the faulty world the
stages' own holds are switched off, so that their readings come back.
Prints per world and stage the teacher-forced logits' ‖Δ‖/‖single‖ (max
and median over positions), max|Δ|, the argmax agreement, and layer 0's
row-parallel products' share of elements off the single-rank product;
writes them to ``chiprun_out/tp_reduce_control.json``.

    python scripts/probe_tp_reduce_control.py [--out chiprun_out/tp_reduce_control.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _faulty():
    """Every row-parallel product reduces partial sums rounded to x's
    dtype (bf16); the stages' holds return instead of raising."""
    from wis_tpu_torch import entry
    from wis_tpu_torch.ops.quant import qmatmul
    from wis_tpu_torch.parallel import axis

    def rounded_partials(x, w, out_dtype=None):
        return qmatmul(x, w).to(out_dtype or x.dtype)

    axis.qmatmul = rounded_partials
    entry._within_tolerance = lambda *a: None
    entry._hold_rows = lambda *a: None


def _rank(rank, devices, fault):
    from wis_tpu_torch import entry
    from wis_tpu_torch.parallel.mesh import make_mesh

    if fault:
        _faulty()
    mesh = make_mesh(1, 2, devices)
    return {"large-v2": entry._stage_whisper_tp(mesh, "large-v2"),
            "xtts v2": entry._stage_xtts_tp(mesh, True)["full"]}


def _summary(st):
    rel = np.asarray(st["tf_rel"])
    return {"tf_rel_max": float(rel.max()), "tf_rel_median": float(np.median(rel)),
            "tf_max_abs": st["tf_max_abs"], "tf_argmax_equal": st["tf_argmax_equal"],
            "row_parallel": st["row_parallel"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/tp_reduce_control.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_tp_reduce_control: no CUDA device", file=sys.stderr)
        return 1
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.parallel.world import run_world

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    _build.kernels()
    out = {"card": card.strip()}
    for world, fault in (("sound", False), ("bf16 partials", True)):
        t0 = time.perf_counter()
        reports = run_world(_rank, ["cuda:0", "cuda:0"], (fault,), timeout=900)
        ref = reports[0]
        out[world] = {stage: _summary(ref[stage]) for stage in ref}
        for stage, s in out[world].items():
            rows = ", ".join(f"{k} {r['frac']:.3e} (control {r['ctl_frac']:.3e}, max|Δ| "
                             f"{r['max_abs']:.3e})" for k, r in s["row_parallel"].items())
            print(f"{world} / {stage}: teacher-forced logits ‖Δ‖/‖single‖ max "
                  f"{s['tf_rel_max']:.4e}, median {s['tf_rel_median']:.4e}, max|Δ| "
                  f"{s['tf_max_abs']:.4e}, argmax equal {s['tf_argmax_equal']:.3f}; "
                  f"row-parallel share off the single rank's: {rows}")
        print(f"{world}: {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
