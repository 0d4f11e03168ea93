"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes its requests from the cell's traffic mix and the seed, sets
up the cell's system (weights from the seed on the card, the cell's shapes
warmed up), then measures for ``--seconds``: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read in a
profiled slice of the window. Once the window has closed and the program's
state is freed, the served outputs are compared with the plain reference.
The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error.

It exits with another code than 0, and prints no result, without a CUDA
device (or fewer than the cell asks for), and if a JAX module is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "wis_tpu")
#: seconds past the window's close that requests are waited for
DRAIN_S = 60.0
#: every build and kernel cache a library might keep, inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "cache" / _sub)


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# --------------------------------------------------------------------------- #
# What BENCHMARK.json and the files beside it define
# --------------------------------------------------------------------------- #
def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, name: str, root: Path = ROOT, bench: Path = BENCH) -> dict:
    """The cell ``name`` with its configuration file, its traffic mix and
    the metrics it reports, each found by name."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(root / cfg_entry["file"]) as f:
        cfg = json.load(f)
    with open(bench / "traffic" / f"{wl['traffic']}.json") as f:
        mix = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": wl, "config": cfg, "mix": mix,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def reader(metric: str, bench: Path = BENCH):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_module(cfg: dict):
    return importlib.import_module(f"benchmark.systems.{cfg['system']}")


# --------------------------------------------------------------------------- #
class Run:
    """What the readers see: the cell, the system with its records, the
    window's bounds on the host clock, the set-up time and, in a traced run,
    the trace. ``t_stamps`` ends the stretch of the window whose host clock
    the profiler leaves alone (the slice's start, or the close): the
    profiler records every host operation inside the slice and slows the
    host there, so readers of host stamps read only before it."""

    def __init__(self, c: dict, system, seed: int, seconds: float):
        self.workload, self.config, self.mix = c["workload"], c["config"], c["mix"]
        self.system, self.seed, self.seconds = system, seed, seconds
        self.t0 = self.t1 = self.t_stamps = 0.0
        self.drain_s = DRAIN_S
        self.setup_s = 0.0
        self.trace = None

    @property
    def requests(self):
        return self.system.requests


def execute(c: dict, seed: int, seconds: float, trace: bool, device, checked=True):
    """Set up, run the window (profiling a slice of it when ``trace``),
    release the program's state and compare with the reference → (Run,
    memory peak, checks)."""
    import torch

    from benchmark import traffic
    from benchmark.trace import SliceProfiler

    requests = traffic.schedule(c["mix"], seed, seconds)
    system = system_module(c["config"]).System(c["config"], c["mix"], seed, device, requests)
    run = Run(c, system, seed, seconds)
    prof = SliceProfiler() if trace else None
    if prof is not None:
        prof.prepare()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.t0 = time.perf_counter()
    run.setup_s = _process_age_s()
    run.t1 = run.t0 + seconds
    run.t_stamps = run.t0 + c["mix"]["trace_slice"][0] * seconds if trace else run.t1
    driver = threading.Thread(target=system.drive, args=(run.t0, seconds, DRAIN_S),
                              name="bench-driver")
    driver.start()
    if prof is not None:
        lo, hi = c["mix"]["trace_slice"]
        time.sleep(max(0.0, run.t0 + lo * seconds - time.perf_counter()))
        prof.begin()
        time.sleep(max(0.0, run.t0 + hi * seconds - time.perf_counter()))
        prof.end()
    driver.join()
    if prof is not None:
        run.trace = prof.trace()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    system.release()
    checks = system.check() if checked else None
    return run, peak, checks


def compared(c: dict, checks: dict) -> list:
    """The numbers compared, each with its limit: [name, value, limit]."""
    limits = c["config"]["check"]["limits"]
    return [[name, checks["served"][key], limit] for name, (key, limit) in limits.items()]


def result_line(c: dict, run: Run, peak: int, checks: dict, kind: str, traced: bool):
    """The result's JSON object and the rows compared ([name, value,
    limit]); with ``traced`` the per-layer metrics, the trace's device
    times and its breakdown."""
    metrics = {}
    for m in (c["per_layer"] if traced else c["end_to_end"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    rows = compared(c, checks)
    failed = sum(1 for r in run.requests if not r["ok"])
    result = {
        "correct": failed == 0 and all(v <= lim for _, v, lim in rows),
        "attempted": len(run.requests),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": int(c["workload"]["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def summary_line(run: Run, checks: dict) -> dict:
    """What the result's line does not carry: how late the generator ran,
    the counts and medians behind the tails, and every reading of the
    check."""
    late = [r["sent"] - r["due_abs"] for r in run.requests if "sent" in r]
    return {"generator_late_ms": {"max": 1e3 * max(late, default=0.0),
                                  "mean": 1e3 * sum(late) / max(len(late), 1)},
            "requests": len(run.requests), "answered": sum(1 for r in run.requests if r["ok"]),
            **run.system.summary(run), "checks": checks, "setup_s": run.setup_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    c = cell(load_spec(), args.workload)
    import torch

    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from wis_tpu_torch.device import resolve_device

    device = resolve_device("cuda:0")
    run, peak, checks = execute(c, args.seed, args.seconds, bool(args.trace), device)
    result, rows = result_line(c, run, peak, checks, torch.cuda.get_device_name(device),
                               bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(summary_line(run, checks)))
    print(json.dumps(result))
    for name, v, lim in rows:
        print(f"{name} {v} limit {lim}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
