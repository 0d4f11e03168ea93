"""Find the knee of the omni cell on the card: ``benchmark.sweep``'s windows
and summary, each request stamped when its reply is answered (an omni
reply comes whole, as a transcript does), with the dispatches each
window made.

    python3 -m benchmark.sweep_omni --seed <n> --seconds <s> --rates 2,2.5,3,2.5,3

One set-up, then a window at each rate in turn, each with requests drawn
from its own seed (``seed + i``), so a rate named twice is a second
sample of it. One JSON line a window: ``benchmark.sweep.summary`` and the
window's dispatches, rows a dispatch and median ``omni_dispatch`` time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import stats, traffic
from benchmark.run import DRAIN_S, cell, load_spec, system_module
from benchmark.sweep import summary

WORKLOAD = "omni-commands"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_omni: no CUDA device", file=sys.stderr)
        return 2
    from wis_tpu_torch.device import resolve_device

    device = resolve_device("cuda:0")
    c = cell(load_spec(), WORKLOAD)
    rates = [float(x) for x in args.rates.split(",")]
    pool = [traffic.schedule(dict(c["mix"], rate_per_s=r), args.seed + i, args.seconds)
            for i, r in enumerate(rates)]
    t = time.perf_counter()
    system = system_module(c["config"]).System(c["config"], c["mix"], args.seed, device,
                                               [r for p in pool for r in p])
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    for i, (rate, reqs) in enumerate(zip(rates, pool)):
        system.prepare(reqs)
        n0 = len(system.calls)
        t0 = time.perf_counter() + 0.5
        system.drive(t0, args.seconds, DRAIN_S)
        calls = system.calls[n0:]
        line = {"rate_per_s": rate, "seed": args.seed + i,
                **summary(reqs, t0, args.seconds, lambda r: r["end"]),
                "dispatches": len(calls),
                "rows_per_dispatch": sum(len(x["rids"]) for x in calls) / max(len(calls), 1),
                "dispatch_ms_p50": stats.percentile(
                    [x["timings"].get("omni_dispatch", 0.0) for x in calls], 50)}
        print(json.dumps(line), flush=True)
    system.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
