"""Find an open-loop cell's knee on the card: one set-up, then a window at
each offered rate in turn, each printing one JSON line.

    python3 -m benchmark.sweep --workload <cell> --seed <n> --seconds <s> --rates 6,9,12

For each rate: the requests due, the share answered inside the window, the
backlog at the close (due but unanswered), the latency's percentiles from
the due time, the 95th over the window's first and last thirds, and for a
streamed reply the 90th percentile of the gaps between its chunks. The knee is the highest rate at which answers keep pace with
arrivals: no backlog that grows, and the last third's latency near the
first's. The run writes nothing; it is read once, when a cell's rate is
set.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import stats, traffic
from benchmark.run import DRAIN_S, cell, load_spec, system_module


def summary(reqs, t0: float, seconds: float, first_stamp) -> dict:
    close = t0 + seconds
    lat = [(first_stamp(r) - r["due_abs"]) * 1e3 for r in reqs if r["ok"]]
    third = [[(first_stamp(r) - r["due_abs"]) * 1e3 for r in reqs if r["ok"]
              and lo <= r["due"] / seconds < hi] for lo, hi in ((0, 1 / 3), (2 / 3, 1))]
    return {
        "due": len(reqs),
        "answered_in_window": sum(1 for r in reqs if r["ok"] and first_stamp(r) <= close),
        "backlog_at_close": sum(1 for r in reqs if not r["ok"] or first_stamp(r) > close),
        "failed": sum(1 for r in reqs if not r["ok"]),
        "p50_ms": stats.percentile(lat, 50), "p75_ms": stats.percentile(lat, 75),
        "p95_ms": stats.percentile(lat, 95),
        "p95_first_third_ms": stats.percentile(third[0], 95),
        "p95_last_third_ms": stats.percentile(third[1], 95),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from wis_tpu_torch.device import resolve_device

    device = resolve_device("cuda:0")
    c = cell(load_spec(), args.workload)
    rates = [float(x) for x in args.rates.split(",")]
    mixes = [dict(c["mix"], rate_per_s=r) for r in rates]
    pool = [traffic.schedule(m, args.seed + i, args.seconds) for i, m in enumerate(mixes)]
    t = time.perf_counter()
    system = system_module(c["config"]).System(c["config"], c["mix"], args.seed, device,
                                               [r for p in pool for r in p])
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    stamp = (lambda r: r["end"]) if "asr" in args.workload else (lambda r: r["chunks"][0])
    for rate, reqs in zip(rates, pool):
        system.prepare(reqs)
        t0 = time.perf_counter() + 0.5
        system.drive(t0, args.seconds, DRAIN_S)
        line = {"rate_per_s": rate, **summary(reqs, t0, args.seconds, stamp)}
        gaps = [(b - a) * 1e3 for r in reqs if r["ok"] for a, b in zip(r.get("chunks", []),
                                                                      r.get("chunks", [])[1:])]
        if gaps:
            line["chunk_gap_p50_ms"] = stats.percentile(gaps, 50)
            line["chunk_gap_p90_ms"] = stats.percentile(gaps, 90)
        print(json.dumps(line), flush=True)
    system.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
