"""95th percentile of the wait in the dynamic batcher: from a request's
submit to the start of the engine call that carries it (the harness's own
stamps)."""

from benchmark import readers


def read(run):
    start = {rid: c["t0"] for c in readers.calls(run) for rid in c["rids"]}
    waits = [(start[r["id"]] - r["submitted"]) * 1e3 for r in run.requests
             if r["id"] in start]
    return readers.p95(waits)
