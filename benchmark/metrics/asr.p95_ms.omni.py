"""95th percentile over the requests due in the window before the traced
slice, from the due time to the reply (a failed one at the drain
limit): the tail beside the end-to-end median."""

from benchmark import readers


def read(run):
    lat = readers.latencies_ms(run, lambda r: r["end"])
    due = [x for x, r in zip(lat, run.requests) if r["due_abs"] < run.t_stamps]
    return readers.p95(due)
