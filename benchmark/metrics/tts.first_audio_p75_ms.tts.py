"""75th percentile, over the replies due before the traced slice, from the
due time to the first audio chunk (a failed one at the drain limit)."""

from benchmark import readers


def read(run):
    lat = readers.latencies_ms(run, lambda r: r["chunks"][0])
    return readers.percentile([x for x, r in zip(lat, run.requests)
                               if r["due_abs"] < run.t_stamps], 75)
