"""Median over every request due in the window, from its due time to its
transcript; a request that fails or is not answered by the drain limit
counts at that limit. The median and not a tail: at the cell's 12 requests
a second the 95th percentile of a 50 s window moves by 15-20% from run to
run (PERF.md §2), more than any bound can hold; it stands beside this as
``asr.p95_ms.utt``."""

from benchmark import readers


def read(run):
    return readers.percentile(readers.latencies_ms(run, lambda r: r["end"]), 50)
