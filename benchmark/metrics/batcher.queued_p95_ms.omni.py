"""95th percentile of the time a request waits in the batcher's queue:
from ``submit`` until the batcher's thread takes it off the queue (the
``asr_batch`` records' ``queued_ms``)."""

from benchmark import program, readers


def read(run):
    return readers.p95([x["queued_ms"] for t in program.records(run, "asr_batch")
                        for x in t.requests])
