"""95th percentile of the time the batcher holds a request it has taken
off the queue before its engine call starts: the admit windows and, in a
batch run request by request, the calls before it (the ``asr_batch``
records' ``held_ms``)."""

from benchmark import program, readers


def read(run):
    return readers.p95([x["held_ms"] for t in program.records(run, "asr_batch")
                        for x in t.requests])
