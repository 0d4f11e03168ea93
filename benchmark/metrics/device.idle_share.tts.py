"""Share of the time with at least one reply in flight (asked for, not yet
read to its end; host stamps on the trace's clock) in which no operation
ran on the device, over the traced slice."""

from benchmark import readers


def read(run):
    if run.trace is None:
        return None
    return readers.idle_share(run, [(run.trace.at(r["sent"]), run.trace.at(r["end"]))
                                    for r in run.requests if "end" in r])
