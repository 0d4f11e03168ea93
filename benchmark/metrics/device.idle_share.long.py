"""Share of the time inside asr_dispatch ranges in which no operation ran
on the device (traced slice)."""

from benchmark import readers


def read(run):
    if run.trace is None:
        return None
    return readers.idle_share(run, [(h.ts, h.te) for h in run.trace.ranges("asr_dispatch")])
