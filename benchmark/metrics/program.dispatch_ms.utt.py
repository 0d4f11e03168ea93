"""Median milliseconds of one ASR program dispatch (the asr_dispatch span,
which ends in a copy to the host, so it is synchronised)."""

from benchmark import readers


def read(run):
    return readers.median(c["timings"]["asr_dispatch"] / readers.n_dispatches(c)
                          for c in readers.calls(run) if "asr_dispatch" in c["timings"])
