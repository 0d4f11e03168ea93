"""Median of the gaps between consecutive audio chunks of every reply due
in the window (a gap longer than the last chunk's audio is an audible
stall); the 90th percentile stands beside it as
``tts.chunk_gap_p90_ms.tts``."""

from benchmark import readers


def read(run):
    gaps = [(b - a) * 1e3 for r in run.requests if r["ok"]
            for a, b in zip(r["chunks"], r["chunks"][1:])]
    return readers.percentile(gaps, 50)
