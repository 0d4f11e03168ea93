"""Median host time of an engine call outside its ASR program calls: the
engine's infer_time_ms less its asr_dispatch spans (StageTimer)."""

from benchmark import readers


def read(run):
    return readers.median(c["infer_ms"] - c["timings"].get("asr_dispatch", 0.0)
                          for c in readers.calls(run))
