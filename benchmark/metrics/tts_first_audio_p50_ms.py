"""Median over every reply due in the window, from its due time to its
first audio chunk; a failed reply counts at the drain limit. The median and
not a tail: at the cell's 0.5 replies a second a 50 s window holds 25
replies, and the tail moves by half from run to run with how the arrivals
overlap (PERF.md §2); it stands beside this as
``tts.first_audio_p75_ms.tts``."""

from benchmark import readers


def read(run):
    return readers.percentile(readers.latencies_ms(run, lambda r: r["chunks"][0]), 50)
