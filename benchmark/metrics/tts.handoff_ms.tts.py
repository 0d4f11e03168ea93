"""Median time a stream's producer thread takes to hand a chunk to the
event loop (``tts.handoff``: the loop's latency and the consumer's
backpressure)."""

from benchmark import program, readers


def read(run):
    return readers.median(program.span_ms(run, "tts_stream", "tts.handoff"))
