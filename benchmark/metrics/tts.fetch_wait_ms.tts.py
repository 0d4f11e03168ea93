"""Median time a stream waits on its next chunk's CUDA event
(``tts.fetch``): the device's GPT steps and vocoder still to run when the
host asks."""

from benchmark import program, readers


def read(run):
    return readers.median(program.span_ms(run, "tts_stream", "tts.fetch"))
