"""Median host time of a stream's GPT prefill (``tts.prefill``: the prompt
through the GPT and the speaker embedding to the card)."""

from benchmark import program, readers


def read(run):
    return readers.median(program.span_ms(run, "tts_stream", "tts.prefill"))
