"""Host time to queue one audio code: the median over chunks of the
``tts.launch`` span (GPT chunk, vocoder and pack queued) over its ``n``
codes."""

from benchmark import program, readers


def read(run):
    return readers.median((s.end - s.start) * 1e3 / s.attrs["n"]
                          for s in program.spans(program.records(run, "tts_stream"),
                                                 "tts.launch"))
