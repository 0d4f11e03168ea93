"""Streams inside the TTS app at each chunk's launch, on average: the
``tts.in_flight`` count over the number of ``tts.launch`` spans."""

from benchmark import program


def read(run):
    recs = program.records(run, "tts_stream")
    launches = len(program.spans(recs, "tts.launch"))
    if not launches:
        return None
    return sum(t.counts.get("tts.in_flight", 0) for t in recs) / launches
