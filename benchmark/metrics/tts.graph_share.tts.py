"""Share of the audio codes launched by replaying a captured CUDA graph:
Σ ``tts.graph_codes`` over Σ ``tts.graph_codes`` + ``tts.eager_codes`` of
the ``tts_stream`` records. A program that counts neither gives nothing."""

from benchmark import program


def read(run):
    recs = program.records(run, "tts_stream")
    graph = sum(t.counts.get("tts.graph_codes", 0) for t in recs)
    total = graph + sum(t.counts.get("tts.eager_codes", 0) for t in recs)
    return 100.0 * graph / total if total else None
