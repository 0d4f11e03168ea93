"""Share of the fused ASR program's prompt prefills replayed from a captured
CUDA graph: Σ ``asr.prefill_graph`` over Σ ``asr.prefill_graph`` +
``asr.prefill_eager`` of the ``asr_call`` records. A program that counts
neither gives nothing."""

from benchmark import program


def read(run):
    recs = program.records(run, "asr_call")
    graph = sum(t.counts.get("asr.prefill_graph", 0) for t in recs)
    total = graph + sum(t.counts.get("asr.prefill_eager", 0) for t in recs)
    return 100.0 * graph / total if total else None
