"""The readers of what the program records about itself: hand-made
records of ``wis_tpu_torch.utils.timing.recent()`` (some outside the
window or inside the traced slice, which are left out) and hand-made
chrome events with the program's ranges; against a program without the
ring or the ranges every reader gives None."""

from types import SimpleNamespace as NS

import pytest

from benchmark import run as bench_run
from benchmark import trace
from benchmark.tests.test_bench_trace import ev
from wis_tpu_torch.utils import timing

T0, T_STAMPS = 100.0, 200.0


def _run(tr=None):
    return NS(t0=T0, t_stamps=T_STAMPS, trace=tr, config={})


def read(name, run):
    return bench_run.reader(name)(run)


def span(name, start, ms, **attrs):
    return NS(name=name, start=start, end=start + ms / 1e3, parent=None, attrs=attrs or None)


def rec(kind, t0, t1, spans=(), counts=None, requests=()):
    return NS(kind=kind, ids=[1], t0=t0, t1=t1, spans=list(spans), counts=dict(counts or {}),
              requests=list(requests))


def batches():
    inside = [rec("asr_batch", 110, 111, requests=[{"id": i, "queued_ms": q, "held_ms": h}
                                                    for i, (q, h) in enumerate(pairs)])
              for pairs in ([(10, 20), (30, 0.5)], [(50, 4)])]
    # before the window, and ending inside the traced slice: left out
    outside = [rec("asr_batch", 90, 99, requests=[{"id": 9, "queued_ms": 1e4, "held_ms": 1e4}]),
               rec("asr_batch", 199, 201, requests=[{"id": 8, "queued_ms": 1e4, "held_ms": 1e4}])]
    return inside + outside


def calls():
    def call(t0, step_ms):
        return rec("asr_call", t0, t0 + 1, counts={"asr.step": len(step_ms), "asr.sync": 3},
                   spans=[span("asr_dispatch", t0, 900, B=4, rows=3)]
                   + [span("asr.step", t0 + 0.1 * i, ms) for i, ms in enumerate(step_ms)])
    return [call(120, [2, 4]), call(130, [5]), call(140, [1, 1, 1]), call(190, []),
            call(50, [100]), call(199.5, [100])]


def streams():
    def stream(t0, launches, in_flight, extra=1.0):
        spans = [span("tts.prefill", t0, 30 * extra)]
        for i, (ms, n) in enumerate(launches):
            spans += [span("tts.launch", t0 + i, ms, n=n, t=256),
                      span("tts.fetch", t0 + i + 0.1, 40 * extra),
                      span("tts.handoff", t0 + i + 0.2, 2 * extra)]
        return rec("tts_stream", t0, t0 + 5, spans=spans, counts={"tts.in_flight": in_flight})
    return [stream(110, [(20, 20), (10, 20)], 3), stream(150, [(6, 6)], 2, extra=3.0),
            stream(10, [(1000, 1)], 50, extra=100.0), stream(196, [(1000, 1)], 50, extra=100.0)]


@pytest.fixture
def ring(monkeypatch):
    recs = batches() + calls() + streams() + [rec("probe", 120, 121)]
    monkeypatch.setattr(timing, "recent", lambda: recs)
    return recs


def test_batcher_queue_and_hold(ring):
    run = _run()
    # in the window: queued 10, 30, 50 and held 20, 0.5, 4 (linear ranks)
    assert read("batcher.queued_p95_ms.utt", run) == pytest.approx(48.0)
    assert read("batcher.held_p95_ms.utt", run) == pytest.approx(18.4)


@pytest.mark.parametrize("name", ["program.step_host_ms.utt", "program.step_host_ms.long"])
def test_step_host_ms_is_the_median_over_calls(ring, name):
    # calls in the window: 3 ms, 5 ms, 1 ms a step; none with no step
    assert read(name, _run()) == pytest.approx(3.0)


def test_tts_spans(ring):
    run = _run()
    assert read("tts.prefill_ms.tts", run) == pytest.approx(60.0)
    # per chunk: 1.0, 0.5 and 1.0 ms a code
    assert read("tts.launch_ms_per_code.tts", run) == pytest.approx(1.0)
    assert read("tts.fetch_wait_ms.tts", run) == pytest.approx(40.0)
    assert read("tts.handoff_ms.tts", run) == pytest.approx(2.0)
    assert read("tts.streams_in_flight.tts", run) == pytest.approx(5 / 3)


def trace_events():
    return [
        ev("user_annotation", trace.SLICE, 1000, 1000, tid=1),
        ev("user_annotation", "asr_dispatch B=4 rows=2 K=5 P=4 M=96 cap=11", 1100, 700, tid=2),
        ev("user_annotation", "asr.encode", 1110, 100, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 1120, 5, tid=2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 1130, 5, tid=2, corr=2),
        ev("user_annotation", "asr.decode", 1300, 400, tid=2),
        ev("user_annotation", "asr.step", 1310, 50, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 1320, 5, tid=2, corr=3),
        ev("user_annotation", "asr.sync", 1400, 250, tid=2),
        ev("kernel", "encoder_gemm", 1200, 60, corr=1),
        ev("kernel", "encoder_gelu", 1260, 20, corr=2),
        ev("kernel", "fused_decode_step", 1380, 100, corr=3),
        # a second dispatch on another thread whose encode launched nothing
        ev("user_annotation", "asr_dispatch B=1 rows=1 K=5 P=4 M=96 cap=5", 1100, 50, tid=3),
        ev("user_annotation", "asr.encode", 1101, 10, tid=3),
        # a decode range that ends past the slice: left out
        ev("user_annotation", "asr.decode", 1900, 300, tid=4),
    ]


def test_decode_idle_share_and_encoder_ms():
    run = _run(trace.parse(trace_events()))
    # 400 µs of asr.decode, the step kernel busy 100 of them
    assert read("program.decode_idle_share.utt", run) == pytest.approx(75.0)
    assert read("program.decode_idle_share.long", run) == pytest.approx(75.0)
    # 80 µs launched inside the encode of a dispatch of 2 real rows, and
    # 0 in the other dispatch's
    assert read("program.encoder_ms.utt", run) == pytest.approx((0.080 / 2 + 0.0) / 2)


NEW = ["batcher.queued_p95_ms.utt", "batcher.held_p95_ms.utt", "program.step_host_ms.utt",
       "program.step_host_ms.long", "program.decode_idle_share.utt",
       "program.decode_idle_share.long", "program.encoder_ms.utt", "tts.prefill_ms.tts",
       "tts.launch_ms_per_code.tts", "tts.fetch_wait_ms.tts", "tts.handoff_ms.tts",
       "tts.streams_in_flight.tts"]


@pytest.mark.parametrize("name", NEW)
def test_an_older_program_reads_none(monkeypatch, name):
    """No ring (``timing.recent`` missing) and a trace with only the bare
    ``asr_dispatch`` range: nothing to read."""
    monkeypatch.delattr(timing, "recent")
    evs = [e for e in trace_events() if not e["name"].startswith("asr.")]
    for e in evs:
        if e["name"].startswith("asr_dispatch"):
            e["name"] = "asr_dispatch"
    assert read(name, _run(trace.parse(evs))) is None


def test_the_new_metrics_are_declared():
    spec = bench_run.load_spec()
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["workloads"] and all(w in {c["name"] for c in spec["workloads"]}
                                      for w in m["workloads"])
