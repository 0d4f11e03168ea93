"""The port's spans and counts (``wis_tpu_torch/utils/timing.py``): no
profiler range without a profiler; under ``torch.profiler`` (every thread,
as the benchmark's profiler runs) a coalesced dispatch from the batcher's
thread shows the program's ranges nested in ``asr_dispatch B=… rows=…``;
the decode loop's step and sync counts against its iterations; the
batcher's ``asr_batch`` record; a TTS stream's ``tts_stream`` record; the
ring's bound. Tiny configs on the CPU: Whisper ``tiny`` with seeded
weights, the micro XTTS of tests/test_torch_xtts_stream.py."""

import asyncio
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_xtts_stream import GPT, VOC, _voice
from wis_tpu_torch.decoding import beam as beam_mod
from wis_tpu_torch.models.whisper.model import cross_kv, encode
from wis_tpu_torch.models.whisper.tokenizer import build_prompt
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts import model as tm
from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
from wis_tpu_torch.runtime.engine import WhisperEngine
from wis_tpu_torch.runtime.residency import ModelRegistry
from wis_tpu_torch.server import tts_app
from wis_tpu_torch.settings import APISettings
from wis_tpu_torch.utils import timing

torch.set_num_threads(1)


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(seconds * 16000)) * 0.05
            ).astype(np.float32)


@pytest.fixture(scope="module")
def engine():
    s = APISettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=8,
                    beam_size=5, long_beam_size=5, fused_decode="on")
    return WhisperEngine(ModelRegistry(s, "cpu"))


def _records(kind, ids):
    return [t for t in timing.recent() if t.kind == kind and sorted(t.ids) == sorted(ids)]


def _queued_together(engine, reqs):
    """Submit ``reqs`` before the executor's thread runs, so they meet in
    one batch whatever the windows; → their results."""
    ex = InferenceExecutor(engine)
    start, ex.start = ex.start, lambda: None
    futures = [ex.submit(r) for r in reqs]
    ex.start = start
    ex.start()
    try:
        return [f.result(timeout=120) for f in futures]
    finally:
        ex.shutdown()


# --------------------------------------------------------------------------- #
def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []

    class Counted:
        def __init__(self, name):
            entered.append(name)
            self.inner = torch.autograd.profiler.record_function(name)

        def __enter__(self):
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(timing, "record_function", Counted)
    with timing.StageTimer("asr_call") as t:
        with t.span("asr_dispatch", B=4):
            with timing.span("asr.step"):
                pass
    with timing.span("batcher.wait"):  # no current timer
        pass
    assert entered == []
    assert [(s.name, s.parent, s.top) for s in t.spans] == [
        ("asr_dispatch", None, True), ("asr.step", "asr_dispatch", False)]
    assert set(t.as_dict()) == {"asr_dispatch"}

    with profile(activities=[ProfilerActivity.CPU]):
        with timing.StageTimer("asr_call") as t:
            with t.span("asr_dispatch", B=4, rows=3):
                with timing.span("asr.step"):
                    pass
    assert entered == ["asr_dispatch B=4 rows=3", "asr.step"]


def test_coalesced_dispatch_nests_program_ranges(engine, tmp_path):
    """Two requests coalesced on the batcher's thread, profiled on every
    thread: one ``asr_dispatch B=2 rows=2 …`` range with the program's
    ranges inside it on its thread."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    reqs = [ASRRequest(audio=_audio(1.0, i), model="tiny", beam_size=5, max_tokens=4)
            for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        _queued_together(engine, reqs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    disp = [e for e in events if e["name"].startswith("asr_dispatch ")]
    assert len(disp) == 1
    d = disp[0]
    assert "B=2 rows=2 K=5" in d["name"]
    inside = {e["name"].split(" ")[0] for e in events
              if e["tid"] == d["tid"] and d["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= d["ts"] + d["dur"] and e is not d}
    assert {"asr.encode", "asr.prefill", "asr.decode", "asr.step", "asr.sync",
            "asr.readback"} <= inside
    assert any(e["name"].startswith("batcher.admit n=2") for e in events)


@pytest.mark.parametrize("beam,eot_first", [(1, False), (1, True), (5, False)])
def test_step_and_sync_counts(engine, monkeypatch, beam, eot_first):
    """asr.step counts the loop's iterations (the decoder steps it ran);
    asr.sync the times its condition was read: one more than the steps
    when the loop stopped on it rather than on its cap."""
    loaded = engine.registry.get("tiny")
    cfg, tok = loaded.cfg, loaded.tokenizer
    mel = torch.zeros((1, cfg.n_mels, 3000))
    xa_kv = cross_kv(loaded.params, encode(loaded.params, mel, cfg), cfg)
    prompt = torch.tensor(build_prompt("en", "transcribe", notimestamps=True,
                                       layout=tok.layout))
    cap = 6

    def gen(eot):
        return beam_mod.build_generate_xa(
            cfg, beam_size=beam, batch=1, max_new_tokens=8, prompt_len=4,
            suppress_tokens=tok.suppress_tokens, begin_suppress_tokens=tok.begin_suppress_tokens,
            eot_id=eot)

    eot = None
    if eot_first:  # the first token the model picks ends the sequence at once
        eot = int(gen(None)(loaded.params, xa_kv, prompt, 2).tokens[0, 0, 0])
    steps = []
    real = beam_mod.decode_step
    monkeypatch.setattr(beam_mod, "decode_step",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    with timing.StageTimer("asr_call") as t:
        gen(eot)(loaded.params, xa_kv, prompt, cap)
    n = len(steps)
    assert t.counts.get("asr.step", 0) == n == sum(s.name == "asr.step" for s in t.spans)
    assert t.counts.get("asr.sync", 0) == n + (n < cap - 1) == sum(
        s.name == "asr.sync" for s in t.spans)
    if eot_first:
        assert n == 0 and t.counts["asr.sync"] == 1
    else:
        assert n == cap - 1
    names = [s.name for s in t.spans if s.parent is None]
    assert names == ["asr.prefill", "asr.decode"]


def test_batch_record(engine):
    """Two requests in one dispatch leave one asr_batch record with their
    ids, each request's queued_ms and held_ms (held at most the windows
    plus slack), and the engine call's record serving the same ids."""
    s = engine.settings
    reqs = [ASRRequest(audio=_audio(0.5, 10 + i), model="tiny", beam_size=5, max_tokens=3)
            for i in range(2)]
    _queued_together(engine, reqs)
    ids = [r.id for r in reqs]
    assert ids[1] > ids[0] > 0
    (rec,) = _records("asr_batch", ids)
    assert sorted(x["id"] for x in rec.requests) == sorted(ids)
    for x in rec.requests:
        assert x["queued_ms"] >= 0 and x["held_ms"] >= 0
        assert x["held_ms"] < (s.batch_window_s + s.batch_admit_max_s) * 1e3 + 250
    assert rec.t0 <= rec.t1
    (call,) = _records("asr_call", ids)
    assert rec.t0 <= call.t0 <= call.t1 <= rec.t1
    assert 1 <= call.counts["asr.step"] <= 2
    assert {"features", "asr_dispatch", "decode_text"} <= set(call.as_dict())


def test_coalesced_infer_time_covers_decode_text(engine):
    reqs = [ASRRequest(audio=_audio(0.5, 20 + i), model="tiny", beam_size=5, max_tokens=3)
            for i in range(2)]
    out = engine.transcribe_coalesced(reqs)
    for res in out:
        t = res.timings
        assert res.infer_time_ms >= t["features"] + t["asr_dispatch"] + t["decode_text"]
        assert res.infer_time_ms == out[0].infer_time_ms


def test_tts_stream_record(tmp_path):
    cfg = tm.XTTSConfig(gpt=tg.GPTConfig(max_audio_tokens=40, **GPT),
                        vocoder=th.HiFiGANConfig(**VOC), text_buckets=(8, 16, 32), cond_len=4,
                        left_context_frames=2, gpt_cache_buckets=(256, 512))
    model = tm.XTTSModel("cpu", cfg=cfg, dtype=torch.float32, fused="on")
    latent, speaker = _voice()
    voice = {"gpt_cond_latent": latent, "speaker_embedding": speaker}
    params = tts_app._stream_params({"stream_chunk_size": "8", "do_sample": "false",
                                     "min_audio_tokens": "40"})
    before = {id(t) for t in timing.recent()}

    async def run():
        return [c async for c in tts_app.stream_tts(model, "hello world", "en", voice,
                                                    params, add_wav_header=False)]

    chunks = asyncio.run(run())
    (rec,) = [t for t in timing.recent() if id(t) not in before and t.kind == "tts_stream"]
    names = [s.name for s in rec.spans]
    assert len(chunks) > 1 and len(rec.ids) == 1
    assert names.count("tts.prefill") == 1
    for name in ("tts.launch", "tts.fetch", "tts.handoff"):
        assert names.count(name) == len(chunks), name
    launches = [s for s in rec.spans if s.name == "tts.launch"]
    assert sum(s.attrs["n"] for s in launches) == 40
    assert all(s.attrs["t"] % 128 == 0 for s in launches)
    # one stream in flight at each launch
    assert rec.counts["tts.in_flight"] == len(launches)
    assert timing.level(tm.STREAMS) == 0
    # on the CPU every code is launched eagerly: no slot, no graph
    assert rec.counts["tts.eager_codes"] == 40
    assert "tts.graph_codes" not in rec.counts and "tts.graph_captures" not in rec.counts


def test_graph_share_reads_the_code_counts():
    """``benchmark/metrics/tts.graph_share.tts.py``: the codes replayed from
    a graph among every code of the window's ``tts_stream`` records;
    nothing where no record counts codes (a program without the counts)."""
    from types import SimpleNamespace as NS

    from benchmark import run as bench_run

    read = bench_run.reader("tts.graph_share.tts")

    def rec(t0, counts):
        return NS(kind="tts_stream", ids=[1], t0=t0, t1=t0 + 1, spans=[], counts=counts)

    window = NS(t0=100.0, t_stamps=200.0, trace=None, config={})
    records = [rec(110, {"tts.graph_codes": 190, "tts.eager_codes": 10}),
               rec(120, {"tts.graph_codes": 100, "tts.graph_captures": 3}),
               rec(50, {"tts.eager_codes": 1000}),  # before the window
               rec(199.5, {"tts.eager_codes": 1000})]  # ends in the traced slice
    orig = timing.recent
    try:
        timing.recent = lambda: records
        assert read(window) == pytest.approx(100.0 * 290 / 300)
        timing.recent = lambda: [rec(110, {"tts.in_flight": 2})]
        assert read(window) is None
    finally:
        timing.recent = orig


def test_ring_stays_at_its_bound():
    for i in range(timing.RING_SIZE + 7):
        with timing.StageTimer("probe", ids=[i]):
            pass
    ring = timing.recent()
    assert len(ring) == timing.RING_SIZE
    assert ring[-1].ids == [timing.RING_SIZE + 6]
