"""The port's dynamic batcher, replica pool and ``unsupported_language``
(``wis_tpu_torch/runtime/{batcher,engine}.py``,
``wis_tpu_torch/parallel/replicas.py``) held against ``wis_tpu``.

Batch composition is compared with a recording fake engine under both
executors. To get a fixed grouping the requests are queued before the
worker starts, so its first, non-blocking drain takes them; nothing here
depends on a window's timing. The real path runs the port's executor on
the port engine against the JAX executor on the JAX engine, on shared
weights (``engine_pair``)."""

import threading

import numpy as np
import pytest
import torch

from torch_port_helpers import audio_i16, engine_pair
from wis_tpu.runtime.batcher import ASRRequest as JaxRequest
from wis_tpu.runtime.batcher import InferenceExecutor as JaxExecutor
from wis_tpu.settings import APISettings as JaxSettings
from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
from wis_tpu_torch.settings import APISettings

torch.set_num_threads(1)


class RecordingEngine:
    """Records each dispatch by the requests' ids (the first sample);
    fails a dispatch that holds the id ``fail``."""

    def __init__(self, settings, fail=None):
        self.settings = settings
        self.calls = []
        self.fail = fail

    def _check(self, ids):
        if self.fail in ids:
            raise RuntimeError(f"device fault in {ids}")

    def transcribe(self, audio, **kw):
        rid = int(audio[0])
        self.calls.append(("one", rid, kw["word_timestamps"]))
        self._check([rid])
        return f"r{rid}"

    def transcribe_coalesced(self, reqs):
        ids = tuple(int(r.audio[0]) for r in reqs)
        self.calls.append(("batch", ids))
        self._check(ids)
        return [f"r{i}" for i in ids]


def _spec_request(cls, rid, spec):
    seconds = spec.get("seconds", 1.0)
    audio = np.full(int(seconds * 16000), rid, np.float32)
    kw = {k: v for k, v in spec.items() if k != "seconds"}
    kw.setdefault("model", "tiny")
    kw.setdefault("beam_size", 1)
    return cls(audio=audio, **kw)


SEQUENCES = {
    # keys: model, effective beam, timestamps, word timestamps; an
    # incompatible request is requeued behind the rest
    "mixed_keys": [{}, {}, {"beam_size": 5}, {}, {"model": "base"}, {"timestamps": True},
                   {}, {"beam_size": 5}, {"timestamps": True}],
    # more than the largest batch bucket: batches of four
    "overflow": [{}] * 9,
    # a long request runs alone; ≥ 12 s takes the long beam into the key
    "long_solo": [{}, {"seconds": 31.0}, {}, {"seconds": 13.0, "beam_size": 5},
                  {"seconds": 13.0, "beam_size": 1}, {}],
    # word_timestamps requests coalesce by key, then run one by one
    "word_timestamps": [{"word_timestamps": True}, {"word_timestamps": True}, {},
                        {"word_timestamps": True}],
    "lone": [{}],
}


def _run_queued(executor_cls, request_cls, settings, specs, sentinel_at=None, fail=None):
    engine = RecordingEngine(settings, fail=fail)
    ex = executor_cls(engine, settings)
    reqs = [_spec_request(request_cls, i, s) for i, s in enumerate(specs)]
    for i, r in enumerate(reqs):
        if i == sentinel_at:
            ex._queue.put(None)
        ex._queue.put(r)
    if sentinel_at == len(reqs):
        ex._queue.put(None)
    ex.start()
    outcomes = []
    for r in reqs:
        try:
            outcomes.append(r.future.result(timeout=30))
        except Exception as e:  # noqa: BLE001 — the failure is what is compared
            outcomes.append(type(e).__name__ + ": " + str(e))
        if sentinel_at is not None and len(outcomes) == sentinel_at:
            break
    ex._thread.join(timeout=5) if sentinel_at is not None else ex.shutdown()
    return engine.calls, outcomes, ex


def _settings_pair(**kw):
    base = dict(batch_window_s=0.001, batch_admit_s=0.001, batch_admit_max_s=0.002)
    base.update(kw)
    return APISettings(**base), JaxSettings(**base)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_same_batches_as_jax(name):
    port_s, jax_s = _settings_pair()
    got = _run_queued(InferenceExecutor, ASRRequest, port_s, SEQUENCES[name])[:2]
    want = _run_queued(JaxExecutor, JaxRequest, jax_s, SEQUENCES[name])[:2]
    assert got == want
    calls = got[0]
    if name == "overflow":
        assert calls == [("batch", (0, 1, 2, 3)), ("batch", (4, 5, 6, 7)), ("one", 8, False)]
    if name == "long_solo":
        assert ("one", 1, False) in calls
    if name == "word_timestamps":
        # the plain request was requeued behind the third word request
        assert calls == [("one", 0, True), ("one", 1, True), ("one", 3, True),
                         ("one", 2, False)]


def test_shutdown_sentinel_runs_what_was_drained():
    """The sentinel met while draining dispatches the batch it closes and
    stops the thread; requests behind it stay queued."""
    port_s, jax_s = _settings_pair()
    specs = [{}] * 5
    got = _run_queued(InferenceExecutor, ASRRequest, port_s, specs, sentinel_at=2)
    want = _run_queued(JaxExecutor, JaxRequest, jax_s, specs, sentinel_at=2)
    assert got[:2] == want[:2] == ([("batch", (0, 1))], ["r0", "r1"])
    assert not got[2]._thread.is_alive()
    assert got[2].queue_depth == want[2].queue_depth == 3


@pytest.mark.parametrize("fail", [1, 4, 6])
def test_exception_reaches_every_future_of_the_batch(fail):
    port_s, jax_s = _settings_pair()
    specs = [{}] * 4 + [{"beam_size": 5}, {}, {"seconds": 31.0}]
    got = _run_queued(InferenceExecutor, ASRRequest, port_s, specs, fail=fail)[:2]
    want = _run_queued(JaxExecutor, JaxRequest, jax_s, specs, fail=fail)[:2]
    assert got == want
    assert any(str(o).startswith("RuntimeError: device fault") for o in got[1])


def test_windows_admit_a_straggler():
    """A lone request lingers for batch_window_s; a request that arrives
    inside it joins the same dispatch."""
    settings = APISettings(batch_window_s=5.0, batch_admit_s=0.0, batch_admit_max_s=0.0)
    engine = RecordingEngine(settings)
    ex = InferenceExecutor(engine, settings)
    first = _spec_request(ASRRequest, 0, {})
    ex.submit(first)
    threading.Timer(0.05, lambda: ex.submit(_spec_request(ASRRequest, 1, {}))).start()
    assert first.future.result(timeout=30) == "r0"
    ex.shutdown()
    assert engine.calls == [("batch", (0, 1))]


def test_request_keys_equal():
    port_s, jax_s = _settings_pair(long_beam_size=3)
    for spec in [{}, {"seconds": 12.0}, {"seconds": 31.0}, {"timestamps": True},
                 {"word_timestamps": True}, {"beam_size": 2, "model": "large"}]:
        p, j = _spec_request(ASRRequest, 0, spec), _spec_request(JaxRequest, 0, spec)
        assert p.batch_key(port_s) == j.batch_key(jax_s)
        assert p.is_long() == j.is_long()
        assert p.effective_beam(port_s) == j.effective_beam(jax_s)


def test_engine_reexports_the_batcher_request():
    from wis_tpu_torch.runtime import engine

    assert engine.ASRRequest is ASRRequest


# --------------------------------------------------------------------------- #
# The port executor on the port engine against the JAX executor on the JAX
# engine, on the same weights
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engines():
    return engine_pair()


def _f32(seconds, seed):
    return audio_i16(int(seconds * 16000), seed)[0].astype(np.float32) / 32768.0


def _executor_results(executor_cls, request_cls, engine, specs):
    calls = []
    real = engine.transcribe_coalesced

    def spy(reqs):
        calls.append(len(reqs))
        return real(reqs)

    engine.transcribe_coalesced = spy
    ex = executor_cls(engine)
    try:
        reqs = [request_cls(audio=_f32(sec, seed), model="tiny", beam_size=beam, **kw)
                for sec, seed, beam, kw in specs]
        for r in reqs:
            ex._queue.put(r)
        ex.start()
        return [r.future.result(timeout=300) for r in reqs], calls
    finally:
        ex.shutdown()
        del engine.transcribe_coalesced


@pytest.mark.parametrize("specs", [
    [(1.0, 1, 1, dict(force_language="de")), (1.5, 2, 1, dict(detect_language=True)),
     (0.5, 3, 1, dict(translate=True))],
    [(1.0, 4, 1, dict(timestamps=True)), (2.0, 5, 1, dict(timestamps=True)),
     (1.0, 6, 1, dict(timestamps=True))],
])
def test_executor_on_the_port_engine_equals_jax(engines, specs):
    jax_engine, port = engines
    want, want_calls = _executor_results(JaxExecutor, JaxRequest, jax_engine, specs)
    got, got_calls = _executor_results(InferenceExecutor, ASRRequest, port, specs)
    assert got_calls == want_calls == [3]
    for g, w in zip(got, want):
        assert (g.text, g.language, g.translation, g.segments, g.audio_duration_ms) == (
            w.text, w.language, w.translation, w.segments, w.audio_duration_ms)
    assert all(g.text for g in got)


def test_executor_word_timestamps_equal(engines):
    jax_engine, port = engines
    specs = [(2.5, 8, 1, dict(word_timestamps=True, max_tokens=8))]
    (want,), want_calls = _executor_results(JaxExecutor, JaxRequest, jax_engine, specs)
    (got,), got_calls = _executor_results(InferenceExecutor, ASRRequest, port, specs)
    assert got_calls == want_calls == []
    assert got.text == want.text and got.words and got.words == want.words


def test_executor_failure_reaches_the_caller(engines):
    _, port = engines
    ex = InferenceExecutor(port)
    try:
        with pytest.raises(KeyError):
            ex.submit_sync(ASRRequest(audio=_f32(0.5, 0), model="doesnotexist", beam_size=1))
    finally:
        ex.shutdown()


# --------------------------------------------------------------------------- #
# ReplicaPool
# --------------------------------------------------------------------------- #
def test_replica_pool_picks_the_least_loaded():
    from wis_tpu_torch.parallel.replicas import ReplicaPool

    settings = APISettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=4,
                           beam_size=1, long_beam_size=1)
    pool = ReplicaPool(settings, devices=["cpu", "cpu", "cpu"])
    assert len(pool.engines) == len(pool.executors) == 3
    assert [e.device for e in pool.engines] == [torch.device("cpu")] * 3
    assert len({id(e.registry) for e in pool.engines}) == 3
    q = [ex._queue for ex in pool.executors]
    # ties go round robin
    assert [pool._pick() for _ in range(4)] == [pool.executors[i] for i in (0, 1, 2, 0)]
    q[0].put("x")
    q[0].put("x")
    q[2].put("x")
    assert pool.queue_depth == 3
    assert pool._pick() is pool.executors[1]
    q[1].put("x")
    q[1].put("x")
    q[1].put("x")
    assert pool._pick() is pool.executors[2]
    for qq in q:
        while not qq.empty():
            qq.get_nowait()
    # a request through the pool, equal to the engine's own result
    audio = _f32(1.0, 11)
    got = pool.submit_sync(ASRRequest(audio=audio, model="tiny", beam_size=1))
    pool.shutdown()
    picked = [e for e in pool.engines if "tiny" in e.registry._models]
    assert len(picked) == 1
    want = picked[0].transcribe(audio, model="tiny", beam_size=1)
    assert got.text == want.text and got.audio_duration_ms == 1000


def test_replica_pool_without_cuda_raises(monkeypatch):
    from wis_tpu_torch.parallel.replicas import ReplicaPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaPool(APISettings())


def test_replica_pool_defaults_to_every_cuda_device(monkeypatch):
    """With CUDA visible, the pool asks for cuda:0 .. cuda:N-1 (a registry
    on a device this machine lacks refuses, so the registry is stubbed)."""
    from wis_tpu_torch.parallel import replicas

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = []

    class Registry:
        def __init__(self, settings, device):
            seen.append(device)
            self.settings, self.device = settings, torch.device("cpu")

    monkeypatch.setattr(replicas, "ModelRegistry", Registry)
    pool = replicas.ReplicaPool(APISettings())
    assert seen == ["cuda:0", "cuda:1"] and len(pool.executors) == 2


# --------------------------------------------------------------------------- #
# unsupported_language
# --------------------------------------------------------------------------- #
def test_unsupported_language_equal_everywhere():
    from wis_tpu import languages as jl
    from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
    from wis_tpu.runtime.engine import unsupported_language as jax_unsupported
    from wis_tpu_torch.runtime.engine import UnsupportedLanguageError, unsupported_language

    assert issubclass(UnsupportedLanguageError, ValueError)
    models = sorted(JAX_CONFIGS) + ["large", "large-v3", "turbo", "distil-large-v3",
                                    "doesnotexist", ""]
    langs = (sorted(jl.LANGUAGES) + sorted(jl.EXTRA_V3_LANGUAGES) + sorted(jl.TO_LANGUAGE_CODE)
             + ["Cantonese", "YUE", "xx", ""])
    v2 = v3 = 0
    for m in models:
        for lang in langs:
            got = unsupported_language(lang, m)
            assert got == jax_unsupported(lang, m), (lang, m)
            v2 += got
        v3 += not unsupported_language("yue", m)
    assert v2 and v3  # both layouts met
