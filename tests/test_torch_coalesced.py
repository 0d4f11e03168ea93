"""The dynamic batcher's coalesced batches on the PyTorch port, held against
wis_tpu on the CPU: ``transcribe_coalesced`` over batches that mix forced
languages, detection and translate (each row detecting for itself, rows
cut to their own token cap), on the v2 and the v3 vocabulary layouts, with
the JAX batcher's ``ASRRequest`` and the port's own; and ``POST /api/asr``
served by wis_tpu's aiohttp app with the port engine and coalescing on."""

import asyncio

import numpy as np
import pytest
import torch

from torch_port_helpers import V3_MICRO, audio_i16, engine_pair, wav_bytes
from wis_tpu.runtime.batcher import ASRRequest as JaxRequest
from wis_tpu_torch.runtime.engine import ASRRequest

torch.set_num_threads(1)


def _f32(seconds, seed):
    return audio_i16(int(seconds * 16000), seed)[0].astype(np.float32) / 32768.0


def _batch(cls, spec):
    return [cls(audio=_f32(sec, seed), model="tiny", beam_size=beam, **kw)
            for sec, seed, beam, kw in spec]


@pytest.fixture(scope="module")
def engines():
    return engine_pair()


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.text == w.text and g.translation == w.translation
        assert g.language == w.language and g.audio_duration_ms == w.audio_duration_ms
        assert g.segments == w.segments


@pytest.mark.parametrize(
    "spec",
    [
        # forced language, detection, translate (a batch of three, padded to 4)
        [(1.0, 1, 1, dict(force_language="de")), (1.0, 2, 1, dict(detect_language=True)),
         (1.0, 3, 1, dict(translate=True))],
        # beams of five, mixed lengths and caps (rows cut to their own cap)
        [(2.0, 4, 5, dict(max_tokens=3)), (0.5, 5, 5, dict(max_tokens=8)),
         (3.0, 6, 5, dict(detect_language=True, max_tokens=6)),
         (1.5, 7, 5, dict(task="translate", max_tokens=8))],
        # timestamps
        [(1.0, 8, 1, dict(timestamps=True)), (2.0, 9, 1, dict(timestamps=True))],
    ],
)
def test_coalesced_equal(engines, spec):
    jax_engine, port = engines
    want = jax_engine.transcribe_coalesced(_batch(JaxRequest, spec))
    got = port.transcribe_coalesced(_batch(JaxRequest, spec))
    _assert_results_equal(got, want)
    # the port's own request type gives the same results
    _assert_results_equal(port.transcribe_coalesced(_batch(ASRRequest, spec)), want)
    assert all(g.text for g in got)


def test_coalesced_v3_layout():
    """v3-layout requests coalesce with per-row prompts from the v3 special
    ids (yue is v3-only)."""
    from wis_tpu.models.whisper.config import WHISPER_CONFIGS as JAX_CONFIGS
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, WhisperConfig

    JAX_CONFIGS["micro-v3"] = JaxConfig(**V3_MICRO)
    WHISPER_CONFIGS["micro-v3"] = WhisperConfig(**V3_MICRO)
    try:
        jax_engine, port = engine_pair(model="micro-v3", batch_buckets=["1", "2"])
        spec = [(1.0, 9, 1, dict(force_language="yue")), (1.0, 10, 1, dict(force_language="en")),
                (1.0, 11, 1, dict(detect_language=True))]
        reqs = [JaxRequest(audio=_f32(sec, seed), model="micro-v3", beam_size=beam, **kw)
                for sec, seed, beam, kw in spec]
        want = jax_engine.transcribe_coalesced(reqs)
        got = port.transcribe_coalesced(reqs)
    finally:
        JAX_CONFIGS.pop("micro-v3", None)
        WHISPER_CONFIGS.pop("micro-v3", None)
    _assert_results_equal(got, want)
    assert [g.language for g in got[:2]] == ["yue", "en"]


def test_warmup_runs_the_coalesced_top_bucket(engines):
    _, port = engines
    calls = []
    real = port.transcribe_coalesced

    def spy(reqs):
        calls.append(len(reqs))
        return real(reqs)

    port.transcribe_coalesced = spy
    try:
        port.warmup(beams=[1])
    finally:
        del port.transcribe_coalesced
    assert calls == [port.settings.batch_bucket_list()[-1]]


def _coalesce_four(port, make_app):
    """Four concurrent POST /api/asr through ``make_app()`` (its batcher
    with a half-second window) with a spy on the port engine's
    transcribe_coalesced → (the batch sizes it dispatched, the bodies, the
    JSON replies)."""
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    calls = []
    real = port.transcribe_coalesced

    def spy(reqs):
        calls.append(len(reqs))
        return real(reqs)

    port.transcribe_coalesced = spy
    bodies = [wav_bytes(1.0, 20 + i) for i in range(4)]

    async def go():
        client = TestClient(TestServer(make_app()))
        await client.start_server()
        try:
            async def post(body):
                form = aiohttp.FormData()
                form.add_field("audio_file", body, filename="a.wav", content_type="audio/wav")
                resp = await client.post("/api/asr?model=tiny&beam_size=1", data=form)
                assert resp.status == 200
                return await resp.json()

            return await asyncio.gather(*(post(b) for b in bodies))
        finally:
            await client.close()

    try:
        data = asyncio.run(go())
    finally:
        del port.transcribe_coalesced
    return calls, bodies, data


def test_api_asr_coalesces_with_the_port_engine(engines):
    """Four concurrent POST /api/asr through wis_tpu's app and batcher with
    the port engine: the batcher coalesces them (a half-second window), and
    each response carries the port's coalesced result for its audio."""
    from wis_tpu.audio.ingest import load_audio
    from wis_tpu.server.app import create_app
    from wis_tpu.settings import APISettings as JaxSettings

    _, port = engines
    settings = JaxSettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=8,
                           beam_size=1, long_beam_size=5, batch_window_s=0.5)
    calls, bodies, data = _coalesce_four(port, lambda: create_app(settings=settings,
                                                                  engine=port))
    assert calls and sum(calls) == 4 and max(calls) > 1
    assert all(d["audio_duration"] == 1000 and d["language"] == "en" and d["text"]
               for d in data)
    if calls == [4]:  # one batch of all four: exactly the engine's coalesced result
        want = port.transcribe_coalesced(
            [ASRRequest(audio=load_audio(b), model="tiny", beam_size=1) for b in bodies])
        assert [d["text"] for d in data] == [w.text for w in want]


def test_api_asr_coalesces_through_the_port_app(engines):
    """The same four requests through the port's own app and batcher
    (wis_tpu_torch.server.app): coalesced, each reply the port's coalesced
    result for its audio."""
    import dataclasses

    from wis_tpu_torch.audio.ingest import load_audio
    from wis_tpu_torch.server.app import create_app

    _, port = engines
    settings = dataclasses.replace(port.settings, batch_window_s=0.5)
    calls, bodies, data = _coalesce_four(port, lambda: create_app(settings=settings,
                                                                  engine=port))
    assert calls and sum(calls) == 4 and max(calls) > 1
    assert all(d["audio_duration"] == 1000 and d["language"] == "en" and d["text"]
               for d in data)
    if calls == [4]:
        want = port.transcribe_coalesced(
            [ASRRequest(audio=load_audio(b), model="tiny", beam_size=1) for b in bodies])
        assert [d["text"] for d in data] == [w.text for w in want]
