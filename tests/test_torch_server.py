"""The port's ASR app (``wis_tpu_torch/server/app.py``) held against
``wis_tpu``'s: every case of tests/test_server.py, each request posted to
both apps under aiohttp's test client, the JAX app on the JAX engine and the
port's app on the port engine of the same pair (``engine_pair``: tiny
whisper, f32, the JAX registry's weights bridged to the port, 6 decode
tokens). Status codes, error bodies and field sets must be equal, and every
field but ``infer_time`` and ``infer_speedup`` (the engines' own clocks) —
``text`` and ``language`` token for token, segments and words.
"""

import io
import json
import os
import sys
import wave

import aiohttp
import numpy as np
import pytest
import torch

from torch_port_helpers import engine_pair, replay, serve, wav_bytes
from torch_port_helpers import http_reply as _reply
from wis_tpu_torch.audio.mel import SAMPLE_RATE
from wis_tpu_torch.server import app as port_app

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return engine_pair(model="tiny", max_decode_tokens=6, batch_buckets=["1", "2", "4"])


def _form(body=None, name="audio_file", filename="a.wav", content_type="audio/wav"):
    form = aiohttp.FormData()
    form.add_field(name, wav_bytes(1.0, 0) if body is None else body, filename=filename,
                   content_type=content_type)
    return form


def test_ping(engines):
    async def go(client):
        return [await _reply(await client.get("/api/ping"))]

    assert replay(engines, go) == [(200, {"message": "pong"})]


def test_asr_multipart_wav(engines):
    async def go(client):
        return [await _reply(await client.post("/api/asr?model=tiny&beam_size=1",
                                               data=_form()))]

    [(status, data)] = replay(engines, go)
    assert status == 200
    assert set(data) >= {"infer_time", "infer_speedup", "audio_duration", "language", "text"}
    assert data["audio_duration"] == 1000 and data["language"] == "en"


def test_asr_flac_fixture(engines, flac_fixture_3s):
    async def go(client):
        form = _form(flac_fixture_3s.read_bytes(), filename="3sec.flac",
                     content_type="audio/flac")
        return [await _reply(await client.post("/api/asr?model=tiny&beam_size=1", data=form))]

    [(status, data)] = replay(engines, go)
    assert status == 200 and data["audio_duration"] == 3840


def test_asr_word_timestamps(engines):
    async def go(client):
        return [await _reply(await client.post(
            "/api/asr?model=tiny&beam_size=1&word_timestamps=true", data=_form()))]

    [(status, data)] = replay(engines, go)
    assert status == 200 and "words" in data
    for w in data["words"]:
        assert set(w) == {"word", "start", "end", "probability"}
        assert w["end"] >= w["start"] >= 0.0


def test_asr_timestamps_segments(engines):
    """?timestamps=true: the segments equal the JAX app's."""
    async def go(client):
        return [await _reply(await client.post(
            "/api/asr?model=tiny&beam_size=1&timestamps=true", data=_form()))]

    [(status, data)] = replay(engines, go)
    assert status == 200 and "segments" in data


@pytest.mark.parametrize("query,error", [
    ("force_language=xx", "Invalid force_language"),
    ("model=tiny&force_language=yue", "large-v3"),
    ("beam_size=40", "beam"),
    ("model=nonesuch", "Unknown model"),
])
def test_asr_refusals(engines, query, error):
    """The refusals of test_server.py (an unknown language, a v3-only one on
    a v2 model) and an oversize beam: the same 400s from both apps."""
    async def go(client):
        return [await _reply(await client.post(f"/api/asr?{query}", data=_form()))]

    [(status, body)] = replay(engines, go)
    assert status == 400 and error in body["error"]


def test_engine_rejects_v3_language_on_v2_layout(engines):
    from wis_tpu_torch.runtime.engine import UnsupportedLanguageError

    _, port = engines
    with pytest.raises(UnsupportedLanguageError):
        port.transcribe(np.zeros(SAMPLE_RATE // 2, np.float32), model="tiny", beam_size=1,
                        force_language="yue", max_tokens=2)


def test_asr_invalid_and_missing_audio(engines):
    async def go(client):
        return [await _reply(await client.post("/api/asr", data=_form(b"not audio at all",
                                                                        filename="a.bin"))),
                await _reply(await client.post("/api/asr", data=_form(name="other")))]

    assert replay(engines, go) == [(400, {"error": "Invalid audio"}),
                                   (400, {"error": "Missing audio_file"})]


def test_willow_pcm_stream(engines):
    async def go(client):
        rng = np.random.default_rng(3)
        pcm = (rng.standard_normal(SAMPLE_RATE) * 0.05 * 32767).astype("<i2")
        return [await _reply(await client.post(
            "/api/willow?model=tiny", data=pcm.tobytes(), headers={
                "x-audio-sample-rate": "16000", "x-audio-bits": "16",
                "x-audio-channel": "1", "x-audio-codec": "pcm", "x-willow-id": "test-device",
            }))]

    [(status, data)] = replay(engines, go)
    assert status == 200 and set(data) == {"language", "text"}


def test_willow_wav_with_stats_and_save_audio(engines, tmp_path):
    """stats=true gives the timing fields; save_audio=true writes the
    decoded audio as a WAV under the static root, the same bytes as the JAX
    app writes."""
    async def go(client):
        return [await _reply(await client.post("/api/willow?model=tiny&stats=true&save_audio=true",
                                               data=wav_bytes(1.0, 4),
                                               headers={"x-audio-codec": "wav"}))]

    [(status, data)] = replay(engines, go, static_root=str(tmp_path))
    assert status == 200 and set(data) >= {"infer_time", "language", "text"}
    got = (tmp_path / "port" / "audio" / "willow.wav").read_bytes()
    assert got == (tmp_path / "jax" / "audio" / "willow.wav").read_bytes()
    with wave.open(io.BytesIO(got)) as w:
        assert (w.getframerate(), w.getnframes()) == (SAMPLE_RATE, SAMPLE_RATE)


@pytest.mark.parametrize("headers", [{"x-audio-codec": "wav"},
                                     {"x-audio-codec": "pcm", "x-audio-bits": "lots"}])
def test_willow_invalid_audio(engines, headers):
    async def go(client):
        return [await _reply(await client.post("/api/willow", data=b"garbage", headers=headers))]

    assert replay(engines, go) == [(400, {"error": "Invalid audio"})]


def test_ws_session_protocol(engines):
    async def go(client):
        ws = await client.ws_connect("/api/ws/asr?model=tiny")
        got = []
        await ws.send_str(json.dumps({"type": "ping"}))
        got.append(json.loads(await ws.receive_str()))
        await ws.send_str(json.dumps({"type": "start", "obj": {"sample_rate": 16000}}))
        got.append(json.loads(await ws.receive_str()))
        rng = np.random.default_rng(5)
        pcm = (rng.standard_normal(SAMPLE_RATE // 2) * 0.05 * 32767).astype("<i2")
        await ws.send_bytes(pcm.tobytes())
        await ws.send_str(json.dumps({"type": "stop", "obj": {"model": "tiny", "beam_size": 1}}))
        infer = json.loads(await ws.receive_str())
        log = json.loads(await ws.receive_str())
        await ws.send_str("{not json")
        err = json.loads(await ws.receive_str())
        await ws.close()
        # the engines' clocks: time and speedup in infer, the log's text
        return [(infer["type"], {k: v for k, v in infer["obj"].items()
                                 if k not in ("time", "speedup")}), (log["type"], None),
                (err["type"], err["obj"]["msg"])] + [(m["type"], m["obj"]) for m in got]

    replies = replay(engines, go)
    assert [r[0] for r in replies] == ["infer", "log", "error", "pong", "log"]
    assert "text" in replies[0][1] and replies[0][1]["audio_duration"] == 500


def test_rtc_unavailable_gives_501(engines):
    async def go(client):
        resp = await client.post("/api/rtc/asr", json={"sdp": "v=0", "type": "offer"})
        return [(resp.status, None)]

    [(status, _)] = replay(engines, go)
    assert status in (200, 501)  # 501 without aiortc


def test_openapi_and_docs(engines):
    async def go(client):
        return [await _reply(await client.get("/api/openapi.json")),
                await _reply(await client.get("/api/docs"))]

    (status, doc), (docs_status, html) = replay(engines, go)
    assert status == docs_status == 200 and "/api/asr" in doc["paths"]
    assert html.startswith("<!DOCTYPE html>")


def test_basic_auth(engines):
    import base64

    token = base64.b64encode(b"u:p").decode()

    async def go(client):
        resp = await client.get("/api/ping")
        out = [await _reply(resp), (resp.headers.get("WWW-Authenticate"), None)]
        return out + [await _reply(await client.get(
            "/api/ping", headers={"Authorization": f"Basic {token}"}))]

    assert replay(engines, go, basic_auth_user="u", basic_auth_pass="p") == [
        (401, {"error": "Unauthorized"}), ('Basic realm="wis"', None),
        (200, {"message": "pong"})]


def test_cors_through_the_app(engines):
    async def go(client):
        resp = await client.get("/api/ping", headers={"Origin": "https://a.example"})
        pre = await client.options("/api/asr", headers={"Origin": "https://a.example"})
        return [(resp.status, resp.headers.get("Access-Control-Allow-Origin")),
                (pre.status, pre.headers.get("Access-Control-Allow-Methods"))]

    assert replay(engines, go, cors_allowed_origins=["https://a.example"]) == [
        (200, "https://a.example"), (204, "GET, POST, OPTIONS")]


def test_sv_disabled_gives_501(engines):
    async def go(client):
        return [await _reply(await client.post("/api/sv", data=wav_bytes(1.0, 0))),
                await _reply(await client.post("/api/willow?voice_auth=true",
                                               data=wav_bytes(1.0, 0),
                                               headers={"x-audio-codec": "wav"}))]

    assert replay(engines, go) == [(501, "SV not supported")] * 2


def test_status_endpoint(engines):
    async def go(client):
        await client.post("/api/asr?model=tiny", data=_form())
        status, body = await _reply(await client.get("/api/status"))
        # the device list and the program counts are each engine's own
        return [(status, sorted(body)), (body["queue_depth"], sorted(body["models_loaded"]))]

    replies = replay(engines, go)
    assert replies[0] == (200, sorted({"devices", "models_loaded", "hbm_resident_bytes",
                                       "hbm_budget_bytes", "queue_depth",
                                       "compiled_programs"}))

    async def devices(client):
        return (await (await client.get("/api/status")).json())["devices"]

    _, port = engines
    assert serve(lambda: port_app.create_app(settings=port.settings, engine=port),
                  devices) == ["cpu"]


def _codecs():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fixture_codecs as fx

    return fx


def test_willow_mp3_and_ogg_end_to_end(engines):
    fx = _codecs()
    if not (fx.lame_available() and fx.vorbis_available()):
        pytest.skip("system codec libraries unavailable")
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    tone = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)

    async def go(client):
        out = []
        for body, codec in [(fx.encode_mp3(tone), "mp3"), (fx.encode_ogg_vorbis(tone), "ogg")]:
            out.append(await _reply(await client.post("/api/willow?model=tiny", data=body,
                                                      headers={"x-audio-codec": codec})))
        return out

    for status, data in replay(engines, go):
        assert status == 200 and set(data) == {"language", "text"}


def test_asr_multipart_mp3(engines):
    fx = _codecs()
    if not fx.lame_available():
        pytest.skip("libmp3lame unavailable")
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    tone = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)

    async def go(client):
        return [await _reply(await client.post(
            "/api/asr?model=tiny", data=_form(fx.encode_mp3(tone), filename="a.mp3")))]

    [(status, data)] = replay(engines, go)
    assert status == 200 and {"language", "text", "infer_time"} <= set(data)


# --------------------------------------------------------------------------- #
# the port's own: the device policy and the state
# --------------------------------------------------------------------------- #
def test_create_app_asks_for_the_card(monkeypatch):
    """create_app defaults to the card and raises without one; the CPU is
    used only when asked for, or when the given engine lives there."""
    from wis_tpu_torch.settings import APISettings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_app.create_app(settings=APISettings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_app.build_state(APISettings())
    state = port_app.build_state(APISettings(whisper_model_default="tiny"), device="cpu")
    assert state.registry.device == torch.device("cpu") and state.engine.device.type == "cpu"
    assert isinstance(state.executor, port_app.InferenceExecutor)
    assert state.save_audio_path == os.path.join("nginx/static", "audio", "willow.wav")


def test_the_state_is_the_apps(engines, tmp_path):
    """The app keeps build_state's fields (the JAX app's keys) under one
    key, and mounts the static directories that exist."""
    from wis_tpu_torch.server.reply import app_key

    (tmp_path / "rtc").mkdir()
    (tmp_path / "rtc" / "index.html").write_text("rtc page")
    _, port = engines
    app = port_app.create_app(settings=port.settings, engine=port, static_root=str(tmp_path))
    state = app[app_key(port_app.AppState)]
    assert state.engine is port and state.registry is port.registry
    assert state.sv_enabled is False and state.save_audio_path == str(
        tmp_path / "audio" / "willow.wav")

    async def go(client):
        resp = await client.get("/rtc/index.html")
        return resp.status, await resp.text()

    assert serve(lambda: app, go) == (200, "rtc page")
