"""The HTTP cases of tests/test_request_hardening.py replayed on the port's
apps: each request posted to ``wis_tpu``'s app on the JAX engine and to the
port's on the port engine of the same pair (``engine_pair``, tiny, 6
decode tokens), with the same status and body from both. Request-supplied
beams are bucket-validated before anything is queued, speaker names are
refused before any file I/O (SV and the TTS store), the SV gate follows the
WavLM weights unless set, and an engine fault is a 500, not a 400.
"""

import asyncio
import dataclasses
import json

import aiohttp
import numpy as np
import pytest
import torch

from torch_port_helpers import engine_pair, replay, serve, wav_bytes
from torch_port_helpers import http_reply as _reply
from wis_tpu_torch.audio.mel import SAMPLE_RATE
from wis_tpu_torch.server import app as port_app
from wis_tpu_torch.server.sv import SpeakerVerifier, valid_speaker_name
from wis_tpu_torch.server.tts_app import SpeakerStore

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return engine_pair(model="tiny", max_decode_tokens=6, decode_token_buckets=["8"],
                       batch_buckets=["1", "2"])


def _asr_form():
    form = aiohttp.FormData()
    form.add_field("audio_file", wav_bytes(0.5, 0), filename="a.wav", content_type="audio/wav")
    return form


# --------------------------------------------------------------------------- #
# Beam-size bucket validation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("route", ["asr", "willow"])
@pytest.mark.parametrize("beam", ["40", "99", "0", "-1", "lots"])
def test_endpoint_rejects_oversize_beam(engines, route, beam):
    """?beam_size outside the buckets → 400, with no program built and
    nothing queued."""
    _, port = engines
    keys = set(port._programs)

    async def go(client):
        if route == "asr":
            resp = await client.post(f"/api/asr?beam_size={beam}", data=_asr_form())
        else:
            resp = await client.post(f"/api/willow?beam_size={beam}", data=wav_bytes(0.5, 0),
                                     headers={"x-audio-codec": "wav"})
        return [await _reply(resp)]

    [(status, body)] = replay(engines, go)
    assert status == 400 and "beam" in body["error"]
    assert set(port._programs) == keys


def test_asr_endpoint_rounds_beam_to_bucket(engines):
    """beam_size=4 runs as the beam-5 bucket, never as a beam-4 program."""
    async def go(client):
        return [await _reply(await client.post("/api/asr?beam_size=4", data=_asr_form()))]

    [(status, _)] = replay(engines, go)
    assert status == 200
    _, port = engines
    beams = {k[1] for k in port._programs if isinstance(k[1], int)}
    assert 5 in beams and 4 not in beams


def test_program_cache_lru_bound(engines):
    _, port = engines
    s = dataclasses.replace(port.settings, compile_cache_max=2)
    eng = port_app.WhisperEngine(port_app.ModelRegistry(s, "cpu",
                                                        jax_trees=port.registry.jax_trees))
    audio = (np.random.default_rng(0).standard_normal(SAMPLE_RATE) * 0.05).astype(np.float32)
    for beam in (1, 2, 3):
        eng.transcribe(audio, model="tiny", beam_size=beam)
    assert len(eng._programs) == 2
    assert {k[1] for k in eng._programs} == {2, 3}  # the most recent keys survive


# --------------------------------------------------------------------------- #
# Speaker-name sanitization (SV and the TTS store)
# --------------------------------------------------------------------------- #
def test_valid_speaker_name():
    assert valid_speaker_name("alice")
    assert valid_speaker_name("CLB")
    assert valid_speaker_name("user_2-b")
    for bad in (None, "", "../../x", "a/b", "a\\b", "..", ".", "a" * 65,
                "né", "a b", "x\x00y"):
        assert not valid_speaker_name(bad)


def test_sv_enroll_rejects_traversal(tmp_path):
    from wis_tpu_torch.settings import APISettings

    v = SpeakerVerifier(APISettings(support_sv=True, sv_speaker_dir=str(tmp_path / "store")),
                        embed_fn=lambda a: np.ones(8, np.float32), device="cpu")
    audio = np.zeros(SAMPLE_RATE, np.float32)
    with pytest.raises(ValueError):
        v.enroll("../../evil", audio)
    assert not (tmp_path / "store").exists()  # no file I/O happened
    v.enroll("alice", audio)
    assert (tmp_path / "store" / "alice.npy").exists()


def test_sv_endpoint_rejects_traversal(engines, tmp_path):
    async def go(client):
        return [await _reply(await client.post("/api/sv?enroll=../../evil",
                                               data=wav_bytes(0.5, 0)))]

    [(status, body)] = replay(engines, go, support_sv=True,
                              sv_speaker_dir=str(tmp_path / "store"))
    assert status == 400 and "speaker" in body["error"].lower()
    assert not (tmp_path / "store").exists()


def test_tts_store_path_rejects_traversal(tmp_path):
    store = SpeakerStore(str(tmp_path))
    with pytest.raises(ValueError):
        store.path("../../x")
    with pytest.raises(ValueError):
        store.load("../secrets")
    assert store.path("default").endswith("default.json")


def test_tts_endpoints_reject_traversal(tmp_path):
    """GET /api/tts and POST /api/tts with a traversing speaker: 400 from
    both TTS apps, and no store directory made."""
    import jax.numpy as jnp

    from test_torch_xtts_stream import _cfgs
    from wis_tpu.models.xtts.model import XTTSModel as JaxXTTS
    from wis_tpu.server.tts_app import create_tts_app as jax_create_tts_app
    from wis_tpu.settings import APISettings as JaxSettings
    from wis_tpu_torch.models.xtts.model import XTTSModel
    from wis_tpu_torch.server.tts_app import create_tts_app
    from wis_tpu_torch.settings import APISettings

    jcfg, tcfg = _cfgs()

    async def go(client):
        out = [await _reply(await client.get("/api/tts",
                                             params={"text": "hi", "speaker": "../../x"}))]
        form = aiohttp.FormData()
        form.add_field("wav_file", wav_bytes(0.5, 0), filename="v.wav", content_type="audio/wav")
        out.append(await _reply(await client.post("/api/tts", params={"speaker": "../evil"},
                                                  data=form)))
        return out

    voices = str(tmp_path / "voices")
    want = serve(lambda: jax_create_tts_app(JaxSettings(xtts_speaker_dir=voices),
                                            model=JaxXTTS(cfg=jcfg, dtype=jnp.float32)), go)
    got = serve(lambda: create_tts_app(APISettings(xtts_speaker_dir=voices),
                                       model=XTTSModel("cpu", cfg=tcfg, dtype=torch.float32)),
                go)
    assert got == want == [(400, {"error": "Invalid speaker name"})] * 2
    assert not (tmp_path / "voices").exists()


# --------------------------------------------------------------------------- #
# SV capability gating
# --------------------------------------------------------------------------- #
def test_sv_auto_disabled_without_weights(engines):
    """support_sv unset (auto) and no WavLM checkpoint: 501."""
    async def go(client):
        return [await _reply(await client.post("/api/sv", data=wav_bytes(0.5, 0)))]

    assert replay(engines, go) == [(501, "SV not supported")]


def test_sv_auto_enabled_with_weights(engines, tmp_path, monkeypatch):
    from wis_tpu_torch.server import sv as sv_mod
    from wis_tpu_torch.server.reply import app_key

    weights = tmp_path / "wavlm-base-plus-sv"
    weights.mkdir()
    (weights / "model.safetensors").write_bytes(b"\0" * 8)
    _, port = engines
    # the capability check follows settings.model_dir (<dir>/wavlm-base-plus-sv)
    assert sv_mod.sv_weights_present(dataclasses.replace(port.settings,
                                                         model_dir=str(tmp_path)))
    assert not sv_mod.sv_weights_present(dataclasses.replace(
        port.settings, model_dir=str(tmp_path / "missing")))

    monkeypatch.setattr(port_app, "sv_weights_present", lambda *a: True)
    s = dataclasses.replace(port.settings, sv_speaker_dir=str(tmp_path / "store"))
    app = port_app.create_app(settings=s, engine=port)
    state = app[app_key(port_app.AppState)]
    assert state.sv_enabled
    state.sv._embed_fn = lambda a: np.ones(8, np.float32)

    async def go(client):
        resp = await client.post("/api/sv?enroll=alice", data=wav_bytes(0.5, 0))
        enrolled = await _reply(resp)
        resp = await client.post("/api/sv", data=wav_bytes(0.5, 1))
        return [enrolled, await _reply(resp)]

    assert serve(lambda: app, go) == [(200, {"enrolled": "alice"}),
                                      (200, {"speakers": {"alice": 1.0}})]
    assert (tmp_path / "store" / "alice.npy").exists()


def test_explicit_support_sv_false_wins(engines, monkeypatch):
    import wis_tpu.server.app as jax_app_mod

    monkeypatch.setattr(jax_app_mod, "sv_weights_present", lambda *a: True)
    monkeypatch.setattr(port_app, "sv_weights_present", lambda *a: True)

    async def go(client):
        return [await _reply(await client.post("/api/sv", data=wav_bytes(0.5, 0)))]

    assert replay(engines, go, support_sv=False) == [(501, "SV not supported")]


# --------------------------------------------------------------------------- #
# Engine faults surface as 500, not "Invalid audio" 400
# --------------------------------------------------------------------------- #
def test_engine_fault_returns_500(engines, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("engine exploded")

    for engine in engines:
        monkeypatch.setattr(engine, "transcribe", boom)

    async def go(client):
        return [await _reply(await client.post("/api/asr", data=_asr_form()))]

    [(status, _)] = replay(engines, go)
    assert status == 500


def test_ws_session_rejects_oversize_beam(engines):
    """A per-utterance beam override outside the buckets fails the
    utterance before enqueue: an error frame, no program built."""
    _, port = engines
    keys = set(port._programs)

    async def go(client):
        ws = await client.ws_connect("/api/ws/asr")
        await ws.send_str(json.dumps({"type": "start"}))
        await ws.receive()  # log: recording started
        pcm = (np.random.default_rng(0).standard_normal(SAMPLE_RATE) * 0.05 * 32767)
        await ws.send_bytes(pcm.astype("<i2").tobytes())
        await ws.send_str(json.dumps({"type": "stop", "obj": {"beam_size": 40}}))
        msg = json.loads((await ws.receive()).data)
        await ws.close()
        return [(msg["type"], msg["obj"]["msg"])]

    [(kind, msg)] = replay(engines, go)
    assert kind == "error" and "beam" in msg
    assert set(port._programs) == keys


def test_refused_requests_queue_nothing(engines):
    """The cores refuse before the body is read: the adapters' readers are
    never awaited, and the executor's queue stays empty."""
    _, port = engines
    state = port_app.build_state(port.settings, engine=port)

    async def never():
        raise AssertionError("the body was read")

    async def go():
        return [await port_app.asr(state, {"beam_size": "40"}, never),
                await port_app.asr(state, {"force_language": "xx"}, never),
                await port_app.asr(state, {"force_language": "yue"}, never),
                await port_app.willow(state, {"beam_size": "99"}, {}, never),
                await port_app.willow(state, {"force_language": "yue"}, {}, never)]

    replies = asyncio.run(go())
    assert [r.status for r in replies] == [400] * 5
    assert state.executor.queue_depth == 0 and not state.executor._started
