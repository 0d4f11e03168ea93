"""The port's streaming session and WebRTC recorder
(``wis_tpu_torch/server/{session,media}.py``) held against
``wis_tpu.server``: tests/test_session_unit.py's cases replayed on the
port, and whole sessions — start, PCM frames, stop; a VAD-gated session
at 48 kHz stereo — through each package's executor and engine on shared
weights, giving the same wire messages apart from the time fields."""

import asyncio
import json
import re

import numpy as np
import pytest
import torch

from fake_aiortc import FakeAudioFrame
from test_vad import _silence, _speech
from torch_port_helpers import audio_i16, engine_pair
from wis_tpu.runtime.batcher import InferenceExecutor as JaxExecutor
from wis_tpu.server.media import MediaRecorderLite as JaxRecorder
from wis_tpu.server.session import DataChannelMessage as JaxMessage
from wis_tpu.server.session import StreamingSession as JaxSession
from wis_tpu.settings import APISettings as JaxSettings
from wis_tpu_torch.runtime.batcher import InferenceExecutor
from wis_tpu_torch.server.media import MediaRecorderLite
from wis_tpu_torch.server.session import DataChannelMessage, StreamingSession, _msg
from wis_tpu_torch.settings import APISettings

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# tests/test_session_unit.py on the port
# --------------------------------------------------------------------------- #
def test_datachannel_message_parse():
    m = DataChannelMessage.parse('{"type": "ping"}')
    assert m.type == "ping" and m.obj == {}
    m = DataChannelMessage.parse('{"type": "stop", "obj": {"model": "tiny"}}')
    assert m.obj["model"] == "tiny"
    with pytest.raises(ValueError):
        DataChannelMessage.parse('{"no_type": 1}')
    with pytest.raises(json.JSONDecodeError):
        DataChannelMessage.parse("not json")
    m = DataChannelMessage.parse('{"type": "ping", "obj": 5}')
    assert m.obj == {}
    for raw in ('{"type": 3, "obj": {"a": [1]}}', '[1, 2]', '{"type": "x", "obj": null}'):
        try:
            want = JaxMessage.parse(raw)
        except ValueError as e:
            with pytest.raises(type(e)):
                DataChannelMessage.parse(raw)
            continue
        got = DataChannelMessage.parse(raw)
        assert (got.type, got.obj) == (want.type, want.obj)
    assert _msg("infer", {"text": "é"}) == json.dumps({"type": "infer", "obj": {"text": "é"}})


def test_session_rejects_stop_before_start():
    session = StreamingSession(executor=None, settings=APISettings())

    async def go():
        out = await session.handle(DataChannelMessage("stop", {}))
        assert json.loads(out[0])["type"] == "error"
        out = await session.handle(DataChannelMessage("bogus", {}))
        assert json.loads(out[0])["type"] == "error"
        out = await session.handle(DataChannelMessage("ping", {"x": 1}))
        assert json.loads(out[0]) == {"type": "pong", "obj": {"x": 1}}

    asyncio.run(go())


def test_session_ignores_audio_when_not_recording():
    session = StreamingSession(executor=None, settings=APISettings())
    session.feed_pcm(b"\x00\x00" * 100)
    session.feed_float(np.zeros(100, np.float32), 16000)
    assert session._chunks == []


def test_session_empty_stop_errors():
    session = StreamingSession(executor=None, settings=APISettings())

    async def go():
        await session.handle(DataChannelMessage("start", {}))
        out = await session.handle(DataChannelMessage("stop", {}))
        assert json.loads(out[0])["type"] == "error"  # no audio received

    asyncio.run(go())


class _Refusing:
    """An executor that must not be reached."""

    queue_depth = 0

    def submit_sync(self, req):
        raise AssertionError(f"enqueued {req}")


@pytest.mark.parametrize("obj,match", [
    ({"model": "tiny", "force_language": "yue"}, "large-v3"),
    ({"model": "large", "force_language": "Cantonese"}, "large-v3"),
    ({"beam_size": 6}, "beam"),
    ({"beam_size": 40}, "beam"),
])
def test_refused_before_enqueue(obj, match):
    """A beam outside the buckets and a v3-only forced language on a
    v2-layout model answer with an error and enqueue nothing, as in
    wis_tpu."""
    outs = []
    for session_cls, msg_cls, settings in ((StreamingSession, DataChannelMessage, APISettings()),
                                           (JaxSession, JaxMessage, JaxSettings())):
        session = session_cls(_Refusing(), settings)

        async def go():
            await session.handle(msg_cls("start", {}))
            session.feed_pcm(np.zeros(8000, "<i2").tobytes())
            return await session.handle(msg_cls("stop", obj))

        outs.append(asyncio.run(go()))
    assert outs[0] == outs[1]
    (reply,) = outs[0]
    parsed = json.loads(reply)
    assert parsed["type"] == "error" and match in parsed["obj"]["msg"]


# --------------------------------------------------------------------------- #
# Whole sessions against wis_tpu's, on shared weights
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pair():
    jax_engine, port = engine_pair()
    jax_ex, port_ex = JaxExecutor(jax_engine), InferenceExecutor(port)
    yield (jax_engine, jax_ex), (port, port_ex)
    jax_ex.shutdown()
    port_ex.shutdown()


def _timeless(messages):
    """Wire messages without the time fields: infer's time and speedup, and
    the numbers in the log lines."""
    out = []
    for raw in messages:
        m = json.loads(raw)
        obj = m["obj"]
        if m["type"] == "infer":
            obj = {k: v for k, v in obj.items() if k not in ("time", "speedup")}
        elif m["type"] == "log":
            obj = {"msg": re.sub(r"\d+(\.\d+)?", "N", obj["msg"])}
        out.append((m["type"], obj))
    return out


def _drive(session_cls, msg_cls, executor, settings, script):
    """Run a script of ("msg", type, obj) / ("pcm", bytes) / ("vad",) steps
    through one session; → every reply in order."""
    session = session_cls(executor, settings, defaults={"model": "tiny"})

    async def go():
        replies = []
        for step in script:
            if step[0] == "msg":
                replies += await session.handle(msg_cls(step[1], step[2]))
            elif step[0] == "pcm":
                session.feed_pcm(step[1])
                if session.vad_triggered:
                    replies += await session.vad_stop()
        return replies

    return asyncio.run(go()), session


def _both_sessions(pair, script):
    (jax_engine, jax_ex), (port, port_ex) = pair
    want, jax_session = _drive(JaxSession, JaxMessage, jax_ex, jax_engine.settings, script)
    got, port_session = _drive(StreamingSession, DataChannelMessage, port_ex, port.settings,
                               script)
    assert _timeless(got) == _timeless(want)
    return got, port_session


def test_full_session_equals_jax(pair):
    """start {16 kHz, 16 bits, 1 channel}, 20 ms int16 frames, stop: the
    frames stay int16 (the hot path) and the infer text is the engine's
    on the same int16 audio."""
    pcm = audio_i16(int(1.5 * 16000), seed=3)[0]
    frames = [pcm[i:i + 320].astype("<i2").tobytes() for i in range(0, pcm.shape[0], 320)]
    script = ([("msg", "ping", {}),
               ("msg", "start", {"sample_rate": 16000, "bits": 16, "channel": 1})]
              + [("pcm", f) for f in frames]
              + [("msg", "stop", {"beam_size": 2})])
    got, session = _both_sessions(pair, script)
    assert [json.loads(m)["type"] for m in got] == ["pong", "log", "infer", "log"]
    assert all(c.dtype == np.int16 for c in session._chunks)
    infer = json.loads(got[2])["obj"]
    port = pair[1][0]
    assert infer["text"] and infer["text"] == port.transcribe(pcm, model="tiny",
                                                              beam_size=2).text
    assert infer["audio_duration"] == 1500


def test_float_session_with_detection_equals_jax(pair):
    """start {48 kHz, 16 bits, 2 channels}: decoded, mixed down and
    resampled by the native library; stop with detection and a forced
    language in two utterances on one session."""
    stereo = audio_i16(48000, seed=4, batch=2).T.reshape(-1).astype("<i2").tobytes()
    start = ("msg", "start", {"sample_rate": 48000, "bits": 16, "channels": 2})
    script = [start, ("pcm", stereo), ("msg", "stop", {"detect_language": True}),
              start, ("pcm", stereo), ("msg", "stop", {"force_language": "german"}),
              ("msg", "stop", {})]
    got, _ = _both_sessions(pair, script)
    assert [json.loads(m)["type"] for m in got] == ["log", "infer", "log", "log", "infer",
                                                    "log", "error"]
    assert json.loads(got[4])["obj"]["language"] == "de"


def test_vad_gated_session_equals_jax(pair):
    """start {vad: true} at 48 kHz stereo, speech then 1.5 s of silence in
    20 ms frames: the VAD ends the utterance mid-stream and vad_stop
    answers with the vad log, infer and log."""
    speech = np.concatenate([_speech(600), _silence(1500)])
    at48 = np.repeat(speech, 3)
    ints = (np.clip(np.stack([at48, at48 * 0.5], axis=1), -1, 1) * 32767).astype("<i2")
    frames = [ints[i:i + 960].tobytes() for i in range(0, ints.shape[0], 960)]
    script = ([("msg", "start", {"vad": True, "sample_rate": 48000, "channels": 2})]
              + [("pcm", f) for f in frames])
    got, session = _both_sessions(pair, script)
    types = [json.loads(m)["type"] for m in got]
    assert types[:4] == ["log", "log", "infer", "log"], types
    assert "vad" in json.loads(got[1])["obj"]["msg"]
    assert not session.recording


# --------------------------------------------------------------------------- #
# MediaRecorderLite
# --------------------------------------------------------------------------- #
def _frames(seed):
    rng = np.random.default_rng(seed)
    return [FakeAudioFrame((rng.standard_normal(960) * 0.2).astype(np.float32), 48000)
            for _ in range(25)]


class _StereoFrame(FakeAudioFrame):
    def to_ndarray(self):
        mono = super().to_ndarray()
        return np.concatenate([mono, mono // 2])


@pytest.mark.parametrize("kind", ["mono48k", "stereo48k", "float16k", "raw16k", "empty"])
def test_media_recorder_same_audio(kind):
    frames = {"mono48k": _frames(1),
              "stereo48k": [_StereoFrame(f._pcm, 48000) for f in _frames(2)],
              "float16k": [type("F", (), {"sample_rate": 16000, "to_ndarray": (
                  lambda self, x=x: x[None])})() for x in
                  np.random.default_rng(3).standard_normal((5, 320)).astype(np.float32)],
              "raw16k": [np.full(160, i / 10, np.float32) for i in range(5)],
              "empty": []}[kind]
    port, ref = MediaRecorderLite(), JaxRecorder()
    for f in frames:
        port.add_frame(f)
        ref.add_frame(f)
    got, want = port.stop(), ref.stop()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert port.stop().shape == (0,)  # stop() empties the recorder


def test_media_recorder_pulls_a_track():
    """start() pulls frames from the track until it ends; stop() returns
    them resampled to 16 kHz, equal to wis_tpu's recorder."""

    class Track:
        def __init__(self, frames):
            self.frames = list(frames)

        async def recv(self):
            if not self.frames:
                raise ConnectionError("track ended")
            await asyncio.sleep(0)
            return self.frames.pop(0)

    async def record(cls):
        rec = cls(Track(_frames(4)))
        rec.start()
        for _ in range(200):
            await asyncio.sleep(0)
        return rec.stop()

    got, want = asyncio.run(record(MediaRecorderLite)), asyncio.run(record(JaxRecorder))
    assert got.shape[0] == 25 * 320 and np.array_equal(got, want)
