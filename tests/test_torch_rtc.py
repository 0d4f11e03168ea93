"""tests/test_rtc.py replayed on the port's WebRTC layer
(``wis_tpu_torch/server/rtc.py``) through the port's ``/api/rtc/asr``,
against tests/fake_aiortc.py: offer/answer, the datachannel ping/start/stop
protocol with a recorded 48 kHz track and per-request overrides from the
stop message (its text equal to the port engine's on the recorded audio),
a bad message, connection cleanup, the RTCP-BYE keepalive patch and the
recorder's resampling; and the 501 without aiortc.
"""

import asyncio
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import fake_aiortc  # noqa: E402

fake_aiortc.install()
sys.modules.pop("wis_tpu_torch.server.rtc", None)

from torch_port_helpers import engine_pair, serve  # noqa: E402
from wis_tpu_torch.audio.mel import SAMPLE_RATE  # noqa: E402
from wis_tpu_torch.server.app import create_app  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return engine_pair(model="tiny", max_decode_tokens=6, batch_buckets=["1", "2"])


def _run(engines, go):
    _, port = engines
    fake_aiortc.RTCPeerConnection.instances.clear()
    return serve(lambda: create_app(settings=port.settings, engine=port), go)


def _offer_body():
    return {"sdp": "v=0 fake-offer", "type": "offer"}


def test_offer_answer(engines):
    async def go(client):
        resp = await client.post("/api/rtc/asr", json=_offer_body())
        return resp.status, await resp.json()

    status, data = _run(engines, go)
    assert status == 200 and data["type"] == "answer" and "fake-answer" in data["sdp"]


def test_datachannel_full_session(engines):
    """ping → pong; start → recording; one second of 48 kHz frames on the
    track; stop with a per-request obj → infer + log, the text the port
    engine gives the recorded audio."""
    recorded = []

    async def go(client):
        resp = await client.post("/api/rtc/asr", json=_offer_body())
        assert resp.status == 200
        pc = fake_aiortc.RTCPeerConnection.instances[-1]
        track = fake_aiortc.FakeAudioTrack()
        chan = fake_aiortc.FakeDataChannel()
        pc.emit_track(track)
        pc.emit_datachannel(chan)

        await chan.deliver(json.dumps({"type": "ping"}))
        assert any(json.loads(m)["type"] == "pong" for m in chan.sent)
        await chan.deliver(json.dumps({"type": "start"}))
        rng = np.random.default_rng(0)
        frames = [(rng.standard_normal(960) * 0.05).astype(np.float32) for _ in range(50)]
        for pcm in frames:
            track.push(fake_aiortc.FakeAudioFrame(pcm, sample_rate=48000))
        await asyncio.sleep(0.2)  # let the recorder task drain the queue
        recorded.extend(frames)
        await chan.deliver(json.dumps({"type": "stop", "obj": {"model": "tiny",
                                                                "beam_size": 1}}))
        return [json.loads(m) for m in chan.sent]

    sent = _run(engines, go)
    types = [m["type"] for m in sent]
    assert "infer" in types, types
    infer = next(m["obj"] for m in sent if m["type"] == "infer")
    # ~1 s of audio at 48 kHz resampled to 16 kHz
    assert 900 <= infer["audio_duration"] <= 1100

    from wis_tpu_torch.server.media import MediaRecorderLite

    rec = MediaRecorderLite()
    for pcm in recorded:
        rec.add_frame(fake_aiortc.FakeAudioFrame(pcm, 48000))
    _, port = engines
    assert infer["text"] == port.transcribe(rec.stop(), model="tiny", beam_size=1).text


def test_bad_message_yields_error(engines):
    async def go(client):
        await client.post("/api/rtc/asr", json=_offer_body())
        pc = fake_aiortc.RTCPeerConnection.instances[-1]
        chan = fake_aiortc.FakeDataChannel()
        pc.emit_datachannel(chan)
        await chan.deliver("this is not json")
        return [json.loads(m) for m in chan.sent]

    assert _run(engines, go) == [{"type": "error", "obj": {"msg": "bad message"}}]


def test_oversize_beam_refused_before_the_offer(engines):
    async def go(client):
        resp = await client.post("/api/rtc/asr?beam_size=40", json=_offer_body())
        return resp.status, await resp.json(), len(fake_aiortc.RTCPeerConnection.instances)

    status, body, n_pcs = _run(engines, go)
    assert status == 400 and "beam" in body["error"] and n_pcs == 0


def test_connection_cleanup(engines):
    async def go(client):
        await client.post("/api/rtc/asr", json=_offer_body())
        from wis_tpu_torch.server import rtc

        pc = fake_aiortc.RTCPeerConnection.instances[-1]
        assert pc in rtc._pcs
        await pc.emit_state("failed")
        return pc.closed, pc in rtc._pcs

    assert _run(engines, go) == (True, False)


def test_rtcp_bye_patch(engines):
    """BYE packets are swallowed, so replaceTrack(null) idle pauses do not
    end the session; other RTCP packets reach the original handler."""
    async def go(client):
        await client.post("/api/rtc/asr", json=_offer_body())  # applies the patch
        from aiortc import rtp
        from aiortc.rtcrtpreceiver import RTCRtpReceiver

        recv = RTCRtpReceiver()
        RTCRtpReceiver.handled.clear()
        bye = await RTCRtpReceiver._handle_rtcp_packet(recv, rtp.RtcpByePacket())
        handled = list(RTCRtpReceiver.handled)

        class OtherPacket:
            pass

        other = await RTCRtpReceiver._handle_rtcp_packet(recv, OtherPacket())
        return bye, handled, other, len(RTCRtpReceiver.handled)

    assert _run(engines, go) == (None, [], "original-handled", 1)


def test_media_recorder_resamples():
    from wis_tpu_torch.server.media import MediaRecorderLite

    rec = MediaRecorderLite()
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(48000) / 48000)).astype(np.float32)
    for i in range(0, 48000, 960):
        rec.add_frame(fake_aiortc.FakeAudioFrame(tone[i: i + 960], 48000))
    audio = rec.stop()
    assert abs(audio.shape[0] - SAMPLE_RATE) < 10
    freq = np.fft.rfftfreq(len(audio), 1 / SAMPLE_RATE)[np.argmax(np.abs(np.fft.rfft(audio)))]
    assert abs(freq - 440.0) < 2.0


def test_without_aiortc_the_route_gives_501(engines, monkeypatch):
    """No aiortc: the route answers 501 and the rest of the app serves."""
    monkeypatch.setitem(sys.modules, "aiortc", None)
    monkeypatch.delitem(sys.modules, "wis_tpu_torch.server.rtc", raising=False)

    async def go(client):
        resp = await client.post("/api/rtc/asr", json=_offer_body())
        ping = await client.get("/api/ping")
        return resp.status, await resp.json(), ping.status

    assert _run(engines, go) == (
        501, {"error": "WebRTC unavailable: aiortc not installed"}, 200)
