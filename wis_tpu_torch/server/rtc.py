"""WebRTC transport (port of ``wis_tpu/server/rtc.py``), loaded lazily by
/api/rtc/asr.

The reference's WebRTC session layer on the shared ``StreamingSession``
protocol:

- SDP offer → RTCPeerConnection answer; the incoming audio track recorded
  by ``MediaRecorderLite`` between datachannel ``start``/``stop`` messages;
- the stop message's per-request model, beam and language shadow the
  endpoint's query parameters;
- **RTCP-BYE keepalive**: aiortc is patched to ignore RtcpByePacket, so
  clients can idle with ``replaceTrack(null)`` at ~5 kbps for days;
- **media port pinning**: UDP ephemeral ports constrained to the
  configured range (``rtc_port_start``..``rtc_port_end``) for
  firewall-friendly deployment.

This module imports aiortc when it is imported; without it the endpoint
answers 501 (``server/app.py`` ``rtc``).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Set

from aiortc import (  # type: ignore
    RTCPeerConnection,
    RTCSessionDescription,
)

from wis_tpu_torch.server.media import MediaRecorderLite
from wis_tpu_torch.server.session import DataChannelMessage, StreamingSession

logger = logging.getLogger("wis_tpu_torch")

_pcs: Set[RTCPeerConnection] = set()
_patched = False


def _patch_rtcp_bye() -> None:
    """Ignore RTCP BYE so idle-paused sessions stay alive."""
    global _patched
    if _patched:
        return
    try:
        from aiortc.rtcrtpreceiver import RTCRtpReceiver
        from aiortc import rtp

        original = RTCRtpReceiver._handle_rtcp_packet

        async def _handle(self, packet):
            if isinstance(packet, rtp.RtcpByePacket):
                logger.debug("RTC: ignoring RTCP BYE (idle keepalive)")
                return
            return await original(self, packet)

        RTCRtpReceiver._handle_rtcp_packet = _handle
        _patched = True
    except Exception as e:  # noqa: BLE001 — the session works without the patch
        logger.warning("RTC: could not patch RTCP BYE handling: %s", e)


def patch_loop_datagram(port_range) -> None:
    """Pin UDP ephemeral ports to the configured media range."""
    try:
        import aioice.ice as ice

        ice.CONSENT_FAILURES = 1000  # tolerate long idle
    except Exception:  # noqa: BLE001 — aioice's knob is optional
        pass
    loop = asyncio.get_event_loop()
    if getattr(loop, "_wis_patched", False):
        return
    original = loop.create_datagram_endpoint
    ports = list(range(port_range[0], port_range[1] + 1))

    async def create_datagram_endpoint(protocol_factory, local_addr=None, **kwargs):
        if local_addr is None or local_addr[1] != 0:
            return await original(protocol_factory, local_addr=local_addr, **kwargs)
        host = local_addr[0]
        for port in ports:
            try:
                return await original(
                    protocol_factory, local_addr=(host, port), **kwargs
                )
            except OSError:
                continue
        raise OSError(f"no free media port in {port_range}")

    loop.create_datagram_endpoint = create_datagram_endpoint
    loop._wis_patched = True


async def rtc_offer(state, params, model, beam_size, detect_language) -> dict:
    """An SDP offer → the answer; ``state`` is the app's ``AppState``."""
    _patch_rtcp_bye()
    settings = state.settings
    patch_loop_datagram((settings.rtc_port_start, settings.rtc_port_end))

    offer = RTCSessionDescription(sdp=params["sdp"], type=params["type"])
    pc = RTCPeerConnection()
    _pcs.add(pc)

    session = StreamingSession(
        state.executor,
        settings,
        defaults={
            "model": model,
            "beam_size": beam_size,
            "detect_language": detect_language,
        },
    )
    track_state = {"track": None, "recorder": None}

    @pc.on("track")
    def on_track(track):
        if track.kind == "audio":
            track_state["track"] = track
            logger.debug("RTC: audio track received")

    @pc.on("datachannel")
    def on_datachannel(channel):
        @channel.on("message")
        def on_message(raw):
            asyncio.ensure_future(_handle_message(raw, channel))

        async def _handle_message(raw, channel):
            try:
                msg = DataChannelMessage.parse(raw)
            except (ValueError, json.JSONDecodeError):
                channel.send(json.dumps({"type": "error", "obj": {"msg": "bad message"}}))
                return
            if msg.type == "start" and track_state["track"] is not None:
                recorder = MediaRecorderLite(track_state["track"])
                recorder.start()
                track_state["recorder"] = recorder
                session.recording = True
                channel.send(json.dumps({"type": "log", "obj": {"msg": "recording"}}))
                return
            if msg.type == "stop" and track_state["recorder"] is not None:
                audio = track_state["recorder"].stop()
                track_state["recorder"] = None
                session.recording = True
                session._chunks = [audio]
                for response in await session.handle(msg):
                    channel.send(response)
                return
            for response in await session.handle(msg):
                channel.send(response)

    @pc.on("connectionstatechange")
    async def on_state_change():
        logger.debug("RTC: connection state %s", pc.connectionState)
        if pc.connectionState in ("failed", "closed"):
            await pc.close()
            _pcs.discard(pc)

    await pc.setRemoteDescription(offer)
    answer = await pc.createAnswer()
    await pc.setLocalDescription(answer)
    return {"sdp": pc.localDescription.sdp, "type": pc.localDescription.type}
