"""Streaming ASR session protocol (port of ``wis_tpu/server/session.py``).

The Willow datachannel's JSON protocol: ``ping`` → ``pong``, ``start``
(optional ``{sample_rate, bits, channel(s), vad}``) begins recording,
``stop`` (optional per-request ``{model, beam_size, detect_language,
force_language, translate}``) runs ASR and answers with ``infer`` +
``log`` messages. The session is transport-agnostic: a WebSocket feeds it
binary PCM frames, WebRTC decoded track frames. Inference goes through the
dynamic batcher (``runtime/batcher.py``), so concurrent sessions coalesce
into one batch. A bad beam or a forced language the model's vocabulary
cannot express is refused before anything is enqueued.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from wis_tpu_torch.audio import codecs
from wis_tpu_torch.audio.mel import SAMPLE_RATE
from wis_tpu_torch.audio.vad import EnergyVAD
from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
from wis_tpu_torch.runtime.engine import unsupported_language
from wis_tpu_torch.settings import APISettings

logger = logging.getLogger("wis_tpu_torch")


@dataclass
class DataChannelMessage:
    """Wire format: ``{"type": ..., "obj": {...}}``."""

    type: str
    obj: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def parse(cls, raw: str) -> "DataChannelMessage":
        data = json.loads(raw)
        if not isinstance(data, dict) or "type" not in data:
            raise ValueError("invalid datachannel message")
        obj = data.get("obj") or {}
        if not isinstance(obj, dict):
            obj = {}
        return cls(type=str(data["type"]), obj=obj)


def _msg(type_: str, obj: Any = None) -> str:
    return json.dumps({"type": type_, "obj": obj})


class StreamingSession:
    """One streaming ASR session: accumulates PCM between start/stop and
    runs inference on stop with per-request parameter overrides."""

    def __init__(
        self,
        executor: InferenceExecutor,
        settings: APISettings,
        defaults: Optional[Dict[str, Any]] = None,
    ):
        self.executor = executor
        self.settings = settings
        # endpoint-level defaults (an endpoint's query parameters),
        # shadowed by the stop message's obj values
        self.defaults = defaults or {}
        self.recording = False
        self._chunks: List[np.ndarray] = []
        self._sample_rate = SAMPLE_RATE
        self._bits = 16
        self._channels = 1
        self._start_time: Optional[float] = None
        self._vad = None  # set when start requests vad-gated endpointing

    # ------------------------------------------------------------------ #
    def feed_pcm(self, data: bytes) -> None:
        if not self.recording:
            return
        if (
            self._bits == 16
            and self._channels == 1
            and self._sample_rate == SAMPLE_RATE
            and self._vad is None
        ):
            # hot streaming case (mono s16le at 16 kHz, no VAD): keep
            # the frames int16 end to end — the engine takes int16 PCM
            # and the ASR program consumes int16, so a float round trip
            # would be host work for nothing
            self._chunks.append(np.frombuffer(data, dtype="<i2"))
            return
        pcm = codecs.pcm_to_float(data, self._bits)
        if self._channels > 1:
            pcm = codecs.mix_to_mono(pcm.reshape(-1, self._channels))
        self._chunks.append(pcm)
        if self._vad is not None:
            self._vad.feed(pcm)

    @property
    def vad_triggered(self) -> bool:
        """End-of-utterance detected by server-side VAD (sessions opt in
        with `start` obj `{"vad": true}`)."""
        return self._vad is not None and self._vad.utterance_ended

    async def vad_stop(self) -> List[str]:
        """Run inference after a VAD endpoint, as if `stop` arrived."""
        responses = await self.handle(DataChannelMessage("stop", {}))
        return [_msg("log", {"msg": "vad: end of utterance"})] + responses

    def feed_float(self, pcm: np.ndarray, sample_rate: int) -> None:
        if not self.recording:
            return
        if sample_rate != SAMPLE_RATE:
            pcm = codecs.resample(pcm, sample_rate, SAMPLE_RATE)
        self._chunks.append(pcm.astype(np.float32))

    def _collect(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, dtype=np.float32)
        audio = np.concatenate(self._chunks)
        if self._sample_rate != SAMPLE_RATE:
            audio = codecs.resample(audio, self._sample_rate, SAMPLE_RATE)
        return audio

    # ------------------------------------------------------------------ #
    async def handle(self, message: DataChannelMessage) -> List[str]:
        """Process one control message, returning wire responses."""
        if message.type == "ping":
            return [_msg("pong", message.obj or None)]

        if message.type == "start":
            obj = message.obj
            self._sample_rate = int(obj.get("sample_rate", SAMPLE_RATE))
            self._bits = int(obj.get("bits", 16))
            self._channels = int(obj.get("channel", obj.get("channels", 1)))
            self._chunks = []
            self.recording = True
            self._start_time = time.perf_counter()
            if obj.get("vad"):
                self._vad = EnergyVAD(sample_rate=self._sample_rate)
            else:
                self._vad = None
            return [_msg("log", {"msg": "recording started"})]

        if message.type == "stop":
            if not self.recording:
                return [_msg("error", {"msg": "not recording"})]
            self.recording = False
            record_ms = (
                (time.perf_counter() - self._start_time) * 1000
                if self._start_time
                else 0.0
            )
            audio = self._collect()
            if audio.shape[0] == 0:
                return [_msg("error", {"msg": "no audio received"})]
            obj = message.obj
            try:
                # beam is a program-cache key: bucket-validate BEFORE
                # enqueue so a bad override cannot build a new program or
                # fail a coalesced batch
                beam = self.settings.beam_bucket(
                    int(
                        obj.get("beam_size")
                        or self.defaults.get("beam_size")
                        or self.settings.beam_size
                    )
                )
            except ValueError as e:
                return [_msg("error", {"msg": str(e)})]
            req = ASRRequest(
                audio=audio,
                model=str(
                    obj.get("model")
                    or self.defaults.get("model")
                    or self.settings.whisper_model_default
                ),
                beam_size=beam,
                detect_language=bool(
                    obj.get(
                        "detect_language",
                        self.defaults.get("detect_language", False),
                    )
                ),
                force_language=obj.get("force_language"),
                translate=bool(obj.get("translate", False)),
            )
            if req.force_language and unsupported_language(
                req.force_language, req.model
            ):
                # rejected BEFORE enqueue so the bad request can't fail
                # a coalesced batch of innocent neighbors
                return [
                    _msg(
                        "error",
                        {
                            "msg": (
                                f"force_language {req.force_language!r} "
                                "requires a large-v3-family model"
                            )
                        },
                    )
                ]
            loop = asyncio.get_running_loop()
            try:
                result = await loop.run_in_executor(
                    None, lambda: self.executor.submit_sync(req)
                )
            except (ValueError, KeyError) as e:
                # bad per-request overrides (unknown model, v3-only
                # language on a v2-layout model, …) fail THIS utterance,
                # not the socket
                return [_msg("error", {"msg": str(e) or "invalid request"})]
            return [
                _msg("infer", {"text": result.text, "language": result.language,
                               "time": result.infer_time_ms,
                               "audio_duration": result.audio_duration_ms,
                               "speedup": result.infer_speedup}),
                _msg(
                    "log",
                    {
                        "msg": (
                            f"infer {result.infer_time_ms:.1f} ms, "
                            f"{result.infer_speedup}x realtime, "
                            f"recorded {record_ms:.0f} ms"
                        )
                    },
                ),
            ]

        return [_msg("error", {"msg": f"unknown message type {message.type}"})]
