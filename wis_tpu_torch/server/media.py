"""In-memory audio recorder for WebRTC tracks (port of
``wis_tpu/server/media.py``).

Frames are duck-typed: anything with ``to_ndarray()`` and
``sample_rate`` (an ``av.AudioFrame`` from aiortc) or a plain array of
16 kHz samples, so the module needs no aiortc. Frames are converted to
float32 PCM, mixed down, and ``stop()`` resamples the accumulated signal
to 16 kHz mono through the wisaudio library.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

import numpy as np

from wis_tpu_torch.audio import codecs
from wis_tpu_torch.audio.mel import SAMPLE_RATE

logger = logging.getLogger("wis_tpu_torch")


class MediaRecorderLite:
    """Record an aiortc audio track into a float32 16 kHz buffer."""

    def __init__(self, track=None):
        self.track = track
        self._chunks: List[np.ndarray] = []
        self._rate: Optional[int] = None
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            try:
                frame = await self.track.recv()
            except Exception:  # track ended / connection closed
                return
            self.add_frame(frame)

    def add_frame(self, frame) -> None:
        """Accept an av.AudioFrame (from aiortc) or raw ndarray."""
        if hasattr(frame, "to_ndarray"):
            data = frame.to_ndarray()  # (channels, samples) int16 typically
            rate = frame.sample_rate
            if data.dtype != np.float32:
                data = data.astype(np.float32) / 32768.0
            if data.ndim == 2:
                data = data.mean(axis=0)
        else:
            data = np.asarray(frame, np.float32)
            rate = SAMPLE_RATE
        self._rate = rate
        self._chunks.append(data.reshape(-1))

    def stop(self) -> np.ndarray:
        """Stop recording and return 16 kHz mono float32 audio."""
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if not self._chunks:
            return np.zeros(0, np.float32)
        audio = np.concatenate(self._chunks)
        self._chunks = []
        if self._rate and self._rate != SAMPLE_RATE:
            audio = codecs.resample(audio, self._rate, SAMPLE_RATE)
        return audio
