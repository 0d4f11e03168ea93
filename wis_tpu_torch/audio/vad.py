"""Energy-based voice activity detection (port of ``wis_tpu/audio/vad.py``).

Willow devices decide utterance boundaries themselves; this server-side
VAD lets streaming sessions opt into end-of-utterance detection (a
``start`` message with ``vad: true``): frame-energy thresholding against
an adapting noise floor, with a minimum speech length and a trailing
silence window, computed incrementally on the host as PCM arrives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from wis_tpu_torch.audio.mel import SAMPLE_RATE


@dataclass
class VADConfig:
    frame_ms: int = 30
    #: dBFS above the noise floor to count a frame as speech
    threshold_db: float = 12.0
    #: initial noise floor (dBFS); adapts toward quiet frames
    noise_floor_db: float = -55.0
    #: trailing silence that ends an utterance (ms)
    silence_ms: int = 700
    #: minimum speech before an utterance can end (ms)
    min_speech_ms: int = 200


class EnergyVAD:
    """Streaming VAD: feed PCM chunks, poll `utterance_ended`."""

    def __init__(self, config: VADConfig | None = None, sample_rate: int = SAMPLE_RATE):
        self.config = config or VADConfig()
        self.sample_rate = sample_rate
        self._frame_len = sample_rate * self.config.frame_ms // 1000
        self._residual = np.zeros(0, np.float32)
        self._noise_floor = self.config.noise_floor_db
        self.speech_ms = 0
        self.silence_run_ms = 0
        self.in_speech = False

    def _frame_db(self, frame: np.ndarray) -> float:
        rms = float(np.sqrt(np.mean(frame * frame) + 1e-12))
        return 20.0 * np.log10(rms + 1e-12)

    def feed(self, pcm: np.ndarray) -> None:
        data = np.concatenate([self._residual, pcm.astype(np.float32)])
        n_frames = len(data) // self._frame_len
        for i in range(n_frames):
            frame = data[i * self._frame_len : (i + 1) * self._frame_len]
            db = self._frame_db(frame)
            is_speech = db > self._noise_floor + self.config.threshold_db
            if is_speech:
                self.in_speech = True
                self.speech_ms += self.config.frame_ms
                self.silence_run_ms = 0
            else:
                # adapt the noise floor toward quiet frames (slowly)
                self._noise_floor = 0.95 * self._noise_floor + 0.05 * db
                if self.in_speech:
                    self.silence_run_ms += self.config.frame_ms
        self._residual = data[n_frames * self._frame_len :]

    @property
    def utterance_ended(self) -> bool:
        return (
            self.in_speech
            and self.speech_ms >= self.config.min_speech_ms
            and self.silence_run_ms >= self.config.silence_ms
        )

    def reset(self) -> None:
        self._residual = np.zeros(0, np.float32)
        self.speech_ms = 0
        self.silence_run_ms = 0
        self.in_speech = False
