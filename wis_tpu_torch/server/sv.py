"""Speaker verification service, the host half (a copy of
``wis_tpu/server/sv.py`` without its HTTP route).

The reference's ``do_sv``: load audio → sox effects (norm, trim to 10 s) →
WavLM x-vector embedding → cosine similarity against the enrolled
``<sv_speaker_dir>/*.npy`` → {name: score} at or above the threshold
(0.75), sorted descending. The sox ``norm 8`` / ``trim 0 10`` chain is
plain numpy (peak-normalize to -8 dBFS, keep 10 s).

The default embedder is the port's WavLM x-vector
(``wis_tpu_torch.models.wavlm``), on the card unless the caller asks for
the CPU; an ``embed_fn`` may be passed instead. The ``/api/sv`` route stays
``wis_tpu``'s; this module imports neither aiohttp nor pydantic.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Dict, Optional

import numpy as np

from wis_tpu_torch.audio.mel import SAMPLE_RATE
from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.settings import APISettings

logger = logging.getLogger("wis_tpu_torch")

#: speaker names become filenames in the enrolment store: a safe charset,
#: so that ``enroll=../../x`` can never leave the directory
_SPEAKER_NAME_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def valid_speaker_name(name: Optional[str]) -> bool:
    return bool(name) and bool(_SPEAKER_NAME_RE.match(name))


def wavlm_dir(settings: Optional[APISettings] = None) -> str:
    """The WavLM checkpoint directory: <model_dir>/wavlm-base-plus-sv (the
    whisper sizes live at <model_dir>/<size> the same way)."""
    settings = settings or APISettings()
    return os.path.join(settings.model_dir, "wavlm-base-plus-sv")


def sv_weights_present(settings: Optional[APISettings] = None) -> bool:
    """True iff a WavLM checkpoint exists: the test behind support_sv's auto
    mode (a random-weight embedder only produces meaningless scores)."""
    d = wavlm_dir(settings)
    return os.path.isdir(d) and any(
        f.endswith((".safetensors", ".npz")) for f in os.listdir(d)
    )


def sox_norm_trim(audio: np.ndarray, db: float = -8.0, seconds: float = 10.0) -> np.ndarray:
    """The reference's sox effect chain: ``norm 8`` peak-normalizes to
    -8 dBFS; ``trim 0 10`` keeps 10 s."""
    audio = audio[: int(seconds * SAMPLE_RATE)]
    peak = np.abs(audio).max()
    if peak > 0:
        target = 10.0 ** (db / 20.0)
        audio = audio * (target / peak)
    return audio.astype(np.float32)


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class SpeakerVerifier:
    """The enrolled-speaker store and its scoring. The embedding function is
    injected, or the port's WavLM x-vector from ``wavlm_dir(settings)`` on
    ``device``, loaded at first use."""

    def __init__(self, settings: Optional[APISettings] = None, embed_fn=None,
                 device: DeviceLike = "cuda"):
        self.settings = settings or APISettings()
        self._embed_fn = embed_fn
        self._device = device
        self._lock = threading.Lock()
        self.speaker_dir = self.settings.sv_speaker_dir

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        if self._embed_fn is None:
            with self._lock:
                if self._embed_fn is None:
                    from wis_tpu_torch.models.wavlm import default_embedder

                    self._embed_fn = default_embedder(wavlm_dir(self.settings), self._device)
        return np.asarray(self._embed_fn(sox_norm_trim(audio))).reshape(-1)

    def enrolled(self) -> Dict[str, np.ndarray]:
        out = {}
        if os.path.isdir(self.speaker_dir):
            for fname in sorted(os.listdir(self.speaker_dir)):
                if fname.endswith(".npy"):
                    out[fname[:-4]] = np.load(os.path.join(self.speaker_dir, fname)).reshape(-1)
        return out

    def enroll(self, name: str, audio: np.ndarray) -> np.ndarray:
        if not valid_speaker_name(name):
            raise ValueError(f"invalid speaker name {name!r}")
        emb = self._embed(audio)
        os.makedirs(self.speaker_dir, exist_ok=True)
        np.save(os.path.join(self.speaker_dir, f"{name}.npy"), emb)
        logger.info("SV: enrolled speaker %s", name)
        return emb

    def verify(self, audio: np.ndarray) -> Dict[str, float]:
        """{speaker: score} for every enrolled speaker at or above the
        threshold, sorted descending."""
        emb = self._embed(audio)
        scores = {name: cosine(emb, ref) for name, ref in self.enrolled().items()}
        return {
            k: round(v, 4)
            for k, v in sorted(scores.items(), key=lambda kv: -kv[1])
            if v >= self.settings.sv_threshold
        }
