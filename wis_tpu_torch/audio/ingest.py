"""Audio ingest: arbitrary upload bytes → 16 kHz mono float32 PCM (port
of ``wis_tpu/audio/ingest.py``).

Sniff the container, decode with the native wisaudio library
(``audio/codecs.py``), downmix, resample to the model rate. Host work
only: the card sees the resulting samples.
"""

from __future__ import annotations

import io
import logging
import struct
import wave
from typing import Optional

import numpy as np

from wis_tpu_torch.audio import codecs
from wis_tpu_torch.audio.mel import SAMPLE_RATE

logger = logging.getLogger("wis_tpu_torch")


class IngestError(ValueError):
    pass


def sniff_format(data: bytes) -> str:
    if len(data) >= 4 and data[:4] == b"fLaC":
        return "flac"
    if len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if len(data) >= 3 and (data[:3] == b"ID3" or data[:2] in (b"\xff\xfb", b"\xff\xf3", b"\xff\xf2")):
        return "mp3"
    if len(data) >= 4 and data[:4] == b"OggS":
        return "ogg"
    return "unknown"


def load_audio(
    data: bytes,
    target_sr: int = SAMPLE_RATE,
    codec: Optional[str] = None,
    sample_rate: Optional[int] = None,
    bits: Optional[int] = None,
    channels: Optional[int] = None,
) -> np.ndarray:
    """Decode ``data`` to mono float32 at ``target_sr``.

    codec: explicit stream type (the Willow x-audio-codec header). None →
    sniff the container.
    sample_rate/bits/channels: required for codec="pcm" raw streams.
    """
    kind = (codec or "").lower() or sniff_format(data)

    if kind == "pcm":
        if not (sample_rate and bits and channels):
            raise IngestError("raw PCM requires sample_rate, bits, channels")
        pcm = codecs.pcm_to_float(data, bits)
        if channels > 1:
            pcm = codecs.mix_to_mono(pcm.reshape(-1, channels))
        return codecs.resample(pcm, sample_rate, target_sr)

    decoders = {
        "wav": codecs.decode_wav,
        "flac": codecs.decode_flac,
        "mp3": codecs.decode_mp3,
        "ogg": codecs.decode_ogg,
    }
    if kind not in decoders:
        raise IngestError(f"unsupported audio format: {kind}")
    try:
        pcm, nch, sr = decoders[kind](data)
    except codecs.CodecError as e:
        raise IngestError(f"{kind} decode failed: {e}") from e

    mono = codecs.mix_to_mono(pcm)
    return codecs.resample(mono, sr, target_sr)


def duration_ms(audio: np.ndarray, sr: int = SAMPLE_RATE) -> int:
    return int(audio.shape[-1] / sr * 1000)


def pcm_to_wav_bytes(
    pcm: np.ndarray, sr: int = SAMPLE_RATE, bits: int = 16
) -> bytes:
    """float32 mono → WAV container bytes (save_audio, TTS emission)."""
    if bits != 16:
        raise IngestError("only 16-bit WAV export supported")
    clipped = np.clip(pcm, -1.0, 1.0)
    ints = (clipped * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(ints.tobytes())
    return buf.getvalue()


def wav_stream_header(sr: int = SAMPLE_RATE, bits: int = 16, channels: int = 1) -> bytes:
    """A WAV header with unknown (max) data length, for chunked streaming
    responses."""
    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 0xFFFFFFFF),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, 1, channels, sr, byte_rate, block_align, bits),
            b"data",
            struct.pack("<I", 0xFFFFFFFF),
        ]
    )
