"""ctypes binding to the native wisaudio codec/DSP library (port of
``wis_tpu/audio/codecs.py``).

The library is the repo's ``native/wisaudio`` C++ sources (FLAC, WAV, raw
PCM, µ-law/A-law, MP3 and Ogg through the system decoders, windowed-sinc
resampling, mixdown). The port builds its own copy at first use with
``g++`` and the Makefile's flags, into
``build/wis_tpu_torch/wisaudio/<hash of the sources and flags>/libwisaudio.so``
beside the package (listed in ``.gitignore``), so it never writes the JAX
package's ``native/libwisaudio.so``; the same sources and flags give the
same library. A pure-Python WAV/PCM fallback (the resampler is
``audio/resample.py``) keeps ingest working where no C++ compiler is
present; FLAC, MP3 and Ogg need the native library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("wis_tpu_torch")

_REPO = Path(__file__).resolve().parents[2]
_SOURCES_DIR = _REPO / "native" / "wisaudio"
_SOURCES = ("flac.cc", "wav.cc", "resample.cc", "sysdec.cc")
#: native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared", "-ldl")
BUILD_ROOT = _REPO / "build" / "wis_tpu_torch" / "wisaudio"

_lib = None
_lib_lock = threading.Lock()


class CodecError(RuntimeError):
    pass


def library_path() -> Path:
    """Where this tree's sources and flags build the library."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in sorted((*_SOURCES, "wisaudio.h")):
        h.update(name.encode())
        h.update((_SOURCES_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libwisaudio.so"


def _build_library(out: Path) -> bool:
    """g++ over the four sources into ``out``; other processes building
    the same hash wait on a file lock, and the library appears whole."""
    if not all((_SOURCES_DIR / n).is_file() for n in _SOURCES):
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():
            return True
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(str(_SOURCES_DIR / n) for n in _SOURCES)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            return True
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
            logger.warning("CODECS: native build failed: %s", e)
            return False
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file() and not _build_library(path):
            return None
        lib = ctypes.CDLL(str(path))
        c_float_p = ctypes.POINTER(ctypes.c_float)
        for name in (
            "wisaudio_decode_flac",
            "wisaudio_decode_wav",
            "wisaudio_decode_mp3",
            "wisaudio_decode_ogg",
        ):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(c_float_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            fn.restype = ctypes.c_int
        lib.wisaudio_pcm_to_float.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int32,
            ctypes.POINTER(c_float_p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wisaudio_pcm_to_float.restype = ctypes.c_int
        lib.wisaudio_resample.argtypes = [
            c_float_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(c_float_p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wisaudio_resample.restype = ctypes.c_int
        lib.wisaudio_mix_to_mono.argtypes = [
            c_float_p,
            ctypes.c_int64,
            ctypes.c_int32,
            c_float_p,
        ]
        lib.wisaudio_mix_to_mono.restype = ctypes.c_int
        lib.wisaudio_free.argtypes = [ctypes.c_void_p]
        lib.wisaudio_free.restype = None
        _lib = lib
        logger.info("CODECS: loaded native library %s", path)
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def _take_buffer(lib, ptr, n: int) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.wisaudio_free(ptr)
    return arr


def _decode_via(fn_name: str, data: bytes) -> Tuple[np.ndarray, int, int]:
    lib = _load_library()
    if lib is None:
        raise CodecError("native wisaudio library unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = getattr(lib, fn_name)(
        data,
        len(data),
        ctypes.byref(out),
        ctypes.byref(n_frames),
        ctypes.byref(channels),
        ctypes.byref(sr),
    )
    if rc != 0:
        raise CodecError(f"{fn_name} failed with code {rc}")
    pcm = _take_buffer(lib, out, n_frames.value * channels.value)
    return pcm.reshape(n_frames.value, channels.value), channels.value, sr.value


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int]:
    """FLAC bytes → ((frames, channels) float32, channels, sample_rate)."""
    return _decode_via("wisaudio_decode_flac", data)


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int, int]:
    """MP3 bytes → ((frames, channels) float32, channels, sample_rate),
    through the system libmpg123; CodecError(-5) when the host lacks it."""
    return _decode_via("wisaudio_decode_mp3", data)


def decode_ogg(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Ogg bytes (Vorbis / Opus / Ogg-FLAC) → ((frames, channels)
    float32, channels, sample_rate)."""
    return _decode_via("wisaudio_decode_ogg", data)


def decode_wav(data: bytes) -> Tuple[np.ndarray, int, int]:
    """WAV bytes → ((frames, channels) float32, channels, sample_rate)."""
    if native_available():
        return _decode_via("wisaudio_decode_wav", data)
    return _decode_wav_python(data)


def pcm_to_float(data: bytes, bits: int) -> np.ndarray:
    """Raw signed little-endian PCM → float32 (the Willow "pcm" codec)."""
    lib = _load_library()
    if lib is None:
        return _pcm_to_float_python(data, bits)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.wisaudio_pcm_to_float(
        data, len(data), bits, ctypes.byref(out), ctypes.byref(n)
    )
    if rc != 0:
        raise CodecError(f"pcm_to_float failed with code {rc}")
    return _take_buffer(lib, out, n.value)


def mix_to_mono(pcm: np.ndarray) -> np.ndarray:
    """(frames, channels) → (frames,) mean mixdown."""
    pcm = np.ascontiguousarray(pcm, dtype=np.float32)
    if pcm.ndim == 1 or pcm.shape[1] == 1:
        return pcm.reshape(-1)
    lib = _load_library()
    if lib is None:
        return pcm.mean(axis=1)
    out = np.empty(pcm.shape[0], dtype=np.float32)
    rc = lib.wisaudio_mix_to_mono(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pcm.shape[0],
        pcm.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise CodecError(f"mix_to_mono failed with code {rc}")
    return out


def resample(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Mono float32 resample via the native windowed-sinc kernel."""
    pcm = np.ascontiguousarray(pcm, dtype=np.float32).reshape(-1)
    if sr_in == sr_out:
        return pcm
    lib = _load_library()
    if lib is None:
        return _resample_python(pcm, sr_in, sr_out)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.wisaudio_resample(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pcm.shape[0],
        sr_in,
        sr_out,
        ctypes.byref(out),
        ctypes.byref(n),
    )
    if rc != 0:
        raise CodecError(f"resample failed with code {rc}")
    return _take_buffer(lib, out, n.value)


# --------------------------------------------------------------------------- #
# Pure-Python fallbacks (no FLAC, MP3 or Ogg — those need the native library)
# --------------------------------------------------------------------------- #
def _decode_wav_python(data: bytes) -> Tuple[np.ndarray, int, int]:
    import io
    import wave

    with wave.open(io.BytesIO(data), "rb") as w:
        nch = w.getnchannels()
        sr = w.getframerate()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128.0
    elif width == 4:
        pcm = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise CodecError(f"unsupported WAV sample width {width}")
    return pcm.reshape(-1, nch), nch, sr


def _pcm_to_float_python(data: bytes, bits: int) -> np.ndarray:
    if bits == 16:
        return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 8:
        return np.frombuffer(data, dtype=np.int8).astype(np.float32) / 128.0
    if bits == 32:
        return np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    raise CodecError(f"unsupported PCM bit depth {bits}")


def _resample_python(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    from wis_tpu_torch.audio.resample import resample as resample_poly

    return resample_poly(pcm, sr_in, sr_out)
