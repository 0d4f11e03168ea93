"""Polyphase resampling of a mono float32 signal (a copy of
``wis_tpu/audio/codecs.py`` ``_resample_python``; the port cannot import
``wis_tpu.audio``). XTTS uses it for ``speed != 1.0``."""

from __future__ import annotations

from math import gcd

import numpy as np


def resample(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Mono float32 resample from sr_in to sr_out (scipy's polyphase
    filter)."""
    from scipy.signal import resample_poly

    pcm = np.ascontiguousarray(pcm, dtype=np.float32).reshape(-1)
    if sr_in == sr_out:
        return pcm
    g = gcd(sr_in, sr_out)
    return resample_poly(pcm, sr_out // g, sr_in // g).astype(np.float32)
