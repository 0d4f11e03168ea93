"""Whisper log-mel frontend (port of ``wis_tpu/audio/mel.py``).

The windowed real DFT is one float32 matmul of the reflect-padded frames
against the (400, 402) cos ‖ −sin basis with the periodic Hann window
folded in, then power, the slaney mel filterbank and the log floor.
Everything stays float32 at full precision: mel power spans ~9 orders of
magnitude, and bf16 or TF32 accumulation destroys the log floor
(``device.resolve_device`` turns TF32 off on the card).

``mel_filterbank`` and ``_stft_basis`` are numpy copies of the JAX
package's; a CPU test holds them equal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# Whisper audio hyperparameters
SAMPLE_RATE = 16000
N_FFT = 400
N_MELS = 80
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples / 30 s window


def pad_or_trim(array: np.ndarray, length: int = N_SAMPLES, *, axis: int = -1):
    """Zero-pad or trim host audio to the model's 30 s window."""
    n = array.shape[axis]
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if n < length:
        widths = [(0, 0)] * array.ndim
        widths[axis] = (0, length - n)
        return np.pad(array, widths)
    return array


def _hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freqs >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@lru_cache(maxsize=None)
def mel_filterbank(
    sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS
) -> np.ndarray:
    """(n_mels, n_fft//2+1) slaney-normalized triangular filterbank."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=None)
def _stft_basis(n_fft: int = N_FFT) -> tuple:
    """Windowed real-DFT basis matrices (cos, -sin), each
    (n_fft, n_fft//2+1), periodic Hann window folded in."""
    n = np.arange(n_fft)
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)  # periodic Hann
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def log_mel(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """audio (..., n_samples) float32 → log-mel (..., n_mels, n_frames)
    float32, on audio's device."""
    lead = audio.shape[:-1]
    n_samples = audio.shape[-1]
    x = audio.reshape(-1, 1, n_samples).float()
    pad = N_FFT // 2
    x = F.pad(x, (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)  # (B, T+1, n_fft)
    cos_b, sin_b = _stft_basis(N_FFT)
    basis = torch.from_numpy(np.concatenate([cos_b, sin_b], axis=1)).to(x.device)
    y = torch.matmul(frames, basis)  # (B, T+1, 402)
    nb = N_FFT // 2 + 1
    re, im = y[..., :nb], y[..., nb:]
    # drop the last frame, as the reference frontend does
    power = (re * re + im * im)[:, :-1].transpose(1, 2)  # (B, n_fft//2+1, T)
    filt = torch.from_numpy(mel_filterbank(SAMPLE_RATE, N_FFT, n_mels)).to(x.device)
    mel = torch.matmul(filt, power)  # (B, n_mels, T)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    # dynamic-range floor: max - 8, then scale to roughly [-1, 1]
    peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.reshape(*lead, *log_spec.shape[1:])
