"""The port's server-side VAD (``wis_tpu_torch/audio/vad.py``) held against
``wis_tpu.audio.vad`` on the JAX tests' signals (tests/test_vad.py): the
same per-frame decisions, noise floor and endpoint, fed in chunks of any
size."""

import dataclasses

import numpy as np
import pytest

from test_vad import _silence, _speech
from wis_tpu.audio.vad import EnergyVAD as JaxVAD
from wis_tpu.audio.vad import VADConfig as JaxConfig
from wis_tpu_torch.audio.vad import EnergyVAD, VADConfig


def _state(vad):
    return (vad.in_speech, vad.speech_ms, vad.silence_run_ms, vad._noise_floor,
            vad.utterance_ended, vad._residual.shape[0])


def _run_both(signal, chunk, sample_rate=16000, **cfg):
    port = EnergyVAD(VADConfig(**cfg), sample_rate=sample_rate)
    ref = JaxVAD(JaxConfig(**cfg), sample_rate=sample_rate)
    trace = []
    for i in range(0, len(signal), chunk):
        port.feed(signal[i:i + chunk])
        ref.feed(signal[i:i + chunk])
        assert _state(port) == _state(ref), i
        trace.append(_state(port))
    return port, ref, trace


def test_config_defaults_equal():
    assert dataclasses.asdict(VADConfig()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("chunk", [160, 480, 1000, 1600, 16000])
def test_same_decisions_and_endpoint(chunk):
    signal = np.concatenate([_silence(200), _speech(400), _silence(400)])
    port, _, trace = _run_both(signal, chunk, silence_ms=300, min_speech_ms=100)
    assert port.utterance_ended and trace[-1][0]


def test_short_blip_never_ends():
    signal = np.concatenate([_speech(60), _silence(500)])
    port, _, trace = _run_both(signal, 320, silence_ms=300, min_speech_ms=200)
    assert not any(t[4] for t in trace)


def test_frame_decisions_one_frame_at_a_time():
    """Every 30 ms frame's energy and speech decision, frame by frame,
    over a signal that crosses the threshold both ways twice."""
    signal = np.concatenate([_silence(300, seed=2), _speech(450, amp=0.05, seed=3),
                             _silence(240, amp=0.01, seed=4), _speech(300, seed=5),
                             _silence(900, seed=6)])
    port = EnergyVAD()
    ref = JaxVAD()
    frame = port._frame_len
    for i in range(0, len(signal) - frame + 1, frame):
        f = signal[i:i + frame]
        assert port._frame_db(f) == ref._frame_db(f)
        port.feed(f)
        ref.feed(f)
        assert _state(port) == _state(ref)
    assert port.utterance_ended


def test_other_rates_and_reset():
    signal = np.repeat(np.concatenate([_speech(300), _silence(800)]), 3)  # 48 kHz
    port, ref, _ = _run_both(signal, 960, sample_rate=48000)
    assert port._frame_len == ref._frame_len == 1440
    assert port.utterance_ended
    port.reset()
    ref.reset()
    assert _state(port) == _state(ref)
    assert not port.utterance_ended and not port.in_speech
