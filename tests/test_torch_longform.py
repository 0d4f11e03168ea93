"""Chunked long-form audio on the PyTorch port, held against wis_tpu on the
CPU: the chunking copy (``wis_tpu_torch/audio/chunking.py``), the ASR
program's on-device windows (``chunked=True``: packed int32 equal to
wis_tpu's and to the port's own program fed the host's windows), and the
engine's ``transcribe`` over 45 s and 75 s of audio — groups of
``concurrent_gpu_chunks`` windows, the first group's language inherited,
window texts LCS-merged — with text and translation equal to the JAX
engine's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    JAX_CFG,
    PORT_CFG,
    audio_i16,
    engine_pair,
    jax_params,
    port_params,
)
from wis_tpu.models.whisper.tokenizer import build_prompt
from wis_tpu_torch.audio import chunking
from wis_tpu_torch.decoding.fused import build_asr_program, pack_ctl

torch.set_num_threads(1)

MAX_NEW = 6


@pytest.mark.parametrize("seconds", [0.5, 22.0, 29.9, 30.5, 45.0, 75.0, 181.0])
def test_chunk_iter_and_count_equal(seconds):
    from wis_tpu.audio import chunking as jc

    audio = np.arange(int(seconds * 16000), dtype=np.float32)
    want = list(jc.chunk_iter(audio))
    got = list(chunking.chunk_iter(audio))
    assert [s for _, s in got] == [s for _, s in want]
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(got, want))
    assert chunking.num_chunks(audio.shape[0]) == jc.num_chunks(audio.shape[0])
    assert (chunking.CHUNK_LEN, chunking.STRIDE_LEFT, chunking.STRIDE_RIGHT) == (
        jc.CHUNK_LEN, jc.STRIDE_LEFT, jc.STRIDE_RIGHT)


def test_longest_common_sequence_merge_equal():
    from wis_tpu.audio import chunking as jc

    rng = np.random.default_rng(0)
    special = frozenset(range(50257, 51865))
    for trial in range(40):
        base = list(rng.integers(0, 60, 40))
        seqs = []
        for w in range(int(rng.integers(1, 5))):
            lo = w * 10 + int(rng.integers(0, 3))
            seq = base[lo: lo + 15 + int(rng.integers(0, 6))]
            if trial % 3 == 0:
                seq = [50257 + int(rng.integers(0, 1600))] + seq  # specials drop out
            seqs.append((seq, (0, 0, 0)))
        np.testing.assert_array_equal(
            chunking.find_longest_common_sequence(seqs, special),
            jc.find_longest_common_sequence(seqs, special))


def _prompts(n):
    return np.asarray([build_prompt("en")] * n, np.int32)


@pytest.mark.parametrize("beam,quant", [(1, False), (3, True)])
def test_chunked_program_packed_equal(beam, quant):
    """Three windows cut on the device from one segment: packed int32 equal
    to wis_tpu's chunked program, and bit-identical to the port's program
    fed the same windows cut on the host (chunk_iter + pad_or_trim)."""
    from wis_tpu.decoding.fused import build_asr_program as jax_program
    from wis_tpu_torch.audio.mel import N_SAMPLES

    batch = 3
    step = chunking.CHUNK_LEN - chunking.STRIDE_LEFT - chunking.STRIDE_RIGHT
    n_samp = (batch - 1) * step + chunking.CHUNK_LEN
    long_audio = audio_i16(n_samp, seed=11 + beam)[0]
    ctl = pack_ctl(_prompts(batch), np.zeros(batch, np.int32), MAX_NEW)
    kw = dict(beam_size=beam, batch=batch, max_new_tokens=MAX_NEW, prompt_len=4,
              suppress_tokens=(), begin_suppress_tokens=())
    want = np.asarray(jax_program(JAX_CFG, chunked=True, n_samples=n_samp, **kw)(
        jax_params(quant, emb_scale=16.0), jnp.asarray(long_audio), jnp.asarray(ctl)))
    tp = port_params(quant, emb_scale=16.0)
    got = build_asr_program(PORT_CFG, chunked=True, n_samples=n_samp, **kw)(
        tp, torch.from_numpy(long_audio), torch.from_numpy(ctl))
    np.testing.assert_array_equal(got.numpy(), want)

    windows = np.zeros((batch, N_SAMPLES), np.int16)
    for w in range(batch):
        seg = long_audio[w * step: w * step + chunking.CHUNK_LEN]
        windows[w, : seg.shape[0]] = seg
    host = build_asr_program(PORT_CFG, **kw)(tp, torch.from_numpy(windows), torch.from_numpy(ctl))
    assert torch.equal(got, host)


@pytest.fixture(scope="module")
def engines():
    return engine_pair()


@pytest.mark.parametrize(
    "seconds,translate,detect,seed",
    [(45.0, False, False, 45), (75.0, True, True, 75), (75.0, False, False, 76),
     (45.0, True, False, 46)],
)
def test_long_form_transcribe_equal(engines, seconds, translate, detect, seed):
    """Over 30 s with chunking on (the default): 4 windows (45 s, one
    group) or 6 (75 s, a second group that inherits the detected
    language); long mode's beam 5. Text, translation and language equal to
    the JAX engine's; the chunked program key (…, n_samples, chunked)."""
    jax_engine, port = engines
    audio = audio_i16(int(seconds * 16000), seed=seed)[0]
    kw = dict(beam_size=1, translate=translate, detect_language=detect, max_tokens=8)
    want = jax_engine.transcribe(audio, **kw)
    got = port.transcribe(audio, **kw)
    assert got.text and got.text == want.text
    assert got.translation == want.translation
    assert got.language == want.language
    assert got.audio_duration_ms == want.audio_duration_ms == int(seconds * 1000)
    chunked = {key for key in port._programs if key[-1]}
    assert chunked and all(key[1] == 5 and key[2] == 4 for key in chunked)
    assert chunked <= set(jax_engine._programs)  # the JAX engine's keys


def test_chunking_off_truncates(engines):
    """support_chunking=False: audio over 30 s is cut to its first window."""
    _, port = engines
    audio = audio_i16(31 * 16000, seed=31)[0]
    port.settings.support_chunking = False
    try:
        res = port.transcribe(audio, max_tokens=4)
        first = port.transcribe(audio[: 30 * 16000], max_tokens=4)
    finally:
        port.settings.support_chunking = True
    assert res.audio_duration_ms == 31_000 and res.text == first.text
