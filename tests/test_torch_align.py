"""Word timestamps on the PyTorch port, held against wis_tpu on the CPU: the
teacher-forced alignment pass (``wis_tpu_torch/decoding/align.py``), its
host copies (alignment heads, DTW, word grouping), and the engine's
``word_timestamps=True`` words.

Tolerances: the alignment matrix within 1e-4 and the probabilities within
1e-5 (f32 on both sides, sums in another order; the per-head
normalization divides by a standard deviation over the tokens, which
scales the differences up). The words — text, start, end, probability —
must be equal."""

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
from wis_tpu.decoding import align as ja
from wis_tpu.models.whisper import model as jm
from wis_tpu.models.whisper.tokenizer import EOT, WhisperTokenizer, build_prompt
from wis_tpu_torch.decoding import align as ta
from wis_tpu_torch.models.whisper import model as tm
from wis_tpu_torch.models.whisper.tokenizer import WhisperTokenizer as PortTokenizer

torch.set_num_threads(1)

SEQ = 16


def _tokens(seed, n_text):
    rng = np.random.default_rng(seed)
    seq = np.full((1, SEQ), EOT, np.int32)
    seq[0, :4] = build_prompt("en")
    seq[0, 4:n_text] = rng.integers(0, 5000, n_text - 4)
    return seq


@pytest.mark.parametrize("n_text,quant", [(12, False), (9, True), (16, False)])
def test_align_program_matches_jax(n_text, quant):
    """From the same cross-KV: the (T, S) matrix and the next-token
    probabilities; rows past n_text are zero."""
    jp, tp = jax_params(quant), port_params(quant)
    rng = np.random.default_rng(n_text)
    mel = rng.standard_normal((1, JAX_CFG.n_mels, 3000)).astype(np.float32)
    j_xa = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(mel), JAX_CFG), JAX_CFG)
    with torch.inference_mode():
        t_xa = tm.cross_kv(tp, tm.encode(tp, torch.from_numpy(mel), PORT_CFG), PORT_CFG)
    heads = ja.default_alignment_heads(JAX_CFG)
    seq = _tokens(n_text, n_text)
    want_m, want_p = (np.asarray(a) for a in ja.build_align_program(
        JAX_CFG, seq_len=SEQ, heads=heads)(jp, j_xa, jnp.asarray(seq), jnp.int32(n_text)))
    got_m, got_p = (a.numpy() for a in ta.build_align_program(
        PORT_CFG, seq_len=SEQ, heads=ta.default_alignment_heads(PORT_CFG))(
        tp, t_xa, torch.from_numpy(seq), n_text))
    assert got_m.shape == (SEQ, JAX_CFG.n_audio_ctx) and got_p.shape == (SEQ,)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    assert not got_m[n_text:].any()
    assert np.abs(got_m[:n_text]).max() > 0.1


def test_align_from_audio_matches_jax():
    """The one-call variant from int16 audio (log-mel, encoder, cross-KV,
    then the pass), with the heads of an alignment_heads.json."""
    jp, tp = jax_params(False), port_params(False)
    audio = audio_i16(480000, seed=4)
    heads = np.zeros((JAX_CFG.n_text_layer, JAX_CFG.n_text_head), np.float32)
    heads[0, 1] = heads[1, 0] = 1.0
    seq = _tokens(5, 11)
    want = ja.build_align_from_audio(JAX_CFG, seq_len=SEQ, heads=heads)(
        jp, jnp.asarray(audio), jnp.asarray(seq), jnp.int32(11))
    got = ta.build_align_from_audio(PORT_CFG, seq_len=SEQ, heads=heads)(
        tp, torch.from_numpy(audio), torch.from_numpy(seq), 11)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_median_filter_follows_jnp_median():
    """The width-7 median over frames with the edge-clamped window."""
    x = np.random.default_rng(2).standard_normal((3, 5, 40)).astype(np.float32)
    s = x.shape[-1]
    widx = np.clip(np.arange(s)[None, :] + np.arange(-3, 4)[:, None], 0, s - 1)
    want = np.asarray(jnp.median(jnp.asarray(x)[:, :, widx], axis=2))
    np.testing.assert_array_equal(ta._median7(torch.from_numpy(x)).numpy(), want)


def test_alignment_heads_equal(tmp_path):
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS

    for size in ("tiny", "large-v2"):
        from wis_tpu.models.whisper.config import WHISPER_CONFIGS as J

        np.testing.assert_array_equal(ta.default_alignment_heads(WHISPER_CONFIGS[size]),
                                      ja.default_alignment_heads(J[size]))
    (tmp_path / "alignment_heads.json").write_text("[[0, 1], [1, 0]]")
    for d in (str(tmp_path), None, str(tmp_path / "missing")):
        np.testing.assert_array_equal(ta.load_alignment_heads(PORT_CFG, d),
                                      ja.load_alignment_heads(JAX_CFG, d))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dtw_and_words_equal(seed):
    """The host half is a held-equal copy: DTW paths, word groups (space
    and no-space languages) and words from a synthetic alignment."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((7, 30)).astype(np.float32)
    for a, b in zip(ta.dtw_path(m), ja.dtw_path(m)):
        np.testing.assert_array_equal(a, b)
    jt, tt = WhisperTokenizer(), PortTokenizer()
    ids = [int(i) for i in rng.integers(0, 3000, 9)] + [EOT]
    for lang in ("en", "ja"):
        assert ta.split_word_tokens(tt, ids, lang) == ja.split_word_tokens(jt, ids, lang)
    matrix = rng.standard_normal((SEQ, 1500)).astype(np.float32)
    probs = rng.uniform(0, 1, SEQ).astype(np.float32)
    for lang in ("en", "zh"):
        assert ta.words_from_alignment(tt, ids, matrix, probs, 4, 120, lang, 1.5) == (
            ja.words_from_alignment(jt, ids, matrix, probs, 4, 120, lang, 1.5))
    assert ta.words_from_alignment(tt, [EOT], matrix, probs, 4, 120) == []


@pytest.fixture(scope="module")
def engines():
    return engine_pair()


@pytest.mark.parametrize("seconds,beam,seed", [(2.5, 1, 8), (4.0, 5, 9)])
def test_transcribe_words_equal(engines, seconds, beam, seed):
    """word_timestamps=True: the words equal the JAX engine's, with the
    alignment call's span in the timings."""
    jax_engine, port = engines
    audio = audio_i16(int(seconds * 16000), seed=seed)[0]
    kw = dict(beam_size=beam, word_timestamps=True, max_tokens=8)
    want = jax_engine.transcribe(audio, **kw)
    got = port.transcribe(audio, **kw)
    assert got.text == want.text
    assert got.words and got.words == want.words
    assert "word_align" in got.timings
    assert any(key[1] == "align" for key in port._programs)
