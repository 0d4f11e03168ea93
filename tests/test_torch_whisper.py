"""PyTorch port: the whisper model and language detect, held against the
JAX package on the CPU with f32 weights from ``wis_tpu``'s own
``random_params``, carried over by the bridge.

Tolerances: 1e-5 on single-stage f32 outputs, 1e-4 through a whole
encoder or decoder stack (the same f32 math in another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import JAX_CFG, PORT_CFG, jax_params, port_params, to_np
from wis_tpu.models.whisper import model as jm
from wis_tpu.models.whisper.tokenizer import build_prompt
from wis_tpu_torch.models.whisper import model as tm

torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(11)
    return rng.standard_normal((B, JAX_CFG.n_mels, 3000)).astype(np.float32)


@pytest.fixture(
    scope="module",
    params=[(False, 1.0), (True, 1.0), (False, 16.0), (True, 16.0)],
    ids=["f32", "int8", "f32-wide-emb", "int8-wide-emb"],
)
def both(request, mel):
    """(jax params, port params, jax xa_kv, port xa_kv) for one weight set;
    the wide-embedding sets are the ones tests/test_torch_slice.py decodes
    token for token."""
    quant, emb_scale = request.param
    jp = jax_params(quant, emb_scale=emb_scale)
    tp = port_params(quant, emb_scale=emb_scale)
    j_xa = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(mel), JAX_CFG), JAX_CFG)
    with torch.inference_mode():
        t_xa = tm.cross_kv(tp, tm.encode(tp, torch.from_numpy(mel), PORT_CFG), PORT_CFG)
    return jp, tp, j_xa, t_xa


def test_encode_matches(mel):
    jp, tp = jax_params(), port_params()
    want = jm.encode(jp, jnp.asarray(mel), JAX_CFG)
    got = tm.encode(tp, torch.from_numpy(mel), PORT_CFG)
    assert got.shape == (B, 1500, JAX_CFG.n_audio_state)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4, rtol=1e-4)


def test_cross_kv_time_minor_matches(both):
    _, _, (jk, jv), (tk, tv) = both
    L, H = JAX_CFG.n_text_layer, JAX_CFG.n_text_head
    assert tk.shape == (L, B, H, JAX_CFG.n_text_state // H, 1500)
    np.testing.assert_allclose(to_np(tk), to_np(jk), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(tv), to_np(jv), atol=1e-4, rtol=1e-4)


def _prefill_both(both, max_len=12):
    jp, tp, j_xa, t_xa = both
    prompt = np.asarray([build_prompt("en"), build_prompt("de", "translate")], np.int32)
    j_cache = jm.DecoderCache.zeros(JAX_CFG, B, max_len, jnp.float32)
    t_cache = tm.DecoderCache.zeros(PORT_CFG, B, max_len, torch.float32, torch.device("cpu"))
    j_logits, j_cache = jm.prefill(jp, jnp.asarray(prompt), j_cache, j_xa, JAX_CFG)
    with torch.inference_mode():
        t_logits, t_cache = tm.prefill(tp, torch.from_numpy(prompt).long(), t_cache, t_xa, PORT_CFG)
    return (j_logits, j_cache), (t_logits, t_cache)


def test_prefill_logits_and_cache_match(both):
    (j_logits, j_cache), (t_logits, t_cache) = _prefill_both(both)
    assert t_logits.shape == (B, 4, JAX_CFG.n_vocab) and t_logits.dtype == torch.float32
    assert t_cache.pos == int(j_cache.pos) == 4
    np.testing.assert_allclose(to_np(t_logits), to_np(j_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(t_cache.k), to_np(j_cache.k), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(t_cache.v), to_np(j_cache.v), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ancestry", [False, True])
def test_decode_step_matches(both, ancestry):
    """Two decode steps on K=2 beams per sequence; with ancestry the second
    step reads a re-parented map (beam 1 continues beam 0's history)."""
    jp, tp, j_xa, t_xa = both
    K, max_len = 2, 12
    (_, j_cache), (_, t_cache) = _prefill_both(both, max_len)
    j_cache = jm.DecoderCache(
        jnp.repeat(j_cache.k, K, axis=1), jnp.repeat(j_cache.v, K, axis=1), j_cache.pos
    )
    t_cache = tm.DecoderCache(
        t_cache.k.repeat_interleave(K, dim=1), t_cache.v.repeat_interleave(K, dim=1),
        t_cache.pos,
    )
    anc = np.where(np.arange(max_len)[None, None] < 4, np.arange(K)[None, :, None], -1)
    anc = np.broadcast_to(anc, (B, K, max_len)).astype(np.int32).copy()
    steps = [np.asarray([[220, 440], [1000, 7]]), np.asarray([[13, 13], [50, 51]])]
    for i, tokens in enumerate(steps):
        if ancestry:
            anc[:, :, 4 + i] = np.arange(K)
            if i == 1:
                anc[:, 1, : 4 + i] = anc[:, 0, : 4 + i]  # beam 1 re-parents to 0
        j_anc = jnp.asarray(anc) if ancestry else None
        t_anc = torch.from_numpy(anc).long() if ancestry else None
        flat = tokens.reshape(B * K)
        j_logits, j_cache = jm.decode_step(jp, jnp.asarray(flat), j_cache, j_xa, JAX_CFG, anc=j_anc)
        with torch.inference_mode():
            t_logits, t_cache = tm.decode_step(
                tp, torch.from_numpy(flat).long(), t_cache, t_xa, PORT_CFG, anc=t_anc
            )
        assert t_logits.shape == (B * K, JAX_CFG.n_vocab)
        np.testing.assert_allclose(to_np(t_logits), to_np(j_logits), atol=1e-4, rtol=1e-4)
    assert t_cache.pos == int(j_cache.pos) == 6
    np.testing.assert_allclose(to_np(t_cache.k), to_np(j_cache.k), atol=1e-4, rtol=1e-4)


def test_detect_from_kv_matches(both):
    from wis_tpu.decoding.detect import _detect_from_kv as jax_detect
    from wis_tpu_torch.decoding.detect import _detect_from_kv

    jp, tp, j_xa, t_xa = both
    j_idx, j_prob = jax_detect(jp, j_xa, JAX_CFG)
    with torch.inference_mode():
        t_idx, t_prob = _detect_from_kv(tp, t_xa, PORT_CFG)
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(to_np(t_idx), to_np(j_idx))
    np.testing.assert_allclose(to_np(t_prob), to_np(j_prob), atol=1e-5, rtol=1e-5)
