"""Timestamp decoding on the PyTorch port, held against wis_tpu on the CPU:
``build_generate_xa(with_timestamps=True)`` on the eager and the fused
branch (the port's plain step and grammar head against the JAX kernels in
interpret mode), greedy and beams, v2 and v3 vocabulary layouts, token for
token; the engine's segments; and the host copies (``parse_segments``,
``all_special_ids``).

The narrowed cases allow only a few text and timestamp ids (the rest
suppressed), as tests/test_fused_decode.py does, so every grammar rule
fires within a few tokens and each decision's margin stands far above the
rounding in which the two sides may differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    JAX_CFG,
    PORT_CFG,
    V3_MICRO,
    audio_i16,
    engine_pair,
    jax_params,
    np_tree,
    port_params,
)
from wis_tpu.decoding.beam import build_generate_xa as jax_generate
from wis_tpu.models.whisper import model as jm
from wis_tpu.models.whisper.tokenizer import EOT, V2_LAYOUT, V3_LAYOUT, build_prompt
from wis_tpu_torch.decoding import beam as beam_mod
from wis_tpu_torch.models.whisper import model as tm

torch.set_num_threads(1)

EMB_SCALE = 16.0
TS = V2_LAYOUT.timestamp_base
#: a few text ids and timestamps (with an open-pair equality candidate)
ALLOWED = (100, 200, 300, TS + 40, TS + 80, TS + 120, TS + 121)


def _narrow(n_vocab, allowed):
    return tuple(i for i in range(n_vocab) if i not in allowed)


def _assert_equal(got, want, rtol):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=rtol)


def _timestamps(tokens, base):
    return [int(t) for t in tokens if base <= int(t)]


@pytest.mark.parametrize("beam,narrow", [(1, False), (5, False), (1, True), (5, True)])
def test_eager_generate_with_timestamps_token_equal(beam, narrow):
    """The eager branch's grammar masks, f32 weights: tokens, lengths and
    best equal, scores to 1e-5 relative; the first token is a timestamp of
    at most 1 s and the timestamps never decrease."""
    jp = jax_params(False, emb_scale=EMB_SCALE)
    tp = port_params(False, emb_scale=EMB_SCALE)
    rng = np.random.default_rng(beam + 10 * narrow)
    mel = rng.standard_normal((1, JAX_CFG.n_mels, 3000)).astype(np.float32)
    j_xa = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(mel), JAX_CFG), JAX_CFG)
    with torch.inference_mode():
        t_xa = tm.cross_kv(tp, tm.encode(tp, torch.from_numpy(mel), PORT_CFG), PORT_CFG)
    prompt = np.asarray(build_prompt("en", notimestamps=False), np.int32)
    kw = dict(beam_size=beam, batch=1, max_new_tokens=10, prompt_len=3,
              suppress_tokens=_narrow(JAX_CFG.n_vocab, ALLOWED) if narrow else (50258,),
              begin_suppress_tokens=(220, EOT), with_timestamps=True)
    want = jax_generate(JAX_CFG, **kw)(jp, j_xa, jnp.asarray(prompt), jnp.int32(10))
    with torch.inference_mode():
        got = beam_mod.build_generate_xa(PORT_CFG, **kw)(tp, t_xa, torch.from_numpy(prompt), 10)
    _assert_equal(got, want, 1e-5)
    best = got.tokens[0, int(got.best[0])].numpy()
    assert TS <= best[0] <= TS + 50
    ts = _timestamps(best[: int(got.lengths[0, int(got.best[0])])], TS)
    assert all(a <= b for a, b in zip(ts, ts[1:]))
    if narrow:
        assert len(ts) >= 3  # pairs open and close


def test_v3_layout_generate_with_timestamps_token_equal():
    """The grammar in the v3 id space (timestamps one id higher, 128 mel
    bins), beams of two."""
    from wis_tpu.models.whisper.config import WhisperConfig as JaxConfig
    from wis_tpu.models.whisper.weights import random_params
    from wis_tpu_torch.models.whisper.config import WhisperConfig
    from wis_tpu_torch.models.whisper.weights import params_from_jax

    jcfg, tcfg = JaxConfig(**V3_MICRO), WhisperConfig(**V3_MICRO)
    jp = random_params(jcfg, seed=7, dtype=jnp.float32)
    dec = dict(jp["decoder"], tok_emb=jp["decoder"]["tok_emb"] * EMB_SCALE)
    jp = dict(jp, decoder=dec)
    tp = params_from_jax(np_tree(jp), "cpu")
    mel = np.random.default_rng(0).standard_normal((1, 128, 3000)).astype(np.float32)
    j_xa = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(mel), jcfg), jcfg)
    with torch.inference_mode():
        t_xa = tm.cross_kv(tp, tm.encode(tp, torch.from_numpy(mel), tcfg), tcfg)
    prompt = np.asarray(build_prompt("en", notimestamps=False, layout=V3_LAYOUT), np.int32)
    kw = dict(beam_size=2, batch=1, max_new_tokens=10, prompt_len=3, suppress_tokens=(),
              begin_suppress_tokens=(220, EOT), with_timestamps=True)
    want = jax_generate(jcfg, **kw)(jp, j_xa, jnp.asarray(prompt), jnp.int32(10))
    with torch.inference_mode():
        got = beam_mod.build_generate_xa(tcfg, **kw)(tp, t_xa, torch.from_numpy(prompt), 10)
    _assert_equal(got, want, 1e-5)
    assert got.tokens[0, int(got.best[0]), 0] >= V3_LAYOUT.timestamp_base


def _fused_trees():
    from wis_tpu.ops.fused_decode import pack_decoder as jax_pack
    from wis_tpu_torch.ops.fused_decode import pack_decoder

    jp = jax_params(True, seed=2, emb_scale=EMB_SCALE, dtype="bfloat16")
    tp = port_params(True, seed=2, emb_scale=EMB_SCALE, dtype="bfloat16")
    return jp, tp, jax.jit(lambda p: jax_pack(p, JAX_CFG))(jp), pack_decoder(tp, PORT_CFG)


@pytest.mark.parametrize("beam,batch", [(1, 1), (5, 1), (2, 2)])
def test_fused_generate_with_timestamps_token_equal(beam, batch):
    """The fused branch with the grammar head (int8 table, int8 cross-KV):
    the port's plain step and head against the JAX kernels in interpret
    mode; tokens, lengths and best equal, scores to 2⁻⁷ relative (bf16
    caches)."""
    jp, tp, jpk, tpk = _fused_trees()
    rng = np.random.default_rng(beam + batch)
    L, H = JAX_CFG.n_text_layer, JAX_CFG.n_text_head
    shape = (L, batch, H, JAX_CFG.n_text_state // H, JAX_CFG.n_audio_ctx)
    xa = [rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2)]
    prompt = np.asarray([build_prompt("en", notimestamps=False),
                         build_prompt("de", notimestamps=False)][:batch], np.int32)
    kw = dict(beam_size=beam, batch=batch, max_new_tokens=8, prompt_len=3,
              suppress_tokens=_narrow(JAX_CFG.n_vocab, ALLOWED), begin_suppress_tokens=(),
              with_timestamps=True, fused=True, xa_int8=True)
    want = jax_generate(JAX_CFG, **kw)(
        jp, jpk, tuple(jnp.asarray(a, jnp.bfloat16) for a in xa), jnp.asarray(prompt),
        jnp.int32(8))
    with torch.inference_mode():
        got = beam_mod.build_generate_xa(PORT_CFG, **kw)(
            tp, tpk, tuple(torch.from_numpy(a).to(torch.bfloat16) for a in xa),
            torch.from_numpy(prompt), 8)
    _assert_equal(got, want, 2.0 ** -7)
    toks = got.tokens.numpy()
    assert (toks[:, :, 0] >= TS).all()
    assert set(np.unique(toks)) <= set(ALLOWED) | {EOT}
    assert len(_timestamps(toks[0, int(got.best[0])], TS)) >= 3


@pytest.fixture(scope="module")
def engines():
    return engine_pair()


@pytest.mark.parametrize("seconds,beam,seed", [(2.0, 1, 3), (5.0, 5, 5)])
def test_transcribe_segments_equal(engines, seconds, beam, seed):
    """The engine's timestamps=True: segments and text equal to the JAX
    engine's; the program key records the timestamp variant."""
    jax_engine, port = engines
    audio = audio_i16(int(seconds * 16000), seed=seed)[0]
    kw = dict(beam_size=beam, timestamps=True, max_tokens=8)
    want = jax_engine.transcribe(audio, **kw)
    got = port.transcribe(audio, **kw)
    assert got.segments is not None and got.segments == want.segments
    assert got.text == want.text
    assert any(key[6] for key in port._programs)  # (…, translate, timestamps, …)
    for seg in got.segments:
        assert 0.0 <= seg["start"] <= 30.0 and 0.0 <= seg["end"] <= 30.0


def test_segment_parsing_and_special_ids_equal():
    """The tokenizer's timestamp half is a held-equal copy."""
    from wis_tpu.models.whisper import tokenizer as jt
    from wis_tpu_torch.models.whisper import tokenizer as tt

    for lay in (V2_LAYOUT, V3_LAYOUT):
        jtok, ttok = jt.WhisperTokenizer(layout=lay), tt.WhisperTokenizer(
            layout=tt.layout_for_vocab(lay.n_vocab))
        assert ttok.all_special_ids == jtok.all_special_ids
        b = lay.timestamp_base
        for ids in ([b, 100, 200, b + 50, b + 50, 300, b + 75, EOT, 7],
                    [400, 401, b + 3],
                    [b + 1, 500, 501],
                    [],
                    [b, b + 5, 600, EOT]):
            assert tt.parse_segments(ttok, ids) == jt.parse_segments(jtok, ids)
