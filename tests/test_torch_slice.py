"""PyTorch port end to end: the ASR program, beam search, the engine's
``transcribe`` and ``POST /api/asr``, held against the JAX package's
non-fused program and engine on the CPU, on one shared weight set.

Decoding is compared token for token (packed int32 equal). A token-exact
comparison only means something when no decision is a near-tie, so the
program test also asserts, for every decode step the port ran, that each
row's top-2 margin and its candidate-set boundary (the KC-th vs the
(KC+1)-th suppressed logit) stand above the 1e-4 logits tolerance that
tests/test_torch_whisper.py holds the decoder to at the same weights.
(The order of near-equal totals across beams in the 2K pool is not
checked this way.)"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    JAX_CFG,
    PORT_CFG,
    audio_i16,
    jax_params,
    port_params,
    wav_bytes,
)
from wis_tpu.decoding.fused import build_asr_program as jax_program
from wis_tpu.models.whisper.tokenizer import (
    DEFAULT_BEGIN_SUPPRESS,
    DEFAULT_SUPPRESS_TOKENS,
    build_prompt,
)
from wis_tpu_torch.decoding import beam as beam_mod
from wis_tpu_torch.decoding.fused import build_asr_program, pack_ctl, packed_width

torch.set_num_threads(1)

LOGITS_TOL = 1e-4
EMB_SCALE = 16.0
MAX_NEW = 8
N_SAMPLES = 64000


class _Margins:
    """Records the logits of every prefill and decode step the port's beam
    search runs and the smallest margin among its decisive gaps."""

    def __init__(self, monkeypatch, kc, suppress, begin_suppress):
        self.kc = kc
        self.worst = np.inf
        sup = np.zeros(JAX_CFG.n_vocab, np.float32)
        sup[list(suppress)] = -np.inf
        begin = sup.copy()
        begin[list(begin_suppress)] = -np.inf
        step, prefill = beam_mod.decode_step, beam_mod.prefill

        def rec_step(*a, **k):
            logits, cache = step(*a, **k)
            self._note(logits, sup)
            return logits, cache

        def rec_prefill(*a, **k):
            logits, cache = prefill(*a, **k)
            self._note(logits[:, -1], begin)
            return logits, cache

        monkeypatch.setattr(beam_mod, "decode_step", rec_step)
        monkeypatch.setattr(beam_mod, "prefill", rec_prefill)

    def _note(self, logits, mask):
        top = -np.sort(-(logits.numpy() + mask), axis=-1)[:, : self.kc + 1]
        gaps = [top[:, 0] - top[:, 1], top[:, self.kc - 1] - top[:, self.kc]]
        self.worst = min(self.worst, float(np.min(gaps)))


def _ctl(batch, detect_rows):
    prompts = np.asarray(
        [build_prompt("en"), build_prompt("de", "translate")][:batch], np.int32
    )
    return pack_ctl(prompts, np.asarray(detect_rows, np.int32), MAX_NEW)


@pytest.mark.parametrize(
    "beam,detect,quant,seed",  # audio seeds whose decisions clear the margin
    [
        (1, False, False, 1),
        (1, True, True, 0),
        (3, True, False, 0),
        (3, False, True, 0),
        (5, False, False, 1),
        (5, True, False, 0),
        (5, True, True, 1),
        (5, False, True, 0),
    ],
)
def test_asr_program_packed_equal(monkeypatch, beam, detect, quant, seed):
    """Packed int32 equal to wis_tpu's non-fused program: greedy and beams,
    detect on/off (row 1 keeps its forced language), translate on, f32
    and int8 weights, a batch of two windows."""
    kw = dict(
        beam_size=beam, batch=2, max_new_tokens=MAX_NEW, prompt_len=4,
        suppress_tokens=DEFAULT_SUPPRESS_TOKENS,
        begin_suppress_tokens=DEFAULT_BEGIN_SUPPRESS,
        detect_language=detect, translate=True, n_samples=N_SAMPLES,
    )
    audio = audio_i16(N_SAMPLES, seed=seed, batch=2)
    ctl = _ctl(2, [1, 0])
    want = np.asarray(
        jax_program(JAX_CFG, **kw)(
            jax_params(quant, emb_scale=EMB_SCALE), jnp.asarray(audio), jnp.asarray(ctl)
        )
    )
    margins = _Margins(
        monkeypatch, 1 if beam == 1 else beam + 1,
        DEFAULT_SUPPRESS_TOKENS, DEFAULT_BEGIN_SUPPRESS,
    )
    got = build_asr_program(PORT_CFG, **kw)(
        port_params(quant, emb_scale=EMB_SCALE),
        torch.from_numpy(audio), torch.from_numpy(ctl),
    )
    assert got.dtype == torch.int32
    assert got.shape == (2, 2 * packed_width(beam, MAX_NEW))
    np.testing.assert_array_equal(got.numpy(), want)
    assert margins.worst > LOGITS_TOL, margins.worst


@pytest.mark.parametrize(
    "beam,renorm,length_penalty", [(1, True, 1.0), (3, True, 1.0), (4, False, 0.7)]
)
def test_generate_with_midloop_finishes(beam, renorm, length_penalty):
    """Beam search with an EOT id the model actually emits, so hypotheses
    finish mid-loop and the finished store, early stop and length penalty
    all act; both suppress-renormalization orders."""
    from wis_tpu.decoding.beam import build_generate_xa as jax_generate
    from wis_tpu.models.whisper import model as jm
    from wis_tpu_torch.models.whisper import model as tm

    jp = jax_params(False, emb_scale=EMB_SCALE)
    tp = port_params(False, emb_scale=EMB_SCALE)
    rng = np.random.default_rng(beam)
    mel = rng.standard_normal((1, JAX_CFG.n_mels, 3000)).astype(np.float32)
    j_xa = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(mel), JAX_CFG), JAX_CFG)
    with torch.inference_mode():
        t_xa = tm.cross_kv(tp, tm.encode(tp, torch.from_numpy(mel), PORT_CFG), PORT_CFG)
    prompt = np.asarray(build_prompt("en"), np.int32)
    kw = dict(
        beam_size=beam, batch=1, max_new_tokens=12, prompt_len=4,
        suppress_tokens=(50258,), begin_suppress_tokens=(),
        length_penalty=length_penalty, renorm_suppressed=renorm,
    )
    # a token the search itself emits second serves as EOT
    with torch.inference_mode():
        first = beam_mod.build_generate_xa(PORT_CFG, **kw)(
            tp, t_xa, torch.from_numpy(prompt), 10
        )
    kw["eot_id"] = int(first.tokens[0, int(first.best[0]), 1])
    want = jax_generate(JAX_CFG, **kw)(jp, j_xa, jnp.asarray(prompt), jnp.int32(10))
    with torch.inference_mode():
        got = beam_mod.build_generate_xa(PORT_CFG, **kw)(
            tp, t_xa, torch.from_numpy(prompt), 10
        )
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)
    if beam > 1:  # hypotheses did finish before the cap
        assert (np.asarray(want.lengths) < 10).any()


def test_program_variants_build_and_run():
    """Every variant the engine asks for builds — the fused step, the
    timestamp grammar, on-device long-form windows — and a chunked program
    with the grammar runs: packed int32 of the documented width for each
    window cut from one segment."""
    from wis_tpu_torch.audio.chunking import CHUNK_LEN, STRIDE_LEFT, STRIDE_RIGHT

    kw = dict(beam_size=1, batch=2, max_new_tokens=4, prompt_len=3,
              suppress_tokens=(), begin_suppress_tokens=())
    for extra in ({"with_timestamps": True}, {"fused_step": True},
                  {"with_timestamps": True, "fused_step": True}):
        assert callable(build_asr_program(PORT_CFG, **kw, **extra))
    n_samp = (CHUNK_LEN - STRIDE_LEFT - STRIDE_RIGHT) + CHUNK_LEN
    prog = build_asr_program(PORT_CFG, **kw, with_timestamps=True, chunked=True,
                             n_samples=n_samp)
    prompts = np.asarray([build_prompt("en", notimestamps=False)] * 2, np.int32)
    ctl = pack_ctl(prompts, np.zeros(2, np.int32), 4)
    got = prog(port_params(False, emb_scale=EMB_SCALE),
               torch.from_numpy(audio_i16(n_samp, seed=3)[0]), torch.from_numpy(ctl))
    assert got.dtype == torch.int32 and got.shape == (2, packed_width(1, 4))
    ts_base = 50364
    assert (got[:, 0] >= ts_base).all()  # each window opens with a timestamp


# --------------------------------------------------------------------------- #
# The fused decode path: the port's plain step and head against the JAX
# kernels in interpret mode, on bf16 trees (the JAX kernel's caches are
# bf16). The vocabulary is narrowed to a few ids by the suppress mask, as
# tests/test_fused_decode.py does, so each decision's margin stands far
# above the bf16 rounding noise in which the two sides may differ.
# --------------------------------------------------------------------------- #
FUSED_ALLOWED = (100, 200, 300, 400, 500, 600, 700)
FUSED_SUPPRESS = tuple(i for i in range(JAX_CFG.n_vocab) if i not in FUSED_ALLOWED)


def _fused_trees(quant):
    """(JAX tree, port tree, JAX packed decoder, port packed decoder)."""
    import jax

    from wis_tpu.ops.fused_decode import pack_decoder as jax_pack
    from wis_tpu_torch.ops.fused_decode import pack_decoder

    jp = jax_params(quant, seed=2, emb_scale=EMB_SCALE, dtype="bfloat16")
    tp = port_params(quant, seed=2, emb_scale=EMB_SCALE, dtype="bfloat16")
    return jp, tp, jax.jit(lambda p: jax_pack(p, JAX_CFG))(jp), pack_decoder(tp, PORT_CFG)


@pytest.mark.parametrize(
    "beam,batch,quant,xa_int8",
    [(1, 1, True, True), (2, 2, True, True), (5, 1, True, False), (3, 1, False, False)],
)
def test_fused_generate_token_equal(beam, batch, quant, xa_int8):
    """build_generate_xa(fused=True) equal to the JAX package's fused
    generate: tokens, lengths and best exactly, scores to 1e-4 relative
    (sums of the same log-probs in another order); greedy and beams, one
    and two windows (block-diagonal cross-attention), int8 and bf16 heads,
    int8 and bf16 cross-KV."""
    from wis_tpu.decoding.beam import build_generate_xa as jax_generate

    jp, tp, jpk, tpk = _fused_trees(quant)
    rng = np.random.default_rng(beam + batch)
    L, H = JAX_CFG.n_text_layer, JAX_CFG.n_text_head
    shape = (L, batch, H, JAX_CFG.n_text_state // H, JAX_CFG.n_audio_ctx)
    xa = [rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(2)]
    j_xa = tuple(jnp.asarray(a, jnp.bfloat16) for a in xa)
    t_xa = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in xa)
    prompt = np.asarray([build_prompt("en"), build_prompt("de")][:batch], np.int32)
    kw = dict(beam_size=beam, batch=batch, max_new_tokens=6, prompt_len=4,
              suppress_tokens=FUSED_SUPPRESS, begin_suppress_tokens=(),
              fused=True, xa_int8=xa_int8)
    want = jax_generate(JAX_CFG, **kw)(jp, jpk, j_xa, jnp.asarray(prompt), jnp.int32(6))
    with torch.inference_mode():
        got = beam_mod.build_generate_xa(PORT_CFG, **kw)(
            tp, tpk, t_xa, torch.from_numpy(prompt), 6
        )
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=2.0 ** -7)
    assert set(np.unique(got.tokens.numpy())) <= set(FUSED_ALLOWED) | {beam_mod.EOT}


@pytest.mark.parametrize("beam,detect", [(5, True), (1, False)])
def test_fused_asr_program_packed_equal(beam, detect):
    """The fused ASR program (int8 weights and cross-KV, translate on, a
    batch of two windows) packed int32 equal to wis_tpu's fused program."""
    jp, tp, jpk, tpk = _fused_trees(True)
    kw = dict(
        beam_size=beam, batch=2, max_new_tokens=MAX_NEW, prompt_len=4,
        suppress_tokens=FUSED_SUPPRESS, begin_suppress_tokens=DEFAULT_BEGIN_SUPPRESS,
        detect_language=detect, translate=True, n_samples=N_SAMPLES,
        fused_step=True, xa_int8=True,
    )
    audio = audio_i16(N_SAMPLES, seed=beam, batch=2)
    ctl = _ctl(2, [1, 0])
    want = np.asarray(
        jax_program(JAX_CFG, **kw)(jp, jpk, jnp.asarray(audio), jnp.asarray(ctl))
    )
    got = build_asr_program(PORT_CFG, **kw)(
        tp, tpk, torch.from_numpy(audio), torch.from_numpy(ctl)
    )
    assert got.dtype == torch.int32
    assert got.shape == (2, 2 * packed_width(beam, MAX_NEW))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# Engine and server on the tiny model, weights shared with the JAX registry
# --------------------------------------------------------------------------- #
def _jax_settings(**kw):
    from wis_tpu.settings import APISettings

    base = dict(whisper_model_default="tiny", dtype="float32", max_decode_tokens=8,
                beam_size=1, long_beam_size=5, batch_window_s=0.01)
    base.update(kw)
    return APISettings(**base)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) sharing the tiny weights the JAX registry
    loaded. The JAX registry seeds random weights with hash(size), which
    Python salts per process; pinning it keeps this test's weights fixed."""
    from wis_tpu.runtime import residency as jax_residency
    from wis_tpu.runtime.engine import WhisperEngine as JaxEngine
    from wis_tpu_torch.models.whisper.weights import params_from_jax
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    from torch_port_helpers import np_tree

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_residency, "hash", lambda s: 7, raising=False)
        js = _jax_settings()
        jax_engine = JaxEngine(jax_residency.ModelRegistry(js), js)
        tree = np_tree(jax_engine.registry.get("tiny").params)
    ps = APISettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=8,
                     beam_size=1, long_beam_size=5)
    port = WhisperEngine(ModelRegistry(ps, "cpu", jax_trees={"tiny": tree}))
    assert "tok_emb_q" in port.registry.get("tiny").params["decoder"]
    return jax_engine, port


@pytest.mark.parametrize(
    "seconds,beam,detect,translate", [(1.0, 1, False, False), (3.84, 5, True, True)]
)
def test_transcribe_text_equal(engines, seconds, beam, detect, translate):
    jax_engine, port = engines
    audio = audio_i16(int(seconds * 16000), seed=int(seconds * 100))[0]
    kw = dict(beam_size=beam, detect_language=detect, translate=translate, max_tokens=8)
    want = jax_engine.transcribe(audio, **kw)
    got = port.transcribe(audio, **kw)
    assert got.text and got.text == want.text
    assert got.translation == want.translation
    assert got.language == want.language
    assert got.audio_duration_ms == want.audio_duration_ms
    assert set(got.timings) >= {"features", "asr_dispatch", "decode_text"}
    assert {k[:6] for k in port._programs} <= {k[:6] for k in jax_engine._programs}


@pytest.fixture(scope="module")
def fused_engines():
    """(JAX engine, port engine), both with ``fused_decode="on"`` (the JAX
    kernels in interpret mode, the port's plain versions), int8 weights and
    int8 cross-KV, sharing the bf16 tiny weights the JAX registry loaded."""
    from wis_tpu.runtime import residency as jax_residency
    from wis_tpu.runtime.engine import WhisperEngine as JaxEngine
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    from torch_port_helpers import np_tree

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_residency, "hash", lambda s: 7, raising=False)
        js = _jax_settings(dtype="bfloat16", fused_decode="on")
        jax_engine = JaxEngine(jax_residency.ModelRegistry(js), js)
        tree = np_tree(jax_engine.registry.get("tiny").params)
    ps = APISettings(whisper_model_default="tiny", dtype="bfloat16", max_decode_tokens=8,
                     beam_size=1, long_beam_size=5, fused_decode="on")
    port = WhisperEngine(ModelRegistry(ps, "cpu", jax_trees={"tiny": tree}))
    return jax_engine, port


@pytest.mark.parametrize(
    "seconds,beam,detect,seed",  # audio seeds that meet no near-tie
    [(3.84, 5, True, 384), (1.0, 1, False, 1)],
)
def test_transcribe_fused_text_equal(fused_engines, seconds, beam, detect, seed):
    """The port engine's fused path gives the JAX engine's fused text. The
    tiny model's random logits are nearly uniform over the full
    vocabulary, so a seed can meet a near-tie that the two sides' bf16
    roundings resolve apart (2 of 12 greedy seeds tried did); the seeds
    here meet none."""
    jax_engine, port = fused_engines
    audio = audio_i16(int(seconds * 16000), seed=seed)[0]
    kw = dict(beam_size=beam, detect_language=detect, max_tokens=8)
    want = jax_engine.transcribe(audio, **kw)
    got = port.transcribe(audio, **kw)
    assert got.text and got.text == want.text
    assert got.language == want.language
    assert port._use_fused(1, beam) and port._xa_int8()
    fused_keys = [key for key in port._programs if key[1] == beam]
    assert fused_keys and all(key[8] for key in fused_keys)  # (…, max_new, fused, n_samples, chunked)
    assert port.registry.get("tiny").packed is not None


def test_engine_picks_the_decode_path():
    """fused_decode "auto" takes the fused path on a CUDA device only, "on"
    anywhere, "off" never; beams above 7 never (the head's 8 slots), nor
    batches of more rows than the kernels take."""
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    eng = WhisperEngine(ModelRegistry(APISettings(), "cpu"))
    assert not eng._use_fused(1, 5)  # "auto" on the CPU
    eng.device = torch.device("cuda")  # the decision reads the device only
    assert eng._use_fused(1, 5) and eng._use_fused(1, 1) and eng._use_fused(1, 7)
    assert not eng._use_fused(1, 8)
    assert eng._use_fused(4, 5) and not eng._use_fused(8, 5)  # 40 rows: more than the kernels take
    eng.settings.fused_decode = "off"
    assert not eng._use_fused(1, 5)
    eng.settings.fused_decode = "on"
    eng.device = torch.device("cpu")
    assert eng._use_fused(2, 5)
    assert eng._xa_int8()
    eng.settings.xa_quant = "none"
    assert not eng._xa_int8()
    eng.settings.xa_quant, eng.settings.quant = "int8", "none"
    assert not eng._xa_int8()


@pytest.mark.parametrize("name", ["tiny", " Tiny "])
def test_registry_eviction(name):
    """``evict`` as the JAX registry's (tests/test_residency.py
    test_eviction): True once, then False, nothing resident afterwards;
    the name is resolved as ``get`` resolves it, and the fused step's
    packed weights go with the model."""
    from wis_tpu_torch.models.whisper.config import resolve_model_name
    from wis_tpu_torch.runtime.engine import WhisperEngine
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    reg = ModelRegistry(APISettings(quant="none"), "cpu")
    eng = WhisperEngine(reg)
    model = reg.get(name)
    eng._packed_decoder(model)
    assert reg.resident_bytes() > 0 and model.packed is not None
    assert reg.evict(name)
    assert not reg.evict(name)
    assert reg.resident_bytes() == 0 and reg.loaded() == {}
    again = reg.get(resolve_model_name(name))
    assert again is not model and again.packed is None


def test_engine_serves_what_was_not_ported(engines):
    """Audio over 30 s, timestamps, word timestamps and coalesced batches
    are served; what is refused stays refused: beam sizes outside the
    buckets at boot, a v3-only language on a v2 model. The JAX engine's
    TPU-tunnel probe ``steady_state_latency`` is not carried."""
    from wis_tpu_torch.runtime.engine import (
        ASRRequest,
        UnsupportedLanguageError,
        WhisperEngine,
    )
    from wis_tpu_torch.runtime.residency import ModelRegistry
    from wis_tpu_torch.settings import APISettings

    _, port = engines
    with pytest.raises(ValueError, match="beam"):  # validated at boot
        WhisperEngine(ModelRegistry(APISettings(long_beam_size=9), "cpu"))
    with pytest.raises(UnsupportedLanguageError):
        port.transcribe(np.zeros(16000, np.float32), force_language="yue")
    assert not hasattr(port, "steady_state_latency")
    long = port.transcribe(audio_i16(31 * 16000, seed=31)[0], max_tokens=4)
    assert long.audio_duration_ms == 31_000 and isinstance(long.text, str)
    res = port.transcribe(audio_i16(16000, seed=1)[0], timestamps=True, word_timestamps=True,
                          max_tokens=4)
    assert res.segments is not None and res.words is not None
    out = port.transcribe_coalesced([
        ASRRequest(audio=audio_i16(16000, seed=i)[0], model="tiny", beam_size=1)
        for i in range(2)])
    assert len(out) == 2 and all(r.audio_duration_ms == 1000 for r in out)


def _post_asr(app, body):
    """POST /api/asr of a WAV on ``app`` under aiohttp's test client → the
    JSON reply."""
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            form = aiohttp.FormData()
            form.add_field("audio_file", body, filename="a.wav", content_type="audio/wav")
            resp = await client.post("/api/asr?model=tiny&beam_size=1", data=form)
            assert resp.status == 200
            return await resp.json()
        finally:
            await client.close()

    return asyncio.run(go())


def test_api_asr_served_by_port_engine(engines):
    """POST /api/asr through wis_tpu's aiohttp app with the port engine:
    the response fields of tests/test_server.py, and the engine's text."""
    from wis_tpu.audio.ingest import load_audio
    from wis_tpu.server.app import create_app

    _, port = engines
    body = wav_bytes(1.0, 0)
    data = _post_asr(create_app(settings=_jax_settings(), engine=port), body)
    assert set(data) >= {"infer_time", "infer_speedup", "audio_duration", "language", "text"}
    assert data["audio_duration"] == 1000
    assert data["language"] == "en"
    assert data["text"] == port.transcribe(load_audio(body), beam_size=1).text


def test_api_asr_served_by_the_port_app(engines):
    """The same request through the port's own app (wis_tpu_torch.server.app)
    and its batcher: the same fields and the engine's text, and the reply
    wis_tpu's app gives with the port engine."""
    from wis_tpu.server.app import create_app as jax_create_app
    from wis_tpu_torch.audio.ingest import load_audio
    from wis_tpu_torch.server.app import create_app

    _, port = engines
    body = wav_bytes(1.0, 0)
    data = _post_asr(create_app(settings=port.settings, engine=port), body)
    assert set(data) == {"infer_time", "infer_speedup", "audio_duration", "language", "text"}
    assert (data["audio_duration"], data["language"]) == (1000, "en")
    assert data["text"] == port.transcribe(load_audio(body), beam_size=1).text
    via_jax = _post_asr(jax_create_app(settings=_jax_settings(), engine=port), body)
    clocks = ("infer_time", "infer_speedup")
    assert {k: v for k, v in data.items() if k not in clocks} == {
        k: v for k, v in via_jax.items() if k not in clocks}
