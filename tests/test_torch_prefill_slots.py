"""The fused ASR program's prompt prefill (``decoding/beam.prefill_state``)
and the slots that replay it from CUDA graphs on the card
(``decoding/prefill_slots``), on the CPU: the prefill gives, bit for bit,
what the inline block it was drawn from gave (a copy below) at batch 1 and
2, beams 1, 3 and 5, timestamps on and off, int8 cross-KV on and off, fused
and eager; programs that differ only in audio bucket, detection,
translation or decode bucket name one slot, and every other key a slot of
its own; an engine call's ``asr_call`` record counts its eager prefills and
makes no slot off the card; the benchmark's two readers of the counts.

A narrow whisper (2 decoder layers, D 128, 2 heads, the real vocabulary),
seeded int8 weights, random cross-KV over the 1500 audio positions. The
graphs themselves run on the card: tests/test_torch_prefill_graphs.py."""

import gc
import weakref
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wis_tpu_torch.decoding import beam as beam_mod
from wis_tpu_torch.decoding.fused import build_asr_program
from wis_tpu_torch.decoding.prefill_slots import PrefillSlots
from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import DecoderCache, prefill
from wis_tpu_torch.models.whisper.tokenizer import (
    DEFAULT_BEGIN_SUPPRESS,
    DEFAULT_SUPPRESS_TOKENS,
    layout_for_vocab,
)
from wis_tpu_torch.models.whisper.weights import random_params
from wis_tpu_torch.ops.fused_decode import quantize_xa_columns
from wis_tpu_torch.ops.quant import quantize_whisper_params
from wis_tpu_torch.runtime.engine import WhisperEngine
from wis_tpu_torch.runtime.residency import ModelRegistry
from wis_tpu_torch.settings import APISettings
from wis_tpu_torch.utils import timing

torch.set_num_threads(1)

CFG = WhisperConfig(name="prefill-slots", n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                    n_text_state=128, n_text_head=2, n_text_layer=2)
P = 4


@pytest.fixture(scope="module")
def params():
    return quantize_whisper_params(random_params(CFG, seed=3, device="cpu"))


def _begin_sup(timestamps: bool) -> torch.Tensor:
    """The first token's suppress mask, by ``build_generate_xa``'s rule."""
    lay = layout_for_vocab(CFG.n_vocab)
    base = tuple(DEFAULT_SUPPRESS_TOKENS) + ((lay.no_timestamps,) if timestamps else ())
    extra = tuple(DEFAULT_BEGIN_SUPPRESS) + base
    if timestamps:
        extra += tuple(range(0, lay.timestamp_base))
        extra += tuple(range(lay.timestamp_base + beam_mod.MAX_INITIAL_TS_INDEX + 1,
                             CFG.n_vocab))
    return torch.from_numpy(beam_mod._suppress_mask(CFG.n_vocab, extra))


def _inputs(batch: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    L, H = CFG.n_text_layer, CFG.n_text_head
    shape = (L, batch, H, CFG.n_text_state // H, CFG.n_audio_ctx)
    xa_kv = tuple(torch.randn(shape, generator=g).to(torch.bfloat16) for _ in range(2))
    prompt = torch.randint(0, 50257, (batch, P), generator=g)
    return prompt, xa_kv


def _inline_block(params, prompt, xa_kv, begin_sup, *, K, cache_len, fused, xa_int8,
                  renorm_suppressed):
    """The prefill as ``build_generate_xa._generate`` ran it inline, before
    it became ``prefill_state``: kept here as the reference."""
    B, prompt_len = prompt.shape
    device = xa_kv[0].device
    dtype = params["decoder"]["tok_emb"].dtype
    cache0 = DecoderCache.zeros(CFG, B, cache_len, dtype, device, None)
    logits, cache0 = prefill(params, prompt, cache0, xa_kv, CFG, None)
    first_raw = logits[:, -1]
    first_masked = first_raw + begin_sup
    first_lse = torch.logsumexp(
        first_masked if renorm_suppressed else first_raw, dim=-1, keepdim=True
    )
    first_lp = first_masked - first_lse
    H, L = CFG.n_text_head, CFG.n_text_layer
    Dh = CFG.n_text_state // H
    s_pad = ((CFG.n_audio_ctx + 127) // 128) * 128
    xa = boff = bk_rows = None
    if fused:
        def flat_tmajor(c):
            flat = c.reshape(L, B, H * Dh, cache_len).permute(0, 2, 3, 1)
            return flat.reshape(L, H * Dh, cache_len * B).repeat_interleave(K, dim=-1)

        cache = DecoderCache(flat_tmajor(cache0.k), flat_tmajor(cache0.v), cache0.pos)

        def flat_xa(xa):
            t = F.pad(xa.permute(0, 2, 3, 1, 4), (0, s_pad - CFG.n_audio_ctx))
            return t.reshape(L, H, Dh, B * s_pad)

        xa_k_f, xa_v_f = flat_xa(xa_kv[0]), flat_xa(xa_kv[1])
        xa = (xa_k_f, xa_v_f)
        if xa_int8:
            xa = quantize_xa_columns(xa_k_f, xa_v_f)
        boff = (torch.arange(B, device=device) * K)[:, None, None]
        bk_rows = torch.arange(B * K, device=device)
    else:
        cache = DecoderCache(cache0.k.repeat_interleave(K, dim=1),
                             cache0.v.repeat_interleave(K, dim=1), cache0.pos)
    own_row = torch.arange(K, device=device)[None, :, None].expand(B, K, cache_len)
    anc = torch.where(torch.arange(cache_len, device=device)[None, None, :] < prompt_len,
                      own_row, -1)
    return first_lp, cache, anc, torch.arange(K, device=device), xa, boff, bk_rows


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


CASES = ([(b, k, ts, xa8, True) for b in (1, 2) for k in (1, 3, 5) for ts in (False, True)
          for xa8 in (False, True)]
         + [(b, k, ts, False, False) for b in (1, 2) for k in (1, 3, 5) for ts in (False, True)])


@pytest.mark.parametrize("batch,beams,timestamps,xa_int8,fused", CASES)
def test_prefill_state_is_the_inline_block(params, batch, beams, timestamps, xa_int8, fused):
    prompt, xa_kv = _inputs(batch, seed=10 * batch + beams)
    begin_sup = _begin_sup(timestamps)
    cache_len = 128 if fused else P + 8
    renorm = not (timestamps and beams == 3)  # HF's order once
    kw = dict(cache_len=cache_len, fused=fused, xa_int8=xa_int8, renorm_suppressed=renorm)
    got = beam_mod.prefill_state(CFG, params, prompt, xa_kv, begin_sup, beams=beams, **kw)
    want = _inline_block(params, prompt, xa_kv, begin_sup, K=beams, **kw)
    first_lp, cache, anc, beam_rows, xa, boff, bk_rows = want
    assert _same(got.first_lp, first_lp)
    assert _same(got.cache.k, cache.k) and _same(got.cache.v, cache.v)
    assert got.cache.pos == cache.pos == P
    assert _same(got.anc, anc) and _same(got.beam_rows, beam_rows)
    assert _same(got.boff, boff) and _same(got.bk_rows, bk_rows)
    assert (got.xa is None) == (xa is None)
    if xa is not None:
        assert len(got.xa) == len(xa) == (3 if xa_int8 else 2)
        assert all(_same(a, b) for a, b in zip(got.xa, xa))


BASE = dict(beam_size=5, batch=4, max_new_tokens=32, prompt_len=P,
            suppress_tokens=tuple(DEFAULT_SUPPRESS_TOKENS),
            begin_suppress_tokens=tuple(DEFAULT_BEGIN_SUPPRESS), fused_step=True, xa_int8=True)


def _key(**kw):
    return build_asr_program(CFG, **{**BASE, **kw}).prefill_key


def test_programs_of_one_prefill_share_a_slot():
    """The engine's program cache splits on the audio bucket, detection,
    translation and decode bucket; the prefill does not."""
    store = PrefillSlots()
    base = _key()
    shared = [_key(n_samples=4 * 16000), _key(detect_language=True), _key(translate=True),
              _key(max_new_tokens=96), _key(chunked=True, n_samples=3 * 14 * 16000 + 22 * 16000)]
    assert all(k == base for k in shared)
    slot = store.get(base)
    assert all(store.get(k) is slot for k in shared)
    assert list(store.slots) == [base] and slot.graph is None and slot.key == base
    assert slot.pools is store.pools == {} and store.bytes == 0


def test_a_new_key_makes_a_new_slot():
    store = PrefillSlots()
    keys = [_key(), _key(batch=1), _key(beam_size=3), _key(prompt_len=P - 1),
            _key(max_new_tokens=200),  # a cache of 256 positions
            _key(xa_int8=False), _key(with_timestamps=True)]
    slots = [store.get(k) for k in keys]
    assert len(set(keys)) == len(keys) == len(store.slots)
    assert len({id(s) for s in slots}) == len(keys)
    # the eager program names its prefill too, with its own cache length
    eager = build_asr_program(CFG, **{**BASE, "fused_step": False, "xa_int8": False})
    assert eager.prefill_key[3] == P + 32 and eager.prefill_key not in store.slots


def test_an_evicted_model_frees_its_slots_without_the_collector():
    """A model's prefill slots hold their graphs' memory pool on the card:
    after an engine call the registry's eviction frees the model's store
    and slots by reference counting alone, with no cycle for the garbage
    collector to find."""
    s = APISettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=8,
                    beam_size=5, long_beam_size=5, fused_decode="on")
    eng = WhisperEngine(ModelRegistry(s, "cpu"))
    eng.transcribe(np.zeros(16000, np.float32), beam_size=5, max_tokens=2)
    store = eng.registry.get("tiny").prefill_slots
    held = [weakref.ref(o) for o in (store, store.get(_key()), store.get(_key(batch=1)))]
    del store
    collect = gc.isenabled()
    gc.disable()
    try:
        assert all(r() is not None for r in held) and eng.registry.evict("tiny")
        assert [r() for r in held] == [None] * 3
    finally:
        if collect:
            gc.enable()


@pytest.fixture(scope="module")
def engine():
    s = APISettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=8,
                    beam_size=5, long_beam_size=5, fused_decode="on")
    return WhisperEngine(ModelRegistry(s, "cpu"))


def test_an_engine_call_counts_its_eager_prefills(engine):
    """Off the card the fused program prefills eagerly: one count a
    prefill (two for a translating call), no slot, no graph."""
    audio = (np.random.default_rng(5).standard_normal(16000) * 0.05).astype(np.float32)
    before = {id(t) for t in timing.recent()}
    engine.transcribe(audio, beam_size=5, max_tokens=4)
    engine.transcribe(audio, beam_size=5, max_tokens=4, translate=True)
    recs = [t for t in timing.recent() if id(t) not in before and t.kind == "asr_call"]
    assert [t.counts.get("asr.prefill_eager") for t in recs] == [1, 2]
    for t in recs:
        assert "asr.prefill_graph" not in t.counts and "asr.prefill_captures" not in t.counts
        assert sum(s.name == "asr.prefill" for s in t.spans) == t.counts["asr.prefill_eager"]
    assert engine.registry.get("tiny").prefill_slots.slots == {}


@pytest.mark.parametrize("metric", ["program.prefill_graph_share.utt",
                                    "program.prefill_graph_share.long"])
def test_graph_share_reads_the_prefill_counts(metric):
    """``benchmark/metrics/<metric>.py``: the prefills replayed from a
    graph among every prefill of the window's ``asr_call`` records;
    nothing where no record counts prefills (a program without the
    counts)."""
    from benchmark import run as bench_run

    read = bench_run.reader(metric)

    def rec(t0, counts, kind="asr_call"):
        return NS(kind=kind, ids=[1], t0=t0, t1=t0 + 1, spans=[], counts=counts)

    window = NS(t0=100.0, t_stamps=200.0, trace=None, config={})
    records = [rec(110, {"asr.prefill_graph": 38, "asr.prefill_eager": 2}),
               rec(120, {"asr.prefill_graph": 1, "asr.prefill_captures": 1}),
               rec(130, {"asr.prefill_eager": 50}, kind="asr_batch"),  # not a call
               rec(50, {"asr.prefill_eager": 1000}),  # before the window
               rec(199.5, {"asr.prefill_eager": 1000})]  # ends in the traced slice
    orig = timing.recent
    try:
        timing.recent = lambda: records
        assert read(window) == pytest.approx(100.0 * 39 / 41)
        timing.recent = lambda: [rec(110, {"asr.step": 20, "asr.sync": 21})]
        assert read(window) is None
    finally:
        timing.recent = orig
