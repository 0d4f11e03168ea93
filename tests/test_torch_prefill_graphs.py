"""The fused ASR program's prompt prefill replayed from CUDA graphs
(``decoding/prefill_slots.py``) on the card, on Whisper ``tiny`` at its
published widths with seeded int8 weights: a slot's replay bit for bit
against the eager prefill at every key the benchmark's ASR cells meet
((B, K, cache) = (1, 5, 128), (2, 5, 128), (4, 5, 128), (1, 3, 128),
(4, 3, 256)), at its capture and at a later replay on new inputs; whole
generate calls (tokens, lengths, scores) and whole programs (a detecting
one, a translating one) with the slots against the same calls without
them; the slots of one store sharing their memory pool through captures
and replays in turn; the engine's calls sharing one slot, their
``asr_call`` counts, and
``int8_matmul.launches`` at 10 a decoder layer a request (the cross-KV's
2 and the prefill's 8), the first request's included, counted through the
replays.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The card's machine has no JAX, so run them there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_prefill_graphs.py
"""

import functools

import numpy as np
import pytest
import torch

from wis_tpu_torch.decoding import beam as beam_mod
from wis_tpu_torch.decoding.beam import build_generate_xa
from wis_tpu_torch.decoding.fused import build_asr_program, pack_ctl
from wis_tpu_torch.decoding.prefill_slots import PrefillSlots
from wis_tpu_torch.models.whisper.model import cross_kv, encode
from wis_tpu_torch.models.whisper.tokenizer import build_prompt
from wis_tpu_torch.ops.quant import int8_matmul
from wis_tpu_torch.runtime.engine import WhisperEngine
from wis_tpu_torch.runtime.residency import ModelRegistry
from wis_tpu_torch.settings import APISettings
from wis_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda

#: (batch, beams, cache length) of the ASR cells' prefills
KEYS = ((1, 5, 128), (2, 5, 128), (4, 5, 128), (1, 3, 128), (4, 3, 256))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slots capture CUDA graphs")
    from wis_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.fixture(scope="module")
def engine(dev):
    s = APISettings(whisper_model_default="tiny", beam_size=5, long_beam_size=5)
    return WhisperEngine(ModelRegistry(s, dev))


@pytest.fixture(scope="module")
def model(engine):
    loaded = engine.registry.get("tiny")
    return loaded, engine._packed_decoder(loaded)


def _audio(batch, seed, n=16000 * 4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) * 0.05 * 32768).clip(-32768, 32767).astype(np.int16)


def _cross_kv(loaded, batch, seed):
    from wis_tpu_torch.audio.mel import N_SAMPLES, log_mel

    dev = loaded.params["decoder"]["tok_emb"].device
    audio = torch.from_numpy(_audio(batch, seed, N_SAMPLES)).to(dev).float() / 32768.0
    with torch.inference_mode():
        return cross_kv(loaded.params, encode(loaded.params, log_mel(audio), loaded.cfg),
                        loaded.cfg)


def _prompts(loaded, batch, seed):
    langs = ("en", "de", "fr", "es")
    rows = [build_prompt(langs[(seed + b) % 4], layout=loaded.tokenizer.layout)
            for b in range(batch)]
    return torch.tensor(rows, dtype=torch.long)


def _gen(loaded, batch, beams, cache, **kw):
    tok = loaded.tokenizer
    return build_generate_xa(loaded.cfg, beam_size=beams, batch=batch,
                             max_new_tokens=cache - 4 - 24, prompt_len=4,
                             suppress_tokens=tok.suppress_tokens,
                             begin_suppress_tokens=tok.begin_suppress_tokens,
                             fused=True, xa_int8=True, **kw)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("batch,beams,cache", KEYS)
def test_replay_is_the_eager_prefill(dev, model, batch, beams, cache):
    loaded, _ = model
    begin_sup = torch.from_numpy(beam_mod._suppress_mask(
        loaded.cfg.n_vocab, tuple(loaded.tokenizer.begin_suppress_tokens))).to(dev)
    body = functools.partial(beam_mod.prefill_state, loaded.cfg, loaded.params, beams=beams,
                             cache_len=cache, fused=True, xa_int8=True, renorm_suppressed=True)
    slot = PrefillSlots().get(_gen(loaded, batch, beams, cache).prefill_key)
    L = loaded.cfg.n_text_layer
    with torch.inference_mode():
        for seed in (1, 2):  # the capture's replay, then a replay on new inputs
            prompt = _prompts(loaded, batch, seed).to(dev)
            xa_kv = _cross_kv(loaded, batch, seed)
            want = body(prompt, xa_kv, begin_sup)
            launches, graph = int8_matmul.launches, slot.graph
            got = slot.run(body, prompt, xa_kv, begin_sup)
            torch.cuda.synchronize()
            assert int8_matmul.launches - launches == 8 * L
            # captured at the first call only, its products tallied in the graph
            assert (slot.graph is not graph) == (seed == 1)
            assert slot.graph.tally[int8_matmul] == 8 * L
            assert _same(got.first_lp, want.first_lp)
            assert _same(got.cache.k, want.cache.k) and _same(got.cache.v, want.cache.v)
            assert got.cache.pos == want.cache.pos == 4
            for name in ("anc", "beam_rows", "boff", "bk_rows"):
                assert _same(getattr(got, name), getattr(want, name)), name
            assert len(got.xa) == 3 and all(_same(a, b) for a, b in zip(got.xa, want.xa))
    assert slot.graph.tally[int8_matmul] == 8 * L and slot.bytes > 0


@pytest.mark.parametrize("batch,beams,cache", KEYS)
def test_generate_gives_the_same_results_with_a_slot(dev, model, batch, beams, cache):
    loaded, packed = model
    gen = _gen(loaded, batch, beams, cache)
    slots = PrefillSlots()
    with torch.inference_mode():
        for seed in (3, 4):
            prompt = _prompts(loaded, batch, seed).to(dev)
            xa_kv = _cross_kv(loaded, batch, seed)
            want = gen(loaded.params, packed, xa_kv, prompt, 24)
            got = gen(loaded.params, packed, xa_kv, prompt, 24, slots)
            for name in ("tokens", "lengths", "scores", "best"):
                assert _same(getattr(got, name), getattr(want, name)), name
    assert list(slots.slots) == [gen.prefill_key]


def test_slots_of_one_store_share_their_pool(dev, model):
    """Every key's slot in one store, two rounds in turn: each capture
    takes over the memory its predecessors freed and each replay writes
    there again, and every call still gives the eager call's results."""
    loaded, packed = model
    slots = PrefillSlots()
    with torch.inference_mode():
        for rnd in range(2):
            for i, (batch, beams, cache) in enumerate(KEYS):
                gen = _gen(loaded, batch, beams, cache)
                prompt = _prompts(loaded, batch, rnd + i).to(dev)
                xa_kv = _cross_kv(loaded, batch, 10 * rnd + i)
                want = gen(loaded.params, packed, xa_kv, prompt, 24)
                got = gen(loaded.params, packed, xa_kv, prompt, 24, slots)
                for name in ("tokens", "lengths", "scores", "best"):
                    assert _same(getattr(got, name), getattr(want, name)), (rnd, i, name)
    assert len(slots.slots) == len(KEYS) and slots.pools[dev].handle is not None
    assert slots.bytes == sum(s.bytes for s in slots.slots.values()) > 0


@pytest.mark.parametrize("detect,translate", [(True, False), (False, True)])
def test_programs_give_the_same_results_with_slots(dev, model, detect, translate):
    loaded, packed = model
    tok = loaded.tokenizer
    kw = dict(beam_size=5, batch=2, max_new_tokens=32, prompt_len=4,
              suppress_tokens=tok.suppress_tokens,
              begin_suppress_tokens=tok.begin_suppress_tokens, detect_language=detect,
              translate=translate, fused_step=True, xa_int8=True, n_samples=16000 * 4)
    prog = build_asr_program(loaded.cfg, **kw)
    slots = PrefillSlots()
    for seed in (5, 6):
        audio = torch.from_numpy(_audio(2, seed)).to(dev)
        ctl = torch.from_numpy(pack_ctl(_prompts(loaded, 2, seed).numpy(),
                                        np.ones(2, np.int32), 32)).to(dev)
        want = prog(loaded.params, packed, audio, ctl)
        got = prog(loaded.params, packed, audio, ctl, slots)
        assert _same(got, want)
    assert list(slots.slots) == [prog.prefill_key]


def test_engine_calls_share_a_slot_and_count_through_replays(engine, model):
    """Requests at other audio buckets and decode caps, detecting and
    not, reach one slot; each request launches 10 int8 products a decoder
    layer, its first included (its warm-up's products taken back)."""
    loaded, _ = model
    L = loaded.cfg.n_text_layer
    loaded.prefill_slots = PrefillSlots()
    rng = np.random.default_rng(7)
    calls = [dict(seconds=1.0, max_tokens=4), dict(seconds=3.5, max_tokens=20),
             dict(seconds=7.0, max_tokens=8, detect_language=True)]
    counts = []
    for kw in calls:
        seconds = kw.pop("seconds")
        audio = (rng.standard_normal(int(16000 * seconds)) * 0.05).astype(np.float32)
        before = {id(t) for t in timing.recent()}
        launches = int8_matmul.launches
        engine.transcribe(audio, beam_size=5, **kw)
        torch.cuda.synchronize()
        (rec,) = [t for t in timing.recent() if id(t) not in before and t.kind == "asr_call"]
        detect = kw.get("detect_language", False)
        assert int8_matmul.launches - launches == 10 * L + 8 * L * detect
        counts.append({k: v for k, v in rec.counts.items() if k.startswith("asr.prefill")})
    assert counts == [{"asr.prefill_graph": 1, "asr.prefill_captures": 1},
                      {"asr.prefill_graph": 1}, {"asr.prefill_graph": 1}]
    (slot,) = loaded.prefill_slots.slots.values()
    assert slot.graph is not None and slot.graph.tally[int8_matmul] == 8 * L
