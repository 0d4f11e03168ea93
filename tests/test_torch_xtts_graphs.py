"""The XTTS code loop replayed from CUDA graphs (``models/xtts/slots.py``)
on the card: a chunk replayed in a slot bit for bit against the host-int
loop (tests/test_torch_xtts_slots.py's ``_host_loop``) through every cache
bucket; whole streams of a narrow XTTS (2 layers, D 256, the real
vocabulary and 605-code cap) with slots against the same model's eager
device-scalar loop; two streams at once from two threads, each on its own
slot; a slot taken after an abandoned stream; the pool's growth and
captures; the slots and graphs freed with their model without the garbage
collector; the steps a graph holds (one) and ``fused_gpt_step.launches`` at
605 a default stream; the benchmark's contract with the model under
slots; the overflow refusal; the step's device ``pos``.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The card's machine has no JAX, so run them there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_xtts_graphs.py
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from test_torch_xtts_slots import (CASES, CFG, CHUNKS, _host_loop, _model, _stream,
                                   check_contract, wrapped_stream)
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts import model as tm
from wis_tpu_torch.models.xtts.slots import CodeSlots
from wis_tpu_torch.ops import fused_gpt as tf

pytestmark = pytest.mark.cuda

GPT = dict(n_layer=2, n_head=4, d_model=256, n_text_vocab=256, n_audio_vocab=1026,
           max_text_tokens=64, max_audio_tokens=605, start_audio_token=1024,
           stop_audio_token=1025)
VOC = dict(in_dim=256, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
           upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
           gpt_code_stride=16)
TEXT = "the light in the kitchen is now on"
KW = dict(stream_chunk_size=20, overlap_wav_len=16, seed=11, min_audio_tokens=605)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture the Hopper kernels")
    from wis_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _xtts(dev, depth=1):
    cfg = tm.XTTSConfig(gpt=tg.GPTConfig(**GPT), vocoder=th.HiFiGANConfig(**VOC),
                        text_buckets=(8, 16, 32, 64), cond_len=4, left_context_frames=2)
    return tm.XTTSModel(dev, cfg=cfg, seed=2, pipeline_depth=depth)


@pytest.fixture(scope="module")
def model(dev):
    return _xtts(dev)


_tls = threading.local()


@pytest.fixture(autouse=True)
def keep_codes(monkeypatch):
    """Each chunk's ``out[0]`` kept in the calling thread's list, as the
    benchmark keeps them."""
    orig = tm.run_decode_chunk_fused

    def keep(*args, **kwargs):
        out = orig(*args, **kwargs)
        if getattr(_tls, "codes", None) is not None:
            _tls.codes.append(out[0])
        return out

    monkeypatch.setattr(tm, "run_decode_chunk_fused", keep)


def _voice():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((4, 256)).astype(np.float32) * 0.1,
            rng.standard_normal(16).astype(np.float32))


def _codes(model, hold=None, **kw):
    """A stream's audio and codes; with ``hold`` (a barrier) the stream
    waits there after its first chunk."""
    _tls.codes = []
    try:
        stream = model.inference_stream(TEXT, "en", *_voice(), **dict(KW, **kw))
        audio = [next(stream)]
        if hold is not None:
            hold.wait(timeout=60)
        audio += list(stream)
        return audio, torch.cat(_tls.codes, dim=1).cpu()
    finally:
        _tls.codes = None


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_chunks_match_the_host_loop(dev, case):
    knobs, min_tokens, bias = CASES[case]
    params, packed, cache = _model(bias, dev)
    want = _stream(_host_loop, params, packed, cache, knobs, min_tokens, seed=1)
    pool = CodeSlots(CFG, dev, torch.bfloat16)
    slot = pool.acquire()
    before = tf.fused_gpt_step.launches
    got = _stream(tg.run_decode_chunk_fused, params, packed, cache, knobs, min_tokens, seed=1,
                  slot=slot)
    assert pool.captures == 3  # one graph a bucket
    # each graph holds one step, counted once a replay and not for the warm-up
    assert [g.tally[tf.fused_gpt_step] for g in slot.codes.values()] == [1, 1, 1]
    assert tf.fused_gpt_step.launches - before == sum(CHUNKS)
    assert len(got) == len(CHUNKS)
    for g, w in zip(got, want):
        for k in w:
            if isinstance(w[k], torch.Tensor):
                assert torch.equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_stream_replayed_matches_eager_and_counts_605(model):
    """A default stream (sampled, to the cap): audio and codes bit for bit
    the eager device-scalar loop's (the model without slots), 605 launches
    of the step counted either way, the first stream's captures included."""
    from wis_tpu_torch.ops.fused_gpt import fused_gpt_step

    slots, model._slots = model._slots, None
    try:
        before = fused_gpt_step.launches
        want_audio, want_codes = _codes(model)
        assert fused_gpt_step.launches - before == 605
    finally:
        model._slots = slots
    before = fused_gpt_step.launches
    got_audio, got_codes = _codes(model)
    assert fused_gpt_step.launches - before == 605
    assert slots.captures == 3 and len(slots.slots) == 1
    assert all(g.tally[fused_gpt_step] == 1 for g in slots.slots[0].codes.values())
    assert torch.equal(got_codes, want_codes) and got_codes.shape == (1, 605)
    assert len(got_audio) == len(want_audio)
    assert all(np.array_equal(g, w) for g, w in zip(got_audio, want_audio))
    before = fused_gpt_step.launches
    again_audio, again_codes = _codes(model)
    assert fused_gpt_step.launches - before == 605 and slots.captures == 3
    assert torch.equal(again_codes, want_codes)


def test_two_threads_two_slots_and_the_pool_grows(model):
    """Two streams at once, each from its own thread and both past their
    first chunk before either goes on: the pool grows to two slots (the
    second captures its graphs while the first replays), and each stream
    equals its lone run."""
    lone = {seed: _codes(model, seed=seed)[1] for seed in (21, 22)}
    pool = model._slots
    captures, n_slots = pool.captures, len(pool.slots)
    both, out, errors = threading.Barrier(2), {}, []

    def run(seed):
        try:
            out[seed] = _codes(model, hold=both, seed=seed)[1]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in (21, 22)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(pool.slots) == max(n_slots, 2)
    assert pool.captures == captures + 3 * (len(pool.slots) - n_slots)
    for seed in (21, 22):
        assert torch.equal(out[seed], lone[seed]), seed


def test_slot_reused_after_an_abandoned_stream(dev):
    """A stream left after two chunks with three more queued on the card
    (pipeline depth 3): the next stream takes its slot and equals its lone
    run."""
    deep = _xtts(dev, depth=3)
    want = _codes(deep, seed=31)[1]
    stream = deep.inference_stream(TEXT, "en", *_voice(), **dict(KW, seed=32))
    next(stream)
    next(stream)
    stream.close()
    got = _codes(deep, seed=31)[1]
    assert torch.equal(got, want) and len(deep._slots.slots) == 1


def test_pool_gives_a_free_slot_or_a_new_one(dev):
    pool = CodeSlots(CFG, dev, torch.bfloat16)
    a, b = pool.acquire(), pool.acquire()
    assert a is not b and pool.slots == [a, b]
    pool.release(a)
    assert pool.acquire() is a
    pool.release(b)
    pool.release(a)
    assert {id(pool.acquire()), id(pool.acquire())} == {id(a), id(b)}
    assert len(pool.slots) == 2 and pool.captures == 0


def test_a_dropped_model_frees_its_slots_without_the_collector(dev):
    """A model's code slots hold their graphs' memory pools on the card:
    dropping the model after a stream frees its slots and their graphs by
    reference counting alone, with no cycle for the garbage collector to
    find."""
    m = _xtts(dev)
    _codes(m, seed=33)
    slots = m._slots
    held = [weakref.ref(o) for o in (slots, *slots.slots, *slots.slots[0].codes.values())]
    assert slots.captures == 3
    torch.cuda.synchronize()
    collect = gc.isenabled()
    gc.disable()
    try:
        del m, slots
        assert [r() for r in held] == [None] * len(held)
    finally:
        if collect:
            gc.enable()


def test_slot_refuses_a_chunk_past_its_cache(dev):
    params, packed, cache = _model(0.0, dev)
    slot = CodeSlots(CFG, dev, torch.bfloat16).acquire()
    kc, vc = tg.flatten_gpt_cache(cache, 12)
    with pytest.raises(ValueError, match="overflows"):
        tg.run_decode_chunk_fused(
            params, packed, tf.build_fused_gpt_step(CFG, bk=1, t_cache=12),
            torch.full((1,), CFG.start_audio_token, device=dev), kc, vc, cache.pos,
            torch.zeros((1, CFG.max_audio_tokens), dtype=torch.long, device=dev), 0,
            torch.zeros((8, 1, CFG.n_audio_vocab), device=dev), 0.1, 50, 0.8, 7.0, True, 0,
            cfg=CFG, chunk=8, batch=1, slot=slot)
    assert not slot.codes


def test_wrapper_contract_under_slots(model, monkeypatch):
    """The benchmark's ``_wrapped_chunk`` around the model's chunks
    replayed in a slot (``check_contract``): the buckets, ``pos`` and
    ``chunk`` it sees, the codes it keeps fresh although the slot's
    history is written by every later chunk; every code counted as
    replayed."""
    _tls.codes = None
    _, seen, kept, rec = wrapped_stream(monkeypatch, model, TEXT, *_voice(), **KW)
    widths = check_contract(seen, kept, rec, 605)
    assert widths[0] == 256 and len(set(widths)) == 3
    assert rec.counts["tts.graph_codes"] == 605 and "tts.eager_codes" not in rec.counts


def test_step_reads_a_device_pos(dev):
    """The step with pos in device memory writes the column a host pos
    writes, bit for bit, and returns the same x; a device pos outside the
    cache writes no column."""
    from test_torch_cuda_kernels import _narrow_gpt

    cfg, _, packed = _narrow_gpt(dev)
    rng = np.random.default_rng(4)
    L, D, t_pad, pos = cfg.n_layer, cfg.d_model, 512, 300
    kc = torch.from_numpy(rng.standard_normal((L, D, t_pad)).astype(np.float32)).to(
        dev, torch.bfloat16)
    vc = kc.flip(-1).contiguous()
    sel = (torch.arange(t_pad, device=dev) < pos).float()[None]
    x = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32)).to(dev)
    host = tf.fused_gpt_step(cfg, packed, x, kc.clone(), vc.clone(), sel, pos)
    on_dev = tf.fused_gpt_step(cfg, packed, x, kc.clone(), vc.clone(), sel,
                               torch.tensor(pos, dtype=torch.int32, device=dev))
    for a, b in zip(host, on_dev):
        assert torch.equal(a, b)
    outside = tf.fused_gpt_step(cfg, packed, x, kc.clone(), vc.clone(), sel,
                                torch.tensor(t_pad, dtype=torch.int32, device=dev))
    assert torch.equal(outside[0], host[0])
    assert torch.equal(outside[1], kc) and torch.equal(outside[2], vc)
    with pytest.raises(ValueError, match="0-dim int32"):
        tf.fused_gpt_step(cfg, packed, x, kc, vc, sel, torch.tensor([pos], device=dev))
