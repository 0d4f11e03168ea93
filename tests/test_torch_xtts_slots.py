"""The XTTS code loop on device scalars (``models/xtts/gpt.decode_code``),
run eagerly on the CPU, against the host-integer loop that
``run_decode_chunk_fused`` ran before (kept here as the reference,
``_host_loop``): over several chunks, with the cache grown between
buckets, the tokens, latents, history, flat caches, position, history
length and ``done`` bit for bit, at batch 1 and 2. The sampling mask with
its knobs as tensors against the same mask with host knobs
(``_host_mask``). Then the benchmark's contract with the model (a wrapper
of ``run_decode_chunk_fused`` sees the bucket, ``pos`` and ``chunk``; the
codes it keeps are fresh tensors) and the ``tts.eager_codes`` count. The
stream slots and their graphs run on the card only:
tests/test_torch_xtts_graphs.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.systems import xtts as bench_xtts
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts import model as tm
from wis_tpu_torch.models.xtts.slots import CodeSlots
from wis_tpu_torch.ops import fused_gpt as tf
from wis_tpu_torch.ops.quant import quantize_gpt_params
from wis_tpu_torch.utils import timing

torch.set_num_threads(1)

#: 2 layers, D=128, 2 heads (head dim 64, the kernel's), 24 codes
CFG = tg.GPTConfig(n_layer=2, n_head=2, d_model=128, n_text_vocab=64, n_audio_vocab=68,
                   max_text_tokens=16, max_audio_tokens=24, start_audio_token=66,
                   stop_audio_token=67)
COND_LEN, TEXT_LEN = 2, 4
PREFIX = COND_LEN + TEXT_LEN + 1
#: cache widths the chunks grow through, as the model picks them
BUCKETS = (16, 24, 32)
CHUNKS = (6, 8, 8, 2)


def _host_loop(params, packed, step_fn, last_token, kc, vc, pos, history, hist_len, gumbel,
               temperature, top_k, top_p, repetition_penalty, do_sample, min_tokens, *, cfg,
               chunk, batch):
    """``run_decode_chunk_fused`` without the fused head as it was with
    positions, floor and knobs as host numbers."""
    dtype = params["text_emb"].dtype
    dev = last_token.device
    bkt = kc.shape[-1]
    col = torch.arange(bkt, device=dev)
    col_t = (col // batch)[None, :]
    own = (col % batch)[None, :] == torch.arange(batch, device=dev)[:, None]
    tok = last_token
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    tokens, latents = [], []
    for i in range(chunk):
        x = tg._audio_embed(params, tok, hist_len + 1).float()
        sel = ((col_t < pos) & own).float()
        xh, kc, vc = step_fn(packed, x, kc, vc, sel, pos)
        h1 = tg._ln(xh.to(dtype), params["gpt_lnf_g"], params["gpt_lnf_b"])
        hidden = tg._ln(h1, params["lnf_g"], params["lnf_b"])
        logits = (hidden @ params["head_w"] + params["head_b"]).float()
        logits = tg._stop_floor(logits, cfg, hist_len < min_tokens)
        nxt = tg._sample_token(logits, history, gumbel[i], temperature, top_k, top_p,
                               repetition_penalty, do_sample)
        stop = cfg.stop_audio_token
        nxt = torch.where(done, stop, nxt)
        done = done | (nxt == stop)
        history[:, min(hist_len, history.shape[1] - 1)] = nxt
        tok = nxt
        pos += 1
        hist_len += 1
        tokens.append(tok)
        latents.append(hidden)
    return (torch.stack(tokens, dim=1), torch.stack(latents, dim=1), kc, vc, pos, history,
            hist_len, done)


def _model(stop_bias: float, device="cpu", batch: int = 1):
    params = quantize_gpt_params(tg.random_gpt(CFG, seed=4, dtype=torch.bfloat16, device=device))
    params["head_b"] = params["head_b"].clone()
    params["head_b"][CFG.stop_audio_token] += stop_bias
    rng = np.random.default_rng(9)
    cond = torch.from_numpy(rng.standard_normal((batch, COND_LEN, CFG.d_model))
                            .astype(np.float32))
    text = torch.from_numpy(rng.integers(0, 64, (batch, TEXT_LEN)))
    prefill = tg.build_prefill(CFG, batch=batch, cond_len=COND_LEN, text_len=TEXT_LEN,
                               max_len=BUCKETS[-1])
    _, cache = prefill(params, cond.to(device, torch.bfloat16), text.to(device))
    return params, tf.pack_gpt(params, CFG), cache


def _bucket(need: int) -> int:
    return next(b for b in BUCKETS if need <= b)


def _stream(run, params, packed, cache, knobs, min_tokens, seed, chunks=CHUNKS, **extra):
    """Each chunk of ``chunks`` through ``run`` (a chunk function with
    ``run_decode_chunk_fused``'s arguments), the cache grown by zero
    padding as the model grows it (its width t·batch flat columns). → each
    chunk's outputs, cloned."""
    dev, b = cache.k.device, cache.k.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    kc, vc = tg.flatten_gpt_cache(cache, _bucket(PREFIX + chunks[0]))
    last = torch.full((b,), CFG.start_audio_token, device=dev)
    history = torch.zeros((b, CFG.max_audio_tokens), dtype=torch.long, device=dev)
    pos, hist_len, out = cache.pos, 0, []
    for chunk in chunks:
        t = max(kc.shape[-1] // b, _bucket(pos + chunk))
        if t * b > kc.shape[-1]:
            grow = (0, t * b - kc.shape[-1])
            kc, vc = F.pad(kc, grow), F.pad(vc, grow)
        u = torch.rand((chunk, b, CFG.n_audio_vocab), generator=gen, device=dev)
        gum = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
        step = tf.build_fused_gpt_step(CFG, bk=b, t_cache=t)
        toks, lats, kc, vc, pos, history, hist_len, done = run(
            params, packed, step, last, kc, vc, pos, history, hist_len, gum, *knobs,
            min_tokens, cfg=CFG, chunk=chunk, batch=b, **extra)
        last = toks[:, -1]
        out.append(dict(tokens=toks.clone(), latents=lats.clone(), kc=kc.clone(), vc=vc.clone(),
                        pos=pos, history=history.clone(), hist_len=hist_len, done=done.clone()))
    return out


#: (knobs (temperature, top_k, top_p, repetition_penalty, do_sample),
#: min_tokens, stop bias): the benchmark's knobs through every bucket; the
#: floor crossed in the second chunk with the stop then drawn; a stop in
#: the first chunk; greedy; sampled at temperature 1
CASES = {
    "sampled, bucket growth": ((0.1, 50, 0.8, 7.0, True), 24, 0.0),
    "floor crossed mid-chunk": ((0.1, 50, 0.8, 7.0, True), 9, 60.0),
    "stop mid-chunk": ((0.1, 50, 0.8, 7.0, True), 3, 60.0),
    "greedy": ((1.0, 5, 0.9, 2.0, False), 24, 0.0),
    "sampled at temperature 1": ((1.0, 20, 0.95, 2.0, True), 0, 0.0),
}


@pytest.mark.parametrize("batch", [1, 2], ids=["eager", "batch2"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_scalar_loop_matches_host_loop(case, batch):
    knobs, min_tokens, bias = CASES[case]
    params, packed, cache = _model(bias, batch=batch)
    want = _stream(_host_loop, params, packed, cache, knobs, min_tokens, seed=1)
    got = _stream(tg.run_decode_chunk_fused, params, packed, cache, knobs, min_tokens, seed=1)
    widths = [c["kc"].shape[-1] // batch for c in got]
    assert widths == [16, 24, 32, 32]
    for g, w in zip(got, want):
        for k in w:
            if isinstance(w[k], torch.Tensor):
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k
    if bias:
        stops = torch.cat([c["tokens"] for c in got], dim=1) == CFG.stop_audio_token
        for row in stops:
            assert int(torch.argmax(row.int())) == min_tokens and bool(row[min_tokens:].all())


def _host_mask(logits, prev_tokens, temperature, top_k, top_p, repetition_penalty):
    """The sampling mask as it was with the knobs as host numbers (top-k's
    row taken by a slice)."""
    v = logits.shape[-1]
    hist = torch.zeros(logits.shape, dtype=torch.bool)
    hist.scatter_(1, prev_tokens, True)
    rp = torch.tensor(repetition_penalty, dtype=torch.float32)
    logits = torch.where(hist, torch.where(logits > 0, logits / rp, logits * rp), logits)
    logits = logits / torch.tensor(max(float(np.float32(temperature)), 1e-5),
                                   dtype=torch.float32)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = min(max(int(top_k) - 1, 0), v - 1)
    logits = torch.where(logits < sorted_desc[:, k_idx:k_idx + 1], tg.NEG, logits)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    cutoff = (cum - probs_sorted < torch.tensor(top_p, dtype=torch.float32)).sum(
        dim=-1, keepdim=True)
    pth = sorted_desc.gather(1, torch.clamp(cutoff - 1, 0, v - 1))
    return torch.where(logits < pth, tg.NEG, logits)


#: (temperature, top_k, top_p, repetition_penalty) at the ends of each
#: knob's range: top-k 0 and 1, the vocabulary and past it, temperature 0
#: (floored), top-p 1
MASK_KNOBS = {
    "benchmark's knobs": (0.1, 50, 0.8, 7.0),
    "top_k 0, temperature 0": (0.0, 0, 0.9, 1.0),
    "top_k 1": (1.0, 1, 0.5, 2.0),
    "top_k the vocabulary, top_p 1": (0.7, CFG.n_audio_vocab, 1.0, 1.3),
    "top_k past the vocabulary": (1.5, 10 * CFG.n_audio_vocab, 0.95, 0.8),
}


@pytest.mark.parametrize("knobs", list(MASK_KNOBS))
def test_mask_with_knob_tensors_matches_host_knobs(knobs):
    """``_mask`` reads the knobs from tensors (``SampleKnobs``), top-k's row
    by ``gather``: bit for bit the host-number mask, and the draws with it."""
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((3, CFG.n_audio_vocab)).astype(np.float32) * 4)
    hist = torch.from_numpy(rng.integers(0, CFG.n_audio_vocab, (3, 10)))
    want = _host_mask(logits, hist, *MASK_KNOBS[knobs])
    assert torch.equal(tg._mask_logits(logits, hist, *MASK_KNOBS[knobs]), want)
    gum = torch.from_numpy(rng.gumbel(size=logits.shape).astype(np.float32))
    for do_sample in (True, False):
        draw = tg._sample_token(logits, hist, gum, *MASK_KNOBS[knobs], do_sample)
        assert torch.equal(draw, torch.argmax(want + gum if do_sample else want, dim=-1))


def test_no_slots_off_the_card():
    with pytest.raises(ValueError, match="CUDA graphs"):
        CodeSlots(CFG, "cpu", torch.bfloat16)


# --------------------------------------------------------------------------- #
# the model and the benchmark's wrapper
# --------------------------------------------------------------------------- #
#: the micro XTTS of tests/test_torch_xtts_stream.py
MICRO_GPT = dict(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
                 max_text_tokens=32, start_audio_token=66, stop_audio_token=67)
MICRO_VOC = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
                 upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
                 gpt_code_stride=16)
CAP = 100


def _micro_model():
    cfg = tm.XTTSConfig(gpt=tg.GPTConfig(max_audio_tokens=CAP, **MICRO_GPT),
                        vocoder=th.HiFiGANConfig(**MICRO_VOC), text_buckets=(8, 16, 32),
                        cond_len=4, left_context_frames=2, gpt_cache_buckets=(128,))
    model = tm.XTTSModel("cpu", cfg=cfg, dtype=torch.float32, fused="on")
    assert model._slots is None  # slots engage on the card only
    return model


def _voice():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((4, 32)).astype(np.float32) * 0.1,
            rng.standard_normal(16).astype(np.float32))


KW = dict(stream_chunk_size=8, overlap_wav_len=16, do_sample=True, seed=3, min_audio_tokens=CAP)


def wrapped_stream(monkeypatch, model, text, latent, speaker, **kw):
    """A stream of ``model`` with the benchmark's ``_wrapped_chunk`` around
    its ``run_decode_chunk_fused``, under a ``tts_stream`` record. → (the
    audio chunks, each call's (bucket, pos, chunk, a clone of ``out[0]``),
    the ``out[0]`` the wrapper kept, the record)."""
    seen, kept = [], []
    orig = tm.run_decode_chunk_fused

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append((args[4].shape[-1], args[6], kwargs["chunk"], out[0].clone()))
        return out

    monkeypatch.setattr(tm, "run_decode_chunk_fused", bench_xtts._wrapped_chunk(spy))
    monkeypatch.setattr(bench_xtts._tls, "codes", kept, raising=False)
    try:
        with timing.StageTimer("tts_stream", ids=[0]) as rec:
            audio = list(model.inference_stream(text, "en", latent, speaker, **kw))
    finally:
        monkeypatch.setattr(tm, "run_decode_chunk_fused", orig)
    return audio, seen, kept, rec


def check_contract(seen, kept, rec, cap):
    """Each call's ``kc.shape[-1]`` is the bucket of its ``tts.launch`` span,
    growing; ``pos`` advances by each ``chunk``; each ``out[0]`` the wrapper
    kept reads after the stream as it did when returned. → the widths."""
    widths = [w for w, *_ in seen]
    assert [s.attrs["t"] for s in rec.spans if s.name == "tts.launch"] == widths
    assert widths == sorted(widths) and widths[0] < widths[-1]
    for (_, a, c, _), (_, b, _, _) in zip(seen, seen[1:]):
        assert b - a == c
    assert sum(c for _, _, c, _ in seen) == cap and len(kept) == len(seen)
    for codes, (_, _, chunk, fresh) in zip(kept, seen):
        assert codes.shape == (1, chunk) and torch.equal(codes.cpu(), fresh.cpu())
    return widths


def test_wrapper_sees_bucket_pos_chunk_and_keeps_fresh_codes(monkeypatch):
    """The benchmark's ``_wrapped_chunk`` around the model's
    ``run_decode_chunk_fused`` (``check_contract``; buckets 128, then 256),
    the stream equal to the one without the wrapper, every code counted as
    launched eagerly."""
    latent, speaker = _voice()
    text = "hello world bucket growth"
    got, seen, kept, rec = wrapped_stream(monkeypatch, _micro_model(), text, latent, speaker,
                                          **KW)
    want = list(_micro_model().inference_stream(text, "en", latent, speaker, **KW))
    assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
    widths = check_contract(seen, kept, rec, CAP)
    assert widths[0] == 128 and widths[-1] == 256
    assert rec.counts["tts.eager_codes"] == CAP and "tts.graph_codes" not in rec.counts
