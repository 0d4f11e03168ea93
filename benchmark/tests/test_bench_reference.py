"""The plain references against the port, on the same seeded tensors, at
tiny widths on the CPU in float32: the log-mel frontend, the Whisper
encoder, cross-KV and decoder, the int8 recipes, the XTTS text ids, GPT
and HiFi-GAN, and the stream's chunk arithmetic."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import quant
from benchmark.reference import whisper as wref
from benchmark.reference import xtts as xref
from benchmark.systems import xtts as xsys
from benchmark.tests.conftest import tiny_whisper, tiny_xtts

F32 = torch.float32


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def whisper_pair():
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS
    from wis_tpu_torch.models.whisper.weights import params_from_hf

    cfg = tiny_whisper()
    sd = weights.whisper_hf(cfg, 21, "cpu")
    port_cfg = WHISPER_CONFIGS["tiny"]
    return cfg, sd, port_cfg, params_from_hf(sd, port_cfg, F32, "cpu")


def _audio(seconds=4.0, seed=1):
    rng = np.random.default_rng(seed)
    a = np.zeros((1, wref.N_SAMPLES), np.float32)
    a[0, :int(seconds * 16000)] = rng.standard_normal(int(seconds * 16000)) * 0.05
    return torch.from_numpy(a)


def test_log_mel_matches_the_port():
    from wis_tpu_torch.audio.mel import log_mel

    audio = _audio()
    assert float((wref.log_mel(audio, 80) - log_mel(audio, 80)).abs().max()) < 1e-4


def test_whisper_encoder_and_decoder_match_the_port(whisper_pair):
    from wis_tpu_torch.models.whisper.model import DecoderCache, cross_kv, encode, prefill

    cfg, sd, port_cfg, params = whisper_pair
    mel = wref.log_mel(_audio(), 80)
    ref = wref.Whisper(sd, cfg, "served")
    xa = ref.encode(_audio())
    assert _rel(encode(params, mel, port_cfg), xa) < 1e-4
    # the port's float32 decoder holds no int8 leaf: compare it with the
    # reference's decoder over the same unrounded weights
    exact = wref.Whisper(sd, cfg, "served")
    exact.w = lambda name: exact.t[name].float()
    prompt = torch.tensor([cfg["generation"]["prompt"] + [400, 500, 600]])
    k, v = cross_kv(params, xa, port_cfg)
    kv_ref = []
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.layers.{i}.encoder_attn"
        kk = exact._lin(xa, p + ".k_proj", bias=False).view(1, 1500, 6, 64).transpose(1, 2)
        vv = exact._lin(xa, p + ".v_proj").view(1, 1500, 6, 64).transpose(1, 2)
        assert _rel(k[i].transpose(-1, -2), kk) < 1e-5
        kv_ref.append((kk, vv))
    want = exact.decode(prompt, kv_ref)
    cache = DecoderCache.zeros(port_cfg, 1, 448, F32, torch.device("cpu"))
    got, _ = prefill(params, prompt, cache, (k, v), port_cfg)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("beam,cap", [(5, 12), (3, 20), (1, 12)])
def test_beam_search_matches_the_ports(whisper_pair, beam, cap):
    """The reference's beam search picks the port's hypothesis, with its
    score, over the same float32 weights and cross-attention K/V."""
    from wis_tpu_torch.decoding.beam import build_generate_xa
    from wis_tpu_torch.models.whisper.model import cross_kv, encode

    cfg, sd, port_cfg, params = whisper_pair
    gen = cfg["generation"]
    exact = wref.Whisper(sd, cfg, "served")
    exact.w = lambda name: exact.t[name].float()
    xa = encode(params, wref.log_mel(_audio(seed=beam), 80), port_cfg)
    k, v = cross_kv(params, xa, port_cfg)
    xkv = [(k[i].transpose(-1, -2), v[i].transpose(-1, -2))
           for i in range(cfg["decoder_layers"])]
    run = build_generate_xa(port_cfg, beam_size=beam, batch=1, max_new_tokens=32,
                            prompt_len=len(gen["prompt"]),
                            suppress_tokens=tuple(gen["suppress_tokens"]),
                            begin_suppress_tokens=tuple(gen["begin_suppress_tokens"]))
    out = run(params, (k, v), torch.tensor(gen["prompt"]), cap)
    best = int(out.best[0])
    want = out.tokens[0, best, :int(out.lengths[0, best])].tolist()
    tokens, score = exact.beam_search(xkv, gen["prompt"], beam, cap, gen["suppress_tokens"],
                                      gen["begin_suppress_tokens"], gen["eot"])
    assert tokens == want
    assert score == pytest.approx(float(out.scores[0, best]), abs=1e-4)
    logits = exact.teacher_forced(xkv, gen["prompt"], [tokens])[0]
    assert wref.score(logits, tokens, gen["suppress_tokens"],
                      gen["begin_suppress_tokens"]) == pytest.approx(score, abs=1e-4)


def test_int8_recipes_equal_the_ports():
    from wis_tpu_torch.ops.fused_decode import quantize_xa_columns
    from wis_tpu_torch.ops.quant import quantize_rows, quantize_weight

    w = torch.randn(256, 384, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    q = quantize_weight(w.T.contiguous())  # the port's (in, out) layout, per output column
    assert torch.equal(quant.weight(w, "int8", "served", dim=1),
                       (q["q"].float() * q["s"]).T)
    q = quantize_rows(w)
    assert torch.equal(quant.weight(w, "int8", "served", dim=1), q["q"].float() * q["s"])
    x = torch.randn(2, 3, 64, 128, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    qk, _, scales = quantize_xa_columns(x, x)
    s = scales.view(2, 3, 2, 128)[:, :, 0].float()
    assert torch.equal(quant.kv(x, 2, "served"), qk.float() * s[:, :, None, :])


def test_control_is_one_step_below():
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(5))
    served = quant.weight(w, "int8", "served", dim=1)
    control = quant.weight(w, "int8", "control", dim=1)
    assert (control - w).abs().mean() > 8 * (served - w).abs().mean()
    assert torch.equal(quant.weight(w.to(torch.bfloat16), "bf16", "served", dim=1),
                       w.to(torch.bfloat16).float())
    assert float((quant.weight(w, "bf16", "control", dim=1) - w).abs().max()) > 0


@pytest.fixture(scope="module")
def xtts_pair():
    from wis_tpu_torch.models.xtts.convert import gpt_from_coqui, hifigan_from_coqui

    cfg = tiny_xtts()
    sd = weights.xtts_coqui(cfg, 22, "cpu")
    pc = xsys.port_config(cfg)
    return cfg, sd, pc, gpt_from_coqui(sd, pc.gpt, F32, "cpu"), hifigan_from_coqui(
        sd, pc.vocoder, F32, "cpu")


def test_xtts_text_ids_match_the_port(xtts_pair):
    from wis_tpu_torch.models.xtts.model import XTTSModel

    cfg, _, pc, _, _ = xtts_pair
    model = XTTSModel("cpu", cfg=pc, quant="none", fused="off")
    g = cfg["gpt"]
    for seed in range(20):
        text = xsys.make_text(25 + 5 * seed, seed)
        assert xref.text_ids(text, "en", g["gpt_number_text_tokens"],
                             g["gpt_max_text_tokens"]) == model.tokenize(text, "en").tolist()


def test_xtts_gpt_and_vocoder_match_the_port(xtts_pair):
    from wis_tpu_torch.models.xtts.gpt import GPTCache, gpt_pass
    from wis_tpu_torch.models.xtts.hifigan import hifigan_forward

    cfg, sd, pc, gpt, voc = xtts_pair
    ref = xref.XTTS(sd, cfg, "served")
    ref.w = lambda name: ref.sd[name].float()  # the port's float32 tree holds no int8 leaf
    x = torch.randn(40, 128, generator=torch.Generator().manual_seed(6))
    cache = GPTCache.zeros(pc.gpt, 1, 64, F32, "cpu")
    got, _ = gpt_pass(gpt, x[None], 0, cache, pc.gpt)
    assert _rel(got[0], ref.gpt(x)) < 1e-4
    lat = torch.randn(9, 128, generator=torch.Generator().manual_seed(7))
    spk = torch.randn(64, generator=torch.Generator().manual_seed(8))
    assert _rel(hifigan_forward(voc, lat[None], spk[None], pc.vocoder)[0],
                ref.vocode(lat, spk)) < 1e-4


def test_stream_arithmetic_matches_the_port(xtts_pair, monkeypatch):
    """The port's float32 stream, greedy, against the reference's
    teacher-forced pass over its codes, cut and cross-faded by
    ``stream_audio``."""
    from wis_tpu_torch.models.xtts import model as xmodel

    cfg, sd, pc, _, _ = xtts_pair
    codes = []
    orig = xmodel.run_decode_chunk

    def keep(*args, **kwargs):
        out = orig(*args, **kwargs)
        codes.append(out[0])
        return out

    monkeypatch.setattr(xmodel, "run_decode_chunk", keep)
    model = xsys._model_class()(sd, "cpu", cfg=pc, quant="none", fused="off", dtype=F32)
    voice = weights.xtts_voice(cfg, 9)
    text = xsys.make_text(30, 1)
    chunks = list(model.inference_stream(
        text, "en", np.asarray(voice["gpt_cond_latent"], np.float32),
        np.asarray(voice["speaker_embedding"], np.float32), stream_chunk_size=20,
        do_sample=False, min_audio_tokens=30))
    got = np.concatenate(chunks)
    toks = torch.cat(codes, dim=1)[0].tolist()
    stop = cfg["gpt"]["gpt_stop_audio_token"]
    n_valid = toks.index(stop)
    assert n_valid == 30
    ref = xref.XTTS(sd, cfg, "served")
    ref.w = lambda name: ref.sd[name].float()
    g = cfg["gpt"]
    ids = xref.text_ids(text, "en", g["gpt_number_text_tokens"], g["gpt_max_text_tokens"])
    cond = torch.tensor(voice["gpt_cond_latent"], dtype=F32)
    bucket = next(b for b in cfg["text_buckets"] if len(ids) <= b)
    logits, hidden = ref.teacher_forced(cond, ids, bucket, toks)
    want = np.concatenate(xref.stream_audio(ref, hidden, n_valid,
                                            torch.tensor(voice["speaker_embedding"], dtype=F32),
                                            20))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < 1e-4
