"""The PyTorch port against HuggingFace ``transformers`` on the CPU, through
the port's own ``params_from_hf`` — the core of tests/test_hf_parity.py
replayed on ``wis_tpu_torch``: the encoder, the decoder's logits, greedy
and beam generation token for token against ``GenerationMixin.generate``
(with the production suppress sets, an EOS that fires mid-loop, both
length penalties, HF's normalize-then-mask order), and the v3 vocabulary
layout. Random HF weights from a seed, f32.

Tolerances are tests/test_hf_parity.py's: encoder atol 2e-3 / rtol 1e-3,
logits atol 3e-3 / rtol 1e-3 (another summation order over f32 and
HF's erf gelu against the port's tanh form, 1.3e-5 apart), beam scores
2e-3; tokens exact.
"""

import numpy as np
import pytest
import torch

from wis_tpu_torch.decoding.beam import build_generate_xa
from wis_tpu_torch.models.whisper.config import WhisperConfig
from wis_tpu_torch.models.whisper.model import DecoderCache, cross_kv, encode, prefill
from wis_tpu_torch.models.whisper.tokenizer import SOT, V3_LAYOUT, build_prompt
from wis_tpu_torch.models.whisper.weights import params_from_hf

torch.set_num_threads(1)

CFG = WhisperConfig(name="hf-micro", n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                    n_text_state=64, n_text_head=2, n_text_layer=2)
CFG_V3 = WhisperConfig(name="hf-micro-v3", n_mels=128, n_vocab=51866, n_audio_state=64,
                       n_audio_head=2, n_audio_layer=2, n_text_state=64, n_text_head=2,
                       n_text_layer=2)
PROMPT = build_prompt("en", "transcribe")
SUPPRESS = (1, 2, 7, 8, 220, 50358)
BEGIN_SUPPRESS = (220, 50257)


def _hf(cfg, seed):
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    hf_cfg = HFConfig(
        vocab_size=cfg.n_vocab, num_mel_bins=cfg.n_mels, d_model=cfg.n_audio_state,
        encoder_layers=cfg.n_audio_layer, encoder_attention_heads=cfg.n_audio_head,
        decoder_layers=cfg.n_text_layer, decoder_attention_heads=cfg.n_text_head,
        encoder_ffn_dim=4 * cfg.n_audio_state, decoder_ffn_dim=4 * cfg.n_text_state,
        max_source_positions=cfg.n_audio_ctx, max_target_positions=cfg.n_text_ctx,
    )
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(hf_cfg)
    model.eval()
    return model


def _port_params(model, cfg):
    return params_from_hf(model.state_dict(), cfg, torch.float32, "cpu")


@pytest.fixture(scope="module")
def hf_model():
    return _hf(CFG, 0)


@pytest.fixture(scope="module")
def params(hf_model):
    return _port_params(hf_model, CFG)


@pytest.fixture(scope="module")
def mel_fix():
    return np.random.default_rng(7).standard_normal((1, 80, 3000)).astype(np.float32)


def test_encoder_parity(hf_model, params):
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    with torch.no_grad():
        expected = hf_model.model.encoder(torch.from_numpy(mel)).last_hidden_state.numpy()
        got = encode(params, torch.from_numpy(mel), CFG).numpy()
    assert got.shape == expected.shape == (2, 1500, 64)
    np.testing.assert_allclose(got, expected, atol=2e-3, rtol=1e-3)


def test_decoder_logits_parity(hf_model, params):
    mel = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 80, 3000)).astype(np.float32))
    tokens = torch.tensor([[SOT, 100, 2000, 31337]])
    with torch.no_grad():
        expected = hf_model(input_features=mel, decoder_input_ids=tokens).logits.numpy()
        xa_kv = cross_kv(params, encode(params, mel, CFG), CFG)
        cache = DecoderCache.zeros(CFG, 1, 8, torch.float32, "cpu")
        got = prefill(params, tokens, cache, xa_kv, CFG)[0].numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=3e-3, rtol=1e-3)


def _hf_generate(hf_model, mel, prompt=PROMPT, *, num_beams, max_new, suppress=(),
                 begin_suppress=(), length_penalty=1.0, eos=50257):
    from transformers import GenerationConfig
    from transformers.generation import GenerationMixin

    gen_cfg = GenerationConfig(
        num_beams=num_beams, num_return_sequences=num_beams, max_new_tokens=max_new,
        do_sample=False, length_penalty=length_penalty, early_stopping=False,
        eos_token_id=eos, pad_token_id=eos, decoder_start_token_id=50258,
        suppress_tokens=list(suppress) or None,
        begin_suppress_tokens=list(begin_suppress) or None,
        output_scores=True, return_dict_in_generate=True, forced_decoder_ids=None,
    )
    with torch.no_grad():
        out = GenerationMixin.generate(
            hf_model, input_features=torch.from_numpy(mel),
            decoder_input_ids=torch.tensor([prompt], dtype=torch.long),
            generation_config=gen_cfg,
        )
    seqs = out.sequences.numpy()[:, len(prompt):]
    hf_scores = getattr(out, "sequences_scores", None)
    return seqs, None if hf_scores is None else hf_scores.numpy()


def _ours_generate(params, mel, cfg=CFG, prompt=PROMPT, *, beam, max_new, suppress=(),
                   begin_suppress=(), length_penalty=1.0, eos=50257,
                   renorm_suppressed=True):
    gen = build_generate_xa(
        cfg, beam_size=beam, batch=1, max_new_tokens=max_new, prompt_len=len(prompt),
        suppress_tokens=tuple(suppress), begin_suppress_tokens=tuple(begin_suppress),
        length_penalty=length_penalty, renorm_suppressed=renorm_suppressed, eot_id=eos,
    )
    with torch.inference_mode():
        xa_kv = cross_kv(params, encode(params, torch.from_numpy(mel), cfg), cfg)
        return gen(params, xa_kv, torch.tensor(prompt), max_new)


def _assert_rows_match(result, hf_seqs, eos, max_new, hf_scores=None):
    """Token-exact comparison of every returned beam, best-first."""
    k = result.tokens.shape[1]
    lengths = result.lengths[0].numpy()
    toks = result.tokens[0].numpy()
    for i in range(k):
        n = int(lengths[i])
        np.testing.assert_array_equal(toks[i, :n], hf_seqs[i][:n],
                                      err_msg=f"beam {i}: ours={toks[i, :n]} hf={hf_seqs[i][:n]}")
        assert (toks[i, n:] == eos).all()
        assert (hf_seqs[i][n:] == eos).all() or n == max_new
    if hf_scores is not None:
        np.testing.assert_allclose(result.scores[0].numpy(), hf_scores, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def emittable_eos(hf_model, mel_fix):
    """A token id random weights emit mid-sequence, declared EOS so that
    finishes happen inside the loop."""
    seqs, _ = _hf_generate(hf_model, mel_fix, num_beams=1, max_new=8)
    return int(seqs[0][5])


def test_generate_greedy_parity(hf_model, params, mel_fix):
    seqs, _ = _hf_generate(hf_model, mel_fix, num_beams=1, max_new=12,
                           suppress=SUPPRESS, begin_suppress=BEGIN_SUPPRESS)
    res = _ours_generate(params, mel_fix, beam=1, max_new=12,
                         suppress=SUPPRESS, begin_suppress=BEGIN_SUPPRESS)
    _assert_rows_match(res, seqs, 50257, 12)


def test_generate_greedy_parity_eos_stop(hf_model, params, mel_fix, emittable_eos):
    seqs, _ = _hf_generate(hf_model, mel_fix, num_beams=1, max_new=16, eos=emittable_eos)
    res = _ours_generate(params, mel_fix, beam=1, max_new=16, eos=emittable_eos)
    assert int(res.lengths[0, 0]) < 16, "EOS never fired — fixture token choice broke"
    _assert_rows_match(res, seqs, emittable_eos, 16)


@pytest.mark.parametrize("length_penalty", [1.0, 0.0])
def test_generate_beam_parity(hf_model, params, mel_fix, length_penalty):
    seqs, hf_scores = _hf_generate(hf_model, mel_fix, num_beams=4, max_new=10,
                                   length_penalty=length_penalty)
    res = _ours_generate(params, mel_fix, beam=4, max_new=10, length_penalty=length_penalty)
    _assert_rows_match(res, seqs, 50257, 10, hf_scores)


def test_generate_beam_parity_mid_loop_eos(hf_model, params, mel_fix):
    plain, _ = _hf_generate(hf_model, mel_fix, num_beams=4, max_new=12)
    eos = int(plain[1][5])
    seqs, hf_scores = _hf_generate(hf_model, mel_fix, num_beams=4, max_new=12, eos=eos,
                                   length_penalty=0.0)
    res = _ours_generate(params, mel_fix, beam=4, max_new=12, eos=eos, length_penalty=0.0)
    assert (res.lengths[0].numpy() < 12).any(), "no mid-loop finish — fixture broke"
    _assert_rows_match(res, seqs, eos, 12, hf_scores)


def test_generate_beam_parity_hf_suppress_mode(hf_model, params, mel_fix):
    seqs, hf_scores = _hf_generate(hf_model, mel_fix, num_beams=4, max_new=10,
                                   suppress=SUPPRESS, begin_suppress=BEGIN_SUPPRESS)
    res = _ours_generate(params, mel_fix, beam=4, max_new=10, suppress=SUPPRESS,
                         begin_suppress=BEGIN_SUPPRESS, renorm_suppressed=False)
    _assert_rows_match(res, seqs, 50257, 10, hf_scores)


def test_generate_beam_parity_v3_layout():
    """Beam-4 token and score parity on the v3 vocabulary layout (128 mel
    bins, 51866 tokens), the v3-shifted suppress specials active in HF
    order."""
    hf_model = _hf(CFG_V3, 3)
    params = _port_params(hf_model, CFG_V3)
    mel = np.random.default_rng(11).standard_normal((1, 128, 3000)).astype(np.float32)
    prompt = build_prompt("yue", "transcribe", layout=V3_LAYOUT)
    suppress = (1, 2, 7, V3_LAYOUT.sot_lm)
    begin_suppress = (220, 50257)
    seqs, hf_scores = _hf_generate(hf_model, mel, prompt, num_beams=4, max_new=10,
                                   suppress=suppress, begin_suppress=begin_suppress)
    res = _ours_generate(params, mel, CFG_V3, prompt, beam=4, max_new=10, suppress=suppress,
                         begin_suppress=begin_suppress, renorm_suppressed=False)
    _assert_rows_match(res, seqs, 50257, 10, hf_scores)
