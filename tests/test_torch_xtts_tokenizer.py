"""The ``tokenizer.json`` branch of the port's ``XTTSModel``
(``_load_tokenizer`` / ``tokenize``), ``tests/test_xtts_tokenizer.py``
replayed on ``wis_tpu_torch``: a trained BPE loads, ``tokenize`` is the
``[lang]``-prefixed cleaned text through it (the same ids as wis_tpu's
model), the language prefix is one special token, the ids stay inside
the text vocabulary, a stream runs on them, and a corrupt file falls back
to the byte mapping.
"""

import numpy as np
import pytest
import torch

from test_xtts_tokenizer import LANG_TOKENS
from test_xtts_tokenizer import MICRO as JAX_MICRO
from wis_tpu_torch.models.xtts.gpt import GPTConfig
from wis_tpu_torch.models.xtts.hifigan import HiFiGANConfig
from wis_tpu_torch.models.xtts.model import XTTSConfig, XTTSModel
from wis_tpu_torch.models.xtts.textnorm import preprocess_text

torch.set_num_threads(1)

MICRO = XTTSConfig(
    gpt=GPTConfig(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
                  max_text_tokens=32, max_audio_tokens=40, start_audio_token=66,
                  stop_audio_token=67),
    vocoder=HiFiGANConfig(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
                          upsample_kernels=(8, 4), resblock_kernels=(3,),
                          resblock_dilations=((1, 3),), gpt_code_stride=16),
    text_buckets=(8, 16, 32),
    cond_len=4,
    left_context_frames=2,
)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A genuine BPE trained on synthetic text (the tokenizer family a real
    model_dir ships), saved where XTTSModel looks for it."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    corpus = [
        "the quick brown fox jumps over the lazy dog",
        "hello world this is a streaming speech test",
        "numbers like twenty two and dates matter",
        "el rapido zorro marron salta sobre el perro",
    ] * 8
    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=180, special_tokens=["[UNK]"] + LANG_TOKENS)
    tok.train_from_iterator(corpus, trainer)
    d = tmp_path_factory.mktemp("xtts_model")
    tok.save(str(d / "tokenizer.json"))
    return str(d)


@pytest.fixture(scope="module")
def model(model_dir):
    return XTTSModel("cpu", cfg=MICRO, dtype=torch.float32, fused="off", model_dir=model_dir)


def test_real_tokenizer_branch_loads(model):
    assert model._tokenizer is not None, "tokenizer.json branch not taken"


def test_tokenize_matches_direct_bpe_encode(model, model_dir):
    """tokenize() == preprocess → [lang] prefix → the BPE's encode, not the
    byte fallback, and wis_tpu's model gives the same ids."""
    import jax.numpy as jnp

    from wis_tpu.models.xtts.model import XTTSModel as JaxModel

    text = "Hello World, the quick brown fox!"
    ids = model.tokenize(text, "en")
    prompt = f"[en]{preprocess_text(text, 'en')}"
    expect = model._tokenizer.encode(prompt).ids
    assert ids.tolist() == expect[: MICRO.gpt.max_text_tokens]
    byte_fallback = [7 + (b % (MICRO.gpt.n_text_vocab - 10)) for b in prompt.encode()]
    assert ids.tolist() != byte_fallback[: MICRO.gpt.max_text_tokens]
    jmodel = JaxModel(model_dir=model_dir, cfg=JAX_MICRO, dtype=jnp.float32)
    for lang, t in (("en", text), ("es", "el rapido zorro"), ("de", "twenty two 22")):
        np.testing.assert_array_equal(model.tokenize(t, lang), jmodel.tokenize(t, lang))


def test_lang_prefix_is_single_special_token(model):
    en = model.tokenize("hello", "en")
    es = model.tokenize("hello", "es")
    assert en[0] != es[0]
    only = model._tokenizer.encode("[en]").ids
    assert len(only) == 1 and en[0] == only[0]


def test_ids_fit_text_vocab(model):
    ids = model.tokenize("the quick brown fox jumps over the lazy dog", "en")
    assert ids.dtype == np.int32
    assert (ids >= 0).all() and (ids < MICRO.gpt.n_text_vocab).all()


def test_stream_end_to_end_through_real_tokenizer(model):
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((MICRO.cond_len, MICRO.gpt.d_model)).astype(np.float32) * 0.05
    speaker = rng.standard_normal(MICRO.vocoder.cond_dim).astype(np.float32)
    chunks = list(model.inference_stream("the quick brown fox", "en", latent, speaker,
                                         stream_chunk_size=8, overlap_wav_len=16,
                                         do_sample=False, min_audio_tokens=8))
    assert chunks, "no audio chunks produced"
    wav = np.concatenate(chunks)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()


def test_corrupt_tokenizer_falls_back(tmp_path):
    """A broken tokenizer.json logs and falls back to the byte mapping."""
    (tmp_path / "tokenizer.json").write_text("{not valid json]")
    m = XTTSModel("cpu", cfg=MICRO, dtype=torch.float32, fused="off", model_dir=str(tmp_path))
    assert m._tokenizer is None
    ids = m.tokenize("hello", "en")
    assert (ids < MICRO.gpt.n_text_vocab).all()
