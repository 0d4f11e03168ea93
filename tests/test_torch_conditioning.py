"""The port's XTTS voice cloning (``wis_tpu_torch/models/xtts/
conditioning.py``, ``convert.conditioning_from_coqui`` and
``XTTSModel.clone_speaker``) held against wis_tpu's on the CPU, on the same
seeded numpy inputs:

- ``conditioning_forward`` on the converted tree of
  ``tests/test_xtts_conditioning.py``'s state dict and on
  ``random_conditioning``'s tree (bit-equal in both packages), at its
  (2, 20, 50) mel, an odd T and a short one, within rtol/atol 2e-4 (the
  bound the JAX package's own test holds its forward to);
- the converter: every key read, an extra key reported, the ``g`` alias,
  each leaf equal to JAX's conversion;
- ``clone_speaker`` on the JAX test's micro XTTS with one micro WavLM
  embedder injected into both models: the latents within one float16 ulp
  of JAX's, the embedding unit-norm at ``cond_dim``, and a stream in the
  cloned voice;
- a ``model.pth`` with the conditioning keys gives both models the same
  conditioning tree; without them both clone with the seeded one.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_xtts_checkpoint import _assert_trees_equal
from test_xtts_conditioning import CFG as JCFG
from test_xtts_conditioning import _synthetic_sd
from wis_tpu.models.xtts import conditioning as jcond
from wis_tpu.models.xtts import convert as jc
from wis_tpu.models.xtts import gpt as jg
from wis_tpu.models.xtts import hifigan as jh
from wis_tpu.models.xtts import model as jm
from wis_tpu_torch.models.wavlm.model import default_embedder
from wis_tpu_torch.models.xtts import conditioning as tcond
from wis_tpu_torch.models.xtts import convert as tc
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts import model as tm
from wis_tpu_torch.utils.selftest import synthetic_coqui_sd

torch.set_num_threads(1)

TCFG = tcond.ConditioningConfig(**dataclasses.asdict(JCFG))


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _trees(source: str):
    """(JAX tree, port tree) of the conditioning encoder."""
    if source == "random":
        return jcond.random_conditioning(JCFG, seed=3), tcond.random_conditioning(TCFG, seed=3)
    sd = _synthetic_sd(JCFG)
    jp = jc.conditioning_from_coqui(sd, JCFG, dtype=np.float32)
    tp = tc.conditioning_from_coqui(_torch_sd(sd), TCFG)
    assert jp.pop("_unmapped") == tp.pop("_unmapped") == []
    return jp, tp


@pytest.mark.parametrize("t", [50, 37, 13])
@pytest.mark.parametrize("source", ["coqui", "random"])
def test_forward_matches_jax(source, t):
    """T 50 (the JAX test's), odd 37 and 13 (neither a multiple of the
    GroupNorm's 8 channels a group)."""
    jp, tp = _trees(source)
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((2, JCFG.n_mels, t)) * 0.5).astype(np.float32)
    want = np.asarray(jcond.conditioning_forward(jp, jnp.asarray(mel), JCFG))
    with torch.no_grad():
        got = tcond.conditioning_forward(tp, torch.from_numpy(mel), TCFG).numpy()
    assert got.shape == want.shape == (2, JCFG.n_latents, JCFG.d_model)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the clone program: one mel, the same function (a batch of one blocks
    # the CPU's products another way)
    program = tcond.build_clone_program(TCFG)
    np.testing.assert_allclose(program(tp, torch.from_numpy(mel[:1])).numpy(), got[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("source", ["coqui", "random"])
def test_trees_equal_jax_leaf_for_leaf(source):
    jp, tp = _trees(source)
    _assert_trees_equal(tp, jp)


def test_converter_reports_extra_keys_and_takes_the_g_alias():
    sd = _synthetic_sd(JCFG, seed=3)
    sd["gpt.conditioning_perceiver.extra.weight"] = np.zeros(3, np.float32)
    sd["gpt.text_embedding.weight"] = np.zeros((4, 4), np.float32)  # outside both prefixes
    assert tc.conditioning_from_coqui(_torch_sd(sd), TCFG)["_unmapped"] == [
        "gpt.conditioning_perceiver.extra.weight"]

    renamed = {k.replace("norm.gamma", "norm.g").replace(".0.gamma", ".0.g"): v
               for k, v in _synthetic_sd(JCFG, seed=4).items()}
    assert any(k.endswith(".0.g") for k in renamed)
    tp = tc.conditioning_from_coqui(_torch_sd(renamed), TCFG)
    jp = jc.conditioning_from_coqui(renamed, JCFG, dtype=np.float32)
    assert tp.pop("_unmapped") == jp.pop("_unmapped") == []
    _assert_trees_equal(tp, jp)


# --------------------------------------------------------------------------- #
# clone_speaker
# --------------------------------------------------------------------------- #
#: tests/test_xtts_conditioning.py's micro XTTS (test_clone_speaker_shapes)
MICRO_GPT = dict(n_layer=2, n_head=2, d_model=64)
MICRO_VOC = dict(in_dim=64, cond_dim=32, upsample_initial=32, upsample_rates=(4, 4),
                 upsample_kernels=(8, 8))
#: tests/test_wavlm.py's micro WavLM
MICRO_WAVLM = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                   conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, num_buckets=40, max_bucket_distance=100,
                   tdnn_dim=(24, 24, 24, 24, 48), xvector_output_dim=24)


def micro_embedder():
    """The port's x-vector at the micro WavLM on seeded weights (CPU)."""
    from wis_tpu_torch.models.wavlm.model import WavLMConfig

    return default_embedder(None, "cpu", cfg=WavLMConfig(**MICRO_WAVLM))


@pytest.fixture(scope="module")
def clone_pair():
    embed = micro_embedder()
    jmodel = jm.XTTSModel(cfg=jm.XTTSConfig(gpt=jg.GPTConfig(**MICRO_GPT),
                                            vocoder=jh.HiFiGANConfig(**MICRO_VOC), cond_len=4))
    jmodel._spk_embed_fn = embed
    port = tm.XTTSModel("cpu", cfg=tm.XTTSConfig(gpt=tg.GPTConfig(**MICRO_GPT),
                                                  vocoder=th.HiFiGANConfig(**MICRO_VOC),
                                                  cond_len=4),
                        fused="off", embed_fn=embed)
    audio = (np.random.default_rng(0).standard_normal(16000 * 3) * 0.1).astype(np.float32)
    return jmodel.clone_speaker(audio), port.clone_speaker(audio), port


def test_clone_speaker_matches_jax(clone_pair):
    want, got, _ = clone_pair
    lat = np.asarray(got["gpt_cond_latent"], np.float16)
    ref = np.asarray(want["gpt_cond_latent"], np.float16)
    assert lat.shape == ref.shape == (4, 64)
    ulp = np.spacing(np.maximum(np.abs(lat), np.abs(ref)))
    assert (np.abs(lat.astype(np.float32) - ref.astype(np.float32))
            <= ulp.astype(np.float32)).all()
    emb = np.asarray(got["speaker_embedding"], np.float32)
    assert emb.shape == (32,) and np.isfinite(emb).all()
    assert abs(np.linalg.norm(emb) - 1.0) < 1e-2
    np.testing.assert_array_equal(emb, np.asarray(want["speaker_embedding"], np.float32))


def test_cloned_voice_streams(clone_pair):
    _, voice, port = clone_pair
    chunks = list(itertools.islice(port.inference_stream(
        "hello there", "en", np.asarray(voice["gpt_cond_latent"], np.float32),
        np.asarray(voice["speaker_embedding"], np.float32), stream_chunk_size=8,
        do_sample=False, min_audio_tokens=16), 2))
    assert len(chunks) == 2
    assert all(c.dtype == np.float32 and c.size > 0 and np.isfinite(c).all() for c in chunks)


# --------------------------------------------------------------------------- #
# the checkpoint hook
# --------------------------------------------------------------------------- #
GPT = dict(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
           max_text_tokens=32, max_audio_tokens=40, start_audio_token=66,
           stop_audio_token=67)
VOC = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
           upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
           gpt_code_stride=16)
KW = dict(text_buckets=(8, 16, 32), cond_len=4, left_context_frames=2)


def _models(model_dir):
    jmodel = jm.XTTSModel(model_dir, cfg=jm.XTTSConfig(gpt=jg.GPTConfig(**GPT),
                                                       vocoder=jh.HiFiGANConfig(**VOC), **KW),
                          dtype=jnp.float32)
    port = tm.XTTSModel("cpu", cfg=tm.XTTSConfig(gpt=tg.GPTConfig(**GPT),
                                                  vocoder=th.HiFiGANConfig(**VOC), **KW),
                        dtype=torch.float32, model_dir=model_dir, fused="off")
    return jmodel, port


@pytest.mark.parametrize("complete", [True, False])
def test_model_pth_conditioning(tmp_path, complete):
    """With every conditioning key, both models convert the same tree, and
    it is not the seeded one; without one of them, both log and clone with
    the seeded tree (the GPT and vocoder still load from the file)."""
    cond_cfg = _models(None)[1]._cond_cfg()
    sd = synthetic_coqui_sd(tg.GPTConfig(**GPT), th.HiFiGANConfig(**VOC), cond_cfg, seed=7)
    if not complete:
        del sd["gpt.conditioning_encoder.attn.1.qkv.bias"]
    torch.save({"model": sd}, tmp_path / "model.pth")
    jmodel, port = _models(str(tmp_path))
    assert (port._cond_params is not None) == complete
    _assert_trees_equal(port._conditioning()[1], jmodel._conditioning()[1])
    seeded = tcond.random_conditioning(cond_cfg)
    assert torch.equal(port._cond_params["latents"], seeded["latents"]) != complete
    assert not torch.equal(port.gpt_params["text_emb"], _models(None)[1].gpt_params["text_emb"])


def test_synthetic_checkpoint_keys_equal_jax():
    """With a conditioning config the port's key list is the JAX package's
    whole list: the same keys, shapes and (zero-filled) values."""
    from wis_tpu.utils.selftest import synthetic_coqui_sd as jax_sd

    jsd = jax_sd(jg.GPTConfig(**GPT), jh.HiFiGANConfig(**VOC), JCFG)
    mine = synthetic_coqui_sd(tg.GPTConfig(**GPT), th.HiFiGANConfig(**VOC), TCFG)
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in jsd.items()}
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)
