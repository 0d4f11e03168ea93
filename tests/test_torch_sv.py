"""The port's speaker-verification host half (``wis_tpu_torch/server/sv.py``)
held against ``wis_tpu/server/sv.py`` on the CPU: ``tests/test_wavlm.py``'s
service tests replayed (sox effects, cosine, enrol and verify on the micro
WavLM), the speaker-name guard, the weights probe and the default
embedder's directory (the same one for ``XTTSModel.clone_speaker``).
"""

import numpy as np
import pytest
import torch

from wis_tpu.server import sv as jsv
from wis_tpu_torch.models.wavlm import model as tw
from wis_tpu_torch.server import sv
from wis_tpu_torch.settings import APISettings

torch.set_num_threads(1)

MICRO = tw.WavLMConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                       conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                       num_conv_pos_embedding_groups=4, num_buckets=40, max_bucket_distance=100,
                       tdnn_dim=(24, 24, 24, 24, 48), xvector_output_dim=24)


def test_sox_norm_trim():
    audio = np.ones(20 * 16000, np.float32) * 0.5
    out = sv.sox_norm_trim(audio)
    assert out.shape[0] == 10 * 16000
    np.testing.assert_allclose(np.abs(out).max(), 10 ** (-8 / 20), atol=1e-5)
    wav = (np.random.default_rng(1).standard_normal(3 * 16000) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(sv.sox_norm_trim(wav), jsv.sox_norm_trim(wav))
    assert not sv.sox_norm_trim(np.zeros(100, np.float32)).any()


def test_cosine():
    a = np.asarray([1.0, 0.0])
    assert sv.cosine(a, a) == pytest.approx(1.0)
    assert sv.cosine(a, np.asarray([0.0, 1.0])) == pytest.approx(0.0)
    assert sv.cosine(a, np.zeros(2)) == 0.0
    b = np.random.default_rng(2).standard_normal((2, 24))
    assert sv.cosine(*b) == jsv.cosine(*b)


def test_speaker_verifier_enroll_and_verify(tmp_path):
    settings = APISettings(support_sv=True, sv_speaker_dir=str(tmp_path))
    params = tw.random_wavlm(MICRO, seed=2)

    def embed(audio):
        with torch.no_grad():
            return tw.xvector_embed(params, torch.from_numpy(audio[None]), MICRO)[0].numpy()

    verifier = sv.SpeakerVerifier(settings, embed_fn=embed)
    rng = np.random.default_rng(3)
    voice = rng.standard_normal(16000).astype(np.float32) * 0.1
    other = rng.standard_normal(16000).astype(np.float32) * 0.1
    verifier.enroll("alice", voice)
    assert (tmp_path / "alice.npy").exists()
    # identical audio matches with score ~1
    hits = verifier.verify(voice)
    assert "alice" in hits and hits["alice"] > 0.99
    # the JAX verifier reads the same store and scores the same
    jv = jsv.SpeakerVerifier(settings_jax(tmp_path), embed_fn=embed)
    assert jv.verify(voice) == hits
    verifier.enroll("bob", other)
    assert list(verifier.enrolled()) == ["alice", "bob"]
    scores = verifier.verify(other)
    assert list(scores)[0] == "bob" and scores == jv.verify(other)
    with pytest.raises(ValueError):
        verifier.enroll("../x", voice)


def settings_jax(tmp_path):
    from wis_tpu.settings import APISettings as JaxSettings

    return JaxSettings(support_sv=True, sv_speaker_dir=str(tmp_path))


@pytest.mark.parametrize("name", ["alice", "Bob_2", "a-b", "../x", "a/b", "", None, "x" * 65,
                                  "é", "a b"])
def test_valid_speaker_name(name):
    assert sv.valid_speaker_name(name) == jsv.valid_speaker_name(name)
    assert sv.valid_speaker_name(name) == (name in ("alice", "Bob_2", "a-b"))


def test_weights_probe_and_directory(tmp_path):
    settings = APISettings(model_dir=str(tmp_path))
    assert sv.wavlm_dir(settings) == str(tmp_path / "wavlm-base-plus-sv")
    assert sv.wavlm_dir() == jsv.wavlm_dir(settings_jax(tmp_path).model_copy(
        update={"model_dir": "models"}))
    assert not sv.sv_weights_present(settings)
    (tmp_path / "wavlm-base-plus-sv").mkdir()
    (tmp_path / "wavlm-base-plus-sv" / "config.json").write_text("{}")
    assert not sv.sv_weights_present(settings)
    (tmp_path / "wavlm-base-plus-sv" / "model.safetensors").write_bytes(b"")
    assert sv.sv_weights_present(settings)


def test_default_embedders_take_the_sv_directory(tmp_path, monkeypatch):
    """Without an embed_fn the verifier and XTTSModel.clone_speaker both load
    the port's WavLM from wavlm_dir (the verifier's settings; the default
    settings for the model), on their device."""
    from wis_tpu_torch.models import wavlm
    from wis_tpu_torch.models.xtts import gpt as tg
    from wis_tpu_torch.models.xtts import hifigan as th
    from wis_tpu_torch.models.xtts import model as tm

    calls = []

    def fake(model_dir, device):
        calls.append((model_dir, str(device)))
        return lambda audio: np.ones(24, np.float32)

    monkeypatch.setattr(wavlm, "default_embedder", fake)
    settings = APISettings(model_dir=str(tmp_path), sv_speaker_dir=str(tmp_path / "spk"))
    verifier = sv.SpeakerVerifier(settings, device="cpu")
    verifier.enroll("carol", np.ones(16000, np.float32))
    model = tm.XTTSModel("cpu", cfg=tm.XTTSConfig(
        gpt=tg.GPTConfig(n_layer=1, n_head=2, d_model=32),
        vocoder=th.HiFiGANConfig(in_dim=32, cond_dim=16, upsample_initial=32,
                                 upsample_rates=(4, 2), upsample_kernels=(8, 4)),
        cond_len=4), fused="off", quant="none")
    emb = model._speaker_embedding(np.ones(16000, np.float32))
    assert calls == [(str(tmp_path / "wavlm-base-plus-sv"), "cpu"),
                     (sv.wavlm_dir(), "cpu")]
    assert emb.dtype == np.float16 and emb.shape == (16,)
    np.testing.assert_allclose(np.linalg.norm(emb.astype(np.float32)), 1.0, atol=1e-3)
