"""XTTS streaming on the PyTorch port (``wis_tpu_torch/models/xtts/
model.py``) held against wis_tpu's ``XTTSModel`` on the CPU, at the JAX
tests' micro config with the same seeded weights: the greedy stream on the
fused path (the kernels' plain versions) and on the eager path, through a
cache-bucket grow and the remainder chunk at the token cap; a sampled
stream given JAX's key chain as gumbel rows; and the port's model served by
wis_tpu's TTS app and by the port's, cloning voices too.

Tolerance: the same chunk count and lengths, and each chunk's samples
within 1e-3 (f32 activations over int8 weights; the GPT latents agree to
~1e-5 and the vocoder's tanh output moves by less).
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_gumbel_rows
from wis_tpu.models.xtts import gpt as jg
from wis_tpu.models.xtts import hifigan as jh
from wis_tpu.models.xtts import model as jm
from wis_tpu_torch.models.xtts import gpt as tg
from wis_tpu_torch.models.xtts import hifigan as th
from wis_tpu_torch.models.xtts import model as tm

torch.set_num_threads(1)

GPT = dict(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
           max_text_tokens=32, start_audio_token=66, stop_audio_token=67)
VOC = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
           upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
           gpt_code_stride=16)


def _cfgs(max_audio_tokens=40, cache_buckets=(256, 512)):
    kw = dict(text_buckets=(8, 16, 32), cond_len=4, left_context_frames=2,
              gpt_cache_buckets=cache_buckets)
    return (
        jm.XTTSConfig(gpt=jg.GPTConfig(max_audio_tokens=max_audio_tokens, **GPT),
                      vocoder=jh.HiFiGANConfig(**VOC), **kw),
        tm.XTTSConfig(gpt=tg.GPTConfig(max_audio_tokens=max_audio_tokens, **GPT),
                      vocoder=th.HiFiGANConfig(**VOC), **kw),
    )


def _voice():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((4, 32)).astype(np.float32) * 0.1,
            rng.standard_normal(16).astype(np.float32))


def _assert_same_stream(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= 1e-3


@pytest.mark.parametrize("fused", ["on", "off"])
def test_greedy_stream_matches_jax(monkeypatch, fused):
    """Greedy, run to the token cap (min_audio_tokens = the cap): a short
    first chunk, steady chunks and the remainder chunk; on the fused path
    the cache starts in the 128 bucket and grows to the full length."""
    cap = 100 if fused == "on" else 40
    jcfg, tcfg = _cfgs(cap, (128,))
    latent, speaker = _voice()
    kw = dict(stream_chunk_size=8, overlap_wav_len=16, do_sample=False, seed=3,
              min_audio_tokens=cap)
    monkeypatch.setenv("XTTS_FUSED", "1" if fused == "on" else "0")
    jmodel = jm.XTTSModel(cfg=jcfg, dtype=jnp.float32)
    want = list(jmodel.inference_stream("hello world bucket growth", "en", latent, speaker, **kw))
    port = tm.XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused=fused)
    assert (port.gpt_packed is not None) == (fused == "on")
    got = list(port.inference_stream("hello world bucket growth", "en", latent, speaker, **kw))
    _assert_same_stream(got, want)
    voc = tcfg.vocoder
    assert sum(len(c) for c in got) == cap * voc.gpt_code_stride * voc.sample_rate \
        // voc.input_sample_rate


def test_sampled_stream_matches_jax_given_its_draws(monkeypatch):
    """Sampled decoding: the port's gumbel rows replaced by the ones JAX's
    key chain draws (per chunk ``split``, then per step), and a stop that
    ends the stream early; the fused head on."""
    jcfg, tcfg = _cfgs(40)
    latent, speaker = _voice()
    kw = dict(stream_chunk_size=8, overlap_wav_len=16, do_sample=True, temperature=1.0,
              top_k=30, top_p=0.95, seed=11, min_audio_tokens=10)
    monkeypatch.setenv("XTTS_FUSED", "0")
    want = list(jm.XTTSModel(cfg=jcfg, dtype=jnp.float32).inference_stream(
        "sampled speech", "en", latent, speaker, **kw))
    port = tm.XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused="on", fused_head=True)
    key = [jax.random.PRNGKey(kw["seed"])]

    def jax_rows(gen, n):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(jax_gumbel_rows(sub, n, tcfg.gpt.n_audio_vocab))

    monkeypatch.setattr(port, "_gumbel", jax_rows)
    got = list(port.inference_stream("sampled speech", "en", latent, speaker, **kw))
    _assert_same_stream(got, want)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_queued_chunks_change_nothing(fused):
    """pipeline_depth 3 queues chunks ahead and drops them at a stop; the
    stream is the default depth 1's, sample for sample (the draws are taken
    in dispatch order either way)."""
    _, tcfg = _cfgs(40)
    latent, speaker = _voice()
    # seed 10 draws the stop in the second chunk, so depth 3 has two more queued
    kw = dict(stream_chunk_size=8, overlap_wav_len=16, do_sample=True, temperature=1.0,
              top_k=68, top_p=1.0, seed=10, min_audio_tokens=2)
    streams = []
    for depth in (1, 3):
        port = tm.XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused=fused,
                            pipeline_depth=depth)
        streams.append(list(port.inference_stream("sampled speech", "en", latent, speaker, **kw)))
    assert len(streams[0]) == len(streams[1]) > 0
    voc = tcfg.vocoder
    assert sum(len(c) for c in streams[0]) < 40 * voc.gpt_code_stride * voc.sample_rate \
        // voc.input_sample_rate  # it stopped before the cap
    for a, b in zip(*streams):
        assert np.array_equal(a, b)


def _micro_embedder():
    """The port's x-vector at tests/test_wavlm.py's micro WavLM (seeded)."""
    from wis_tpu_torch.models.wavlm.model import WavLMConfig, default_embedder

    return default_embedder(None, "cpu", cfg=WavLMConfig(
        hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, conv_dim=(16,) * 7,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=40,
        max_bucket_distance=100, tdnn_dim=(24, 24, 24, 24, 48), xvector_output_dim=24))


def test_stream_surface():
    """speed resamples each chunk; text splitting streams per sentence;
    synthesize concatenates; clone_speaker returns a voice of the model's
    shapes."""
    _, tcfg = _cfgs(40)
    latent, speaker = _voice()
    port = tm.XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused="off",
                        embed_fn=_micro_embedder())
    kw = dict(stream_chunk_size=8, overlap_wav_len=0, do_sample=False, min_audio_tokens=16)
    base = port.synthesize("hi there", "en", latent, speaker, **kw)
    fast = port.synthesize("hi there", "en", latent, speaker, speed=2.0, **kw)
    assert base.shape[0] > 0 and abs(fast.shape[0] * 2 - base.shape[0]) <= 8
    pieces = list(port.inference_stream_split("Hi. Bye.", "en", latent, speaker,
                                              enable_text_splitting=True, **kw))
    assert len(pieces) >= 2
    voice = port.clone_speaker(np.random.default_rng(6).standard_normal(16000).astype(np.float32))
    lat = np.asarray(voice["gpt_cond_latent"], np.float32)
    emb = np.asarray(voice["speaker_embedding"], np.float32)
    assert lat.shape == (tcfg.cond_len, tcfg.gpt.d_model) and emb.shape == (tcfg.vocoder.cond_dim,)
    assert np.isfinite(lat).all() and abs(np.linalg.norm(emb) - 1.0) < 1e-2
    assert np.array_equal(port.tokenize("Pay $5, Dr. Lee!", "en"),
                          port.tokenize("pay five dollars, doctor lee!", "en"))


# --------------------------------------------------------------------------- #
# served by wis_tpu's TTS app, and by the port's
# --------------------------------------------------------------------------- #
def _jax_tts_app(model, tmp_path):
    from wis_tpu.server.tts_app import create_tts_app
    from wis_tpu.settings import APISettings

    return create_tts_app(APISettings(xtts_speaker_dir=str(tmp_path)), model=model)


def _port_tts_app(model, tmp_path):
    from wis_tpu_torch.server.tts_app import create_tts_app
    from wis_tpu_torch.settings import APISettings

    return create_tts_app(APISettings(xtts_speaker_dir=str(tmp_path)), model=model)


def _serve(model, tmp_path, go, make_app=_jax_tts_app):
    from aiohttp.test_utils import TestClient, TestServer

    async def runner():
        app = make_app(model, tmp_path)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await go(client)
        finally:
            await client.close()

    return asyncio.run(runner())


def _wav_ok(body: bytes) -> int:
    """A RIFF header, then int16 samples; → the sample count."""
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    payload = body[44:]
    assert len(payload) > 0 and len(payload) % 2 == 0
    return len(payload) // 2


def test_served_by_the_tts_app(tmp_path, make_app=_jax_tts_app):
    """POST /tts_stream with latents, and GET /api/tts with a voice saved in
    the store: both stream a well-formed WAV of the expected length."""
    _, tcfg = _cfgs(40)
    port = tm.XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused="on")
    latent, speaker = _voice()
    (tmp_path / "default.json").write_text(json.dumps(
        {"gpt_cond_latent": latent.tolist(), "speaker_embedding": speaker.tolist()}))
    voc = tcfg.vocoder
    cap_samples = 40 * voc.gpt_code_stride * voc.sample_rate // voc.input_sample_rate

    async def go(client):
        resp = await client.post("/tts_stream", json={
            "text": "hello", "language": "en", "gpt_cond_latent": latent.tolist(),
            "speaker_embedding": speaker.tolist(), "stream_chunk_size": 8, "do_sample": False})
        assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
        assert _wav_ok(await resp.read()) <= cap_samples
        resp = await client.get("/api/tts?text=hello&language=en&speaker=default"
                                "&stream_chunk_size=8&do_sample=false&min_audio_tokens=40")
        assert resp.status == 200
        assert _wav_ok(await resp.read()) == cap_samples
        resp = await client.get("/api/tts?text=hi&language=xx")
        assert resp.status == 400

    _serve(port, tmp_path, go, make_app)


def test_served_by_the_port_tts_app(tmp_path):
    """The same through the port's own TTS app (wis_tpu_torch.server.tts_app)."""
    test_served_by_the_tts_app(tmp_path, _port_tts_app)


def _wav_upload(seconds: float = 2.0) -> bytes:
    import io
    import wave

    t = np.arange(int(seconds * 16000)) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 180 * t) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def test_the_tts_app_clones_through_the_port(tmp_path, make_app=_jax_tts_app):
    """POST /clone_speaker returns the port's voice, (cond_len, D) latents
    and a cond_dim embedding; GET /api/tts with an empty store provisions
    the built-in voices through clone_speaker and streams a well-formed WAV."""
    import aiohttp

    _, tcfg = _cfgs(40)
    port = tm.XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused="on",
                        embed_fn=_micro_embedder())
    voc = tcfg.vocoder
    cap_samples = 40 * voc.gpt_code_stride * voc.sample_rate // voc.input_sample_rate

    async def go(client):
        form = aiohttp.FormData()
        form.add_field("wav_file", _wav_upload(), filename="v.wav")
        resp = await client.post("/clone_speaker", data=form)
        assert resp.status == 200
        voice = await resp.json()
        assert np.asarray(voice["gpt_cond_latent"]).shape == (tcfg.cond_len, tcfg.gpt.d_model)
        assert np.asarray(voice["speaker_embedding"]).shape == (voc.cond_dim,)
        assert not list(tmp_path.iterdir())
        resp = await client.get("/api/tts?text=hello&language=en&speaker=default"
                                "&stream_chunk_size=8&do_sample=false&min_audio_tokens=40")
        assert resp.status == 200
        assert _wav_ok(await resp.read()) == cap_samples
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "CLB.json", "default.json", "female.json", "male.json"]
        saved = json.loads((tmp_path / "female.json").read_text())
        assert np.asarray(saved["gpt_cond_latent"]).shape == (tcfg.cond_len, tcfg.gpt.d_model)

    _serve(port, tmp_path, go, make_app)


def test_the_port_tts_app_clones(tmp_path):
    """The same through the port's own TTS app."""
    test_the_tts_app_clones_through_the_port(tmp_path, _port_tts_app)
