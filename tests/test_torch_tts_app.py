"""The port's TTS app (``wis_tpu_torch/server/tts_app.py``) held against
``wis_tpu``'s, route by route: the port's ``create_tts_app`` on the port's
micro ``XTTSModel`` (tests/test_torch_xtts_stream.py's config, the fused
path through the kernels' plain versions) and ``wis_tpu``'s on the JAX model
with the same seeded weights, one micro WavLM embedder injected into both.

Tolerance: greedy streams give the same WAV header, the same number of
chunks and bytes, and int16 samples within 1e-3 · 32767 + 1 (the float
tolerance tests/test_torch_xtts_stream.py holds, plus one rounding step);
cloned latents within one float16 ulp (1e-5 near zero) and embeddings
equal. Refusals are equal. Two
concurrent streams on one model give their lone runs' bytes.
"""

import asyncio
import json

import aiohttp
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_xtts_stream import _cfgs, _micro_embedder, _voice, _wav_upload
from torch_port_helpers import http_reply, serve
from wis_tpu.models.xtts.model import XTTSModel as JaxXTTS
from wis_tpu.server import tts_app as jax_tts
from wis_tpu.settings import APISettings as JaxSettings
from wis_tpu_torch.models.xtts.model import XTTSModel
from wis_tpu_torch.server import tts_app
from wis_tpu_torch.settings import APISettings

torch.set_num_threads(1)

#: int16 tolerance: the stream tests' 1e-3 in float, plus one rounding step
I16_TOL = int(1e-3 * 32767) + 1
GREEDY = "stream_chunk_size=8&do_sample=false&min_audio_tokens=40"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs(40)
    embed = _micro_embedder()
    jmodel = JaxXTTS(cfg=jcfg, dtype=jnp.float32)
    jmodel._spk_embed_fn = embed
    return jmodel, XTTSModel("cpu", cfg=tcfg, dtype=torch.float32, fused="on", embed_fn=embed)


class _Chunks:
    """Counts the chunks an app writes (its postprocess_int16 calls)."""

    def __init__(self, module, monkeypatch):
        self.n = 0
        real = module.postprocess_int16

        def counted(wav):
            self.n += 1
            return real(wav)

        monkeypatch.setattr(module, "postprocess_int16", counted)


def both(models, tmp_path, monkeypatch, go, voices=None):
    """go(client) on wis_tpu's TTS app (store tmp/jax) and on the port's
    (store tmp/port), each store seeded with ``voices``; → ((JAX replies,
    chunks written), (port replies, chunks written))."""
    jmodel, port = models
    out = []
    for side, module, make in (
        ("jax", jax_tts, lambda d: jax_tts.create_tts_app(JaxSettings(xtts_speaker_dir=d),
                                                          model=jmodel)),
        ("port", tts_app, lambda d: tts_app.create_tts_app(APISettings(xtts_speaker_dir=d),
                                                           model=port)),
    ):
        store = tmp_path / side
        store.mkdir()
        for name, voice in (voices or {}).items():
            (store / f"{name}.json").write_text(json.dumps(voice))
        chunks = _Chunks(module, monkeypatch)
        out.append((serve(lambda: make(str(store)), go), chunks.n))
    return out


async def _wav(resp):
    return resp.status, resp.headers.get("Content-Type"), await resp.read()


def assert_same_samples(got: bytes, want: bytes):
    assert len(got) == len(want) > 0
    a = np.frombuffer(got, "<i2").astype(np.int32)
    b = np.frombuffer(want, "<i2").astype(np.int32)
    assert np.abs(a - b).max() <= I16_TOL


def assert_same_wav(got: bytes, want: bytes):
    assert got[:44] == want[:44] and got[:4] == b"RIFF"
    assert_same_samples(got[44:], want[44:])


def _default_voice():
    latent, speaker = _voice()
    return {"gpt_cond_latent": latent.tolist(), "speaker_embedding": speaker.tolist()}


def test_tts_get_streams_what_jax_streams(models, tmp_path, monkeypatch):
    """GET /api/tts with a stored voice, greedy to the cap: the same
    header, chunk count and samples."""
    async def go(client):
        return [await _wav(await client.get(
            f"/api/tts?text=hello%20world&language=en&speaker=default&{GREEDY}"))]

    (want, n_want), (got, n_got) = both(models, tmp_path, monkeypatch, go,
                                        voices={"default": _default_voice()})
    assert got[0][:2] == want[0][:2] == (200, "audio/wav")
    assert n_got == n_want > 1
    assert_same_wav(got[0][2], want[0][2])


@pytest.mark.parametrize("add_wav_header", [True, False])
def test_tts_stream_post(models, tmp_path, monkeypatch, add_wav_header):
    """POST /tts_stream with the latents in the body (and without the WAV
    header when asked)."""
    voice = _default_voice()

    async def go(client):
        return [await _wav(await client.post("/tts_stream", json={
            "text": "hello", "language": "en", "stream_chunk_size": 8, "do_sample": False,
            "add_wav_header": add_wav_header, **voice}))]

    (want, n_want), (got, n_got) = both(models, tmp_path, monkeypatch, go)
    assert got[0][:2] == want[0][:2] == (200, "audio/wav") and n_got == n_want > 0
    if add_wav_header:
        assert_same_wav(got[0][2], want[0][2])
    else:
        assert got[0][2][:4] != b"RIFF"
        assert_same_samples(got[0][2], want[0][2])


def _assert_same_voice(got, want):
    """Latents within one float16 ulp of the larger value, or within 1e-5
    where that ulp is finer than the f32 rounding of the encoder's
    unit-scale sums (values near zero); embeddings equal."""
    lat = np.asarray(got["gpt_cond_latent"], np.float16)
    ref = np.asarray(want["gpt_cond_latent"], np.float16)
    assert lat.shape == ref.shape
    ulp = np.spacing(np.maximum(np.abs(lat), np.abs(ref))).astype(np.float32)
    assert (np.abs(lat.astype(np.float32) - ref.astype(np.float32))
            <= np.maximum(ulp, 1e-5)).all()
    assert got["speaker_embedding"] == want["speaker_embedding"]


def test_clone_enroll_and_list(models, tmp_path, monkeypatch):
    """POST /clone_speaker, POST /api/tts?speaker=bob and the speakers
    list: the same voices and the same store files."""
    async def go(client):
        form = aiohttp.FormData()
        form.add_field("wav_file", _wav_upload(), filename="v.wav")
        clone = await http_reply(await client.post("/clone_speaker", data=form))
        form = aiohttp.FormData()
        form.add_field("file", _wav_upload(3.0), filename="v.wav")
        enrol = await http_reply(await client.post("/api/tts?speaker=bob", data=form))
        return [clone, enrol, await http_reply(await client.get("/api/tts/speakers"))]

    (want, _), (got, _) = both(models, tmp_path, monkeypatch, go)
    assert [g[0] for g in got] == [w[0] for w in want] == [200] * 3
    _assert_same_voice(got[0][1], want[0][1])
    assert got[1:] == want[1:] == [(200, {"speaker": "bob", "status": "saved"}),
                                   (200, {"speakers": ["bob"]})]
    _assert_same_voice(json.loads((tmp_path / "port" / "bob.json").read_text()),
                       json.loads((tmp_path / "jax" / "bob.json").read_text()))


def test_provisioning_the_builtin_voices(models, tmp_path, monkeypatch):
    """GET /api/tts for an unknown speaker with an empty store: both apps
    clone the four built-in voices into the store, then stream in the
    default voice."""
    async def go(client):
        return [await _wav(await client.get(
            f"/api/tts?text=hi&language=en&speaker=nobody&{GREEDY}"))]

    (want, n_want), (got, n_got) = both(models, tmp_path, monkeypatch, go)
    names = ["CLB.json", "default.json", "female.json", "male.json"]
    for side in ("jax", "port"):
        assert sorted(p.name for p in (tmp_path / side).iterdir()) == names
    for name in names:
        _assert_same_voice(json.loads((tmp_path / "port" / name).read_text()),
                           json.loads((tmp_path / "jax" / name).read_text()))
    assert got[0][0] == want[0][0] == 200 and n_got == n_want > 1
    assert len(got[0][2]) == len(want[0][2])


def test_tts_refusals(models, tmp_path, monkeypatch):
    """The same 400s: an unsupported language, a traversing speaker, a
    missing speaker name, a missing upload, audio that is no audio, missing
    latents."""
    def form(name="wav_file", body=None):
        f = aiohttp.FormData()
        f.add_field(name, body if body is not None else _wav_upload(), filename="v.wav")
        return f

    async def go(client):
        return [await http_reply(r) for r in (
            await client.get("/api/tts?text=hi&language=xx"),
            await client.get("/api/tts?text=hi&speaker=../../x"),
            await client.post("/api/tts", data=form()),
            await client.post("/api/tts?speaker=a/b", data=form()),
            await client.post("/api/tts?speaker=bob", data=form("other")),
            await client.post("/api/tts?speaker=bob", data=form(body=b"not audio")),
            await client.post("/clone_speaker", data=form("other")),
            await client.post("/clone_speaker", data=form(body=b"not audio")),
            await client.post("/tts_stream", json={"text": "hi"}),
        )]

    (want, _), (got, _) = both(models, tmp_path, monkeypatch, go)
    assert got == want
    assert [g[1]["error"] for g in got] == [
        "Unsupported language xx", "Invalid speaker name", "Missing speaker name",
        "Invalid speaker name", "Missing audio upload", "Invalid audio", "Missing wav_file",
        "Invalid audio", "Missing speaker latents"]
    assert not list((tmp_path / "port").iterdir())


@pytest.mark.parametrize("sample", ["false", "true"])
def test_two_concurrent_streams_equal_their_lone_runs(models, tmp_path, sample):
    """Two GET /api/tts streams at once on one model, each the bytes of its
    lone run (sampling draws from a generator seeded per call)."""
    _, port = models
    (tmp_path / "default.json").write_text(json.dumps(_default_voice()))
    urls = [f"/api/tts?text={t}&language=en&stream_chunk_size=8&do_sample={sample}"
            f"&min_audio_tokens=24&temperature=1.0&top_k=30" for t in ("hello", "good%20bye")]

    async def lone(client):
        return [await (await client.get(u)).read() for u in urls]

    async def together(client):
        async def one(u):
            return await (await client.get(u)).read()

        return await asyncio.gather(*(one(u) for u in urls))

    def app():
        return tts_app.create_tts_app(APISettings(xtts_speaker_dir=str(tmp_path)), model=port)

    alone = serve(app, lone)
    assert alone[0] != alone[1] and all(len(b) > 44 for b in alone)
    assert serve(app, together) == alone


def test_the_stream_core_stops_its_producer(models, monkeypatch):
    """A consumer that leaves after the first chunk stops the producer at
    its next chunk: the model is not run to the end of the text."""
    _, port = models
    produced = []
    real = port.inference_stream_split

    def spy(*a, **kw):
        for chunk in real(*a, **kw):
            produced.append(len(chunk))
            yield chunk

    monkeypatch.setattr(port, "inference_stream_split", spy)
    latent, speaker = _voice()
    voice = {"gpt_cond_latent": latent, "speaker_embedding": speaker}
    params = dict(stream_chunk_size=4, do_sample=False, min_audio_tokens=40)

    async def go():
        stream = tts_app.stream_tts(port, "hello", "en", voice, params)
        header = await stream.__anext__()
        first = await stream.__anext__()
        await stream.aclose()
        return header, first

    header, first = asyncio.run(go())
    assert header[:4] == b"RIFF" and len(first) == 2 * produced[0]
    # 40 tokens in chunks of 4 after a first of 4: ten chunks in all
    assert len(produced) < 10


def test_create_tts_app_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts_app.create_tts_app(APISettings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts_app.build_tts_state(APISettings())
