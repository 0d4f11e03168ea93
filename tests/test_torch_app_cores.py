"""The port's app cores with no web framework: what the card's machine,
which has no aiohttp, aiortc, pydantic or JAX, can serve. A fresh
interpreter that refuses to import those (and ``wis_tpu``) builds
``build_state`` on a tiny Whisper engine on the CPU and drives the
``ping``, ``asr``, ``willow``, ``sv``, ``status``, ``openapi`` and ``docs``
cores, the WebSocket loop ``run_ws``, and the TTS cores on a micro XTTS
model, streams included; ``run`` refuses with an ImportError naming
aiohttp. Also: the port's own ASR replies match ``engine.transcribe`` on
the same audio.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import asyncio, io, json, sys, tempfile, wave

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("aiohttp", "aiortc", "pydantic", "jax", "jaxlib", "wis_tpu"):
            raise ImportError(f"{name} is refused here")

sys.meta_path.insert(0, Refuse())

import numpy as np
import torch

torch.set_num_threads(1)
from wis_tpu_torch.models.xtts import gpt as tg, hifigan as th, model as tm
from wis_tpu_torch.server import app, tts_app
from wis_tpu_torch.settings import APISettings

out = {}
root = tempfile.mkdtemp()
s = APISettings(whisper_model_default="tiny", dtype="float32", max_decode_tokens=4,
                beam_size=1, long_beam_size=1, batch_buckets=["1", "2"],
                xtts_speaker_dir=root + "/voices")
state = app.build_state(s, static_root=root, device="cpu")

rng = np.random.default_rng(0)
pcm = (rng.standard_normal(16000) * 0.05 * 32767).astype("<i2")
buf = io.BytesIO()
with wave.open(buf, "wb") as w:
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000); w.writeframes(pcm.tobytes())
wav = buf.getvalue()


async def asr_side():
    r = {}
    r["ping"] = (await app.ping(state)).json
    rep = await app.asr(state, {"model": "tiny"}, wav)
    r["asr"] = [rep.status, rep.json]
    r["asr_refused"] = [(await app.asr(state, {"beam_size": "9"}, wav)).status,
                        (await app.asr(state, {}, b"no audio")).json]
    rep = await app.willow(state, {"stats": "true", "save_audio": "1"}, {
        "X-Audio-Codec": "pcm", "X-Audio-Sample-Rate": "16000", "X-Audio-Bits": "16",
        "X-Audio-Channel": "1"}, pcm.tobytes())
    r["willow"] = [rep.status, rep.json]
    r["sv"] = [(await app.sv(state, {}, wav)).status,
               (await app.willow(state, {"voice_auth": "1"}, {}, wav)).text]

    async def messages():
        yield json.dumps({"type": "start", "obj": {"sample_rate": 16000}})
        for i in range(0, pcm.shape[0], 320):
            yield pcm[i:i + 320].tobytes()
        yield json.dumps({"type": "stop", "obj": {}})
        yield "{broken"

    session = app.ws_session(state, {"model": "tiny"})
    r["ws"] = [json.loads(m) for m in [m async for m in app.run_ws(session, messages())]]
    st = await app.status(state)
    r["status"] = st.json
    r["openapi"] = sorted((await app.openapi(state)).json["paths"])
    docs = await app.docs(state)
    r["docs"] = [docs.content_type, docs.text[:15]]
    r["rtc"] = [(await app.rtc(state, {}, None)).status]
    return r


state.executor.start()
try:
    out.update(asyncio.run(asr_side()))
finally:
    state.executor.shutdown()
direct = state.engine.transcribe(pcm.astype(np.float32) / 32768.0, model="tiny", beam_size=1)
out["direct"] = [direct.text, direct.language]
with wave.open(root + "/audio/willow.wav") as w:
    out["saved"] = w.getnframes()

GPT = dict(n_layer=2, n_head=2, d_model=32, n_text_vocab=256, n_audio_vocab=68,
           max_text_tokens=32, start_audio_token=66, stop_audio_token=67, max_audio_tokens=40)
VOC = dict(in_dim=32, cond_dim=16, upsample_initial=32, upsample_rates=(4, 2),
           upsample_kernels=(8, 4), resblock_kernels=(3,), resblock_dilations=((1, 3),),
           gpt_code_stride=16)
cfg = tm.XTTSConfig(gpt=tg.GPTConfig(**GPT), vocoder=th.HiFiGANConfig(**VOC),
                    text_buckets=(8, 16, 32), cond_len=4, left_context_frames=2,
                    gpt_cache_buckets=(256, 512))
model = tm.XTTSModel("cpu", cfg=cfg, dtype=torch.float32, fused="on",
                     embed_fn=lambda a: np.ones(24, np.float32))
tts = tts_app.build_tts_state(s, model=model)


async def tts_side():
    r = {}
    rep = await tts_app.tts_get(tts, {"text": "hello", "speaker": "default", "do_sample": "false",
                                      "stream_chunk_size": "8", "min_audio_tokens": "40"})
    chunks = [c async for c in rep.stream]
    r["tts"] = [rep.status, rep.headers["Content-Type"], len(chunks), chunks[0][:4].decode(),
                sum(len(c) for c in chunks[1:]) // 2]
    r["voices"] = (await tts_app.tts_speakers_list(tts)).json
    r["tts_refused"] = (await tts_app.tts_get(tts, {"language": "xx"})).json
    rep = await tts_app.tts_stream(tts, {"text": "hi", "gpt_cond_latent": [[0.0] * 32] * 4,
                                         "speaker_embedding": [0.0] * 16, "do_sample": False,
                                         "stream_chunk_size": 8})
    r["tts_stream"] = len([c async for c in rep.stream])
    r["clone"] = sorted((await tts_app.clone_speaker(tts, wav)).json)
    return r


out.update(asyncio.run(tts_side()))
voc = cfg.vocoder
out["cap_samples"] = 40 * voc.gpt_code_stride * voc.sample_rate // voc.input_sample_rate

from wis_tpu_torch.cli import main
try:
    main(["run", "--device", "cpu", "--no-warmup"])
    out["run"] = "served"
except ImportError as e:
    out["run"] = str(e)
out["refused_loaded"] = sorted({m.split(".")[0] for m in sys.modules} &
                               {"aiohttp", "aiortc", "pydantic", "jax", "jaxlib", "wis_tpu"})
print(json.dumps(out))
'''


def test_the_cores_serve_without_aiohttp_pydantic_or_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["refused_loaded"] == []
    assert out["ping"] == {"message": "pong"}
    status, body = out["asr"]
    assert status == 200 and body["audio_duration"] == 1000
    assert [body["text"], body["language"]] == out["direct"]
    assert set(body) == {"infer_time", "infer_speedup", "audio_duration", "language", "text"}
    assert out["asr_refused"] == [400, {"error": "Invalid audio"}]
    status, body = out["willow"]
    assert status == 200 and [body["text"], body["language"]] == out["direct"]
    assert out["saved"] == 16000
    assert out["sv"] == [501, "SV not supported"]
    types = [m["type"] for m in out["ws"]]
    assert types == ["log", "infer", "log", "error"]
    assert out["ws"][1]["obj"]["text"] == out["direct"][0]
    assert out["status"]["devices"] == ["cpu"] and out["status"]["queue_depth"] == 0
    assert list(out["status"]["models_loaded"]) == ["tiny"]
    assert len(out["openapi"]) == 7
    assert out["docs"] == ["text/html", "<!DOCTYPE html>"]
    assert out["rtc"] == [501]
    status, ctype, n_chunks, riff, samples = out["tts"]
    assert (status, ctype, riff) == (200, "audio/wav", "RIFF") and n_chunks > 2
    assert samples == out["cap_samples"]
    assert out["voices"] == {"speakers": ["CLB", "default", "female", "male"]}
    assert out["tts_refused"] == {"error": "Unsupported language xx"}
    assert out["tts_stream"] > 1
    assert out["clone"] == ["gpt_cond_latent", "speaker_embedding"]
    assert "aiohttp" in out["run"]
