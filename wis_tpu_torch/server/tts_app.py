"""The TTS app (port of ``wis_tpu/server/tts_app.py``), the reference
XTTS sidecar's surface:

    POST /clone_speaker      — reference wav → conditioning latents JSON
    POST /tts_stream         — JSON body streaming TTS
    GET  /api/tts            — query-parameter streaming TTS with the full
                               sampling surface and persisted speakers
    POST /api/tts            — enrol a new voice from an upload
    GET  /api/tts/speakers   — the enrolled voices

Speaker voices persist as ``<dir>/<name>.json`` with float16
``gpt_cond_latent`` + ``speaker_embedding``. Responses stream
``audio/wav``: the header first, then int16 chunks as the vocoder emits
them.

As in ``server/app.py``, each route is a core over the app's ``TTSState``
(``build_tts_state``) returning a ``Reply`` (a stream for the two TTS
routes: ``stream_tts``, an async generator fed by a producer thread) and
an aiohttp adapter that ``create_tts_app`` builds. ``python -m
wis_tpu_torch.server.tts_app [port]`` serves it on the card (``main``).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from wis_tpu_torch.audio.ingest import load_audio, wav_stream_header
from wis_tpu_torch.device import DeviceLike
from wis_tpu_torch.models.xtts.model import STREAMS, XTTS_LANGUAGES, XTTSModel
from wis_tpu_torch.server.reply import Body, Reply, app_key, read, send
from wis_tpu_torch.server.sv import valid_speaker_name
from wis_tpu_torch.settings import APISettings, get_api_settings
from wis_tpu_torch.utils.timing import StageTimer, inside, span

logger = logging.getLogger("wis_tpu_torch")

#: the streamed responses' headers
STREAM_HEADERS = {"Content-Type": "audio/wav", "Cache-Control": "public, max-age=31536000"}
#: stream ids, monotonic across the process
_stream_ids = itertools.count(1)


def postprocess_int16(wav: np.ndarray) -> bytes:
    """float wave → int16 bytes with clip and scale."""
    wav = np.clip(wav, -1.0, 1.0)
    return (wav * 32767).astype("<i2").tobytes()


class SpeakerStore:
    """JSON voice store."""

    def __init__(self, directory: str):
        self.directory = directory

    def path(self, name: str) -> str:
        # names become file names: traversal is refused before any file I/O
        # (the endpoints answer 400 before reaching here)
        if not valid_speaker_name(name):
            raise ValueError(f"invalid speaker name {name!r}")
        return os.path.join(self.directory, f"{name}.json")

    def names(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            f[:-5] for f in os.listdir(self.directory) if f.endswith(".json")
        )

    def load(self, name: str) -> Optional[Dict]:
        p = self.path(name)
        if not os.path.isfile(p):
            return None
        with open(p, encoding="utf-8") as f:
            return json.load(f)

    def save(self, name: str, latents: Dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path(name), "w", encoding="utf-8") as f:
            json.dump(latents, f)
        logger.info("TTS: saved speaker %s", name)

    def load_or_default(self, name: str, provision=None) -> Dict:
        """Unknown speakers fall back to 'default'. If no 'default' voice
        exists yet and a ``provision`` callback is given, it is called once
        to enrol the built-in voices (cloned from deterministic synthetic
        utterances). Last resort: a zero voice."""
        voice = self.load(name)
        if voice is None:
            voice = self.load("default")
        if voice is None and provision is not None:
            provision(self)
            voice = self.load(name) or self.load("default")
        if voice is None:
            voice = {
                "gpt_cond_latent": [[0.0] * 1024] * 32,
                "speaker_embedding": [0.0] * 512,
            }
        return voice


def _voice_seed_audio(f0: float, seconds: float = 4.0, sr: int = 16000) -> np.ndarray:
    """Deterministic vowel-like utterance for provisioning the built-in
    voices: an f0 harmonic stack shaped by slowly-gliding formants."""
    t = np.arange(int(seconds * sr)) / sr
    glide = 1.0 + 0.02 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * f0 * np.cumsum(glide) / sr
    wav = np.zeros_like(t, dtype=np.float64)
    formants = (500 + 80 * np.sin(2 * np.pi * 0.31 * t),
                1500 + 200 * np.sin(2 * np.pi * 0.17 * t),
                2500 * np.ones_like(t))
    for k in range(1, 40):
        fk = k * f0
        amp = sum(np.exp(-0.5 * ((fk - fc) / 220.0) ** 2) for fc in formants)
        wav += amp * np.sin(k * phase)
    wav *= 0.15 / max(np.abs(wav).max(), 1e-9)
    # amplitude syllable envelope
    wav *= 0.6 + 0.4 * np.clip(np.sin(2 * np.pi * 2.5 * t), 0.0, 1.0)
    return wav.astype(np.float32)


def provision_builtin_voices(model: XTTSModel):
    """A provision callback enrolling the reference's shipped voice set
    (default, female, male and CLB, the Arctic corpus speaker)."""

    def provision(store: SpeakerStore) -> None:
        for name, f0 in (
            ("default", 160.0),
            ("female", 225.0),
            ("male", 120.0),
            ("CLB", 210.0),
        ):
            if store.load(name) is None:
                store.save(name, model.clone_speaker(_voice_seed_audio(f0)))
        logger.info("TTS: provisioned built-in voices %s", store.names())

    return provision


def _stream_params(query: Mapping[str, str]) -> Dict:
    """The reference's full GET /api/tts sampling surface."""
    def f(name, default, cast):
        raw = query.get(name)
        if raw is None:
            return default
        try:
            return cast(raw)
        except ValueError:
            return default

    decoder = query.get("decoder", "ne_hifigan")
    if decoder not in ("ne_hifigan", "hifigan"):
        decoder = "ne_hifigan"
    return {
        "stream_chunk_size": f("stream_chunk_size", 20, int),
        "overlap_wav_len": f("overlap_wav_len", 1024, int),
        "temperature": f("temperature", 0.1, float),
        "length_penalty": f("length_penalty", 1.0, float),
        "repetition_penalty": f("repetition_penalty", 7.0, float),
        "top_k": f("top_k", 50, int),
        "top_p": f("top_p", 0.8, float),
        "do_sample": query.get("do_sample", "true").lower() in ("1", "true", "t", "yes"),
        "speed": f("speed", 1.0, float),
        "decoder": decoder,
        "enable_text_splitting": query.get("enable_text_splitting", "false").lower()
        in ("1", "true", "t", "yes"),
        # beyond the reference surface: floors the emitted token count (stop
        # masked until then), so load and latency tests can pin an
        # utterance's length under random weights; the default 0 is inert
        "min_audio_tokens": f("min_audio_tokens", 0, int),
    }


async def stream_tts(model: XTTSModel, text: str, language: str, voice: Dict, params: Dict,
                     add_wav_header: bool = True):
    """The WAV header (unless ``add_wav_header`` is false), then each chunk
    as int16 bytes as the model emits it. A producer thread runs
    ``inference_stream_split`` behind a queue of 4 chunks; a consumer that
    stops early stops the producer at its next chunk. A fault in the model
    is raised after the chunks before it.

    The producer thread leaves one ``tts_stream`` record (``utils/timing``)
    under the stream's id: the model's ``tts.prefill``, ``tts.launch`` and
    ``tts.fetch`` spans and a ``tts.handoff`` span around each chunk's put
    (the event loop's latency and the consumer's backpressure)."""
    with inside(STREAMS):
        if add_wav_header:
            yield wav_stream_header(sr=model.cfg.vocoder.sample_rate)
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue(maxsize=4)
        stop = threading.Event()
        stream_id = next(_stream_ids)

        def producer():
            with StageTimer("tts_stream", ids=[stream_id]):
                stream = model.inference_stream_split(
                    text,
                    language,
                    np.asarray(voice["gpt_cond_latent"], np.float32),
                    np.asarray(voice["speaker_embedding"], np.float32),
                    **params,
                )
                try:
                    for chunk in stream:
                        if stop.is_set():
                            break
                        with span("tts.handoff"):
                            asyncio.run_coroutine_threadsafe(queue.put(chunk), loop).result()
                finally:
                    stream.close()
                    asyncio.run_coroutine_threadsafe(queue.put(None), loop).result()

        task = loop.run_in_executor(None, producer)
        try:
            while (chunk := await queue.get()) is not None:
                yield postprocess_int16(chunk)
        finally:
            stop.set()
            while not task.done():  # a producer blocked on the full queue: make room
                while not queue.empty():
                    queue.get_nowait()
                await asyncio.sleep(0.01)
        await task


# --------------------------------------------------------------------------- #
# State and cores
# --------------------------------------------------------------------------- #
@dataclass
class TTSState:
    settings: APISettings
    model: XTTSModel
    speakers: SpeakerStore
    #: enrols the built-in voices when the store has no 'default'
    provision: Callable[[SpeakerStore], None]


def build_tts_state(settings: Optional[APISettings] = None, model: Optional[XTTSModel] = None,
                    device: DeviceLike = "cuda") -> TTSState:
    """The model (``model``, or XTTS v2 on ``device``, the card by default,
    which raises without one), the voice store and its provisioning."""
    settings = settings or get_api_settings()
    model = model or XTTSModel(device, quant=settings.xtts_quant)
    return TTSState(settings, model, SpeakerStore(settings.xtts_speaker_dir),
                    provision_builtin_voices(model))


async def _clone(state: TTSState, audio: np.ndarray) -> Dict:
    return await asyncio.get_running_loop().run_in_executor(None, state.model.clone_speaker,
                                                            audio)


async def clone_speaker(state: TTSState, wav_file: Body) -> Reply:
    """POST /clone_speaker: ``wav_file`` is the uploaded part's bytes."""
    data = await read(wav_file)
    if data is None:
        return Reply(400, {"error": "Missing wav_file"})
    try:
        audio = load_audio(bytes(data))
    except Exception:  # noqa: BLE001 — any undecodable upload is the client's 400
        return Reply(400, {"error": "Invalid audio"})
    return Reply(json=await _clone(state, audio))


async def tts_stream(state: TTSState, body: Dict) -> Reply:
    """POST /tts_stream: ``body`` is the request's JSON object."""
    text = body.get("text", "")
    language = body.get("language", "en")
    voice = {
        "gpt_cond_latent": body.get("gpt_cond_latent"),
        "speaker_embedding": body.get("speaker_embedding"),
    }
    if voice["gpt_cond_latent"] is None or voice["speaker_embedding"] is None:
        return Reply(400, {"error": "Missing speaker latents"})
    # the reference's StreamingInputs carries the full sampling surface
    decoder = body.get("decoder", "ne_hifigan")
    if decoder not in ("ne_hifigan", "hifigan"):
        decoder = "ne_hifigan"
    params = {
        "stream_chunk_size": int(body.get("stream_chunk_size", 20)),
        "temperature": float(body.get("temperature", 0.1)),
        "length_penalty": float(body.get("length_penalty", 1.0)),
        "repetition_penalty": float(body.get("repetition_penalty", 7.0)),
        "top_k": int(body.get("top_k", 50)),
        "top_p": float(body.get("top_p", 0.8)),
        "do_sample": bool(body.get("do_sample", True)),
        "speed": float(body.get("speed", 1.0)),
        "decoder": decoder,
        "enable_text_splitting": bool(body.get("enable_text_splitting", False)),
    }
    add_header = bool(body.get("add_wav_header", True))
    return Reply(headers=dict(STREAM_HEADERS), stream=stream_tts(
        state.model, text, language, voice, params, add_wav_header=add_header))


async def tts_get(state: TTSState, query: Mapping[str, str]) -> Reply:
    """GET /api/tts, the Willow streaming endpoint."""
    text = query.get("text", "")
    language = query.get("language", "en").lower()
    if language not in XTTS_LANGUAGES:
        return Reply(400, {"error": f"Unsupported language {language}"})
    speaker = query.get("speaker", "default")
    if not valid_speaker_name(speaker):
        return Reply(400, {"error": "Invalid speaker name"})
    voice = await asyncio.get_running_loop().run_in_executor(
        None, state.speakers.load_or_default, speaker, state.provision)
    return Reply(headers=dict(STREAM_HEADERS), stream=stream_tts(
        state.model, text, language, voice, _stream_params(query)))


async def tts_enroll(state: TTSState, query: Mapping[str, str], wav_file: Body) -> Reply:
    """POST /api/tts?speaker=<name>: enrol the uploaded voice."""
    speaker = query.get("speaker")
    if not speaker:
        return Reply(400, {"error": "Missing speaker name"})
    if not valid_speaker_name(speaker):
        return Reply(400, {"error": "Invalid speaker name"})
    data = await read(wav_file)
    if data is None:
        return Reply(400, {"error": "Missing audio upload"})
    try:
        audio = load_audio(bytes(data))
    except Exception:  # noqa: BLE001 — any undecodable upload is the client's 400
        return Reply(400, {"error": "Invalid audio"})
    state.speakers.save(speaker, await _clone(state, audio))
    return Reply(json={"speaker": speaker, "status": "saved"})


async def tts_speakers_list(state: TTSState) -> Reply:
    return Reply(json={"speakers": state.speakers.names()})


# --------------------------------------------------------------------------- #
# aiohttp adapters
# --------------------------------------------------------------------------- #
def create_tts_app(settings: Optional[APISettings] = None, model: Optional[XTTSModel] = None,
                   device: DeviceLike = "cuda"):
    """The aiohttp application over ``build_tts_state``'s state (imports
    aiohttp)."""
    from aiohttp import web

    state = build_tts_state(settings, model, device)
    app = web.Application(client_max_size=512 * 1024**2)
    app[app_key(TTSState)] = state

    async def upload(request) -> Optional[bytes]:
        async for part in await request.multipart():
            if part.name in ("wav_file", "audio_file", "file"):
                return bytes(await part.read(decode=False))
        return None

    async def h_clone(request):
        return await send(request, await clone_speaker(state, lambda: upload(request)))

    async def h_stream(request):
        return await send(request, await tts_stream(state, await request.json()))

    async def h_get(request):
        return await send(request, await tts_get(state, request.query))

    async def h_enroll(request):
        return await send(request, await tts_enroll(state, request.query,
                                                    lambda: upload(request)))

    async def h_speakers(request):
        return await send(request, await tts_speakers_list(state))

    app.router.add_post("/clone_speaker", h_clone)
    app.router.add_post("/tts_stream", h_stream)
    app.router.add_get("/api/tts", h_get)
    app.router.add_post("/api/tts", h_enroll)
    app.router.add_get("/api/tts/speakers", h_speakers)
    return app


def main() -> None:
    """``python -m wis_tpu_torch.server.tts_app [port]``: the TTS server on
    the card on ``port`` (19010 by default), served as ``python -m
    wis_tpu_torch.cli run-tts --port <port>`` serves it (needs aiohttp)."""
    import sys

    from wis_tpu_torch import cli

    port = int(sys.argv[1]) if len(sys.argv) > 1 else 19010
    cli.main(["run-tts", "--port", str(port)])


if __name__ == "__main__":
    main()
