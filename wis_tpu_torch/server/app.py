"""The ASR HTTP/WebSocket app (port of ``wis_tpu/server/app.py``).

Endpoints, as in the JAX app:

    GET  /api/ping          — liveness
    POST /api/asr           — multipart upload ASR with query parameters
    POST /api/willow        — raw-body ASR (x-audio-* headers)
    POST /api/rtc/asr       — WebRTC SDP offer (needs aiortc)
    GET  /api/ws/asr        — WebSocket streaming session (the datachannel
                              protocol)
    POST /api/sv            — speaker verify / enrol (?enroll=<name>)
    GET  /api/status        — residency and queue snapshot
    GET  /api/docs, /api/openapi.json — API docs
    static: /rtc, /dict, /audio

Each route is a core and an adapter (``server/reply.py``). The cores take
the app's ``AppState`` (``build_state``) and plain values and return a
``Reply``; they run every check in the JAX handler's order, so a request
refused by its query or headers is refused before its body is read or
anything is queued. ``run_ws`` is the WebSocket loop over an async
iterator of messages. ``create_app`` imports aiohttp and wraps the cores
in handlers; the card's machine has no aiohttp, so there the cores are
driven directly (``chip_smoke.py`` phase 12).

Inference goes through the port's dynamic batcher (``runtime/batcher.py``)
on its own thread, or a replica pool over every visible card
(``parallel/replicas.py``), so it never blocks the event loop.
``python -m wis_tpu_torch.server.app [port]`` serves it on the card
(``main``).
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from typing import AsyncIterator, List, Mapping, Optional, Union

import torch

from wis_tpu_torch.audio.ingest import IngestError, load_audio, pcm_to_wav_bytes
from wis_tpu_torch.device import DeviceLike, resolve_device
from wis_tpu_torch.languages import check_language
from wis_tpu_torch.parallel.replicas import ReplicaPool, cuda_devices
from wis_tpu_torch.runtime.batcher import ASRRequest, InferenceExecutor
from wis_tpu_torch.runtime.engine import WhisperEngine, unsupported_language
from wis_tpu_torch.runtime.residency import ModelRegistry
from wis_tpu_torch.server.reply import Body, Reply, app_key, read, send
from wis_tpu_torch.server.schemas import openapi_document
from wis_tpu_torch.server.session import DataChannelMessage, StreamingSession
from wis_tpu_torch.server.sv import SpeakerVerifier, sv_weights_present, valid_speaker_name
from wis_tpu_torch.settings import APISettings, get_api_settings

logger = logging.getLogger("wis_tpu_torch")

_TRUE = {"1", "true", "t", "yes", "y", "on"}


def _qbool(query: Mapping[str, str], name: str, default: bool = False) -> bool:
    raw = query.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in _TRUE


def _beam_or_none(settings: APISettings, query: Mapping[str, str], name: str, default: int):
    """Bucket-validate a request-supplied beam size BEFORE it is enqueued:
    the bucketed beam, or None (the caller answers 400)."""
    raw = query.get(name)
    try:
        beam = int(raw) if raw is not None else default
        return settings.beam_bucket(beam)
    except ValueError:
        return None


_BEAM_400 = {
    "error": "beam_size outside the compiled beam buckets "
    "(configure beam_buckets to extend)"
}


def _language_refusal(force_language: Optional[str], model: str) -> Optional[Reply]:
    if force_language and not check_language(force_language):
        return Reply(400, {"error": "Invalid force_language"})
    if force_language and unsupported_language(force_language, model):
        return Reply(400, {
            "error": f"force_language {force_language!r} requires a "
            "large-v3-family model"
        })
    return None


def _asr_response(result, include_stats: bool = True) -> dict:
    """The reference's response dict."""
    payload = {
        "infer_time": result.infer_time_ms,
        "infer_speedup": result.infer_speedup,
        "audio_duration": result.audio_duration_ms,
        "language": result.language,
        "text": result.text,
    }
    if not include_stats:
        payload = {"language": result.language, "text": result.text}
    if result.translation is not None:
        payload["translation"] = result.translation
    return payload


# --------------------------------------------------------------------------- #
# State
# --------------------------------------------------------------------------- #
@dataclass
class AppState:
    """What the routes share: ``create_app`` keeps one per application."""

    settings: APISettings
    engine: WhisperEngine
    registry: ModelRegistry
    #: the dynamic batcher, or a replica pool (the same submit interface)
    executor: Union[InferenceExecutor, ReplicaPool]
    sv: SpeakerVerifier
    sv_enabled: bool
    save_audio_path: str


def _build_executor(settings: APISettings, engine: Optional[WhisperEngine],
                    device: torch.device):
    """One engine and its executor, or a replica pool over every visible
    card when ``replica_pool`` is on and more than one is visible."""
    if (engine is None and device.type == "cuda"
            and settings.replica_pool in ("auto", "true", "1", "on")):
        devices = cuda_devices()
        if len(devices) > 1:
            pool = ReplicaPool(settings, devices=devices)
            return pool.engines[0], pool
    engine = engine or WhisperEngine(ModelRegistry(settings, device))
    return engine, InferenceExecutor(engine, settings)


def build_state(
    settings: Optional[APISettings] = None,
    engine: Optional[WhisperEngine] = None,
    static_root: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> AppState:
    """The engine (``engine``, or one on ``device``), its executor, the
    speaker verifier and its gate. Given an engine, the app runs on the
    engine's device. ``device`` defaults to the card and raises without
    one; nothing falls back to the CPU."""
    settings = settings or get_api_settings()
    device = engine.device if engine is not None else resolve_device(device)
    engine, executor = _build_executor(settings, engine, device)
    return AppState(
        settings=settings,
        engine=engine,
        registry=engine.registry,
        executor=executor,
        sv=SpeakerVerifier(settings, device=engine.device),
        # capability-gated SV: support_sv=None (auto) enables it iff WavLM
        # weights exist; an explicit true/false wins either way
        sv_enabled=(settings.support_sv if settings.support_sv is not None
                    else sv_weights_present(settings)),
        save_audio_path=os.path.join(static_root or "nginx/static", "audio", "willow.wav"),
    )


async def _run_asr(state: AppState, req: ASRRequest):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, lambda: state.executor.submit_sync(req))


# --------------------------------------------------------------------------- #
# Cores
# --------------------------------------------------------------------------- #
async def ping(state: AppState) -> Reply:
    return Reply(json={"message": "pong"})


async def asr(state: AppState, query: Mapping[str, str], audio_file: Body) -> Reply:
    """POST /api/asr: ``audio_file`` is the multipart part's bytes."""
    settings = state.settings
    model = query.get("model", settings.whisper_model_default)
    detect_language = _qbool(query, "detect_language", settings.detect_language)
    beam_size = _beam_or_none(settings, query, "beam_size", settings.beam_size)
    if beam_size is None:
        return Reply(400, _BEAM_400)
    force_language = query.get("force_language")
    translate = _qbool(query, "translate", False)
    timestamps = _qbool(query, "timestamps", False)
    word_timestamps = _qbool(query, "word_timestamps", False)
    refused = _language_refusal(force_language, model)
    if refused is not None:
        return refused

    data = await read(audio_file)
    if data is None:
        return Reply(400, {"error": "Missing audio_file"})
    try:
        audio = load_audio(bytes(data))
    except IngestError as e:
        # only codec/container faults are the client's 400; any other fault
        # surfaces as a logged 500
        logger.debug("ASR: invalid audio: %s", e)
        return Reply(400, {"error": "Invalid audio"})

    try:
        result = await _run_asr(state, ASRRequest(
            audio=audio,
            model=model,
            beam_size=beam_size,
            detect_language=detect_language,
            force_language=force_language,
            translate=translate,
            timestamps=timestamps,
            word_timestamps=word_timestamps,
        ))
    except KeyError:
        return Reply(400, {"error": f"Unknown model {model}"})
    except ValueError as e:
        return Reply(400, {"error": str(e)})
    payload = _asr_response(result)
    if timestamps and result.segments is not None:
        payload["segments"] = result.segments
    if word_timestamps and result.words is not None:
        payload["words"] = result.words
    return Reply(json=payload)


async def willow(state: AppState, query: Mapping[str, str], headers: Mapping[str, str],
                 body: Body) -> Reply:
    """POST /api/willow: the raw body, described by the Willow device's
    ``x-audio-*`` headers (names case-insensitive)."""
    settings = state.settings
    model = query.get("model", settings.whisper_model_default)
    detect_language = _qbool(query, "detect_language", settings.detect_language)
    beam_size = _beam_or_none(settings, query, "beam_size", settings.beam_size)
    if beam_size is None:
        return Reply(400, _BEAM_400)
    force_language = query.get("force_language")
    translate = _qbool(query, "translate", False)
    save_audio = _qbool(query, "save_audio", False)
    stats = _qbool(query, "stats", False)
    voice_auth = _qbool(query, "voice_auth", False)
    refused = _language_refusal(force_language, model)
    if refused is not None:
        return refused

    lowered = {}
    for k, v in headers.items():  # the first of repeated headers, as .get() gives
        lowered.setdefault(k.lower(), v)
    headers = lowered
    sample_rate = headers.get("x-audio-sample-rate", "").lower()
    bits = headers.get("x-audio-bits", "").lower()
    channel = headers.get("x-audio-channel", "").lower()
    codec = headers.get("x-audio-codec", "").lower()
    willow_id = headers.get("x-willow-id", "").lower()
    if willow_id:
        logger.debug("WILLOW: got Willow ID %s", willow_id)

    data = await read(body) or b""
    try:
        if codec == "pcm":
            audio = load_audio(data, codec="pcm", sample_rate=int(sample_rate),
                               bits=int(bits), channels=int(channel))
        elif codec == "wav":
            audio = load_audio(data, codec="wav")
        else:
            audio = load_audio(data)  # sniff the container
    except ValueError as e:  # IngestError (codec) or bad x-audio-* headers
        logger.debug("WILLOW: invalid audio: %s", e)
        return Reply(400, {"error": "Invalid audio"})

    if save_audio:
        os.makedirs(os.path.dirname(state.save_audio_path), exist_ok=True)
        with open(state.save_audio_path, "wb") as f:
            f.write(pcm_to_wav_bytes(audio))

    sv_results = None
    speaker_status = None
    if voice_auth:
        stats = True
        if not state.sv_enabled:
            return Reply(501, text="SV not supported")
        loop = asyncio.get_running_loop()
        sv_results = await loop.run_in_executor(None, state.sv.verify, audio)
        if not sv_results:
            return Reply(406, text="Unauthorized voice")
        speaker_status = f"I heard {next(iter(sv_results))} say:"

    try:
        result = await _run_asr(state, ASRRequest(
            audio=audio,
            model=model,
            beam_size=beam_size,
            detect_language=detect_language,
            force_language=force_language,
            translate=translate,
        ))
    except KeyError:
        return Reply(400, {"error": f"Unknown model {model}"})
    except ValueError as e:
        return Reply(400, {"error": str(e)})

    payload = _asr_response(result, include_stats=stats)
    if stats and voice_auth:
        payload["voice_auth"] = sv_results
        payload["speaker_status"] = speaker_status
    return Reply(json=payload)


def ws_session(state: AppState, query: Mapping[str, str]) -> StreamingSession:
    """The streaming session of one WebSocket, its defaults from the query."""
    return StreamingSession(state.executor, state.settings, {
        "model": query.get("model"),
        "beam_size": query.get("beam_size"),
        "detect_language": _qbool(query, "detect_language", False),
    })


async def run_ws(session: StreamingSession,
                 messages: AsyncIterator[Union[str, bytes]]) -> AsyncIterator[str]:
    """The WebSocket loop: text messages are JSON control messages, binary
    ones PCM audio; yields the text frames to send, in order."""
    async for msg in messages:
        if isinstance(msg, str):
            try:
                parsed = DataChannelMessage.parse(msg)
            except ValueError as e:
                yield '{"type": "error", "obj": {"msg": "%s"}}' % e
                continue
            for response in await session.handle(parsed):
                yield response
        else:
            session.feed_pcm(msg)
            if session.vad_triggered:
                for response in await session.vad_stop():
                    yield response


async def rtc(state: AppState, query: Mapping[str, str], offer) -> Reply:
    """POST /api/rtc/asr: ``offer`` is a coroutine function that reads the
    JSON body. Without aiortc: 501."""
    try:
        from wis_tpu_torch.server.rtc import rtc_offer
    except ImportError:
        return Reply(501, {"error": "WebRTC unavailable: aiortc not installed"})
    params = await offer()
    settings = state.settings
    beam_size = _beam_or_none(settings, query, "beam_size", settings.beam_size)
    if beam_size is None:
        return Reply(400, _BEAM_400)
    answer = await rtc_offer(
        state,
        params,
        model=query.get("model", settings.whisper_model_default),
        beam_size=beam_size,
        detect_language=_qbool(query, "detect_language", settings.detect_language),
    )
    return Reply(json=answer)


async def sv(state: AppState, query: Mapping[str, str], body: Body) -> Reply:
    """POST /api/sv: verify the body's voice, or enrol it as ?enroll=<name>."""
    if not state.sv_enabled:
        return Reply(501, text="SV not supported")
    name = query.get("enroll")
    if name is not None and not valid_speaker_name(name):
        # refused BEFORE any file I/O: the name becomes a file name
        return Reply(400, {"error": "Invalid speaker name"})
    try:
        audio = load_audio(await read(body) or b"")
    except IngestError:
        return Reply(400, {"error": "Invalid audio"})
    loop = asyncio.get_running_loop()
    if name:
        await loop.run_in_executor(None, state.sv.enroll, name, audio)
        return Reply(json={"enrolled": name})
    results = await loop.run_in_executor(None, state.sv.verify, audio)
    return Reply(json={"speakers": results})


def _visible_devices(device: torch.device) -> List[str]:
    """The devices of the engine's kind, as ``jax.devices()`` lists the
    default backend's."""
    if device.type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(device)]


async def status(state: AppState) -> Reply:
    """Residency and queue snapshot."""
    return Reply(json={
        "devices": _visible_devices(state.registry.device),
        "models_loaded": {
            name: {
                "param_bytes": m.param_bytes,
                "layers": m.cfg.n_audio_layer,
                "d_model": m.cfg.n_audio_state,
            }
            for name, m in state.registry.loaded().items()
        },
        "hbm_resident_bytes": state.registry.resident_bytes(),
        "hbm_budget_bytes": state.settings.hbm_budget_bytes,
        "queue_depth": state.executor.queue_depth,
        "compiled_programs": len(state.engine._programs),
    })


async def openapi(state: AppState) -> Reply:
    return Reply(json=openapi_document(state.settings))


async def docs(state: AppState) -> Reply:
    """Swagger UI over /api/openapi.json, loaded from the same CDN FastAPI
    uses; offline deployments still get the link to the schema."""
    name = state.settings.name
    return Reply(content_type="text/html", text=f"""<!DOCTYPE html>
<html>
<head>
  <title>{name} — docs</title>
  <link rel="stylesheet"
        href="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
  <div id="swagger-ui">
    <h1>{name}</h1>
    <p>OpenAPI schema: <a href="/api/openapi.json">/api/openapi.json</a>
    (interactive docs render when the Swagger UI assets are reachable)</p>
  </div>
  <script src="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
  <script>
    if (window.SwaggerUIBundle) {{
      SwaggerUIBundle({{url: "/api/openapi.json", dom_id: "#swagger-ui"}});
    }}
  </script>
</body>
</html>""")


# --------------------------------------------------------------------------- #
# aiohttp adapters
# --------------------------------------------------------------------------- #
def create_app(
    settings: Optional[APISettings] = None,
    engine: Optional[WhisperEngine] = None,
    warmup: bool = False,
    static_root: Optional[str] = None,
    device: DeviceLike = "cuda",
):
    """The aiohttp application over ``build_state``'s state (imports
    aiohttp)."""
    from aiohttp import web

    from wis_tpu_torch.server.auth import basic_auth_middleware, cors_middleware

    state = build_state(settings, engine, static_root, device)
    settings = state.settings
    app = web.Application(
        middlewares=[cors_middleware(settings), basic_auth_middleware(settings)],
        client_max_size=2 * 1024**3,  # 2 GB bodies
    )
    app[app_key(AppState)] = state

    async def audio_part(request) -> Optional[bytes]:
        async for part in await request.multipart():
            if part.name == "audio_file":
                return bytes(await part.read(decode=False))
        return None

    async def h_ping(request):
        return await send(request, await ping(state))

    async def h_asr(request):
        return await send(request, await asr(state, request.query,
                                             lambda: audio_part(request)))

    async def h_willow(request):
        return await send(request, await willow(state, request.query, request.headers,
                                                request.read))

    async def h_rtc(request):
        return await send(request, await rtc(state, request.query, request.json))

    async def h_ws(request):
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)

        async def messages():
            async for msg in ws:
                if msg.type in (web.WSMsgType.TEXT, web.WSMsgType.BINARY):
                    yield msg.data
                elif msg.type == web.WSMsgType.ERROR:
                    logger.debug("WS: connection error: %s", ws.exception())

        async for out in run_ws(ws_session(state, request.query), messages()):
            await ws.send_str(out)
        return ws

    async def h_sv(request):
        return await send(request, await sv(state, request.query, request.read))

    async def h_status(request):
        return await send(request, await status(state))

    async def h_openapi(request):
        return await send(request, await openapi(state))

    async def h_docs(request):
        return await send(request, await docs(state))

    app.router.add_get("/api/ping", h_ping)
    app.router.add_post("/api/asr", h_asr)
    app.router.add_post("/api/willow", h_willow)
    app.router.add_post("/api/rtc/asr", h_rtc)
    app.router.add_get("/api/ws/asr", h_ws)
    app.router.add_post("/api/sv", h_sv)
    app.router.add_get("/api/openapi.json", h_openapi)
    app.router.add_get("/api/docs", h_docs)
    app.router.add_get("/api/status", h_status)

    root = static_root or "nginx/static"
    for mount in ("rtc", "dict", "audio"):
        path = os.path.join(root, mount)
        if os.path.isdir(path):
            app.router.add_static(f"/{mount}", path)

    async def on_startup(app_) -> None:
        state.executor.start()
        if warmup:
            def _warm():
                state.registry.preload()
                state.engine.warmup()

            await asyncio.get_running_loop().run_in_executor(None, _warm)

    async def on_cleanup(app_) -> None:
        state.executor.shutdown()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def main() -> None:
    """``python -m wis_tpu_torch.server.app [port]``: the ASR server on the
    card, warmed up, on ``port`` (19000 by default), served as ``python -m
    wis_tpu_torch.cli run --port <port>`` serves it (needs aiohttp)."""
    import sys

    from wis_tpu_torch import cli

    port = int(sys.argv[1]) if len(sys.argv) > 1 else 19000
    cli.main(["run", "--port", str(port)])


if __name__ == "__main__":
    main()
