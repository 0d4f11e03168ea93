"""API response shapes and the OpenAPI document (port of
``wis_tpu/server/schemas.py``, without pydantic).

The JAX module declares the shapes as pydantic models and asks them for
their JSON schemas. The card's machine has no pydantic, so here the shapes
are dataclasses and the document carries the ``ASR`` and ``Ping`` schemas
as literals: exactly what pydantic 2's ``model_json_schema()`` writes for
the JAX models (field order, titles, ``required``, and ``anyOf`` with
``null`` plus ``default: None`` for the optional ``translation``). A CPU
test holds the whole document JSON-equal to ``wis_tpu``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class Ping:
    message: str


@dataclass(kw_only=True)
class ASR:
    language: str
    infer_time: float
    translation: Optional[str] = None
    infer_speedup: int
    audio_duration: int
    text: str


@dataclass(kw_only=True)
class WillowStats(ASR):
    voice_auth: Optional[Dict[str, float]] = None
    speaker_status: Optional[str] = None


#: ``wis_tpu.server.schemas.ASR.model_json_schema()``
ASR_SCHEMA = {
    "properties": {
        "language": {"title": "Language", "type": "string"},
        "infer_time": {"title": "Infer Time", "type": "number"},
        "translation": {
            "anyOf": [{"type": "string"}, {"type": "null"}],
            "default": None,
            "title": "Translation",
        },
        "infer_speedup": {"title": "Infer Speedup", "type": "integer"},
        "audio_duration": {"title": "Audio Duration", "type": "integer"},
        "text": {"title": "Text", "type": "string"},
    },
    "required": ["language", "infer_time", "infer_speedup", "audio_duration", "text"],
    "title": "ASR",
    "type": "object",
}

#: ``wis_tpu.server.schemas.Ping.model_json_schema()``
PING_SCHEMA = {
    "properties": {"message": {"title": "Message", "type": "string"}},
    "required": ["message"],
    "title": "Ping",
    "type": "object",
}


def openapi_document(settings) -> dict:
    """Minimal OpenAPI 3.1 document for the served surface."""
    return {
        "openapi": "3.1.0",
        "info": {
            "title": settings.name,
            "description": settings.description,
            "version": settings.version,
        },
        "paths": {
            "/api/ping": {
                "get": {
                    "summary": "Ping for connectivity check",
                    "responses": {"200": {"description": "pong"}},
                }
            },
            "/api/asr": {
                "post": {
                    "summary": "Submit audio file for ASR",
                    "parameters": [
                        (
                            {
                                "name": p,
                                "in": "query",
                                "required": False,
                                "description": (
                                    "beam width; rounds UP to the nearest "
                                    "compiled beam bucket "
                                    f"({sorted(int(b) for b in settings.beam_buckets)}); "
                                    "values above the largest bucket are "
                                    "rejected with 400 (beam size is a "
                                    "compile key on TPU)"
                                ),
                            }
                            if p == "beam_size"
                            else {"name": p, "in": "query", "required": False}
                        )
                        for p in (
                            "model",
                            "detect_language",
                            "beam_size",
                            "force_language",
                            "translate",
                            "timestamps",
                            "word_timestamps",
                        )
                    ],
                    "responses": {"200": {"description": "ASR engine output"}},
                }
            },
            "/api/willow": {
                "post": {
                    "summary": "Stream Willow audio for ASR",
                    "responses": {"200": {"description": "ASR engine output"}},
                }
            },
            "/api/rtc/asr": {
                "post": {
                    "summary": "Return SDP for WebRTC clients",
                    "responses": {"200": {"description": "SDP answer"}},
                }
            },
            "/api/ws/asr": {
                "get": {
                    "summary": "WebSocket streaming ASR session "
                    "(datachannel-protocol messages)",
                    "responses": {"101": {"description": "upgrade"}},
                }
            },
            "/api/sv": {
                "post": {
                    "summary": "Speaker verification / enrollment",
                    "responses": {"200": {"description": "speaker scores"}},
                }
            },
            "/api/status": {
                "get": {
                    "summary": "Model residency / queue snapshot",
                    "responses": {"200": {"description": "status"}},
                }
            },
        },
        "components": {"schemas": {"ASR": ASR_SCHEMA, "Ping": PING_SCHEMA}},
    }
