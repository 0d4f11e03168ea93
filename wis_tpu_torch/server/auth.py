"""HTTP Basic auth and CORS (port of ``wis_tpu/server/auth.py``).

The checks are plain functions of the settings and the request's
headers, so that they run without aiohttp; ``basic_auth_middleware`` and
``cors_middleware`` wrap them for an aiohttp application and import
aiohttp when called.

Basic auth is active when ``basic_auth_user`` or ``basic_auth_pass`` is
configured; a falsy user or password skips that half of the check, and
with both unconfigured every request passes (the JAX module's deliberate
departure from the reference, which would lock everyone out). The
comparison is constant-time (``secrets.compare_digest``).
"""

from __future__ import annotations

import base64
import binascii
import secrets
from typing import Dict, Mapping

#: the refusal: status, JSON body, headers
UNAUTHORIZED = (401, {"error": "Unauthorized"}, {"WWW-Authenticate": 'Basic realm="wis"'})


def basic_auth_ok(settings, headers: Mapping[str, str]) -> bool:
    """True when the request may pass: auth unconfigured, or an
    ``Authorization: Basic`` header whose user and password match the
    configured halves."""
    user, password = settings.basic_auth_user, settings.basic_auth_pass
    if not user and not password:
        return True
    header = headers.get("Authorization", "")
    if not header.startswith("Basic "):
        return False
    try:
        decoded = base64.b64decode(header[6:]).decode("utf-8")
    except (binascii.Error, UnicodeDecodeError):
        return False
    got_user, _, got_pass = decoded.partition(":")
    ok = True
    if user:
        ok = ok and secrets.compare_digest(got_user, user)
    if password:
        ok = ok and secrets.compare_digest(got_pass, password)
    return ok


def cors_headers(settings, headers: Mapping[str, str]) -> Dict[str, str]:
    """The CORS headers a response to this request carries: none unless
    its ``Origin`` is allowed (``cors_allowed_origins``, ``["*"]`` for
    any)."""
    origins = settings.cors_allowed_origins
    origin = headers.get("Origin")
    if origin and (origins == ["*"] or origin in origins):
        return {
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
            "Access-Control-Allow-Headers": "*",
        }
    return {}


def basic_auth_middleware(settings):
    from aiohttp import web

    @web.middleware
    async def middleware(request, handler):
        if not basic_auth_ok(settings, request.headers):
            status, body, headers = UNAUTHORIZED
            return web.json_response(body, status=status, headers=headers)
        return await handler(request)

    return middleware


def cors_middleware(settings):
    from aiohttp import web

    @web.middleware
    async def middleware(request, handler):
        if request.method == "OPTIONS":  # a preflight: no handler runs
            resp = web.Response(status=204)
        else:
            resp = await handler(request)
        resp.headers.update(cors_headers(settings, request.headers))
        return resp

    return middleware
