"""tests/test_auth_unit.py and tests/test_ws_concurrent.py replayed on the
port (``wis_tpu_torch/server/auth.py``, ``server/app.py``): Basic auth and
CORS as middlewares on an aiohttp app, each case answered as ``wis_tpu``'s
middlewares answer it, and as plain functions of the settings and headers
(what runs without aiohttp); the replica pool's least-loaded pick; and
concurrent WebSocket sessions on the port's app, coalesced by its batcher.
"""

import asyncio
import base64
import itertools
import json

import numpy as np
import pytest
import torch
from aiohttp import web

from torch_port_helpers import engine_pair, serve
from wis_tpu.server import auth as jax_auth
from wis_tpu.settings import APISettings as JaxSettings
from wis_tpu_torch.audio.mel import SAMPLE_RATE
from wis_tpu_torch.server import auth
from wis_tpu_torch.settings import APISettings

torch.set_num_threads(1)


def _app(module, settings):
    async def ok(request):
        return web.json_response({"ok": True})

    app = web.Application(middlewares=[module.cors_middleware(settings),
                                       module.basic_auth_middleware(settings)])
    app.router.add_get("/x", ok)
    return app


def _both(settings, go):
    """go(client) on an app with wis_tpu's middlewares and on one with the
    port's, the same settings on each side; asserts equal; → the port's."""
    want = serve(lambda: _app(jax_auth, JaxSettings(**settings)), go)
    got = serve(lambda: _app(auth, APISettings(**settings)), go)
    assert got == want
    return got


def _basic(raw: bytes) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(raw).decode()}


async def _status(resp):
    return resp.status, resp.headers.get("WWW-Authenticate"), await resp.text()


def test_no_auth_configured_passes():
    async def go(client):
        return await _status(await client.get("/x"))

    assert _both({}, go)[0] == 200


def test_bad_base64_rejected():
    async def go(client):
        return await _status(await client.get("/x", headers={"Authorization": "Basic !!!notb64"}))

    assert _both(dict(basic_auth_user="u", basic_auth_pass="p"), go) == (
        401, 'Basic realm="wis"', '{"error": "Unauthorized"}')


@pytest.mark.parametrize("raw,want", [(b"u:wrong", 401), (b"u:p", 200), (b"v:p", 401),
                                      (b"u", 401), (b"\xff\xfe", 401)])
def test_user_and_password(raw, want):
    async def go(client):
        return await _status(await client.get("/x", headers=_basic(raw)))

    assert _both(dict(basic_auth_user="u", basic_auth_pass="p"), go)[0] == want


def test_user_only_check():
    """A falsy password: only the user name is checked."""
    async def go(client):
        return await _status(await client.get("/x", headers=_basic(b"u:anything")))

    assert _both(dict(basic_auth_user="u", basic_auth_pass=None), go)[0] == 200


@pytest.mark.parametrize("origins", [["*"], ["https://a.example"], ["https://b.example"], []])
def test_cors_headers(origins):
    async def go(client):
        out = []
        for method in ("GET", "OPTIONS"):
            resp = await client.request(method, "/x", headers={"Origin": "https://a.example"})
            out.append((resp.status, resp.headers.get("Access-Control-Allow-Origin"),
                        resp.headers.get("Access-Control-Allow-Methods"),
                        resp.headers.get("Access-Control-Allow-Headers")))
        return out

    got = _both(dict(cors_allowed_origins=origins), go)
    allowed = origins in (["*"], ["https://a.example"])
    assert [g[0] for g in got] == [200, 204]
    assert got[0][1] == ("https://a.example" if allowed else None)


def test_the_checks_without_aiohttp():
    """The plain functions the middlewares wrap."""
    s = APISettings(basic_auth_user="u", basic_auth_pass="p",
                    cors_allowed_origins=["https://a.example"])
    assert auth.basic_auth_ok(s, _basic(b"u:p"))
    assert not auth.basic_auth_ok(s, _basic(b"u:q"))
    assert not auth.basic_auth_ok(s, {"Authorization": "Bearer x"})
    assert not auth.basic_auth_ok(s, {})
    assert auth.basic_auth_ok(APISettings(), {})
    assert auth.UNAUTHORIZED == (401, {"error": "Unauthorized"},
                                 {"WWW-Authenticate": 'Basic realm="wis"'})
    assert auth.cors_headers(s, {"Origin": "https://a.example"})[
        "Access-Control-Allow-Origin"] == "https://a.example"
    assert auth.cors_headers(s, {"Origin": "https://evil.example"}) == {}
    assert auth.cors_headers(s, {}) == {}


def test_replica_pool_least_loaded():
    from wis_tpu_torch.parallel.replicas import ReplicaPool

    class FakeExec:
        def __init__(self, depth):
            self._d = depth
            self.got = 0

        @property
        def queue_depth(self):
            return self._d

        def submit(self, req):
            self.got += 1
            return "future"

    pool = ReplicaPool.__new__(ReplicaPool)
    pool.executors = [FakeExec(5), FakeExec(0), FakeExec(2)]
    pool._rr = itertools.count()
    assert pool.submit(None) == "future"
    assert pool.executors[1].got == 1  # the least loaded won


# --------------------------------------------------------------------------- #
# concurrent WebSocket sessions (tests/test_ws_concurrent.py)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_engine():
    return engine_pair(model="tiny", max_decode_tokens=4, batch_buckets=["1", "2", "4"])[1]


def test_concurrent_ws_sessions(port_engine):
    """Four WS sessions stream and stop at once on the port's app (a batch
    window of 0.5 s, so that they coalesce on a loaded host): every session
    gets its infer frame, and the batcher dispatches the four utterances in
    coalesced batches."""
    import dataclasses

    from wis_tpu_torch.server.app import create_app

    settings = dataclasses.replace(port_engine.settings, batch_window_s=0.5)
    calls = []
    real = port_engine.transcribe_coalesced

    def spy(reqs):
        calls.append(len(reqs))
        return real(reqs)

    async def one_session(client, seed):
        ws = await client.ws_connect("/api/ws/asr?model=tiny")
        await ws.send_str(json.dumps({"type": "start", "obj": {"sample_rate": 16000}}))
        await ws.receive_str()  # log
        rng = np.random.default_rng(seed)
        pcm = (rng.standard_normal(SAMPLE_RATE // 2) * 0.05 * 32767).astype("<i2")
        await ws.send_bytes(pcm.tobytes())
        await ws.send_str(json.dumps({"type": "stop", "obj": {"beam_size": 1}}))
        infer = json.loads(await ws.receive_str())
        await ws.close()
        return infer

    async def go(client):
        return await asyncio.gather(*(one_session(client, i) for i in range(4)))

    port_engine.transcribe_coalesced = spy
    try:
        infers = serve(lambda: create_app(settings=settings, engine=port_engine), go)
    finally:
        del port_engine.transcribe_coalesced
    assert [m["type"] for m in infers] == ["infer"] * 4
    assert all(isinstance(m["obj"]["text"], str) and m["obj"]["audio_duration"] == 500
               for m in infers)
    assert calls and max(calls) > 1 and sum(calls) <= 4
