"""What a route's core returns, and the aiohttp side of it.

Each route of the port's apps (``server/app.py``, ``server/tts_app.py``)
is split in two: a core that takes plain values (the state, the query, the
headers, the body) and returns a ``Reply``, and an aiohttp adapter that
reads the request, awaits the core and sends the reply. The cores run
without aiohttp, which the card's machine does not have; ``send`` and
``app_key`` import it when called.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional, Union

#: a request body: its bytes, or a coroutine function that reads them (an
#: adapter passes its reader, so that a request refused by its query or
#: headers is never read)
Body = Union[bytes, None, Callable[[], Awaitable[Optional[bytes]]]]


@dataclass
class Reply:
    status: int = 200
    #: a JSON body, unless ``text`` or ``stream`` is set
    json: Any = None
    #: a text body of ``content_type``
    text: Optional[str] = None
    content_type: str = "text/plain"
    headers: Dict[str, str] = field(default_factory=dict)
    #: a streamed body: the chunks in order
    stream: Optional[AsyncIterator[bytes]] = None


async def read(body: Body) -> Optional[bytes]:
    return await body() if callable(body) else body


async def send(request, reply: Reply):
    """The aiohttp response for ``reply``; a stream is written chunk by
    chunk as the core yields it."""
    from aiohttp import web

    if reply.stream is not None:
        resp = web.StreamResponse(status=reply.status, headers=reply.headers)
        await resp.prepare(request)
        async for chunk in reply.stream:
            await resp.write(chunk)
        await resp.write_eof()
        return resp
    if reply.text is not None:
        return web.Response(text=reply.text, status=reply.status,
                            content_type=reply.content_type, headers=reply.headers)
    return web.json_response(reply.json, status=reply.status, headers=reply.headers)


@functools.lru_cache(maxsize=None)
def app_key(kind: type):
    """The ``aiohttp.web.AppKey`` under which an app keeps its ``kind``
    state."""
    from aiohttp import web

    return web.AppKey(f"wis_tpu_torch.{kind.__name__}", kind)
