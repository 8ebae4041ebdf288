"""The REST half of the port's fake brokers on the stdlib: the Pulsar admin
API of ``pulsar_fake.py`` and the Pravega controller API of
``pravega_fake.py`` (the JAX package's fakes serve both on ``aiohttp.web``,
which the card's machine does not have).

A ``ThreadingHTTPServer`` (HTTP/1.1) answers on request threads; a handler
never runs there. Each request is handed to the fake's event loop
(``run_coroutine_threadsafe``) and its thread waits for the answer, so only
the loop's thread touches the fake's state. The answers are aiohttp's:
``json_response`` gives ``application/json; charset=utf-8`` and
``json.dumps`` of the document, ``Response`` an empty body; a path no route
matches is 404, a path matched under another method 405, a handler that
raises 500.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import threading
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Awaitable, Callable, Optional

log = logging.getLogger(__name__)

# how long a request thread waits for the loop to answer
HANDLER_TIMEOUT_S = 60.0


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: Optional[str] = None


def json_response(doc: Any, status: int = 200) -> Response:
    return Response(status, json.dumps(doc).encode(), "application/json; charset=utf-8")


@dataclass
class Request:
    """What a handler reads: the path's named segments (``match_info``,
    percent-decoded) and the body."""

    match_info: dict[str, str]
    body: bytes = b""
    query: dict[str, str] = field(default_factory=dict)

    async def read(self) -> bytes:
        return self.body

    async def json(self) -> Any:
        return json.loads(self.body.decode())


Handler = Callable[[Request], Awaitable[Response]]


def _compile(pattern: str) -> re.Pattern:
    """``/v1/scopes/{scope}`` → a regex with one named group a segment."""
    parts = re.split(r"\{(\w+)\}", pattern)
    out = []
    for i, part in enumerate(parts):
        out.append(f"(?P<{part}>[^/]+)" if i % 2 else re.escape(part))
    return re.compile("^" + "".join(out) + "$")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # the head and the body go out in two writes: without TCP_NODELAY a
    # keep-alive client's delayed ACK holds the body ~40 ms
    disable_nagle_algorithm = True
    server: "_Server"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), fmt % args)

    def _answer(self, resp: Response) -> None:
        self.send_response(resp.status)
        if resp.content_type:
            self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        if resp.body:
            self.wfile.write(resp.body)

    def _handle(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b""
        split = urllib.parse.urlsplit(self.path)
        allowed = False
        for method, regex, handler in self.server.routes:
            match = regex.match(split.path)
            if match is None:
                continue
            if method != self.command:
                allowed = True
                continue
            params = {k: urllib.parse.unquote(v) for k, v in match.groupdict().items()}
            request = Request(params, body, dict(urllib.parse.parse_qsl(split.query)))
            future = asyncio.run_coroutine_threadsafe(handler(request), self.server.loop)
            try:
                resp = future.result(HANDLER_TIMEOUT_S)
            except Exception:  # noqa: BLE001 — aiohttp answers a raising handler 500
                log.exception("fake REST handler %s %s failed", self.command, split.path)
                resp = Response(500)
            self._answer(resp)
            return
        self._answer(Response(405 if allowed else 404))

    do_GET = do_PUT = do_POST = do_DELETE = _handle  # noqa: N815 — the stdlib's spelling


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    routes: list = []
    loop: asyncio.AbstractEventLoop


class FakeRestServer:
    """``routes``: ``(method, "/path/{name}", handler)``; ``start`` on the
    fake's loop, then ``port``."""

    def __init__(self, host: str, routes: list[tuple[str, str, Handler]]) -> None:
        self.host = host
        self._routes = [(m.upper(), _compile(p), h) for m, p, h in routes]
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self.port = 0

    async def start(self) -> int:
        server = _Server((self.host, 0), _Handler)
        server.routes = self._routes
        server.loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            name="fake-rest", daemon=True,
        )
        self._thread.start()
        self._server = server
        self.port = server.server_address[1]
        return self.port

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        # request threads may be waiting for this loop: keep it running
        await asyncio.to_thread(server.shutdown)
        server.server_close()
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join)
            self._thread = None
