"""The port's HTTP client on the stdlib, for the remote AI providers, the
gateway's authentication providers and the http / storage agents (the JAX
package's clients use aiohttp, which the card's machine does not have).

Every request runs ``urllib`` in a worker thread, so no call holds the
event loop that the gateway, the broker, the runners and the provider's
chunk writer share. A streamed answer (server-sent events) is read line by
line in a worker thread and handed to the loop through an
``asyncio.Queue`` (``stream``), so its consumer runs on the loop's thread,
in order. No proxy is taken from the environment (aiohttp's session
default). The answers are read as aiohttp reads them: ``Response.text``
decodes with the content type's charset, else UTF-8; ``Response.json``
parses whatever the content type (aiohttp's ``json(content_type=None)``),
and an empty body is None.
"""

from __future__ import annotations

import asyncio
import codecs
import http.cookiejar
import ipaddress
import json
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass
from email.message import Message
from typing import Any, AsyncIterator, Optional
from urllib.parse import urlparse

# aiohttp's default total timeout of a request
TIMEOUT_S = 300.0
# no proxy from the environment (aiohttp's session default)
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class HttpStatusError(RuntimeError):
    """A 4xx / 5xx answer where the caller asked for a success (aiohttp's
    ``raise_for_status``; the text is ``ClientResponseError``'s)."""

    def __init__(self, status: int, reason: str, url: str) -> None:
        super().__init__(f"{status}, message={reason!r}, url={url!r}")
        self.status = status


@dataclass
class Response:
    status: int
    reason: str
    headers: Message
    body: bytes
    url: str

    @property
    def content_type(self) -> str:
        """The media type, lower case (aiohttp's ``content_type``; no
        header reads as ``application/octet-stream``)."""
        raw = self.headers.get("Content-Type")
        if not raw:
            return "application/octet-stream"
        return raw.split(";", 1)[0].strip().lower()

    def encoding(self) -> str:
        charset = self.headers.get_content_charset() if self.headers.get("Content-Type") else None
        if charset:
            try:
                codecs.lookup(charset)
                return charset
            except LookupError:
                pass
        return "utf-8"

    def text(self) -> str:
        return self.body.decode(self.encoding())

    def json(self) -> Any:
        stripped = self.body.strip()
        if not stripped:
            return None
        return json.loads(stripped.decode(self.encoding()))

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HttpStatusError(self.status, self.reason, self.url)


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """Hands a 3xx back as the answer (aiohttp's ``allow_redirects=False``)."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):  # noqa: ANN001
        return None


class _NoIpCookies(http.cookiejar.DefaultCookiePolicy):
    """aiohttp's default cookie jar (``unsafe=False``) keeps no cookie set
    by a host named by its IP address."""

    def set_ok(self, cookie, request):  # noqa: ANN001
        host = urlparse(request.get_full_url()).hostname or ""
        try:
            ipaddress.ip_address(host)
            return False
        except ValueError:
            return super().set_ok(cookie, request)


def build_opener(follow_redirects: bool = True, cookies: bool = False):
    """An opener of its own (one agent's session): redirects followed or
    handed back, and a cookie jar kept across its requests."""
    handlers: list = [urllib.request.ProxyHandler({})]
    if not follow_redirects:
        handlers.append(_NoRedirect())
    if cookies:
        jar = http.cookiejar.CookieJar(policy=_NoIpCookies())
        handlers.append(urllib.request.HTTPCookieProcessor(jar))
    return urllib.request.build_opener(*handlers)


def send(method: str, url: str, body: Optional[bytes] = None,
         headers: Optional[dict[str, str]] = None, timeout: float = TIMEOUT_S,
         opener=None) -> Response:
    """One blocking request → its ``Response`` (a 4xx / 5xx too). A POST,
    PUT or PATCH without a body or a content type says
    ``application/octet-stream``, as aiohttp's does."""
    headers = dict(headers or {})
    if (body is None and method in ("POST", "PUT", "PATCH")
            and not any(k.lower() == "content-type" for k in headers)):
        headers["Content-Type"] = "application/octet-stream"
    request = urllib.request.Request(url, data=body, headers=headers, method=method)
    try:
        with (opener or OPENER).open(request, timeout=timeout) as resp:
            return Response(resp.status, resp.reason, resp.headers, resp.read(), url)
    except urllib.error.HTTPError as e:  # a 3xx (not followed), 4xx or 5xx answer
        with e:
            return Response(e.code, e.reason, e.headers, e.read(), url)


async def request(method: str, url: str, body: Optional[bytes] = None,
                  headers: Optional[dict[str, str]] = None, timeout: float = TIMEOUT_S,
                  opener=None) -> Response:
    """``send`` in a worker thread."""
    return await asyncio.to_thread(send, method, url, body, headers, timeout, opener)


def json_body(value: Any, headers: Optional[dict[str, str]] = None) -> tuple[bytes, dict]:
    """A JSON value as aiohttp's ``json=`` sends it: ``json.dumps`` with its
    default separators, ``Content-Type: application/json`` unless the
    caller set one."""
    headers = dict(headers or {})
    if not any(k.lower() == "content-type" for k in headers):
        headers["Content-Type"] = "application/json"
    return json.dumps(value).encode(), headers


class StreamResponse:
    """A streamed answer: ``status`` / ``reason`` / ``headers`` once the
    head arrived, then ``lines()`` (each line with its ``\\n``, the last
    one without it when the body does not end in one) or ``read()``."""

    def __init__(self, queue: asyncio.Queue, stop: threading.Event, url: str) -> None:
        self._queue = queue
        self._stop = stop
        self.url = url
        self.status = 0
        self.reason = ""
        self.headers: Message = Message()

    async def _next(self):
        kind, item = await self._queue.get()
        if kind == "error":
            raise item
        return kind, item

    async def lines(self) -> AsyncIterator[bytes]:
        while True:
            kind, item = await self._next()
            if kind == "end":
                return
            yield item

    async def read(self) -> bytes:
        return b"".join([line async for line in self.lines()])

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HttpStatusError(self.status, self.reason, self.url)

    def close(self) -> None:
        """Stop the reader thread at its next line (it closes the
        connection)."""
        self._stop.set()


def _pump(loop, queue: asyncio.Queue, stop: threading.Event, request: urllib.request.Request,
          timeout: float) -> None:
    def put(kind: str, item: Any) -> None:
        try:
            loop.call_soon_threadsafe(queue.put_nowait, (kind, item))
        except RuntimeError:  # the loop has closed: nobody reads any more
            stop.set()

    try:
        try:
            resp = OPENER.open(request, timeout=timeout)
            head = (resp.status, resp.reason, resp.headers)
        except urllib.error.HTTPError as e:
            resp, head = e, (e.code, e.reason, e.headers)
        with resp:
            put("head", head)
            while not stop.is_set():
                line = resp.readline()
                if not line:
                    break
                put("line", line)
        put("end", None)
    except BaseException as e:  # noqa: BLE001 — the loop's reader raises it
        put("error", e)


async def stream(method: str, url: str, body: Optional[bytes] = None,
                 headers: Optional[dict[str, str]] = None,
                 timeout: float = TIMEOUT_S) -> StreamResponse:
    """Send, and return once the answer's head arrived; a worker thread
    reads the body line by line into the loop (``StreamResponse.lines``).
    Close it (``close()``) when leaving before its end."""
    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue()
    stop = threading.Event()
    req = urllib.request.Request(url, data=body, headers=dict(headers or {}), method=method)
    threading.Thread(target=_pump, args=(loop, queue, stop, req, timeout),
                     name="http-stream", daemon=True).start()
    resp = StreamResponse(queue, stop, url)
    kind, item = await resp._next()
    if kind == "end":  # cannot happen: the head comes first
        raise RuntimeError(f"no answer from {url}")
    resp.status, resp.reason, resp.headers = item
    return resp
