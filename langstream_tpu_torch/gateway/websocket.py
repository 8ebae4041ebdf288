"""HTTP/1.1 and RFC 6455 websockets on asyncio streams, for the port's
gateway (the card's machine has no aiohttp).

Server side: ``read_request`` parses one request (``Content-Length`` or
chunked body), ``write_response`` answers it, ``serve_connection`` runs a
keep-alive connection's requests through a server's dispatch, and
``WebSocket.accept``
upgrades it (``Sec-WebSocket-Accept``) into a socket whose ``receive()``
yields whole text or binary messages: client frames must be masked,
fragments are joined across continuation frames (control frames may come
between them), a ping is answered with a pong, and a peer's close frame is
answered with 1000 (as aiohttp's server answers it); ``receive()`` then
reports the peer's code. A protocol fault closes with 1002, bad
UTF-8 in a text message with 1007, a message over ``max_message`` bytes
with 1009.

Client side: ``connect(url)`` opens a websocket (masked frames) for tests
and ``chip_smoke.py``; ``http_request`` sends one HTTP request.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import struct
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Optional

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
CLOSE_OK = 1000
CLOSE_PROTOCOL_ERROR = 1002
CLOSE_NO_STATUS = 1005
CLOSE_ABNORMAL = 1006
CLOSE_INVALID_DATA = 1007
CLOSE_TOO_BIG = 1009
# aiohttp's default cap on one received message
MAX_MESSAGE = 4 * 1024 * 1024

REASONS = {
    101: "Switching Protocols", 200: "OK", 400: "Bad Request", 401: "Unauthorized",
    404: "Not Found", 405: "Method Not Allowed", 429: "Too Many Requests", 500: "Internal Server Error", 502: "Bad Gateway",
    504: "Gateway Timeout",
}


class HttpError(Exception):
    """An HTTP error answer: ``status``, and ``reason`` as the status line's
    phrase and the text body ``"<status>: <reason>"`` (aiohttp's form)."""

    def __init__(self, status: int, reason: str = "") -> None:
        super().__init__(reason or REASONS.get(status, ""))
        self.status = status
        self.reason = reason or REASONS.get(status, "")


class ProtocolError(Exception):
    """A websocket protocol fault: the socket closes with ``code``."""

    def __init__(self, message: str, code: int = CLOSE_PROTOCOL_ERROR) -> None:
        super().__init__(message)
        self.code = code


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    query_string: str
    headers: dict[str, str]  # names lower-cased
    body: bytes
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    match_info: dict[str, str] = field(default_factory=dict)
    keep_alive: bool = True

    def text(self) -> str:
        return self.body.decode("utf-8")

    def wants_websocket(self) -> bool:
        return (
            self.headers.get("upgrade", "").lower() == "websocket"
            and "upgrade" in self.headers.get("connection", "").lower()
        )


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json; charset=utf-8"
    headers: dict[str, str] = field(default_factory=dict)
    reason: str = ""

    @staticmethod
    def json(doc: Any, status: int = 200, headers: Optional[dict] = None) -> "Response":
        return Response(status, json.dumps(doc).encode(), headers=dict(headers or {}))

    @staticmethod
    def error(err: HttpError) -> "Response":
        return Response(err.status, f"{err.status}: {err.reason}".encode(),
                        "text/plain; charset=utf-8", reason=err.reason)


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    out = bytearray()
    while True:
        size_line = await reader.readuntil(b"\r\n")
        size = int(size_line.split(b";")[0].strip(), 16)
        if size == 0:
            while (await reader.readuntil(b"\r\n")) != b"\r\n":  # trailers
                pass
            return bytes(out)
        out += await reader.readexactly(size)
        await reader.readexactly(2)


async def read_request(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> Optional[Request]:
    """One request off the connection; None when the peer closed between
    requests. Raises ``HttpError`` (400) for a malformed head."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise HttpError(400, "incomplete request head") from None
    except asyncio.LimitOverrunError:
        raise HttpError(400, "request head too large") from None
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, f"bad request line {lines[0][:80]!r}")
    method, target, version = parts
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, "bad header line")
        key = name.strip().lower()
        headers[key] = f"{headers[key]}, {value.strip()}" if key in headers else value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = await _read_chunked(reader)
    else:
        length = int(headers.get("content-length", "0") or 0)
        body = await reader.readexactly(length) if length else b""
    split = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(split.query, keep_blank_values=True))
    keep_alive = version == "HTTP/1.1" and headers.get("connection", "").lower() != "close"
    return Request(method.upper(), split.path, query, split.query, headers, body,
                   reader, writer, keep_alive=keep_alive)


async def write_response(writer: asyncio.StreamWriter, response: Response,
                         keep_alive: bool) -> None:
    reason = response.reason or REASONS.get(response.status, "")
    # a reason phrase is one line of visible characters
    reason = "".join(c if 32 <= ord(c) < 127 else " " for c in reason)
    head = [f"HTTP/1.1 {response.status} {reason}",
            f"Content-Type: {response.content_type}",
            f"Content-Length: {len(response.body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    head += [f"{k}: {v}" for k, v in response.headers.items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + response.body)
    await writer.drain()


async def serve_connection(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                           dispatch, connections: set) -> None:
    """One HTTP/1.1 connection of a server: its requests in turn, each
    answered by ``await dispatch(request)`` — or taken over by it (a
    websocket, a stream) when it returns None, which ends the connection.
    The task is kept in ``connections`` while it serves, for the server's
    stop to cancel."""
    task = asyncio.current_task()
    assert task is not None
    connections.add(task)
    try:
        while True:
            try:
                request = await read_request(reader, writer)
            except HttpError as e:
                await write_response(writer, Response.error(e), keep_alive=False)
                return
            if request is None:
                return
            response = await dispatch(request)
            if response is None:
                return
            await write_response(writer, response, request.keep_alive)
            if not request.keep_alive:
                return
    except (ConnectionError, asyncio.IncompleteReadError, asyncio.CancelledError):
        pass
    finally:
        connections.discard(task)
        try:
            writer.close()
        except (ConnectionError, RuntimeError):
            pass


def accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True, mask: bool = False) -> bytes:
    """One frame: 7-, 16- or 64-bit length; masked with a random key when
    ``mask`` (a client's frames)."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    bit = 0x80 if mask else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = _unmask(payload, key)
    return bytes(head) + payload


def _unmask(data: bytes, key: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    k = int.from_bytes((key * (n // 4 + 1))[:n], "big")
    return (int.from_bytes(data, "big") ^ k).to_bytes(n, "big")


@dataclass
class Message:
    kind: str  # "text" | "binary" | "close"
    data: Any  # str, bytes, or the close code


class WebSocket:
    """One open websocket over an asyncio stream pair. ``masked_in``: the
    peer must mask its frames (the server side); ``mask_out``: this side
    masks (the client side)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 masked_in: bool, mask_out: bool, max_message: int = MAX_MESSAGE) -> None:
        self.reader = reader
        self.writer = writer
        self.masked_in = masked_in
        self.mask_out = mask_out
        self.max_message = max_message
        self.closed = False  # a close frame was sent
        self.close_code: Optional[int] = None  # the peer's close code
        self._send_lock = asyncio.Lock()
        # a receive() in progress owns the reader: close() from another
        # task then only sends its frame, and that receive() reads the answer
        self._reading = False

    @staticmethod
    async def accept(request: Request) -> "WebSocket":
        """Answer the upgrade (101) of a websocket request."""
        key = request.headers.get("sec-websocket-key", "")
        if not request.wants_websocket() or not key:
            raise HttpError(400, "No WebSocket UPGRADE hdr")
        if request.headers.get("sec-websocket-version", "13") != "13":
            raise HttpError(400, "Unsupported version")
        head = ("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                f"Connection: upgrade\r\nSec-WebSocket-Accept: {accept_key(key)}\r\n\r\n")
        request.writer.write(head.encode())
        await request.writer.drain()
        return WebSocket(request.reader, request.writer, masked_in=True, mask_out=False)

    # -- sending -------------------------------------------------------------

    async def _send(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        async with self._send_lock:
            if self.closed and opcode != OP_CLOSE:
                raise ConnectionResetError("websocket is closed")
            self.writer.write(encode_frame(opcode, payload, fin=fin, mask=self.mask_out))
            await self.writer.drain()

    async def send_str(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode("utf-8"))

    async def send_json(self, doc: Any) -> None:
        await self.send_str(json.dumps(doc))

    async def close(self, code: int = CLOSE_OK, reason: str = "") -> None:
        """Send the close frame (once) and close the stream once the peer
        answered, or at once when it already sent its own."""
        if not self.closed:
            payload = b"" if code == CLOSE_NO_STATUS else struct.pack("!H", code) + reason.encode()
            try:
                await self._send(OP_CLOSE, payload)
            except (ConnectionError, RuntimeError):
                pass
            self.closed = True
            if self._reading:
                return
            if self.close_code is None:
                try:  # the peer's answer, briefly
                    await asyncio.wait_for(self._drain_until_close(), 2.0)
                except (asyncio.TimeoutError, ConnectionError, ProtocolError,
                        asyncio.IncompleteReadError):
                    pass
        self._abort()

    async def _drain_until_close(self) -> None:
        while self.close_code is None:
            await self._frame()

    def _abort(self) -> None:
        try:
            self.writer.close()
        except (ConnectionError, RuntimeError):
            pass

    # -- receiving -----------------------------------------------------------

    async def _frame(self) -> tuple[bool, int, bytes]:
        b1, b2 = await self.reader.readexactly(2)
        fin, rsv, opcode = bool(b1 & 0x80), b1 & 0x70, b1 & 0x0F
        masked, n = bool(b2 & 0x80), b2 & 0x7F
        if rsv:
            raise ProtocolError("reserved bits set")
        if opcode not in (OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG):
            raise ProtocolError(f"unknown opcode {opcode:#x}")
        if masked != self.masked_in:
            raise ProtocolError("client frames must be masked" if self.masked_in
                                else "server frames must not be masked")
        if n == 126:
            (n,) = struct.unpack("!H", await self.reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self.reader.readexactly(8))
        if opcode >= OP_CLOSE and (n > 125 or not fin):
            raise ProtocolError("a control frame must be whole and at most 125 bytes")
        if n > self.max_message:
            raise ProtocolError(f"frame of {n} bytes over {self.max_message}", CLOSE_TOO_BIG)
        key = await self.reader.readexactly(4) if masked else b""
        payload = await self.reader.readexactly(n) if n else b""
        if masked:
            payload = _unmask(payload, key)
        if opcode == OP_CLOSE:
            if len(payload) == 1:
                raise ProtocolError("a close payload of one byte")
            self.close_code = struct.unpack("!H", payload[:2])[0] if payload else CLOSE_NO_STATUS
        return fin, opcode, payload

    async def receive(self) -> Message:
        """The next data message, or ``Message("close", code)`` once the
        peer closed or the connection dropped (the close answered)."""
        parts: list[bytes] = []
        first: Optional[int] = None
        size = 0
        self._reading = True
        try:
            while True:
                fin, opcode, payload = await self._frame()
                if opcode == OP_PING:
                    await self._send(OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    continue
                if opcode == OP_CLOSE:
                    code = self.close_code or CLOSE_NO_STATUS
                    self._reading = False
                    if not self.closed:
                        await self.close(CLOSE_OK)
                    self._abort()
                    return Message("close", code)
                if opcode == OP_CONT:
                    if first is None:
                        raise ProtocolError("a continuation frame with no message")
                elif first is not None:
                    raise ProtocolError("a new message inside a fragmented one")
                else:
                    first = opcode
                size += len(payload)
                if size > self.max_message:
                    raise ProtocolError(f"message over {self.max_message} bytes", CLOSE_TOO_BIG)
                parts.append(payload)
                if fin:
                    data = b"".join(parts)
                    if first == OP_TEXT:
                        try:
                            return Message("text", data.decode("utf-8"))
                        except UnicodeDecodeError:
                            raise ProtocolError("invalid UTF-8 in a text message",
                                                CLOSE_INVALID_DATA) from None
                    return Message("binary", data)
        except ProtocolError as e:
            self._reading = False
            await self.close(e.code, str(e)[:120])
            return Message("close", e.code)
        except (asyncio.IncompleteReadError, ConnectionError):
            self.closed = True
            self._abort()
            return Message("close", CLOSE_ABNORMAL)
        finally:
            self._reading = False

    def __aiter__(self) -> "WebSocket":
        return self

    async def __anext__(self) -> Message:
        msg = await self.receive()
        if msg.kind == "close":
            raise StopAsyncIteration
        return msg


# -- clients -----------------------------------------------------------------


class HandshakeError(Exception):
    """The server refused the upgrade: ``status`` and its reason phrase."""

    def __init__(self, status: int, reason: str, body: bytes = b"") -> None:
        super().__init__(f"{status} {reason}")
        self.status = status
        self.reason = reason
        self.body = body


async def _read_head(reader: asyncio.StreamReader) -> tuple[int, str, dict[str, str]]:
    head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
    _, status, reason = (head[0].split(" ", 2) + [""])[:3]
    headers = {}
    for line in head[1:]:
        if line:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
    return int(status), reason, headers


async def _read_body(reader: asyncio.StreamReader, headers: dict[str, str]) -> bytes:
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return await _read_chunked(reader)
    if "content-length" in headers:
        return await reader.readexactly(int(headers["content-length"]))
    return await reader.read()


async def connect(url: str, timeout: float = 30.0) -> WebSocket:
    """Open a client websocket to ``ws://host:port/path?query``."""
    split = urllib.parse.urlsplit(url)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(split.hostname, split.port or 80), timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    target = split.path + (f"?{split.query}" if split.query else "")
    writer.write((f"GET {target} HTTP/1.1\r\nHost: {split.netloc}\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    status, reason, headers = await asyncio.wait_for(_read_head(reader), timeout)
    if status != 101:
        body = await _read_body(reader, headers)
        writer.close()
        raise HandshakeError(status, reason, body)
    if headers.get("sec-websocket-accept") != accept_key(key):
        writer.close()
        raise HandshakeError(status, "bad Sec-WebSocket-Accept")
    return WebSocket(reader, writer, masked_in=False, mask_out=True)


async def http_request(method: str, url: str, body: bytes = b"",
                       headers: Optional[dict[str, str]] = None,
                       timeout: float = 60.0) -> tuple[int, dict[str, str], bytes]:
    """One HTTP/1.1 request on its own connection: (status, headers, body)."""
    split = urllib.parse.urlsplit(url)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(split.hostname, split.port or 80), timeout)
    try:
        target = split.path + (f"?{split.query}" if split.query else "")
        lines = [f"{method} {target} HTTP/1.1", f"Host: {split.netloc}",
                 f"Content-Length: {len(body)}", "Connection: close"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body)
        await writer.drain()
        status, _, resp_headers = await asyncio.wait_for(_read_head(reader), timeout)
        data = await asyncio.wait_for(_read_body(reader, resp_headers), timeout)
        return status, resp_headers, data
    finally:
        writer.close()
