"""A stdlib HTTP stub for the port's tests of its remote clients: routes of
(method, path regex) → handler, on a ``ThreadingHTTPServer`` at 127.0.0.1
(a free port), every request recorded. The same stub serves the JAX
package's aiohttp clients and the port's urllib ones, so both are held to
one server.

A handler takes the ``Call`` and returns ``(status, headers, body)`` (body
``bytes``, ``str`` or a JSON value), or a generator of ``bytes`` to stream
the body chunked (server-sent events). Unknown paths answer 404."""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qsl, urlsplit


@dataclass
class Call:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    match: dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        return json.loads(self.body)


class Stub:
    def __init__(self, routes: list[tuple[str, str, Callable]]) -> None:
        self.calls: list[Call] = []
        self._routes = [(m, re.compile(f"^{p}$"), h) for m, p, h in routes]
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _serve(self):
                parts = urlsplit(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                call = Call(self.command, parts.path, dict(parse_qsl(parts.query)),
                            {k.lower(): v for k, v in self.headers.items()}, body)
                stub.calls.append(call)
                for method, pattern, handler in stub._routes:
                    m = pattern.match(parts.path)
                    if m and method in (self.command, "*"):
                        call.match = m.groupdict()
                        out = handler(call)
                        break
                else:
                    out = (404, {"Content-Type": "text/plain"}, b"not found")
                if isinstance(out, tuple):
                    status, headers, payload = out
                    if not isinstance(payload, (bytes, str)):
                        payload = json.dumps(payload)
                        headers = {"Content-Type": "application/json", **headers}
                    data = payload.encode() if isinstance(payload, str) else payload
                    self.send_response(status)
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                status, headers, chunks = 200, {"Content-Type": "text/event-stream"}, out
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for chunk in chunks:
                    self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")

            do_GET = do_POST = do_PUT = do_DELETE = _serve

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(10)

    def __enter__(self) -> "Stub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def closed_port_url() -> str:
    """A loopback URL nothing listens on (a port bound, then released)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"
