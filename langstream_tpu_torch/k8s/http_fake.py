"""FakeKubeServer served over real HTTP — the API-server stand-in that
lets ``KubeApiClient`` (and therefore the operator / deployer / setup
roles) be tested over an actual socket with the same paths and verbs a
live cluster serves. The port's own copy of ``langstream_tpu/k8s/http_fake.py``
on the stdlib (the JAX package's fake is an ``aiohttp.web`` app, which the
card's machine does not have): a ``ThreadingHTTPServer`` (HTTP/1.1) whose
request threads call the store directly (its verbs take its lock).

The JAX fake's paths, verbs, status codes and JSON bodies: a list answers
``{"kind": "<Kind>List", "metadata": {"resourceVersion"}, "items"}``, a
missing object 404, a create over an existing one 409, an unknown path 404,
another verb 405, a body that is not JSON 500. ``?watch=1`` streams chunked
newline-delimited ``{type, object}`` events from ``resourceVersion`` (an
in-stream ERROR event with code 410 past the store's ``event_window``) and
ends cleanly at ``timeoutSeconds``. A server given a ``token`` answers 401
to a request without it as a bearer token; ``error_queue`` holds
``(method or None, status)`` answers the next matching requests take (the
chaos tests' 409 / 5xx).

    python -m langstream_tpu_torch.k8s.http_fake [port]

serves a fresh store, prints ``{"url": ...}`` once it listens, and runs
until the process is stopped.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from langstream_tpu_torch.k8s.client import KIND_ROUTES
from langstream_tpu_torch.k8s.fake import FakeKubeServer

log = logging.getLogger(__name__)

_PLURAL_TO_KIND = {
    (prefix, plural): kind for kind, (prefix, plural, _ns) in KIND_ROUTES.items()
}
# how often a watch stream looks for new events
WATCH_POLL_S = 0.03


def _resolve(path: str):
    """path → (kind, namespace, name, is_status). Supports
    {prefix}/namespaces/{ns}/{plural}[/{name}[/status]] and
    cluster-scoped {prefix}/{plural}[/{name}] (also the cluster-wide
    list form of namespaced kinds)."""
    for (prefix, plural), kind in _PLURAL_TO_KIND.items():
        ns_base = f"{prefix}/namespaces/"
        flat_base = f"{prefix}/{plural}"
        if path.startswith(ns_base):
            rest = path[len(ns_base):]
            parts = rest.split("/")
            if len(parts) >= 2 and parts[1] == plural:
                ns = parts[0]
                name = parts[2] if len(parts) > 2 else None
                is_status = len(parts) > 3 and parts[3] == "status"
                return kind, ns, name, is_status
        if path == flat_base or path.startswith(flat_base + "/"):
            rest = path[len(flat_base):].strip("/")
            parts = rest.split("/") if rest else []
            name = parts[0] if parts else None
            is_status = len(parts) > 1 and parts[1] == "status"
            return kind, None, name, is_status
    return None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    server: "_Server"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), fmt % args)

    def _json(self, doc: Any, status: int = 200) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _handle(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b""
        split = urllib.parse.urlsplit(self.path)
        query = dict(urllib.parse.parse_qsl(split.query))
        try:
            self.server.owner._serve(self, split.path, query, body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True  # the client went away
        except Exception:  # noqa: BLE001 — answer 500, as aiohttp does
            log.exception("fake API server %s %s failed", self.command, split.path)
            self._json({"message": "internal error"}, status=500)

    do_GET = do_PUT = do_POST = do_PATCH = do_DELETE = _handle  # noqa: N815


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "HttpFakeKubeServer"


class HttpFakeKubeServer:
    """A FakeKubeServer with k8s REST semantics on a stdlib HTTP server."""

    def __init__(self, store: Optional[FakeKubeServer] = None, token: Optional[str] = None) -> None:
        self.store = store or FakeKubeServer()
        self.token = token  # when set, requests must carry it as Bearer
        self.port = 0
        # chaos injection: (method-or-None, status) entries consumed one per
        # matching request — tests use this to exercise 409/5xx retry paths
        self.error_queue: list[tuple[Optional[str], int]] = []
        self.requests_served = 0
        self._lock = threading.Lock()
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._closing = threading.Event()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def serve(self, port: int = 0) -> "HttpFakeKubeServer":
        """Bind and serve on a thread of its own."""
        server = _Server(("127.0.0.1", port), _Handler)
        server.owner = self
        self.port = server.server_address[1]
        self._closing.clear()
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            name="fake-kube-api", daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop accepting, end every watch stream, close the socket."""
        server, self._server = self._server, None
        self._closing.set()
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    async def start(self, port: int = 0) -> "HttpFakeKubeServer":
        return self.serve(port)

    async def stop(self) -> None:
        import asyncio

        await asyncio.to_thread(self.close)

    # -- request handling ----------------------------------------------------

    def _take_error(self, method: str) -> Optional[int]:
        with self._lock:
            self.requests_served += 1
            if self.error_queue and self.error_queue[0][0] in (None, method):
                return self.error_queue.pop(0)[1]
        return None

    def _watch(self, h: _Handler, kind: str, ns: Optional[str], query: dict) -> None:
        """?watch=1 stream: newline-delimited watch events, the real
        apiserver's wire shape — {type, object} lines, an ERROR event with
        code 410 when the requested resourceVersion fell out of the bounded
        event log, clean end-of-stream at timeoutSeconds."""
        rv = int(query.get("resourceVersion", self.store.version) or 0)
        deadline = time.monotonic() + float(query.get("timeoutSeconds", 30))
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()
        h.close_connection = True

        def chunk(doc: Any) -> None:
            data = json.dumps(doc).encode() + b"\n"
            h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        while time.monotonic() < deadline and not self._closing.is_set():
            events = self.store.events_since(rv, kind=kind, namespace=ns)
            if events is None:  # horizon expired → 410 inside the stream
                chunk({"type": "ERROR",
                       "object": {"kind": "Status", "code": 410, "reason": "Expired"}})
                break
            for ev_rv, type_, obj in events:
                chunk({"type": type_, "object": obj})
                rv = ev_rv
            self._closing.wait(WATCH_POLL_S)
        h.wfile.write(b"0\r\n\r\n")
        h.wfile.flush()

    def _serve(self, h: _Handler, path: str, query: dict, body: bytes) -> None:
        method = h.command
        status = self._take_error(method)
        if status is not None:
            return h._json({"message": "injected chaos"}, status=status)
        if self.token is not None:
            if h.headers.get("Authorization", "") != f"Bearer {self.token}":
                return h._json({"message": "unauthorized"}, status=401)
        resolved = _resolve(path)
        if resolved is None:
            return h._json({"message": "unknown path"}, status=404)
        kind, ns, name, is_status = resolved

        if is_status and method == "PATCH":
            doc = json.loads(body)
            out = self.store.patch_status(kind, ns or "default", name or "", doc.get("status", {}))
            if out is None:
                return h._json({"message": "not found"}, status=404)
            return h._json(out)
        if method == "GET" and name is None and query.get("watch"):
            return self._watch(h, kind, ns, query)
        if method == "GET" and name is None:
            return h._json({
                "kind": f"{kind}List",
                "metadata": {"resourceVersion": str(self.store.version)},
                "items": self.store.list(kind, ns),
            })
        if method == "GET":
            obj = self.store.get(kind, ns or "default", name or "")
            if obj is None:
                return h._json({"message": "not found"}, status=404)
            return h._json(obj)
        if method == "POST" and name is None:
            manifest = json.loads(body)
            manifest.setdefault("metadata", {})
            if ns is not None:
                manifest["metadata"].setdefault("namespace", ns)
            if self.store.get(
                kind, manifest["metadata"].get("namespace", "default"),
                manifest["metadata"].get("name", ""),
            ) is not None:
                return h._json({"message": "already exists"}, status=409)
            return h._json(self.store.apply(manifest), status=201)
        if method == "PUT" and name is not None:
            manifest = json.loads(body)
            manifest.setdefault("metadata", {})
            if ns is not None:
                manifest["metadata"].setdefault("namespace", ns)
            manifest["metadata"]["name"] = name
            return h._json(self.store.apply(manifest))
        if method == "DELETE" and name is not None:
            if self.store.delete(kind, ns or "default", name):
                return h._json({"status": "Success"})
            return h._json({"message": "not found"}, status=404)
        return h._json({"message": f"unsupported {method}"}, status=405)


def run_blocking(server: HttpFakeKubeServer, port: int = 0) -> None:
    """Serve until the process is stopped (dev tool and a process of its
    own: ``python -m langstream_tpu_torch.k8s.http_fake``)."""
    server.serve(port)
    print(json.dumps({"url": server.url}), flush=True)
    threading.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    import sys

    run_blocking(HttpFakeKubeServer(), int(sys.argv[1]) if len(sys.argv) > 1 else 0)
