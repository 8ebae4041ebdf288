"""The replica's runtime HTTP server (the port's own copy of the fleet routes
of ``langstream_tpu/runtime/http_server.py``), built on the stdlib:
``http.server.ThreadingHTTPServer``, HTTP/1.1, chunked transfer both ways.

Routes (the JAX server's statuses, content types and bodies, so either
package's clients talk to either package's server):

  GET  /state             the fleet beacons of this process's engine
  GET  /healthz           liveness, with ``recovering`` / ``restoring``
  GET  /metrics, /info    the two callbacks the server was built with
  GET  /traces            the tracer's recent spans (``limit``, default
                          200; not an integer: 400; 0 or less: ``[]``)
  GET  /flight            the recent flight-recorder dumps, newest last
  POST /fleet/generate    dispatch; ``stream: true`` answers a chunked
                          frame stream — ``lstpu-frames-v1`` NDJSON, or
                          ``lstpu-frames-v2`` with ``wire: "v2"``; a shed
                          answers 429 with ``Retry-After``
  POST /fleet/cancel      cancel a session's requests in this process
  POST /fleet/migrate     bind an inbound migration (v1 NDJSON, or the
                          v2 body sniffed from its preamble); answers the ACK
  POST /fleet/migrate-out push this engine's prefix to ``dest``
  POST /fleet/pages       serve a prefix's pages to a peer (a copy)
  POST /fleet/fetch       pull a prefix's pages from ``source``
  POST /fleet/prefetch    warm a session's pages on its future replica
  POST /fleet/reset       zero the engine's streaming histograms

Every handler reads the process registry of ``serving/fleet.py``
(``local_*``), never an engine, and runs on its own request thread (the
counterpart of the JAX server's executor): the engine work it waits for runs
on the engine thread, which no handler blocks. The streaming handlers apply
the wire's fault sites per frame (``net-stall``: the wire goes silent;
``net-cut``: the connection is reset in a frame's place; ``net-corrupt``: a
malformed frame), and closing a stream on any exit cancels the engine
request behind it: a client that went away does not keep a slot.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator, Optional

from langstream_tpu_torch.serving import fleet as fleet_mod
from langstream_tpu_torch.serving import lifecycle
from langstream_tpu_torch.serving import wire as wire_mod
from langstream_tpu_torch.serving.migrate import MigrationError
from langstream_tpu_torch.serving.observability import recent_dumps
from langstream_tpu_torch.tracing import TRACER

log = logging.getLogger(__name__)

JSON = "application/json; charset=utf-8"
NDJSON = "application/x-ndjson"
FRAMES2 = "application/x-lstpu-frames2"
KVMIG2 = "application/x-lstpu-kvmig2"


class _BadRequest(Exception):
    """A request the handler refuses with 400 (the JAX server's
    ``HTTPBadRequest``)."""


class _Cut(Exception):
    """The connection was reset on purpose (a ``net-cut`` drill, or a page
    export that died mid-stream): nothing more may be written."""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_Server"

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), fmt % args)

    # -- plumbing --------------------------------------------------------------

    def _send(self, status: int, body: bytes, ctype: str, headers: Optional[dict] = None,
              reason: Optional[str] = None) -> None:
        self.send_response(status, reason)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        self.close_connection = True

    def _json(self, doc: Any, status: int = 200, headers: Optional[dict] = None) -> None:
        self._send(status, json.dumps(doc).encode("utf-8"), JSON, headers)

    def _read_body(self, limit: Optional[int] = None) -> Optional[bytes]:
        """The request body, by Content-Length or chunked; None once it
        passes ``limit`` bytes (read incrementally: a rogue length or an
        endless chunked body never lands in memory)."""
        out = bytearray()
        if "chunked" in str(self.headers.get("Transfer-Encoding", "")).lower():
            while True:
                line = self.rfile.readline(1 << 16)
                if not line:
                    raise ConnectionError("chunked body cut before its last chunk")
                size = int(line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while self.rfile.readline(1 << 16) not in (b"\r\n", b"\n", b""):
                        pass  # trailers
                    return bytes(out)
                if limit is not None and len(out) + size > limit:
                    return None
                out += wire_mod.read_exact(self.rfile.read, size)
                self.rfile.readline(1 << 16)  # the chunk's CRLF
        n = int(self.headers.get("Content-Length") or 0)
        if limit is not None and n > limit:
            return None
        return wire_mod.read_exact(self.rfile.read, n) if n else b""

    def _payload(self) -> dict:
        try:
            doc = json.loads((self._read_body() or b"").decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise _BadRequest("body must be JSON") from None
        if not isinstance(doc, dict):
            raise _BadRequest("body must be a JSON object")
        return doc

    def _start_chunked(self, ctype: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

    def _end_chunked(self) -> None:
        try:
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass

    def _abort(self) -> None:
        """Reset the connection (RST, no terminating chunk): the client
        reads a dead wire, never a clean-looking short body."""
        try:
            self.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
            self.connection.close()
        except OSError:
            pass
        self.close_connection = True
        raise _Cut()

    def _dispatch(self, routes: dict[str, Callable[[], None]]) -> None:
        path = urllib.parse.urlsplit(self.path).path
        route = routes.get(path)
        if route is None:
            self._send(404, b"404: Not Found", "text/plain; charset=utf-8")
            return
        try:
            route()
        except _BadRequest as e:
            self._send(400, f"400: {e}".encode("utf-8"), "text/plain; charset=utf-8",
                       reason=str(e))
        except _Cut:
            pass
        except (ConnectionError, OSError) as e:
            log.debug("fleet client went away: %s", e)
            self.close_connection = True

    def do_GET(self) -> None:  # noqa: N802 — the stdlib's spelling
        self._dispatch({
            "/state": lambda: self._json(fleet_mod.local_state()),
            "/healthz": self._healthz,
            "/metrics": lambda: self._send(
                200, self.server.owner.metrics_text().encode("utf-8"),
                "text/plain; charset=utf-8",
            ),
            "/info": lambda: self._json(self.server.owner.agents_info()),
            "/traces": self._traces,
            "/flight": lambda: self._json(recent_dumps()),
        })

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch({
            "/fleet/generate": self._fleet_generate,
            "/fleet/cancel": self._fleet_cancel,
            "/fleet/migrate": self._fleet_migrate,
            "/fleet/migrate-out": lambda: self._command(fleet_mod.local_migrate_out),
            "/fleet/pages": self._fleet_pages,
            "/fleet/fetch": lambda: self._command(fleet_mod.local_p2p_fetch),
            "/fleet/prefetch": self._fleet_prefetch,
            "/fleet/reset": self._fleet_reset,
        })

    # -- routes ---------------------------------------------------------------

    def _traces(self) -> None:
        query = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        try:
            limit = int(query.get("limit", ["200"])[0])
        except ValueError:
            raise _BadRequest("limit must be an integer") from None
        self._json(TRACER.spans(limit) if limit > 0 else [])

    def _healthz(self) -> None:
        """Liveness stays OK through an engine restart (the replica rebuilds
        in place); ``recovering`` and ``restoring`` are for readiness probes
        that want to hold traffic meanwhile."""
        try:
            recovering = fleet_mod.local_recovering()
            restoring = fleet_mod.local_restoring()
        except Exception:  # noqa: BLE001 — the health endpoint must not 500
            recovering = restoring = False
        self._json({"status": "OK", "recovering": recovering, "restoring": restoring})

    def _fleet_generate(self) -> None:
        """Fleet dispatch. The submit happens BEFORE the response commits
        to a chunked stream, so a shed, a bad request or a dead engine
        still answers a real status code."""
        payload = self._payload()
        try:
            if payload.get("stream"):
                frames = fleet_mod.local_generate_stream(payload)
            else:
                result = fleet_mod.local_generate(payload)
        except fleet_mod.FleetShedError as e:
            self._json({"error": "shed", "retry_after_s": e.retry_after_s}, status=429,
                       headers={"Retry-After": f"{e.retry_after_s:.3f}"})
            return
        except (fleet_mod.ReplicaError, RuntimeError) as e:
            self._json({"error": str(e)}, status=503)
            return
        except ValueError as e:
            raise _BadRequest(str(e)) from None
        if payload.get("stream"):
            self._stream_frames(frames, binary=payload.get("wire") == "v2")
        else:
            self._json(result)

    def _stream_frames(self, frames: Iterator[dict], binary: bool) -> None:
        """One frame iterator as the chunked body — NDJSON or the
        ``lstpu-frames-v2`` layout — with the wire's fault sites applied per
        frame. The frame iterator is closed on ANY exit, which cancels the
        engine request when the stream did not finish."""
        proto = "v2" if binary else "v1"
        injector = fleet_mod.wire_injector()
        try:
            self._start_chunked(FRAMES2 if binary else NDJSON)
            if binary:
                wire_mod.count_wire_bytes(proto, len(wire_mod.FRAMES2_PREAMBLE))
                self._chunk(wire_mod.FRAMES2_PREAMBLE)
            for frame in frames:
                if injector is not None:
                    if injector.fires("net-stall"):
                        # the wire goes quiet: no frame, no heartbeat — the
                        # client's idle timeout must call this a dead peer
                        time.sleep(injector.stall_s)
                    if injector.fires("net-cut"):
                        self._abort()
                    if injector.fires("net-corrupt"):
                        # garbage in the frame's place: the client's frame
                        # validation (JSON parse / magic + CRC) fails the hop
                        self._chunk(b"\xff" * wire_mod.PRELUDE.size if binary
                                    else b'{"seq": "corrupt", "kind"\n')
                        continue
                chunk = (wire_mod.encode_stream_frame(frame) if binary
                         else json.dumps(frame).encode("utf-8") + b"\n")
                wire_mod.count_wire_bytes(proto, len(chunk))
                self._chunk(chunk)
        finally:
            fleet_mod.close_frames(frames)
        self._end_chunked()

    def _fleet_cancel(self) -> None:
        """Cross-process cancel: the process that saw the client go away
        forwards the session key here (``lifecycle.cancel`` there); the
        requests registered under it in THIS process stop at their next
        chunk boundary."""
        session = str(self._payload().get("session") or "")
        if not session:
            raise _BadRequest("missing 'session'")
        self._json({"cancelled": lifecycle.cancel(session)})

    def _fleet_migrate(self) -> None:
        """Inbound KV-page migration: the body is a v1 NDJSON frame stream
        or, sniffed from its preamble, the v2 binary body. Protocol failures
        (a checksum, a cut stream, an oversized or corrupt frame, a full
        pool) answer ``{"ok": false}`` with HTTP 200 — the transfer failed,
        the transport worked — and the sender keeps its copy. Every byte
        count is bounded by THIS pool's geometry, never by a length from the
        wire: the body by its pages, each frame's payload by a page's bytes
        (twice, for v1's base64 and JSON)."""
        limits = fleet_mod.local_migrate_limits()
        bpp = int(limits.get("bytes_per_page") or 0)
        pages_total = int(limits.get("pages_total") or 0)
        max_payload = max(2 * bpp, 1 << 20) if bpp else 64 << 20
        max_total = 2 * bpp * pages_total + (1 << 20) if bpp and pages_total else 256 << 20
        try:
            raw = self._read_body(limit=max_total)
        except (ConnectionError, OSError, ValueError, wire_mod.WireError):
            self._json({"ok": False, "error": "body read failed (cut wire)"})
            return
        if raw is None:
            self._json({"ok": False,
                        "error": f"migration body exceeds this pool's {max_total}-byte bound"})
            return
        query = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        try:
            timeout_s = float((query.get("timeout-s") or ["30"])[0])
        except ValueError:
            timeout_s = 30.0
        # the SENDER's budget governs the bind too, clamped so a rogue peer
        # cannot park a thread for hours
        timeout_s = min(max(timeout_s, 0.05), 600.0)

        def frames() -> Iterator[dict]:
            if raw.startswith(wire_mod.KVMIG2_PREAMBLE):
                view = memoryview(raw)
                pos = len(wire_mod.KVMIG2_PREAMBLE)

                def read(n: int) -> bytes:
                    nonlocal pos
                    chunk = bytes(view[pos:pos + n])
                    pos += len(chunk)
                    return chunk

                try:
                    yield from wire_mod.decode_mig_frames(read, max_payload=max_payload)
                except wire_mod.WireError as e:
                    raise MigrationError(f"corrupt v2 migration frame ({e})") from e
                return
            for line in raw.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError as e:
                    raise MigrationError(f"undecodable migration frame ({e})") from e

        try:
            ack = fleet_mod.local_migrate_bind(frames(), timeout_s)
        except MigrationError as e:
            self._json({"ok": False, "error": str(e)})
            return
        except fleet_mod.ReplicaError as e:
            self._json({"ok": False, "error": str(e)}, status=503)
            return
        self._json(ack)

    def _command(self, fn: Callable[[dict], dict]) -> None:
        """A migration command (``/fleet/migrate-out``, ``/fleet/fetch``):
        a failed transfer answers ``{"ok": false}`` with HTTP 200 (the
        command's transport worked) and the router falls back."""
        payload = self._payload()
        try:
            ack = fn(payload)
        except MigrationError as e:
            self._json({"ok": False, "error": str(e)})
            return
        except fleet_mod.ReplicaError as e:
            self._json({"ok": False, "error": str(e)}, status=503)
            return
        except ValueError as e:
            raise _BadRequest(str(e)) from None
        self._json(ack)

    def _fleet_pages(self) -> None:
        """P2P page serve: the frames of ``prompt_tokens``'s deepest
        published prefix, as the body ``/fleet/migrate`` reads (v2 with
        ``wire: "v2"``); the engine RELEASES NOTHING. A refusal before the
        stream (no published prefix, a dead engine) answers a JSON error, so
        the fetcher tells refusal from a cut wire; an export that dies
        mid-stream resets the connection."""
        payload = self._payload()
        v2 = payload.get("wire") == "v2"
        proto = "v2" if v2 else "v1"
        frames: Any = None
        try:
            frames = fleet_mod.local_migrate_pages(payload)
            # the FIRST frame before committing to a stream: the snapshot
            # (no such prefix, a dead engine) fails here
            first = next(frames, None)
        except (MigrationError, ValueError) as e:
            fleet_mod.close_frames(frames)
            self._json({"ok": False, "error": str(e)})
            return
        except fleet_mod.ReplicaError as e:
            fleet_mod.close_frames(frames)
            self._json({"ok": False, "error": str(e)}, status=503)
            return
        try:
            self._start_chunked(KVMIG2 if v2 else NDJSON)
            if v2:
                wire_mod.count_wire_bytes(proto, len(wire_mod.KVMIG2_PREAMBLE))
                self._chunk(wire_mod.KVMIG2_PREAMBLE)
            frame = first
            while frame is not None:
                chunk = (wire_mod.encode_mig_frame(frame) if v2
                         else json.dumps(frame).encode("utf-8") + b"\n")
                wire_mod.count_wire_bytes(proto, len(chunk))
                self._chunk(chunk)
                try:
                    frame = next(frames, None)
                except (MigrationError, fleet_mod.ReplicaError, wire_mod.WireError) as e:
                    log.warning("p2p page export died mid-stream: %s", e)
                    self._abort()
        finally:
            fleet_mod.close_frames(frames)
        self._end_chunked()

    def _fleet_prefetch(self) -> None:
        """Prefetch on a hint: best-effort by contract — every failure
        answers ``{"prefetched": false}`` with HTTP 200."""
        payload = self._payload()
        try:
            ack = fleet_mod.local_prefetch(payload)
        except fleet_mod.FleetShedError as e:
            self._json({"prefetched": False, "error": str(e)})
            return
        except fleet_mod.ReplicaError as e:
            self._json({"prefetched": False, "error": str(e)}, status=503)
            return
        except ValueError as e:
            raise _BadRequest(str(e)) from None
        self._json(ack)

    def _fleet_reset(self) -> None:
        self._read_body()
        fleet_mod.local_reset()
        self._json({"status": "OK"})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "RuntimeHttpServer"


class RuntimeHttpServer:
    """The replica's HTTP server: ``start()`` binds and serves on a thread,
    ``stop()`` stops accepting and closes the socket (port 0 binds a free
    port, read back into ``port``)."""

    def __init__(
        self,
        metrics_text: Callable[[], str],
        agents_info: Callable[[], list[dict[str, Any]]],
        host: str = "127.0.0.1",
        port: int = 8080,
    ) -> None:
        self.metrics_text = metrics_text
        self.agents_info = agents_info
        self.host = host
        self.port = port
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        server = _Server((self.host, self.port), _Handler)
        server.owner = self
        self.port = server.server_address[1]
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.1},
            name="runtime-http", daemon=True,
        )
        self._thread.start()
        log.info("runtime http server on %s:%s", self.host, self.port)

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
