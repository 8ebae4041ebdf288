"""Protocol-level fake Pravega: segment store (TCP, pravega_protocol codec)
plus controller REST (a stdlib HTTP server whose handlers run on the fake's
loop, ``fake_rest.py``) — the kafka_fake/pulsar_fake pattern.

Semantics modelled:
- segments are append-only byte logs; AppendBlockEnd appends atomically and
  acks with DataAppended (event_number echo, previous number tracked per
  writer), duplicate event numbers from the same writer are idempotently
  dropped (pravega's exactly-once append contract)
- ReadSegment returns bytes from an offset (bounded by suggested_length),
  with at_tail/end_of_segment flags
- controller REST: scope/stream CRUD with FIXED_NUM_SEGMENTS scaling,
  sealed-before-delete enforcement

Stands in for the reference's testcontainers Pravega (no JVM, no egress).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.messaging import fake_rest
from langstream_tpu_torch.messaging import pravega_protocol as wire

log = logging.getLogger(__name__)


@dataclass
class _Segment:
    data: bytearray = field(default_factory=bytearray)
    sealed: bool = False
    start_offset: int = 0  # truncation frontier: bytes below are gone
    # writer_id → last event number appended (idempotent replay guard)
    writers: dict = field(default_factory=dict)


class FakePravega:
    def __init__(self, host: str = "127.0.0.1") -> None:
        self.host = host
        self.port = 0
        self.rest_port = 0
        self.segments: dict[str, _Segment] = {}
        self.scopes: set[str] = set()
        self.streams: dict[str, dict] = {}  # "scope/stream" → config doc
        self._server: Optional[asyncio.base_events.Server] = None
        self._rest_runner: Any = None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "FakePravega":
        self._server = await asyncio.start_server(self._serve, self.host, 0)
        self.port = self._server.sockets[0].getsockname()[1]

        scope_streams = "/v1/scopes/{scope}/streams"
        self._rest_runner = fake_rest.FakeRestServer(
            self.host,
            [
                ("POST", "/v1/scopes", self._rest_create_scope),
                ("POST", scope_streams, self._rest_create_stream),
                ("GET", scope_streams + "/{stream}", self._rest_get_stream),
                ("PUT", scope_streams + "/{stream}/state", self._rest_update_state),
                ("DELETE", scope_streams + "/{stream}", self._rest_delete_stream),
            ],
        )
        self.rest_port = await self._rest_runner.start()
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._rest_runner is not None:
            await self._rest_runner.stop()
            self._rest_runner = None

    @property
    def segment_store_url(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    @property
    def controller_url(self) -> str:
        return f"http://{self.host}:{self.rest_port}"

    # -- controller REST ----------------------------------------------------

    async def _rest_create_scope(self, request):
        doc = await request.json()
        name = doc.get("scopeName", "")
        if name in self.scopes:
            return fake_rest.json_response({"scopeName": name}, status=409)
        self.scopes.add(name)
        return fake_rest.json_response({"scopeName": name}, status=201)

    async def _rest_create_stream(self, request):
        scope = request.match_info["scope"]
        doc = await request.json()
        stream = doc.get("streamName", "")
        key = f"{scope}/{stream}"
        if scope not in self.scopes:
            return fake_rest.json_response({"message": "no such scope"}, status=404)
        if key in self.streams:
            return fake_rest.json_response(self.streams[key], status=409)
        self.streams[key] = {
            "streamName": stream,
            "scopeName": scope,
            "scalingPolicy": doc.get(
                "scalingPolicy", {"type": "FIXED_NUM_SEGMENTS", "minSegments": 1}
            ),
            "state": "ACTIVE",
        }
        return fake_rest.json_response(self.streams[key], status=201)

    async def _rest_get_stream(self, request):
        key = f"{request.match_info['scope']}/{request.match_info['stream']}"
        doc = self.streams.get(key)
        if doc is None:
            return fake_rest.json_response({"message": "not found"}, status=404)
        return fake_rest.json_response(doc)

    async def _rest_update_state(self, request):
        key = f"{request.match_info['scope']}/{request.match_info['stream']}"
        doc = self.streams.get(key)
        if doc is None:
            return fake_rest.json_response({"message": "not found"}, status=404)
        body = await request.json()
        doc["state"] = body.get("streamState", doc["state"])
        if doc["state"] == "SEALED":
            for name, seg in self.segments.items():
                if name.startswith(key + "/"):
                    seg.sealed = True
        return fake_rest.json_response({"streamState": doc["state"]})

    async def _rest_delete_stream(self, request):
        key = f"{request.match_info['scope']}/{request.match_info['stream']}"
        doc = self.streams.get(key)
        if doc is None:
            return fake_rest.json_response({"message": "not found"}, status=404)
        if doc["state"] != "SEALED":
            return fake_rest.json_response({"message": "stream not sealed"}, status=412)
        del self.streams[key]
        for name in [n for n in self.segments if n.startswith(key + "/")]:
            del self.segments[name]
        return fake_rest.Response(status=204)

    # -- segment store ------------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        lock = asyncio.Lock()
        # per-CONNECTION writer routing (a real store's AppendProcessor):
        # SetupAppend binds a writer to a segment ON THIS SOCKET; appends
        # from a writer the connection never set up are rejected, which is
        # what forces clients to re-setup after a reconnect. (The DEDUP
        # state — last event number per writer — lives on the segment, as
        # real segment attributes do.)
        setups: dict = {}  # writer_id → segment name

        async def send(frame_bytes: bytes) -> None:
            async with lock:
                writer.write(frame_bytes)
                await writer.drain()

        try:
            while True:
                header = await reader.readexactly(8)
                type_, length = wire.parse_frame_header(header)
                payload = await reader.readexactly(length)
                name, f = wire.decode(type_, payload)
                handler = getattr(self, f"_on_{name}", None)
                if handler is None:
                    await send(wire.encode("error_message", {
                        "request_id": f.get("request_id", -1),
                        "message": f"unhandled {name}",
                    }))
                    continue
                f["_conn_setups"] = setups
                reply = await handler(f)
                if reply is not None:
                    await send(reply)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _on_hello(self, f: dict) -> bytes:
        return wire.encode("hello", {})

    async def _on_keep_alive(self, f: dict) -> Optional[bytes]:
        return wire.encode("keep_alive", {})

    async def _on_create_segment(self, f: dict) -> bytes:
        name = f["segment"]
        if name in self.segments:
            return wire.encode("error_message", {
                "request_id": f["request_id"], "message": "segment exists",
            })
        self.segments[name] = _Segment()
        return wire.encode("segment_created", {
            "request_id": f["request_id"], "segment": name,
        })

    async def _on_setup_append(self, f: dict) -> bytes:
        seg = self.segments.get(f["segment"])
        if seg is None:
            return wire.encode("no_such_segment", {
                "request_id": f["request_id"], "segment": f["segment"],
            })
        f["_conn_setups"][f["writer_id"]] = f["segment"]
        last = seg.writers.setdefault(f["writer_id"], 0)
        return wire.encode("append_setup", {
            "request_id": f["request_id"],
            "segment": f["segment"],
            "writer_id": f["writer_id"],
            "last_event_number": last,
        })

    async def _on_append_block_end(self, f: dict) -> bytes:
        writer_id = f["writer_id"]
        # routing comes from THIS connection's setups, not global state
        name = f["_conn_setups"].get(writer_id)
        seg = self.segments.get(name) if name is not None else None
        if seg is None:
            return wire.encode("error_message", {
                "request_id": f["request_id"], "message": "writer not set up",
            })
        previous = seg.writers[writer_id]
        event_number = f["last_event_number"]
        if event_number > previous:  # idempotent: replays are dropped
            if seg.sealed:
                return wire.encode("error_message", {
                    "request_id": f["request_id"], "message": "segment sealed",
                })
            seg.data.extend(f["data"])
            seg.writers[writer_id] = event_number
        return wire.encode("data_appended", {
            "writer_id": writer_id,
            "event_number": event_number,
            "previous_event_number": previous,
            "request_id": f["request_id"],
        })

    async def _on_read_segment(self, f: dict) -> bytes:
        seg = self.segments.get(f["segment"])
        if seg is None:
            return wire.encode("no_such_segment", {
                "request_id": f["request_id"], "segment": f["segment"],
            })
        # reads below the truncation frontier resume AT the frontier; the
        # echoed offset tells the client where the returned bytes start
        offset = max(f["offset"], seg.start_offset)
        chunk = bytes(seg.data[offset : offset + f["suggested_length"]])
        at_tail = offset + len(chunk) >= len(seg.data)
        return wire.encode("segment_read", {
            "segment": f["segment"],
            "offset": offset,
            "at_tail": at_tail,
            "end_of_segment": seg.sealed and at_tail,
            "data": chunk,
            "request_id": f["request_id"],
        })

    async def _on_get_stream_segment_info(self, f: dict) -> bytes:
        seg = self.segments.get(f["segment"])
        return wire.encode("stream_segment_info", {
            "request_id": f["request_id"],
            "segment": f["segment"],
            "exists": seg is not None,
            "sealed": seg.sealed if seg else False,
            "write_offset": len(seg.data) if seg else 0,
            "start_offset": 0,
        })

    async def _on_delete_segment(self, f: dict) -> bytes:
        self.segments.pop(f["segment"], None)
        return wire.encode("segment_deleted", {
            "request_id": f["request_id"], "segment": f["segment"],
        })

    async def _on_truncate_segment(self, f: dict) -> bytes:
        seg = self.segments.get(f["segment"])
        if seg is None:
            return wire.encode("no_such_segment", {
                "request_id": f["request_id"], "segment": f["segment"],
            })
        new_start = max(seg.start_offset, min(int(f["offset"]), len(seg.data)))
        # blank the truncated range (offsets stay absolute; a real store
        # frees the backing extents the same way)
        seg.data[seg.start_offset : new_start] = b"\x00" * (
            new_start - seg.start_offset
        )
        seg.start_offset = new_start
        return wire.encode("segment_truncated", {
            "request_id": f["request_id"], "segment": f["segment"],
        })

    async def _on_seal_segment(self, f: dict) -> bytes:
        seg = self.segments.get(f["segment"])
        if seg is not None:
            seg.sealed = True
        return wire.encode("segment_sealed", {
            "request_id": f["request_id"], "segment": f["segment"],
        })
