"""Pravega topic-connections runtime: dependency-free asyncio client.

Parity: reference ``langstream-pravega-runtime``
(PravegaTopicConnectionsRuntimeProvider.java:1 — EventStreamWriter/Reader +
ReaderGroup + StreamManager via the official io.pravega client) and
``langstream-pravega`` (planner half). This rebuild speaks the segment
store's TCP wire protocol directly (``pravega_protocol.py`` — the
kafka.py/pulsar.py pattern) and the controller's documented REST API for
stream CRUD, so the runtime ships with zero dependencies.

Behavior matched to the reference:
- topics are streams with ``ScalingPolicy.fixed(partitions)`` segments;
  admin CRUD creates the scope + stream (REST: POST /v1/scopes,
  POST /v1/scopes/{scope}/streams — PravegaTopicConnectionsRuntimeProvider
  .java:393-400) and the fixed segments on the segment store.
- records ride as JSON events ``{"key","value","headers","timestamp"}``
  (the reference serializes records through ObjectMapper the same way,
  :154-200) with writeEvent(routingKey, value) semantics: same key → same
  segment, ordered within the segment (:317-319).
- consumers form a subscription group that SPLITS segments across replicas
  (the reference gets this from Pravega reader groups, :127-128).
  Divergence, documented: reader-group coordination here is the platform's
  OWN, built from the same pravega primitive the official client's
  state-synchronizer uses — an event-sourced metadata stream per
  subscription (``_ls_sub_<stream>_<sub>``) carrying membership events and
  committed-offset snapshots (PravegaTopicConsumer docstring). The
  broker-visible protocol is unchanged.
- readers are offset-addressed (TopicReader + absolute seek) over pravega
  byte offsets per segment.

Wire-conformance caveat: see pravega_protocol.py's honesty note and
docs/COMPAT_RUNBOOK.md.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import time
import uuid
from typing import Any, Optional
from urllib.parse import urlparse

from langstream_tpu_torch.api.record import Header, Record
from langstream_tpu_torch.api.topics import (
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConsumer,
    TopicOffsetPosition,
    TopicProducer,
    TopicReadResult,
    TopicReader,
)
from langstream_tpu_torch.messaging import pravega_protocol as wire
from langstream_tpu_torch.messaging.memory import ConsumedRecord
from langstream_tpu_torch.runtime import http_client

log = logging.getLogger(__name__)

READ_CHUNK = 1 << 20  # suggested_length per ReadSegment


class PravegaError(RuntimeError):
    pass


def _record_to_event(record: Record) -> tuple[Optional[str], bytes]:
    """(routing key, serialized JSON event) — reference's ObjectMapper shape."""
    headers = {}
    for h in record.headers or ():
        v = h.value
        headers[h.key] = v.decode() if isinstance(v, bytes) else v
    key = record.key
    value = record.value
    doc = {
        "key": key.decode() if isinstance(key, bytes) else key,
        "value": value.decode() if isinstance(value, bytes) else value,
        "headers": headers,
        "timestamp": record.timestamp or time.time(),
    }
    routing = doc["key"]
    return (str(routing) if routing is not None else None), json.dumps(doc).encode()


def _event_to_record(topic: str, partition: int, offset: int, data: bytes) -> ConsumedRecord:
    doc = json.loads(data.decode())
    return ConsumedRecord(
        value=doc.get("value"),
        key=doc.get("key"),
        headers=tuple(Header(k, v) for k, v in (doc.get("headers") or {}).items()),
        origin=topic,
        timestamp=doc.get("timestamp"),
        partition=partition,
        offset=offset,
    )


class SegmentStoreConnection:
    """One TCP connection to a segment store; request/response correlated by
    request_id, append acks by (writer_id, event_number)."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._acks: dict[tuple[uuid.UUID, int], asyncio.Future] = {}
        self._request_ids = itertools.count(1)
        self._write_lock = asyncio.Lock()
        self._dispatch: Optional[asyncio.Task] = None
        self.dead = False  # set when the dispatch loop exits; owner reconnects

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        await self._send(wire.encode("hello", {}))
        self._dispatch = asyncio.create_task(self._dispatch_loop())

    async def close(self) -> None:
        if self._dispatch is not None:
            self._dispatch.cancel()
            try:
                await self._dispatch
            except asyncio.CancelledError:
                pass
            self._dispatch = None
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None

    async def _send(self, frame_bytes: bytes) -> None:
        assert self._writer is not None, "not connected"
        async with self._write_lock:
            self._writer.write(frame_bytes)
            await self._writer.drain()

    async def _read_frame(self) -> tuple[str, dict]:
        assert self._reader is not None
        header = await self._reader.readexactly(8)
        type_, length = wire.parse_frame_header(header)
        payload = await self._reader.readexactly(length)
        return wire.decode(type_, payload)

    async def _dispatch_loop(self) -> None:
        try:
            while True:
                name, fields = await self._read_frame()
                if name in ("hello", "keep_alive"):
                    continue
                if name == "data_appended":
                    key = (fields["writer_id"], fields["event_number"])
                    fut = self._acks.pop(key, None)
                    if fut is not None and not fut.done():
                        fut.set_result(fields)
                    continue
                rid = fields.get("request_id")
                if rid is not None:
                    fut = self._pending.pop(int(rid), None)
                    if fut is not None and not fut.done():
                        if name in ("error_message", "no_such_segment", "wrong_host"):
                            fut.set_exception(PravegaError(
                                f"{name}: {fields.get('message', fields.get('segment', ''))}"
                            ))
                        else:
                            fut.set_result((name, fields))
        except (asyncio.CancelledError, asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self.dead = True
            err = PravegaError("connection closed")
            for fut in list(self._pending.values()) + list(self._acks.values()):
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            self._acks.clear()

    async def request(self, command: str, fields: dict[str, Any]) -> tuple[str, dict]:
        request_id = next(self._request_ids)
        fields = {**fields, "request_id": request_id}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = fut
        try:
            await self._send(wire.encode(command, fields))
            return await asyncio.wait_for(fut, timeout=30)
        finally:
            self._pending.pop(request_id, None)

    async def append(
        self, writer_id: uuid.UUID, event_number: int, data: bytes, num_events: int
    ) -> dict:
        # request_id from the SHARED counter (never event_number: a small
        # integer that could collide with a concurrent request's id and
        # misroute an error reply); the one future is registered under BOTH
        # keys — DataAppended resolves it via _acks, an error_message /
        # no_such_segment reply via _pending
        request_id = next(self._request_ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._acks[(writer_id, event_number)] = fut
        self._pending[request_id] = fut
        try:
            await self._send(wire.encode("append_block_end", {
                "writer_id": writer_id,
                "size_of_whole_events": len(data),
                "data": data,
                "num_events": num_events,
                "last_event_number": event_number,
                "request_id": request_id,
            }))
            result = await asyncio.wait_for(fut, timeout=30)
            return result if isinstance(result, dict) else result[1]
        finally:
            self._acks.pop((writer_id, event_number), None)
            self._pending.pop(request_id, None)


class PravegaClient:
    """Controller REST (scope/stream CRUD) + one shared segment-store
    connection. Single-segment-store deployments (standalone / one node)
    take the address from config; multi-node segment discovery needs the
    controller's gRPC surface — out of scope, documented in the module
    docstring."""

    def __init__(
        self,
        controller_url: str = "http://localhost:10080",
        segment_store: str = "tcp://localhost:12345",
        scope: str = "langstream",
    ) -> None:
        self.controller_url = controller_url.rstrip("/")
        parsed = urlparse(segment_store)
        self.ss_host = parsed.hostname or "localhost"
        self.ss_port = parsed.port or 12345
        self.scope = scope
        self._conn: Optional[SegmentStoreConnection] = None
        self._lock = asyncio.Lock()

    async def conn(self) -> SegmentStoreConnection:
        async with self._lock:
            if self._conn is not None and self._conn.dead:
                # transient store restart / socket drop: reconnect instead of
                # serving the dead connection forever (writers re-setup on
                # their next append via the error path)
                await self._conn.close()
                self._conn = None
            if self._conn is None:
                conn = SegmentStoreConnection(self.ss_host, self.ss_port)
                await conn.connect()
                self._conn = conn
            return self._conn

    async def close(self) -> None:
        if self._conn is not None:
            await self._conn.close()
            self._conn = None

    # -- controller REST ----------------------------------------------------

    async def rest(self, method: str, path: str, body: Optional[dict] = None) -> tuple[int, dict]:
        """One controller REST call through ``runtime/http_client`` in a
        worker thread; an empty body or one that is not JSON reads as
        ``{}``."""
        headers = {"Accept": "application/json"}
        data = None
        if body is not None:
            data, headers = http_client.json_body(body, headers)
        resp = await http_client.request(
            method, f"{self.controller_url}/v1{path}", data, headers
        )
        try:
            doc = resp.json()
        except Exception:  # noqa: BLE001 — empty/non-json body
            doc = {}
        return resp.status, doc or {}

    async def ensure_scope(self) -> None:
        status, _ = await self.rest("POST", "/scopes", {"scopeName": self.scope})
        if status not in (201, 409):  # created | already exists
            raise PravegaError(f"create scope failed: HTTP {status}")

    async def create_stream(self, stream: str, segments: int) -> None:
        await self.ensure_scope()
        status, _ = await self.rest(
            "POST",
            f"/scopes/{self.scope}/streams",
            {
                "streamName": stream,
                "scopeName": self.scope,
                "scalingPolicy": {
                    "type": "FIXED_NUM_SEGMENTS",
                    "minSegments": max(1, segments),
                },
            },
        )
        if status not in (201, 409):
            raise PravegaError(f"create stream {stream} failed: HTTP {status}")
        conn = await self.conn()
        for number in range(max(1, segments)):
            name = wire.SegmentName(self.scope, stream, number).qualified
            try:
                await conn.request("create_segment", {"segment": name})
            except PravegaError:
                pass  # already exists

    async def delete_stream(self, stream: str) -> None:
        # the controller requires SEALED before delete
        await self.rest(
            "PUT",
            f"/scopes/{self.scope}/streams/{stream}/state",
            {"streamState": "SEALED"},
        )
        status, _ = await self.rest("DELETE", f"/scopes/{self.scope}/streams/{stream}")
        if status not in (204, 404):
            raise PravegaError(f"delete stream {stream} failed: HTTP {status}")

    async def stream_segments(self, stream: str) -> int:
        status, doc = await self.rest("GET", f"/scopes/{self.scope}/streams/{stream}")
        if status == 404:
            return 0
        return int(doc.get("scalingPolicy", {}).get("minSegments", 1))

    async def ensure_stream(self, stream: str) -> int:
        """Auto-create on first touch (the other runtimes' broker-side
        auto-create behavior); returns the segment count."""
        n = await self.stream_segments(stream)
        if n == 0:
            await self.create_stream(stream, 1)
            n = 1
        return n

    def segment(self, stream: str, number: int) -> str:
        return wire.SegmentName(self.scope, stream, number).qualified


class PravegaTopicProducer(TopicProducer):
    """EventStreamWriter semantics: routing key → fixed segment, append
    acks awaited per event (the reference's writeEvent().get())."""

    def __init__(self, client: PravegaClient, topic: str) -> None:
        self.client = client
        self.topic_name = topic
        self._writer_ids: dict[int, uuid.UUID] = {}
        self._event_numbers: dict[int, int] = {}
        self._segments = 0
        self._rr = 0
        self._total_in = 0

    async def start(self) -> None:
        self._segments = await self.client.ensure_stream(self.topic_name)
        conn = await self.client.conn()
        for number in range(self._segments):
            writer_id = uuid.uuid4()
            _, fields = await conn.request("setup_append", {
                "writer_id": writer_id,
                "segment": self.client.segment(self.topic_name, number),
            })
            self._writer_ids[number] = writer_id
            self._event_numbers[number] = int(fields.get("last_event_number", 0))

    async def close(self) -> None:
        self._writer_ids.clear()

    async def write(self, record: Record) -> None:
        if not self._writer_ids:
            await self.start()
        routing, data = _record_to_event(record)
        if routing is not None:
            number = wire.routing_key_segment(routing, self._segments)
        else:
            number = self._rr % self._segments
            self._rr += 1
        conn = await self.client.conn()
        self._event_numbers[number] += 1
        try:
            await conn.append(
                self._writer_ids[number],
                self._event_numbers[number],
                wire.frame_event(data),
                1,
            )
        except PravegaError:
            # connection was replaced (store restart): writers must re-setup
            # on the new socket, then the append retries exactly once
            await self.start()
            conn = await self.client.conn()
            self._event_numbers[number] += 1
            await conn.append(
                self._writer_ids[number],
                self._event_numbers[number],
                wire.frame_event(data),
                1,
            )
        self._total_in += 1

    @property
    def total_in(self) -> int:
        return self._total_in


_HEARTBEAT_EVERY = 2.0  # seconds between my heartbeat appends
_LIVENESS_WINDOW = 15.0  # member considered dead past this silence
_REFRESH_EVERY = 0.5  # how often read() re-derives the assignment


class PravegaTopicConsumer(TopicConsumer):
    """Subscription consumer with DYNAMIC segment splitting.

    Where the reference leans on the client library's ReaderGroup (a
    state-synchronizer segment), this consumer builds the same coordination
    from pravega primitives it already speaks: a single-segment metadata
    stream per (topic, subscription) carries an event-sourced log of
    membership events ({join, leave, heartbeat}) and committed-offset
    snapshots. Every member replays the log (incrementally — it remembers
    its read offset), derives the live member set, and takes the segments
    ``s where s % n_members == my_rank`` — all members compute the same
    assignment from the same log, so each segment has exactly one owner per
    converged view, and offsets snapshots hand work over on rebalance.
    ``start`` only joins: the first ``read`` replays the log again and
    claims, so members started together see each other's joins whatever
    order their joins landed in.
    Within a segment, delivery is ordered and commit advances over the
    contiguous acked prefix (the kafka OffsetTracker rule)."""

    def __init__(
        self,
        client: PravegaClient,
        topic: str,
        subscription: str,
        poll_timeout: float = 0.1,
        max_records: int = 100,
    ) -> None:
        self.client = client
        self.topic_name = topic
        self.subscription = subscription
        self.poll_timeout = poll_timeout
        self.max_records = max_records
        self.member_id = f"c-{uuid.uuid4().hex[:12]}"
        self._n_segments = 1
        self._positions: dict[int, int] = {}  # owned segment → next fetch offset
        # segment → {start offset → (end offset, acked)} in delivery order
        self._pending: dict[int, dict[int, tuple[int, bool]]] = {}
        self._committed: dict[int, int] = {}  # merged view for MY segments
        self._meta_stream = f"_ls_sub_{topic}_{subscription}"
        self._meta_offset = 0  # replay frontier in the metadata segment
        self._meta_base = 0  # truncation frontier last observed
        self._members: dict[str, float] = {}  # member → last seen ts
        self._snapshot_offsets: dict[str, int] = {}  # last offsets snapshot
        self._meta_writer: Optional[uuid.UUID] = None
        self._meta_event_number = 0
        self._last_heartbeat = 0.0
        self._last_refresh = 0.0
        self._claimed = False  # set by the first assignment (first read)
        self._total_out = 0

    # -- metadata log -------------------------------------------------------

    META_COMPACT_BYTES = 256 * 1024  # snapshot+truncate past this log size

    def _meta_segment(self) -> str:
        return self.client.segment(self._meta_stream, 0)

    async def _append_meta(self, doc: dict) -> None:
        """Append on a PERSISTENT writer (one setup per consumer lifetime,
        re-set-up only after a reconnect) — a fresh writer per append would
        grow the store's per-segment writer map unboundedly."""
        conn = await self.client.conn()
        if self._meta_writer is None:
            await self._setup_meta_writer(conn)
        self._meta_event_number += 1
        payload = wire.frame_event(json.dumps(doc).encode())
        try:
            await conn.append(self._meta_writer, self._meta_event_number, payload, 1)
        except PravegaError:
            conn = await self.client.conn()
            await self._setup_meta_writer(conn)
            self._meta_event_number += 1
            await conn.append(self._meta_writer, self._meta_event_number, payload, 1)

    async def _setup_meta_writer(self, conn: SegmentStoreConnection) -> None:
        self._meta_writer = uuid.uuid4()
        _, fields = await conn.request("setup_append", {
            "writer_id": self._meta_writer, "segment": self._meta_segment(),
        })
        self._meta_event_number = int(fields.get("last_event_number", 0))

    async def _replay_meta(self) -> None:
        """Fold new metadata events into the membership/offsets view. The
        store may answer a read below its truncation frontier with bytes
        from the frontier — the echoed offset says where they start."""
        conn = await self.client.conn()
        while True:
            _, fields = await conn.request("read_segment", {
                "segment": self._meta_segment(),
                "offset": self._meta_offset,
                "suggested_length": READ_CHUNK,
            })
            base = int(fields.get("offset", self._meta_offset))
            if base > self._meta_offset:  # jumped past a truncation
                self._meta_offset = base
                self._meta_base = base
            advanced = False
            for off, event in wire.iter_events(fields["data"], self._meta_offset):
                doc = json.loads(event.decode())
                kind = doc.get("type")
                if kind == "member":
                    member = doc["member"]
                    if doc["action"] == "leave":
                        self._members.pop(member, None)
                    else:  # join / heartbeat
                        self._members[member] = float(doc.get("ts", 0.0))
                elif kind == "offsets":
                    self._snapshot_offsets.update(
                        {k: int(v) for k, v in doc.get("offsets", {}).items()}
                    )
                elif kind == "snapshot":  # compaction point: replaces state
                    self._members = {
                        m: float(ts) for m, ts in doc.get("members", {}).items()
                    }
                    self._snapshot_offsets = {
                        k: int(v) for k, v in doc.get("offsets", {}).items()
                    }
                self._meta_offset = off + 8 + len(event)
                advanced = True
            if not advanced:
                return

    async def _compact_meta_if_due(self, live: list[str]) -> None:
        """Log compaction: when the un-truncated log grows past the cap, the
        LOWEST-ranked live member writes one snapshot record carrying the
        full folded state and truncates everything before it. Joiners then
        replay {snapshot, tail} instead of the whole history."""
        if self._meta_offset - self._meta_base < self.META_COMPACT_BYTES:
            return
        if not live or live[0] != self.member_id:
            return  # one compactor at a time is enough
        conn = await self.client.conn()
        _, info = await conn.request(
            "get_stream_segment_info", {"segment": self._meta_segment()}
        )
        snapshot_at = int(info.get("write_offset", self._meta_offset))
        await self._append_meta({
            "type": "snapshot",
            "members": self._members,
            "offsets": self._snapshot_offsets,
        })
        await conn.request("truncate_segment", {
            "segment": self._meta_segment(), "offset": snapshot_at,
        })
        self._meta_base = snapshot_at

    async def _refresh_assignment(self) -> None:
        await self._replay_meta()
        now = time.time()
        live = sorted(
            m for m, ts in self._members.items() if now - ts < _LIVENESS_WINDOW
        )
        if self.member_id not in live:
            live.append(self.member_id)
            live.sort()
        rank = live.index(self.member_id)
        mine = {s for s in range(self._n_segments) if s % len(live) == rank}
        await self._compact_meta_if_due(live)
        if mine != set(self._positions):
            # rebalance: drop lost segments (their unacked in-flight events
            # redeliver to the new owner — at-least-once), adopt gained ones
            # from the last committed snapshot
            for seg in list(self._positions):
                if seg not in mine:
                    del self._positions[seg]
                    self._pending.pop(seg, None)
                    self._committed.pop(seg, None)
            for seg in mine:
                if seg not in self._positions:
                    start = int(self._snapshot_offsets.get(str(seg), 0))
                    self._positions[seg] = start
                    self._committed[seg] = start
                    self._pending[seg] = {}
        self._claimed = True
        self._last_refresh = asyncio.get_running_loop().time()

    async def _heartbeat_if_due(self) -> None:
        now = time.time()
        if now - self._last_heartbeat >= _HEARTBEAT_EVERY:
            self._last_heartbeat = now
            await self._append_meta({
                "type": "member", "member": self.member_id,
                "action": "heartbeat", "ts": now,
            })

    # -- SPI ----------------------------------------------------------------

    async def start(self) -> None:
        self._n_segments = await self.client.ensure_stream(self.topic_name)
        await self.client.create_stream(self._meta_stream, 1)
        self._last_heartbeat = time.time()
        await self._append_meta({
            "type": "member", "member": self.member_id,
            "action": "join", "ts": self._last_heartbeat,
        })
        await self._replay_meta()

    async def close(self) -> None:
        if not self._positions and not self._members:
            return
        try:
            await self._append_meta({
                "type": "member", "member": self.member_id, "action": "leave",
            })
        except (PravegaError, ConnectionError, asyncio.TimeoutError):
            log.warning("pravega consumer leave append failed", exc_info=True)
        self._positions.clear()
        self._pending.clear()
        self._members.clear()

    async def read(self) -> list[Record]:
        out: list[Record] = []
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.poll_timeout
        conn = await self.client.conn()
        while len(out) < self.max_records:
            if not self._claimed or loop.time() - self._last_refresh >= _REFRESH_EVERY:
                await self._heartbeat_if_due()
                await self._refresh_assignment()
            got_any = False
            for number in list(self._positions):
                offset = self._positions[number]
                _, fields = await conn.request("read_segment", {
                    "segment": self.client.segment(self.topic_name, number),
                    "offset": offset,
                    "suggested_length": READ_CHUNK,
                })
                for off, event in wire.iter_events(fields["data"], offset):
                    end = off + 8 + len(event)
                    out.append(_event_to_record(self.topic_name, number, off, event))
                    self._pending[number][off] = (end, False)
                    self._positions[number] = end
                    got_any = True
                    if len(out) >= self.max_records:
                        break
            if not got_any:
                if out:
                    break
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                await asyncio.sleep(min(0.02, remaining))
        self._total_out += len(out)
        return out

    async def commit(self, records: list[Record]) -> None:
        """Mark acked, advance each owned segment's committed offset over
        the contiguous acked prefix, snapshot to the metadata log."""
        for r in records:
            if isinstance(r, ConsumedRecord):
                seg = self._pending.get(r.partition)
                if seg is not None and r.offset in seg:
                    seg[r.offset] = (seg[r.offset][0], True)
        changed = False
        for number, seg in self._pending.items():
            while True:
                head = self._committed.get(number, 0)
                entry = seg.get(head)
                if entry is None or not entry[1]:
                    break
                self._committed[number] = entry[0]
                del seg[head]
                changed = True
        if changed:
            await self._append_meta({
                "type": "offsets",
                "offsets": {str(k): v for k, v in self._committed.items()},
            })

    def get_info(self) -> dict[str, Any]:
        return {
            "topic": self.topic_name,
            "subscription": self.subscription,
            "member": self.member_id,
            "segments": sorted(self._positions),
            "committed": dict(self._committed),
        }

    @property
    def total_out(self) -> int:
        return self._total_out


class PravegaTopicReader(TopicReader):
    """Offset-addressed reader over ALL segments of a stream."""

    def __init__(
        self, client: PravegaClient, topic: str, initial_position: TopicOffsetPosition
    ) -> None:
        self.client = client
        self.topic_name = topic
        self.initial_position = initial_position
        self._positions: dict[int, int] = {}
        self._n = 1

    async def start(self) -> None:
        self._n = await self.client.ensure_stream(self.topic_name)
        conn = await self.client.conn()
        for number in range(self._n):
            p = number if self._n > 1 else -1
            seg = self.client.segment(self.topic_name, number)
            if self.initial_position.position == "absolute":
                self._positions[p] = int(self.initial_position.offsets.get(p, 0))
            elif self.initial_position.position == TopicOffsetPosition.LATEST:
                _, info = await conn.request("get_stream_segment_info", {"segment": seg})
                self._positions[p] = int(info.get("write_offset", 0))
            else:
                self._positions[p] = 0

    async def close(self) -> None:
        self._positions.clear()

    async def read(self) -> TopicReadResult:
        out: list[Record] = []
        record_offsets: list[dict[int, int]] = []
        conn = await self.client.conn()
        for p in list(self._positions):
            number = max(0, p)
            offset = self._positions[p]
            _, fields = await conn.request("read_segment", {
                "segment": self.client.segment(self.topic_name, number),
                "offset": offset,
                "suggested_length": READ_CHUNK,
            })
            for off, event in wire.iter_events(fields["data"], offset):
                end = off + 8 + len(event)
                out.append(_event_to_record(self.topic_name, p, off, event))
                self._positions[p] = end
                record_offsets.append(dict(self._positions))
        if not out:
            await asyncio.sleep(0.02)
        return TopicReadResult(out, dict(self._positions), record_offsets=record_offsets)


class PravegaTopicAdmin(TopicAdmin):
    """Stream CRUD over the controller REST API (the StreamManager surface,
    reference :393-400)."""

    def __init__(self, client: PravegaClient) -> None:
        self.client = client

    async def create_topic(
        self, name: str, partitions: int = 1, options: Optional[dict] = None
    ) -> None:
        await self.client.create_stream(name, partitions)

    async def delete_topic(self, name: str) -> None:
        await self.client.delete_stream(name)

    async def topic_exists(self, name: str) -> bool:
        return (await self.client.stream_segments(name)) > 0


class PravegaTopicConnectionsRuntime(TopicConnectionsRuntime):
    """``streamingCluster.type: pravega`` — config mirrors the reference's
    ``client`` block (controller-uri, scope; PravegaClientUtils.java:1) plus
    ``segment-store`` for the data plane."""

    def __init__(self) -> None:
        self.client: Optional[PravegaClient] = None

    async def init(self, streaming_cluster_config: dict[str, Any]) -> None:
        cfg = streaming_cluster_config.get("client", {}) or {}
        self.client = PravegaClient(
            controller_url=cfg.get(
                "controller-rest-uri", cfg.get("controller-uri", "http://localhost:10080")
            ),
            segment_store=cfg.get("segment-store", "tcp://localhost:12345"),
            scope=cfg.get("scope", "langstream"),
        )

    async def close(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None

    def create_consumer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicConsumer:
        config = config or {}
        return PravegaTopicConsumer(
            self.client,
            topic,
            subscription=config.get("subscription", agent_id or "langstream"),
        )

    def create_producer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicProducer:
        return PravegaTopicProducer(self.client, topic)

    def create_reader(
        self,
        topic: str,
        initial_position: TopicOffsetPosition = TopicOffsetPosition(),
        config: Optional[dict[str, Any]] = None,
    ) -> TopicReader:
        return PravegaTopicReader(self.client, topic, initial_position)

    def create_topic_admin(self) -> TopicAdmin:
        return PravegaTopicAdmin(self.client)
