"""Kafka topic-connections runtime over a pure-asyncio wire-protocol client.

Parity: reference `langstream-kafka-runtime/` — consumer wrapper with manual
contiguous-prefix offset commit (KafkaConsumerWrapper.java:41-190), producer
wrapper with key partitioning, offset-addressed reader for the gateway, and
topic admin. No client library: the protocol codec is
``kafka_protocol.py`` (stdlib only) and works against a real broker or the
protocol-level fake (``kafka_fake.py`` — the `k8s/fake.py` testing pattern).

Design notes:
- Partition assignment is DYNAMIC when a ``group.id`` is set: the consumer
  speaks the JoinGroup/SyncGroup/Heartbeat group protocol
  (``KafkaGroupMembership`` below) with a client-side RangeAssignor, so
  replicas of the same agent split a topic's partitions and rebalance on
  membership change; commits are generation-fenced. With an explicit
  ``partitions`` list the consumer is static and uses offset storage only
  (OffsetCommit/OffsetFetch with generation -1 — the "simple consumer"
  convention).
- Commit bookkeeping is the same native OffsetTracker the memory broker
  uses: acks may arrive out of order, the committed offset only advances
  over the contiguous prefix.
- Values/keys serialize as UTF-8 for str, raw for bytes, compact JSON for
  anything else (decode tries UTF-8 first, falls back to raw bytes) —
  replacing the reference's Serde zoo with one honest rule.
"""

from __future__ import annotations

import asyncio
import functools
import itertools
import json
import time
from typing import Any, Optional

from langstream_tpu_torch.api.record import Header, Record
from langstream_tpu_torch.api.topics import (
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConsumer,
    TopicOffsetPosition,
    TopicProducer,
    TopicReader,
    TopicReadResult,
)
from langstream_tpu_torch.messaging import kafka_protocol as wire
from langstream_tpu_torch.messaging.memory import ConsumedRecord
from langstream_tpu_torch.native import OffsetTracker


class OffsetOutOfRange(RuntimeError):
    """Fetch offset fell outside the partition's log (retention truncated
    past a committed position); carries where so callers can reset."""

    def __init__(self, topic: str, partition: int) -> None:
        super().__init__(f"offset out of range for {topic}/{partition}")
        self.topic = topic
        self.partition = partition


class CommitFenced(RuntimeError):
    """OffsetCommit rejected by the coordinator (stale generation / unknown
    member): this replica was rebalanced away; it must rejoin, and the
    unacked records will be redelivered to the new partition owner."""


def _parse_bootstrap(bootstrap: str) -> list[tuple[str, int]]:
    """'host1:9092,host2:9093' / 'host' → [(host, port)] (default port 9092)."""
    out: list[tuple[str, int]] = []
    for entry in bootstrap.split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, _, port = entry.rpartition(":")
        if host and port.isdigit():
            out.append((host, int(port)))
        else:
            out.append((entry, 9092))
    if not out:
        raise ValueError(f"empty bootstrap.servers {bootstrap!r}")
    return out


# transport headers carrying the Avro schema across the broker (schema-in-
# header v1: no registry needed; the canonical JSON is the intern key, so a
# downstream agent re-encodes under the ORIGINAL schema — the reference
# round-trips schemas through its serdes, KafkaProducerWrapper.java)
_AVRO_VALUE_SCHEMA_HEADER = "ls-avro-value-schema"
_AVRO_KEY_SCHEMA_HEADER = "ls-avro-key-schema"


@functools.lru_cache(maxsize=256)
def _schema_from_header(raw: bytes):
    """Memoized schema parse — a topic typically streams one fixed schema,
    and re-parsing JSON per consumed record would dominate hot-path CPU."""
    from langstream_tpu_torch.api.avro import parse_schema

    return parse_schema(raw)


def _encode_datum(v: Any) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode()
    from langstream_tpu_torch.api.avro import AvroValue

    if isinstance(v, AvroValue):
        return v.encode()  # binary Avro; schema travels in the header
    return json.dumps(v, separators=(",", ":")).encode()


def _decode_datum(b: Optional[bytes]) -> Any:
    if b is None:
        return None
    try:
        return b.decode()
    except UnicodeDecodeError:
        return b


class KafkaConnection:
    """One broker connection; serial request/response with a lock (the
    runtime opens one connection per broker node per client)."""

    def __init__(self, host: str, port: int, client_id: str) -> None:
        self.host = host
        self.port = port
        self.client_id = client_id
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()
        self._correlation = itertools.count(1)

    async def connect(self) -> None:
        if self._writer is None:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001 — peer may already be gone
                pass
            self._writer = None
            self._reader = None

    async def call(self, api_key: int, payload: bytes) -> wire.Reader:
        async with self._lock:
            await self.connect()
            assert self._writer is not None and self._reader is not None
            cid = next(self._correlation)
            try:
                self._writer.write(
                    wire.encode_request(api_key, cid, self.client_id, payload)
                )
                await self._writer.drain()
                size = int.from_bytes(await self._reader.readexactly(4), "big")
                frame = await self._reader.readexactly(size)
            except BaseException:
                # a cancelled/failed mid-flight call leaves the stream with an
                # unread response; drop the connection so the next call
                # reconnects with clean framing
                await self.close()
                raise
            r = wire.Reader(frame)
            got = r.int32()
            if got != cid:
                raise RuntimeError(f"correlation mismatch: sent {cid} got {got}")
            return r


class KafkaClient:
    """Minimal cluster client: metadata-driven leader routing over
    per-node connections."""

    def __init__(self, bootstrap: str, client_id: str = "langstream-tpu") -> None:
        servers = _parse_bootstrap(bootstrap)
        host, port = servers[0]  # remaining entries are DNS-level fallbacks
        self._bootstrap = KafkaConnection(host, port, client_id)
        self._client_id = client_id
        self._nodes: dict[int, tuple[str, int]] = {}
        self._conns: dict[int, KafkaConnection] = {}
        # per (node, key) fetch connections: long-poll fetches get their own
        # socket per consumer so they never head-of-line block produces or
        # other consumers on the shared command connection
        self._fetch_conns: dict[tuple[int, int], KafkaConnection] = {}
        self._leaders: dict[tuple[str, int], int] = {}
        self._coordinators: dict[str, int] = {}

    async def close(self) -> None:
        await self._bootstrap.close()
        for conn in list(self._conns.values()) + list(self._fetch_conns.values()):
            await conn.close()
        self._conns.clear()
        self._fetch_conns.clear()

    async def _leader_conn(self, topic: str, partition: int) -> KafkaConnection:
        # leaders < 0 (LEADER_NOT_AVAILABLE) are never cached, so a missing
        # key is the only state to refresh; retry briefly for the transient
        # just-created-topic window
        for attempt in range(5):
            if (topic, partition) in self._leaders:
                break
            await self.metadata([topic])
            if (topic, partition) in self._leaders:
                break
            await asyncio.sleep(0.05 * (attempt + 1))
        node = self._leaders.get((topic, partition))
        if node is None:
            raise RuntimeError(f"no leader for {topic}/{partition}")
        conn = self._conns.get(node)
        if conn is None:
            host, port = self._nodes[node]
            conn = KafkaConnection(host, port, self._client_id)
            self._conns[node] = conn
        return conn

    def _fetch_conn(self, node: int, key: int) -> KafkaConnection:
        conn = self._fetch_conns.get((node, key))
        if conn is None:
            host, port = self._nodes[node]
            conn = KafkaConnection(host, port, self._client_id)
            self._fetch_conns[(node, key)] = conn
        return conn

    async def release_fetch_conns(self, key: int) -> None:
        """Close the per-consumer fetch sockets (consumer/reader close)."""
        for nk in [nk for nk in self._fetch_conns if nk[1] == key]:
            await self._fetch_conns.pop(nk).close()

    # -- apis ---------------------------------------------------------------

    async def ensure_topic(self, topic: str) -> list[int]:
        """Partition ids for ``topic``, creating it (1 partition) if absent —
        the client-side analogue of Kafka's auto.create.topics."""
        meta = await self.metadata([topic])
        if topic not in meta:
            await self.create_topic(topic, 1)
            meta = await self.metadata([topic])
        return meta.get(topic) or [0]

    async def metadata(self, topics: Optional[list[str]] = None) -> dict[str, list[int]]:
        """topic → partition ids; refreshes node + leader routing tables."""
        w = wire.Writer().array(topics, lambda w, t: w.string(t))
        r = await self._bootstrap.call(wire.METADATA, w.build())
        out: dict[str, list[int]] = {}
        for _ in range(r.int32()):  # brokers
            node, host, port = r.int32(), r.string(), r.int32()
            r.string()  # rack
            self._nodes[node] = (host or "localhost", port)
        r.int32()  # controller id
        for _ in range(r.int32()):  # topics
            err, name = r.int16(), r.string()
            r.boolean()  # is_internal
            parts: list[int] = []
            for _ in range(r.int32()):
                perr = r.int16()
                pid, leader = r.int32(), r.int32()
                r.array(lambda rr: rr.int32())  # replicas
                r.array(lambda rr: rr.int32())  # isr
                parts.append(pid)
                if perr == wire.NONE and leader >= 0:
                    self._leaders[(name, pid)] = leader
                else:  # transient LEADER_NOT_AVAILABLE — never cache -1
                    self._leaders.pop((name, pid), None)
            if err == wire.NONE and name is not None:
                out[name] = sorted(parts)
        return out

    async def produce(
        self, topic: str, partition: int, records: list[wire.WireRecord]
    ) -> int:
        """Append one batch; returns the assigned base offset."""
        batch = wire.encode_record_batch(records)
        w = wire.Writer()
        w.string(None)  # transactional_id
        w.int16(-1)  # acks: all
        w.int32(30_000)
        w.array(
            [(topic, partition, batch)],
            lambda w, t: w.string(t[0]).array(
                [t],
                lambda w2, t2: w2.int32(t2[1]).bytes_(t2[2]),
            ),
        )
        conn = await self._leader_conn(topic, partition)
        r = await conn.call(wire.PRODUCE, w.build())
        base_offset = -1
        for _ in range(r.int32()):
            r.string()  # topic
            for _ in range(r.int32()):
                r.int32()  # partition
                err = r.int16()
                base_offset = r.int64()
                r.int64()  # log_append_time
                if err != wire.NONE:
                    # leader may have moved: evict so the next call re-resolves
                    self._leaders.pop((topic, partition), None)
                    raise RuntimeError(f"produce to {topic}/{partition}: error {err}")
        r.int32()  # throttle
        return base_offset

    async def fetch(
        self,
        offsets: dict[tuple[str, int], int],
        max_wait_ms: int,
        max_partition_bytes: int = 4 * 1024 * 1024,
        conn_key: int = 0,
    ) -> dict[tuple[str, int], list[wire.WireRecord]]:
        """Fetch from each (topic, partition) at its offset. Partitions are
        grouped per leader node; one Fetch request per node."""
        by_node: dict[int, list[tuple[str, int]]] = {}
        for (topic, partition) in offsets:
            await self._leader_conn(topic, partition)  # ensure routing
            node = self._leaders[(topic, partition)]
            by_node.setdefault(node, []).append((topic, partition))

        out: dict[tuple[str, int], list[wire.WireRecord]] = {}
        for node, tps in by_node.items():
            by_topic: dict[str, list[int]] = {}
            for topic, partition in tps:
                by_topic.setdefault(topic, []).append(partition)
            w = wire.Writer()
            w.int32(-1)  # replica_id
            w.int32(max_wait_ms)
            w.int32(1)  # min_bytes
            w.int32(64 * 1024 * 1024)  # max_bytes
            w.int8(0)  # isolation: read_uncommitted
            w.array(
                sorted(by_topic.items()),
                lambda w, t: w.string(t[0]).array(
                    t[1],
                    lambda w2, p, _topic=t[0]: w2.int32(p)
                    .int64(offsets[(_topic, p)])
                    .int32(max_partition_bytes),
                ),
            )
            conn = self._fetch_conn(node, conn_key)
            r = await conn.call(wire.FETCH, w.build())
            r.int32()  # throttle
            for _ in range(r.int32()):
                topic = r.string() or ""
                for _ in range(r.int32()):
                    partition = r.int32()
                    err = r.int16()
                    r.int64()  # high watermark
                    r.int64()  # last stable
                    r.array(lambda rr: (rr.int64(), rr.int64()))  # aborted txns
                    data = r.bytes_() or b""
                    if err == wire.OFFSET_OUT_OF_RANGE:
                        raise OffsetOutOfRange(topic, partition)
                    if err in wire.RETRIABLE_FETCH_ERRORS:
                        # routine leader movement during failover: evict the
                        # cached route and poll again next loop (the Java
                        # client's retry semantics), not an application error
                        self._leaders.pop((topic, partition), None)
                        out.setdefault((topic, partition), [])
                        continue
                    if err != wire.NONE:
                        self._leaders.pop((topic, partition), None)
                        raise RuntimeError(f"fetch {topic}/{partition}: error {err}")
                    want = offsets[(topic, partition)]
                    recs = [
                        rec for rec in wire.decode_record_batches(data)
                        if rec.offset >= want  # batches may start earlier
                    ]
                    out[(topic, partition)] = recs
        return out

    async def list_offsets(self, topic: str, partition: int, timestamp: int) -> int:
        w = wire.Writer()
        w.int32(-1)
        w.array(
            [(topic, partition)],
            lambda w, t: w.string(t[0]).array(
                [t[1]], lambda w2, p: w2.int32(p).int64(timestamp)
            ),
        )
        conn = await self._leader_conn(topic, partition)
        r = await conn.call(wire.LIST_OFFSETS, w.build())
        offset = 0
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()  # partition
                err = r.int16()
                r.int64()  # timestamp
                offset = r.int64()
                if err != wire.NONE:
                    self._leaders.pop((topic, partition), None)
                    raise RuntimeError(f"list_offsets {topic}/{partition}: error {err}")
        return offset

    async def coordinator_node(self, group: str) -> int:
        """Group coordinator's node id, cached per group (the Java client's
        behavior) — heartbeats/commits must not serialize a FIND_COORDINATOR
        round-trip behind the shared bootstrap lock on every tick. Callers
        evict via ``invalidate_coordinator`` when a coordinator call fails."""
        cached = self._coordinators.get(group)
        if cached is not None:
            return cached
        w = wire.Writer().string(group).int8(0)
        r = await self._bootstrap.call(wire.FIND_COORDINATOR, w.build())
        r.int32()  # throttle
        err = r.int16()
        r.string()  # error message
        node, host, port = r.int32(), r.string(), r.int32()
        if err != wire.NONE:
            raise RuntimeError(f"find_coordinator({group}): error {err}")
        self._nodes[node] = (host or "localhost", port)
        self._coordinators[group] = node
        return node

    def invalidate_coordinator(self, group: str) -> None:
        self._coordinators.pop(group, None)

    async def find_coordinator(self, group: str) -> KafkaConnection:
        node = await self.coordinator_node(group)
        conn = self._conns.get(node)
        if conn is None:
            host, port = self._nodes[node]
            conn = KafkaConnection(host, port, self._client_id)
            self._conns[node] = conn
        return conn

    async def coordinator_conn(self, group: str, key: int) -> KafkaConnection:
        """Dedicated coordinator socket for one group member — JoinGroup and
        follower SyncGroup block server-side until the rebalance completes,
        and must never head-of-line block produce/commit traffic (or another
        member's join!) on the shared command connection."""
        node = await self.coordinator_node(group)
        return self._fetch_conn(node, key)

    async def offset_commit(
        self,
        group: str,
        topic: str,
        offsets: dict[int, int],
        generation: int = -1,
        member_id: str = "",
    ) -> None:
        """Commit offsets; generation -1 is the simple-consumer convention,
        a real generation is fenced by the coordinator (CommitFenced)."""
        w = wire.Writer()
        w.string(group)
        w.int32(generation)
        w.string(member_id)
        w.int64(-1)  # retention
        w.array(
            [topic],
            lambda w, t: w.string(t).array(
                sorted(offsets.items()),
                lambda w2, po: w2.int32(po[0]).int64(po[1]).string(None),
            ),
        )
        conn = await self.find_coordinator(group)
        r = await conn.call(wire.OFFSET_COMMIT, w.build())
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                partition = r.int32()
                err = r.int16()
                if err in (wire.ILLEGAL_GENERATION, wire.UNKNOWN_MEMBER_ID):
                    raise CommitFenced(f"offset_commit {topic}/{partition}: error {err}")
                if err != wire.NONE:
                    raise RuntimeError(f"offset_commit {topic}/{partition}: error {err}")

    # -- consumer group membership ------------------------------------------

    async def join_group(
        self,
        conn: KafkaConnection,
        group: str,
        member_id: str,
        topics: list[str],
        session_timeout_ms: int,
        rebalance_timeout_ms: int,
    ) -> tuple[int, int, Optional[str], str, list[tuple[str, bytes]]]:
        """JoinGroup v2 → (error, generation, leader, member_id, roster);
        roster (member_id, subscription bytes) is non-empty only for the
        elected leader, who must compute the assignment."""
        w = wire.Writer()
        w.string(group)
        w.int32(session_timeout_ms)
        w.int32(rebalance_timeout_ms)
        w.string(member_id)
        w.string("consumer")
        w.array(
            [("range", wire.encode_subscription(topics))],
            lambda w, p: w.string(p[0]).bytes_(p[1]),
        )
        r = await conn.call(wire.JOIN_GROUP, w.build())
        r.int32()  # throttle
        err = r.int16()
        generation = r.int32()
        r.string()  # protocol name
        leader = r.string()
        me = r.string() or ""
        roster = r.array(lambda rr: (rr.string() or "", rr.bytes_() or b""))
        return err, generation, leader, me, roster

    async def sync_group(
        self,
        conn: KafkaConnection,
        group: str,
        generation: int,
        member_id: str,
        assignments: list[tuple[str, bytes]],
    ) -> tuple[int, bytes]:
        w = wire.Writer()
        w.string(group)
        w.int32(generation)
        w.string(member_id)
        w.array(assignments, lambda w, a: w.string(a[0]).bytes_(a[1]))
        r = await conn.call(wire.SYNC_GROUP, w.build())
        r.int32()  # throttle
        err = r.int16()
        return err, r.bytes_() or b""

    async def heartbeat(
        self, conn: KafkaConnection, group: str, generation: int, member_id: str
    ) -> int:
        w = wire.Writer().string(group).int32(generation).string(member_id)
        r = await conn.call(wire.HEARTBEAT, w.build())
        r.int32()  # throttle
        return r.int16()

    async def leave_group(
        self, conn: KafkaConnection, group: str, member_id: str
    ) -> None:
        w = wire.Writer().string(group).string(member_id)
        r = await conn.call(wire.LEAVE_GROUP, w.build())
        r.int32()  # throttle
        r.int16()  # best-effort

    async def offset_fetch(self, group: str, topic: str, partitions: list[int]) -> dict[int, int]:
        w = wire.Writer()
        w.string(group)
        w.array(
            [topic],
            lambda w, t: w.string(t).array(partitions, lambda w2, p: w2.int32(p)),
        )
        conn = await self.find_coordinator(group)
        r = await conn.call(wire.OFFSET_FETCH, w.build())
        out: dict[int, int] = {}
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                partition = r.int32()
                offset = r.int64()
                r.string()  # metadata
                err = r.int16()
                if err == wire.NONE:
                    out[partition] = offset
        return out

    async def create_topic(self, name: str, partitions: int) -> None:
        w = wire.Writer()
        w.array(
            [name],
            lambda w, t: w.string(t)
            .int32(partitions)
            .int16(1)  # replication factor
            .array([], lambda w2, _: None)  # assignments
            .array([], lambda w2, _: None),  # configs
        )
        w.int32(30_000)
        r = await self._bootstrap.call(wire.CREATE_TOPICS, w.build())
        for _ in range(r.int32()):
            r.string()
            err = r.int16()
            if err not in (wire.NONE, wire.TOPIC_ALREADY_EXISTS):
                raise RuntimeError(f"create_topic {name}: error {err}")

    async def delete_topic(self, name: str) -> None:
        w = wire.Writer()
        w.array([name], lambda w, t: w.string(t))
        w.int32(30_000)
        r = await self._bootstrap.call(wire.DELETE_TOPICS, w.build())
        for _ in range(r.int32()):
            r.string()
            r.int16()  # best-effort


# ---------------------------------------------------------------------------
# SPI implementations
# ---------------------------------------------------------------------------


def _to_consumed(topic: str, partition: int, rec: wire.WireRecord) -> ConsumedRecord:
    value: Any = None
    key: Any = None
    value_schema = key_schema = None
    headers: list[Header] = []
    for k, v in rec.headers:
        if k == _AVRO_VALUE_SCHEMA_HEADER:
            value_schema = v
        elif k == _AVRO_KEY_SCHEMA_HEADER:
            key_schema = v
        else:
            headers.append(Header(k, _decode_datum(v)))
    if value_schema is not None or key_schema is not None:
        from langstream_tpu_torch.api.avro import AvroValue, decode

        if value_schema is not None and rec.value is not None:
            schema = _schema_from_header(value_schema)
            value = AvroValue(schema, decode(schema, rec.value))
        else:
            value = _decode_datum(rec.value)
        if key_schema is not None and rec.key is not None:
            schema = _schema_from_header(key_schema)
            key = AvroValue(schema, decode(schema, rec.key))
        else:
            key = _decode_datum(rec.key)
    else:
        value = _decode_datum(rec.value)
        key = _decode_datum(rec.key)
    return ConsumedRecord(
        value=value,
        key=key,
        headers=tuple(headers),
        origin=topic,
        timestamp=rec.timestamp_ms / 1000.0,
        partition=partition,
        offset=rec.offset,
    )


def _to_wire(record: Record) -> wire.WireRecord:
    from langstream_tpu_torch.api.avro import AvroValue

    headers = [(h.key, _encode_datum(h.value)) for h in record.headers]
    if isinstance(record.value, AvroValue):
        headers.append(
            (_AVRO_VALUE_SCHEMA_HEADER, record.value.schema.canonical().encode())
        )
    if isinstance(record.key, AvroValue):
        headers.append(
            (_AVRO_KEY_SCHEMA_HEADER, record.key.schema.canonical().encode())
        )
    return wire.WireRecord(
        key=_encode_datum(record.key),
        value=_encode_datum(record.value),
        # None header values stay null on the wire (varint -1) so they
        # round-trip identically to the memory transport
        headers=headers,
        timestamp_ms=int((record.timestamp or time.time()) * 1000),
    )


class KafkaGroupMembership:
    """Dynamic consumer-group membership: JoinGroup/SyncGroup to obtain a
    partition assignment, background Heartbeat to hold it, rejoin on any
    coordinator signal. This is what splits a topic's partitions across the
    planner's N pod replicas (the reference's #1 parallelism primitive —
    KafkaConsumerWrapper.java:41-115 rebalance listener semantics).

    The elected leader runs Kafka's RangeAssignor client-side (the real
    protocol's design: the broker treats subscriptions/assignments as opaque
    bytes and any member must be able to lead)."""

    def __init__(
        self,
        client: KafkaClient,
        group: str,
        topics: list[str],
        session_timeout: float = 10.0,
    ) -> None:
        self.client = client
        self.group = group
        self.topics = topics
        self.session_timeout = session_timeout
        self.member_id = ""
        self.generation = -1
        self.assignment: dict[str, list[int]] = {}
        self.rejoin_needed = True
        self._hb_task: Optional[asyncio.Task] = None
        self._conn_key = id(self)

    async def ensure_active(self) -> bool:
        """(Re)join if flagged; True when a rejoin happened (the caller must
        rebuild positions from committed offsets)."""
        if not self.rejoin_needed:
            return False
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        await self._join()
        self.rejoin_needed = False
        self._hb_task = asyncio.create_task(self._heartbeat_loop())
        return True

    async def _join(self) -> None:
        session_ms = int(self.session_timeout * 1000)
        rebalance_ms = session_ms * 2
        conn_failures = 0
        while True:
            try:
                conn = await self.client.coordinator_conn(self.group, self._conn_key)
                err, generation, leader, me, roster = await self.client.join_group(
                    conn, self.group, self.member_id, self.topics, session_ms, rebalance_ms
                )
            except (ConnectionError, OSError, EOFError):
                # coordinator moved or dropped: re-resolve and retry
                self.client.invalidate_coordinator(self.group)
                conn_failures += 1
                if conn_failures >= 5:
                    raise
                await asyncio.sleep(0.1 * conn_failures)
                continue
            if err == wire.UNKNOWN_MEMBER_ID:
                self.member_id = ""
                continue
            if err == wire.REBALANCE_IN_PROGRESS:
                await asyncio.sleep(0.05)
                continue
            if err != wire.NONE:
                raise RuntimeError(f"join_group({self.group}): error {err}")
            self.member_id = me
            assignments: list[tuple[str, bytes]] = []
            if me == leader:
                subs = [(mid, wire.decode_subscription(meta)) for mid, meta in roster]
                all_topics = sorted({t for _, ts in subs for t in ts})
                meta = await self.client.metadata(all_topics)
                parts = {t: meta.get(t, []) for t in all_topics}
                plan = wire.range_assign(subs, parts)
                assignments = [
                    (mid, wire.encode_assignment(a)) for mid, a in plan.items()
                ]
            err2, data = await self.client.sync_group(
                conn, self.group, generation, me, assignments
            )
            if err2 == wire.REBALANCE_IN_PROGRESS:
                continue
            if err2 in (wire.UNKNOWN_MEMBER_ID, wire.ILLEGAL_GENERATION):
                self.member_id = ""
                continue
            if err2 != wire.NONE:
                raise RuntimeError(f"sync_group({self.group}): error {err2}")
            self.generation = generation
            self.assignment = wire.decode_assignment(data) if data else {}
            return

    async def _heartbeat_loop(self) -> None:
        interval = max(self.session_timeout / 3.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                conn = await self.client.coordinator_conn(self.group, self._conn_key)
                err = await self.client.heartbeat(
                    conn, self.group, self.generation, self.member_id
                )
            except Exception:  # noqa: BLE001 — coordinator gone: rejoin
                self.client.invalidate_coordinator(self.group)
                self.rejoin_needed = True
                return
            if err != wire.NONE:
                self.rejoin_needed = True
                return

    async def close(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        if self.member_id:
            try:
                conn = await self.client.coordinator_conn(self.group, self._conn_key)
                await self.client.leave_group(conn, self.group, self.member_id)
            except Exception:  # noqa: BLE001 — best-effort goodbye
                pass
        await self.client.release_fetch_conns(self._conn_key)


class KafkaTopicConsumer(TopicConsumer):
    def __init__(
        self,
        client: KafkaClient,
        topic: str,
        group: str,
        poll_timeout: float = 0.1,
        max_records: int = 100,
        partitions: Optional[list[int]] = None,
        session_timeout: float = 10.0,
    ) -> None:
        self.client = client
        self.topic_name = topic
        self.group = group
        self.poll_timeout = poll_timeout
        self.max_records = max_records
        self._explicit_partitions = partitions
        self._membership: Optional[KafkaGroupMembership] = None
        self._session_timeout = session_timeout
        self._assigned: list[int] = []
        self._fetch_pos: dict[int, int] = {}
        self._trackers: dict[int, OffsetTracker] = {}
        self._committed: dict[int, int] = {}
        self._total_out = 0
        self._rr_start = -1

    async def start(self) -> None:
        await self.client.ensure_topic(self.topic_name)
        if self._explicit_partitions is not None:
            # static assignment (operator-pinned slice): offsets only, no
            # group membership — Kafka's "simple consumer" mode
            self._reset_positions(
                self._explicit_partitions,
                await self.client.offset_fetch(
                    self.group, self.topic_name, self._explicit_partitions
                ),
            )
            return
        self._membership = KafkaGroupMembership(
            self.client,
            self.group,
            [self.topic_name],
            session_timeout=self._session_timeout,
        )
        await self._reassign()

    def _reset_positions(self, partitions: list[int], committed: dict[int, int]) -> None:
        self._assigned = sorted(partitions)
        self._fetch_pos.clear()
        self._trackers.clear()
        self._committed.clear()
        for p in self._assigned:
            start = max(committed.get(p, 0), 0)  # -1 = no committed offset
            self._fetch_pos[p] = start
            self._trackers[p] = OffsetTracker(start)
            self._committed[p] = start

    async def _reassign(self) -> None:
        assert self._membership is not None
        try:
            await self._membership.ensure_active()
            partitions = self._membership.assignment.get(self.topic_name, [])
            self._reset_positions(
                partitions,
                await self.client.offset_fetch(self.group, self.topic_name, partitions),
            )
        except BaseException:
            # positions were NOT rebuilt: without this flag the consumer
            # would keep fetching its pre-rebalance partitions under a valid
            # new generation — double consumption with unfenced commits
            self._membership.rejoin_needed = True
            raise

    async def close(self) -> None:
        # command connections are owned by the runtime's shared client;
        # this consumer's dedicated fetch sockets close with it
        if self._membership is not None:
            await self._membership.close()
        await self.client.release_fetch_conns(id(self))

    async def read(self) -> list[Record]:
        if self._membership is not None and self._membership.rejoin_needed:
            await self._reassign()
        if not self._assigned:
            # every partition is owned by other group members right now
            await asyncio.sleep(self.poll_timeout)
            return []
        try:
            got = await self.client.fetch(
                {(self.topic_name, p): self._fetch_pos[p] for p in self._assigned},
                max_wait_ms=int(self.poll_timeout * 1000),
                conn_key=id(self),
            )
        except OffsetOutOfRange as e:
            # retention truncated past our position: reset to earliest (the
            # standard auto.offset.reset recovery) and poll again next loop
            earliest = await self.client.list_offsets(
                e.topic, e.partition, wire.EARLIEST_TIMESTAMP
            )
            self._fetch_pos[e.partition] = earliest
            self._trackers[e.partition] = OffsetTracker(earliest)
            self._committed[e.partition] = earliest
            return []
        # rotate the partition start each read so a hot partition can't
        # starve the others under the max_records cap
        self._rr_start = (self._rr_start + 1) % max(len(self._assigned), 1)
        order = self._assigned[self._rr_start :] + self._assigned[: self._rr_start]
        out: list[Record] = []
        for partition in order:
            for rec in got.get((self.topic_name, partition), ()):
                if len(out) >= self.max_records:
                    break
                out.append(_to_consumed(self.topic_name, partition, rec))
                self._fetch_pos[partition] = rec.offset + 1
        self._total_out += len(out)
        return out

    async def commit(self, records: list[Record]) -> None:
        """Contiguous-prefix commit (KafkaConsumerWrapper.commit:159-190):
        out-of-order acks park in the tracker; only the prefix commits.
        Acks for partitions revoked by a rebalance are dropped — the new
        owner refetches from the last committed offset (at-least-once)."""
        to_commit: dict[int, int] = {}
        for r in records:
            if not isinstance(r, ConsumedRecord):
                continue
            tracker = self._trackers.get(r.partition)
            if tracker is None:
                if self._membership is not None:
                    continue  # revoked partition: let the new owner redeliver
                tracker = OffsetTracker(0)
                self._trackers[r.partition] = tracker
            new_committed = tracker.ack(r.offset)
            if new_committed != self._committed.get(r.partition):
                to_commit[r.partition] = new_committed
        if not to_commit:
            return
        generation, member = -1, ""
        if self._membership is not None:
            generation = self._membership.generation
            member = self._membership.member_id
        try:
            await self.client.offset_commit(
                self.group, self.topic_name, to_commit, generation, member
            )
        except CommitFenced:
            if self._membership is None:
                raise
            self._membership.rejoin_needed = True
            return
        self._committed.update(to_commit)

    def get_info(self) -> dict[str, Any]:
        return {
            "topic": self.topic_name,
            "group": self.group,
            "assigned-partitions": list(self._assigned),
            "committed": {str(p): self._committed.get(p, 0) for p in self._assigned},
        }

    @property
    def total_out(self) -> int:
        return self._total_out


class KafkaTopicProducer(TopicProducer):
    def __init__(self, client: KafkaClient, topic: str) -> None:
        self.client = client
        self.topic_name = topic
        self._partitions: Optional[list[int]] = None
        self._rr = 0
        self._total_in = 0

    async def start(self) -> None:
        self._partitions = await self.client.ensure_topic(self.topic_name)

    async def write(self, record: Record) -> None:
        if self._partitions is None:
            await self.start()
        assert self._partitions is not None
        n = len(self._partitions)
        if record.key is not None:
            # murmur2 (Kafka's DefaultPartitioner), NOT the platform FNV
            # hash: keyed records must co-partition with Java/librdkafka
            # producers sharing the topic
            key_bytes = _encode_datum(record.key) or b""
            part = self._partitions[wire.murmur2_partition(key_bytes, n)]
        else:
            part = self._partitions[self._rr % n]
            self._rr += 1
        await self.client.produce(self.topic_name, part, [_to_wire(record)])
        self._total_in += 1

    @property
    def total_in(self) -> int:
        return self._total_in


class KafkaTopicReader(TopicReader):
    """Offset-addressed reader (gateway consume path — no group)."""

    def __init__(
        self,
        client: KafkaClient,
        topic: str,
        initial: TopicOffsetPosition,
        poll_timeout: float = 0.1,
    ) -> None:
        self.client = client
        self.topic_name = topic
        self.initial = initial
        self.poll_timeout = poll_timeout
        self._pos: dict[int, int] = {}

    async def close(self) -> None:
        await self.client.release_fetch_conns(id(self))

    async def start(self) -> None:
        for p in await self.client.ensure_topic(self.topic_name):
            if self.initial.position == TopicOffsetPosition.EARLIEST:
                self._pos[p] = await self.client.list_offsets(
                    self.topic_name, p, wire.EARLIEST_TIMESTAMP
                )
            elif self.initial.position == "absolute":
                self._pos[p] = self.initial.offsets.get(p, 0)
            else:
                self._pos[p] = await self.client.list_offsets(
                    self.topic_name, p, wire.LATEST_TIMESTAMP
                )

    async def read(self) -> TopicReadResult:
        try:
            got = await self.client.fetch(
                {(self.topic_name, p): pos for p, pos in self._pos.items()},
                max_wait_ms=int(self.poll_timeout * 1000),
                conn_key=id(self),
            )
        except OffsetOutOfRange as e:
            self._pos[e.partition] = await self.client.list_offsets(
                e.topic, e.partition, wire.EARLIEST_TIMESTAMP
            )
            return TopicReadResult([], dict(self._pos), record_offsets=[])
        out: list[Record] = []
        offsets: list[dict[int, int]] = []
        for (topic, partition), recs in sorted(got.items()):
            for rec in recs:
                out.append(_to_consumed(topic, partition, rec))
                self._pos[partition] = rec.offset + 1
                offsets.append(dict(self._pos))
        return TopicReadResult(out, dict(self._pos), record_offsets=offsets)


class KafkaTopicAdmin(TopicAdmin):
    def __init__(self, client: KafkaClient) -> None:
        self.client = client

    async def create_topic(
        self, name: str, partitions: int = 1, options: Optional[dict] = None
    ) -> None:
        await self.client.create_topic(name, max(partitions, 1))

    async def delete_topic(self, name: str) -> None:
        await self.client.delete_topic(name)

    async def topic_exists(self, name: str) -> bool:
        meta = await self.client.metadata([name])
        return name in meta


class KafkaTopicConnectionsRuntime(TopicConnectionsRuntime):
    def __init__(self) -> None:
        self._bootstrap = "localhost:9092"
        self._consumer_defaults: dict[str, Any] = {}
        self._client: Optional[KafkaClient] = None

    async def init(self, streaming_cluster_config: dict[str, Any]) -> None:
        admin = streaming_cluster_config.get("admin", {})
        self._bootstrap = admin.get("bootstrap.servers", self._bootstrap)
        # streamingCluster.configuration.consumer: defaults merged under
        # every create_consumer config (reference's consumer config block)
        self._consumer_defaults = dict(streaming_cluster_config.get("consumer", {}))

    def client(self) -> KafkaClient:
        if self._client is None:
            self._client = KafkaClient(self._bootstrap)
        return self._client

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None

    def create_consumer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicConsumer:
        config = {**self._consumer_defaults, **(config or {})}
        return KafkaTopicConsumer(
            self.client(),
            topic,
            group=config.get("group", agent_id),
            poll_timeout=float(config.get("poll-timeout", 0.1)),
            max_records=int(config.get("max-records", 100)),
            partitions=config.get("partitions"),
            session_timeout=float(config.get("session-timeout", 10.0)),
        )

    def create_producer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicProducer:
        return KafkaTopicProducer(self.client(), topic)

    def create_reader(
        self,
        topic: str,
        initial_position: TopicOffsetPosition = TopicOffsetPosition(),
        config: Optional[dict[str, Any]] = None,
    ) -> TopicReader:
        return KafkaTopicReader(self.client(), topic, initial_position)

    def create_topic_admin(self) -> TopicAdmin:
        return KafkaTopicAdmin(self.client())
