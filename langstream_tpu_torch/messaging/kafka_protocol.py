"""Kafka wire protocol: dependency-free binary codec over the documented
protocol (kafka.apache.org/protocol).

Implements the fixed, pre-flexible API versions the runtime needs — enough
for a full data plane (produce / fetch / offsets / coordinator / admin)
against a real broker or the protocol-level fake in ``kafka_fake.py``:

  Produce v3, Fetch v4, ListOffsets v1, Metadata v1, OffsetCommit v2,
  OffsetFetch v1, FindCoordinator v1, CreateTopics v0, DeleteTopics v0

plus the record batch v2 format (varint records, CRC32C).

Parity: replaces the reference's Java kafka-clients dependency
(`langstream-kafka-runtime/`); the SEMANTICS the runtime layers on top
(contiguous-prefix commit, KafkaConsumerWrapper.java:41-190) live in
``kafka.py``, not here. This module is deliberately a pure codec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

# api keys
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2
METADATA = 3
OFFSET_COMMIT = 8
OFFSET_FETCH = 9
FIND_COORDINATOR = 10
JOIN_GROUP = 11
HEARTBEAT = 12
LEAVE_GROUP = 13
SYNC_GROUP = 14
CREATE_TOPICS = 19
DELETE_TOPICS = 20

API_VERSIONS = {
    PRODUCE: 3,
    FETCH: 4,
    LIST_OFFSETS: 1,
    METADATA: 1,
    OFFSET_COMMIT: 2,
    OFFSET_FETCH: 1,
    FIND_COORDINATOR: 1,
    JOIN_GROUP: 2,  # v2: adds rebalance_timeout, pre-flexible
    HEARTBEAT: 1,
    LEAVE_GROUP: 1,
    SYNC_GROUP: 1,
    CREATE_TOPICS: 0,
    DELETE_TOPICS: 0,
}

# error codes (subset)
NONE = 0
UNKNOWN_TOPIC_OR_PARTITION = 3
OFFSET_OUT_OF_RANGE = 1
NOT_LEADER_FOR_PARTITION = 6
REPLICA_NOT_AVAILABLE = 9
ILLEGAL_GENERATION = 22
UNKNOWN_MEMBER_ID = 25
REBALANCE_IN_PROGRESS = 27
TOPIC_ALREADY_EXISTS = 36

# fetch errors the Java client silently retries after a metadata refresh
# (routine leader movement during broker restart/failover)
RETRIABLE_FETCH_ERRORS = frozenset(
    {NOT_LEADER_FOR_PARTITION, REPLICA_NOT_AVAILABLE, UNKNOWN_TOPIC_OR_PARTITION}
)

EARLIEST_TIMESTAMP = -2
LATEST_TIMESTAMP = -1


# CRC32C (Castagnoli) — record batch v2 checksum; C++ on the produce hot
# path with a pure-Python fallback (langstream_tpu_torch.native)
from langstream_tpu_torch.native import crc32c  # noqa: E402


# ---------------------------------------------------------------------------
# Primitive codec
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def int8(self, v: int) -> "Writer":
        return self.raw(struct.pack(">b", v))

    def int16(self, v: int) -> "Writer":
        return self.raw(struct.pack(">h", v))

    def int32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">i", v))

    def int64(self, v: int) -> "Writer":
        return self.raw(struct.pack(">q", v))

    def uint32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">I", v))

    def boolean(self, v: bool) -> "Writer":
        return self.int8(1 if v else 0)

    def string(self, s: Optional[str]) -> "Writer":
        if s is None:
            return self.int16(-1)
        b = s.encode()
        return self.int16(len(b)).raw(b)

    def bytes_(self, b: Optional[bytes]) -> "Writer":
        if b is None:
            return self.int32(-1)
        return self.int32(len(b)).raw(b)

    def array(self, items, encode) -> "Writer":
        if items is None:
            return self.int32(-1)
        self.int32(len(items))
        for item in items:
            encode(self, item)
        return self

    def varint(self, v: int) -> "Writer":
        # zigzag
        return self.uvarint((v << 1) ^ (v >> 31))

    def varlong(self, v: int) -> "Writer":
        return self.uvarint((v << 1) ^ (v >> 63))

    def uvarint(self, v: int) -> "Writer":
        out = bytearray()
        v &= 0xFFFFFFFFFFFFFFFF
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        return self.raw(bytes(out))

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def raw(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError(f"need {n} bytes at {self.pos}, have {len(out)}")
        self.pos += n
        return out

    def int8(self) -> int:
        return struct.unpack(">b", self.raw(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self.raw(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self.raw(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self.raw(8))[0]

    def uint32(self) -> int:
        return struct.unpack(">I", self.raw(4))[0]

    def boolean(self) -> bool:
        return self.int8() != 0

    def string(self) -> Optional[str]:
        n = self.int16()
        if n < 0:
            return None
        return self.raw(n).decode()

    def bytes_(self) -> Optional[bytes]:
        n = self.int32()
        if n < 0:
            return None
        return self.raw(n)

    def array(self, decode) -> list:
        n = self.int32()
        if n < 0:
            return []
        return [decode(self) for _ in range(n)]

    def uvarint(self) -> int:
        shift = 0
        out = 0
        while True:
            b = self.raw(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def varint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    varlong = varint

    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------------------
# Record batch v2
# ---------------------------------------------------------------------------


@dataclass
class WireRecord:
    key: Optional[bytes]
    value: Optional[bytes]
    headers: list[tuple[str, bytes]] = field(default_factory=list)
    timestamp_ms: int = 0
    offset: int = 0  # absolute, filled on decode / assigned by broker


def encode_record_batch(records: list[WireRecord], base_offset: int = 0) -> bytes:
    """One record batch v2 (magic=2) containing ``records``."""
    base_ts = records[0].timestamp_ms if records else 0
    max_ts = max((r.timestamp_ms for r in records), default=0)

    body = Writer()
    body.int16(0)  # attributes: no compression, no transaction
    body.int32(len(records) - 1)  # lastOffsetDelta
    body.int64(base_ts)
    body.int64(max_ts)
    body.int64(-1)  # producerId
    body.int16(-1)  # producerEpoch
    body.int32(-1)  # baseSequence
    body.int32(len(records))
    for i, rec in enumerate(records):
        r = Writer()
        r.int8(0)  # record attributes
        r.varlong(rec.timestamp_ms - base_ts)
        r.varint(i)  # offsetDelta
        if rec.key is None:
            r.varint(-1)
        else:
            r.varint(len(rec.key)).raw(rec.key)
        if rec.value is None:
            r.varint(-1)
        else:
            r.varint(len(rec.value)).raw(rec.value)
        r.varint(len(rec.headers))
        for hk, hv in rec.headers:
            kb = hk.encode()
            r.varint(len(kb)).raw(kb)
            if hv is None:
                r.varint(-1)
            else:
                r.varint(len(hv)).raw(hv)
        rb = r.build()
        body.varint(len(rb)).raw(rb)
    payload = body.build()

    out = Writer()
    out.int64(base_offset)
    out.int32(4 + 1 + 4 + len(payload))  # partitionLeaderEpoch..end
    out.int32(-1)  # partitionLeaderEpoch
    out.int8(2)  # magic
    out.uint32(crc32c(payload))
    out.raw(payload)
    return out.build()


def decode_record_batches(data: bytes) -> list[WireRecord]:
    """Decode a (possibly partial) sequence of record batches; a trailing
    truncated batch (broker may cut at max_bytes) is ignored."""
    out: list[WireRecord] = []
    r = Reader(data)
    while r.remaining() >= 12:
        base_offset = r.int64()
        length = r.int32()
        if r.remaining() < length:
            break  # truncated tail
        batch = Reader(r.raw(length))
        batch.int32()  # partitionLeaderEpoch
        magic = batch.int8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        batch.uint32()  # crc — trusted (TCP checksums; fake broker is local)
        attributes = batch.int16()
        if attributes & 0x07:
            raise ValueError("compressed record batches not supported")
        batch.int32()  # lastOffsetDelta
        base_ts = batch.int64()
        batch.int64()  # maxTimestamp
        batch.int64()  # producerId
        batch.int16()  # producerEpoch
        batch.int32()  # baseSequence
        n = batch.int32()
        for _ in range(n):
            rec_len = batch.varint()
            rec = Reader(batch.raw(rec_len))
            rec.int8()  # attributes
            ts_delta = rec.varlong()
            offset_delta = rec.varint()
            klen = rec.varint()
            key = rec.raw(klen) if klen >= 0 else None
            vlen = rec.varint()
            value = rec.raw(vlen) if vlen >= 0 else None
            headers = []
            for _ in range(rec.varint()):
                hklen = rec.varint()
                hk = rec.raw(hklen).decode()
                hvlen = rec.varint()
                hv = rec.raw(hvlen) if hvlen >= 0 else None
                headers.append((hk, hv))
            out.append(
                WireRecord(
                    key=key,
                    value=value,
                    headers=headers,
                    timestamp_ms=base_ts + ts_delta,
                    offset=base_offset + offset_delta,
                )
            )
    return out


# ---------------------------------------------------------------------------
# Consumer protocol (the embedded metadata/assignment format the Java
# "consumer" protocol type exchanges through JoinGroup/SyncGroup — the
# group coordinator treats both as opaque bytes)
# ---------------------------------------------------------------------------


def encode_subscription(topics: list[str]) -> bytes:
    """ConsumerProtocolSubscription v0: version, topics[], user_data."""
    return Writer().int16(0).array(sorted(topics), lambda w, t: w.string(t)).bytes_(None).build()


def decode_subscription(data: bytes) -> list[str]:
    r = Reader(data)
    r.int16()  # version
    return [t for t in r.array(lambda rr: rr.string()) if t is not None]


def encode_assignment(assignment: dict[str, list[int]]) -> bytes:
    """ConsumerProtocolAssignment v0: version, [topic, partitions[]], user_data."""
    w = Writer().int16(0)
    w.array(
        sorted(assignment.items()),
        lambda w, kv: w.string(kv[0]).array(sorted(kv[1]), lambda w2, p: w2.int32(p)),
    )
    return w.bytes_(None).build()


def decode_assignment(data: bytes) -> dict[str, list[int]]:
    r = Reader(data)
    r.int16()  # version
    out: dict[str, list[int]] = {}
    for _ in range(r.int32()):
        topic = r.string() or ""
        out[topic] = r.array(lambda rr: rr.int32())
    return out


def range_assign(
    members: list[tuple[str, list[str]]], partitions: dict[str, list[int]]
) -> dict[str, dict[str, list[int]]]:
    """Kafka's RangeAssignor: per topic, sort subscribed members and hand
    each a contiguous slice; the first ``extra`` members get one more.
    member_id → topic → partition ids."""
    out: dict[str, dict[str, list[int]]] = {m: {} for m, _ in members}
    topics = sorted({t for _, subs in members for t in subs})
    for topic in topics:
        subscribers = sorted(m for m, subs in members if topic in subs)
        parts = sorted(partitions.get(topic, []))
        if not subscribers or not parts:
            continue
        per, extra = divmod(len(parts), len(subscribers))
        pos = 0
        for i, member in enumerate(subscribers):
            n = per + (1 if i < extra else 0)
            if n:
                out[member][topic] = parts[pos : pos + n]
            pos += n
    return out


def murmur2(data: bytes) -> int:
    """Kafka's murmur2 (32-bit, seed 0x9747b28c) — the default partitioner
    hash, so keyed records co-partition with Java/librdkafka producers."""
    length = len(data)
    seed = 0x9747B28C
    m = 0x5BD1E995
    mask = 0xFFFFFFFF
    h = (seed ^ length) & mask
    n = length & ~0x3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * m) & mask
        k ^= k >> 24
        k = (k * m) & mask
        h = (h * m) & mask
        h ^= k
    rem = length & 0x3
    if rem == 3:
        h ^= (data[n + 2] & 0xFF) << 16
    if rem >= 2:
        h ^= (data[n + 1] & 0xFF) << 8
    if rem >= 1:
        h ^= data[n] & 0xFF
        h = (h * m) & mask
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def murmur2_partition(key: bytes, num_partitions: int) -> int:
    """toPositive(murmur2(key)) % numPartitions — DefaultPartitioner."""
    return (murmur2(key) & 0x7FFFFFFF) % num_partitions


# ---------------------------------------------------------------------------
# Request framing
# ---------------------------------------------------------------------------


def encode_request(
    api_key: int, correlation_id: int, client_id: str, payload: bytes
) -> bytes:
    header = (
        Writer()
        .int16(api_key)
        .int16(API_VERSIONS[api_key])
        .int32(correlation_id)
        .string(client_id)
        .build()
    )
    frame = header + payload
    return struct.pack(">i", len(frame)) + frame


def decode_request_header(r: Reader) -> tuple[int, int, int, Optional[str]]:
    """(api_key, api_version, correlation_id, client_id)"""
    return r.int16(), r.int16(), r.int32(), r.string()
