"""Pravega segment-store wire codec (WireCommands subset).

Parity: reference ``langstream-pravega-runtime`` delegates everything to the
official ``io.pravega`` client; this repo speaks the segment store's TCP
protocol directly, the same dependency-free approach as ``kafka_protocol``
/ ``pulsar_protocol``.

Framing (the Netty CommandEncoder convention): every message is

    [type  int32][length int32][payload ...]

with big-endian integers; payload fields follow Java ``DataOutput``
conventions — ``writeUTF`` strings (uint16 length + modified-UTF8 bytes,
plain UTF-8 here), int32/int64 big-endian, UUIDs as two int64s, byte
blocks length-prefixed with int32.

HONESTY NOTE (docs/COMPAT_RUNBOOK.md): the command *type codes and field
layouts* below are this repo's reconstruction of Pravega's WireCommands —
the conversation shapes (SetupAppend→AppendSetup, AppendBlockEnd→
DataAppended, ReadSegment→SegmentRead, …) follow the public protocol
documentation, but byte-level conformance against a real segment store is
unverified in this no-egress image. Both the client (pravega.py) and the
fake (pravega_fake.py) are built on THIS codec, so a future capture from a
real cluster can falsify it frame by frame.
"""

from __future__ import annotations

import struct
import uuid
from dataclasses import dataclass
from typing import Any, Optional

# command type codes (reconstructed WireCommandType enum subset)
HELLO = -127
WRONG_HOST = 0
SETUP_APPEND = 1
APPEND_SETUP = 2
APPEND_BLOCK_END = 4
DATA_APPENDED = 7
SEGMENT_IS_SEALED = 8
NO_SUCH_SEGMENT = 10
READ_SEGMENT = 22
SEGMENT_READ = 23
GET_STREAM_SEGMENT_INFO = 24
STREAM_SEGMENT_INFO = 25
CREATE_SEGMENT = 20
SEGMENT_CREATED = 21
DELETE_SEGMENT = 26
SEGMENT_DELETED = 27
SEAL_SEGMENT = 28
SEGMENT_SEALED = 29
TRUNCATE_SEGMENT = 30
SEGMENT_TRUNCATED = 31
KEEP_ALIVE = 100
ERROR_MESSAGE = -1

# the per-event header type code inside an append block / segment bytes
EVENT_TYPE_CODE = 0

WIRE_VERSION = 15  # protocol version advertised in HELLO
OLDEST_COMPATIBLE = 5


class Writer:
    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def int32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">i", v))
        return self

    def int64(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">q", v))
        return self

    def bool_(self, v: bool) -> "Writer":
        self._parts.append(b"\x01" if v else b"\x00")
        return self

    def utf(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        self._parts.append(struct.pack(">H", len(b)) + b)
        return self

    def uuid(self, u: uuid.UUID) -> "Writer":
        # two signed int64s (msb, lsb) — the Java UUID wire convention
        msb = (u.int >> 64) & 0xFFFFFFFFFFFFFFFF
        lsb = u.int & 0xFFFFFFFFFFFFFFFF
        self._parts.append(struct.pack(
            ">qq",
            msb - (1 << 64) if msb >= (1 << 63) else msb,
            lsb - (1 << 64) if lsb >= (1 << 63) else lsb,
        ))
        return self

    def block(self, b: bytes) -> "Writer":
        self._parts.append(struct.pack(">i", len(b)) + b)
        return self

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes) -> None:
        self._d = data
        self._o = 0

    def int32(self) -> int:
        (v,) = struct.unpack_from(">i", self._d, self._o)
        self._o += 4
        return v

    def int64(self) -> int:
        (v,) = struct.unpack_from(">q", self._d, self._o)
        self._o += 8
        return v

    def bool_(self) -> bool:
        v = self._d[self._o] != 0
        self._o += 1
        return v

    def utf(self) -> str:
        (n,) = struct.unpack_from(">H", self._d, self._o)
        self._o += 2
        s = self._d[self._o : self._o + n].decode("utf-8")
        self._o += n
        return s

    def uuid(self) -> uuid.UUID:
        msb, lsb = struct.unpack_from(">qq", self._d, self._o)
        self._o += 16
        return uuid.UUID(int=((msb & 0xFFFFFFFFFFFFFFFF) << 64) | (lsb & 0xFFFFFFFFFFFFFFFF))

    def block(self) -> bytes:
        n = self.int32()
        b = self._d[self._o : self._o + n]
        self._o += n
        return b

    def rest(self) -> bytes:
        return self._d[self._o :]

    def remaining(self) -> int:
        return len(self._d) - self._o


def frame(type_: int, payload: bytes) -> bytes:
    return struct.pack(">ii", type_, len(payload)) + payload


def parse_frame_header(header: bytes) -> tuple[int, int]:
    """(type, payload length) from the 8-byte frame header."""
    return struct.unpack(">ii", header)


# -- command payload builders/parsers ---------------------------------------
# Each command is (type, dict) at the API boundary; codecs below.


def encode(command: str, f: dict[str, Any]) -> bytes:
    w = Writer()
    if command == "hello":
        return frame(HELLO, w.int32(f.get("high", WIRE_VERSION)).int32(f.get("low", OLDEST_COMPATIBLE)).build())
    if command == "setup_append":
        w.int64(f["request_id"]).uuid(f["writer_id"]).utf(f["segment"]).utf(f.get("token", ""))
        return frame(SETUP_APPEND, w.build())
    if command == "append_setup":
        w.int64(f["request_id"]).utf(f["segment"]).uuid(f["writer_id"]).int64(f["last_event_number"])
        return frame(APPEND_SETUP, w.build())
    if command == "append_block_end":
        w.uuid(f["writer_id"]).int32(f["size_of_whole_events"])
        w.block(f["data"]).int32(f["num_events"]).int64(f["last_event_number"]).int64(f["request_id"])
        return frame(APPEND_BLOCK_END, w.build())
    if command == "data_appended":
        w.uuid(f["writer_id"]).int64(f["event_number"]).int64(f.get("previous_event_number", -1)).int64(f["request_id"])
        return frame(DATA_APPENDED, w.build())
    if command == "create_segment":
        w.int64(f["request_id"]).utf(f["segment"]).int32(f.get("scale_type", 0)).int32(f.get("target_rate", 0)).utf(f.get("token", ""))
        return frame(CREATE_SEGMENT, w.build())
    if command == "segment_created":
        w.int64(f["request_id"]).utf(f["segment"])
        return frame(SEGMENT_CREATED, w.build())
    if command == "read_segment":
        w.utf(f["segment"]).int64(f["offset"]).int32(f["suggested_length"]).utf(f.get("token", "")).int64(f["request_id"])
        return frame(READ_SEGMENT, w.build())
    if command == "segment_read":
        w.utf(f["segment"]).int64(f["offset"]).bool_(f.get("at_tail", False)).bool_(f.get("end_of_segment", False))
        w.block(f["data"]).int64(f["request_id"])
        return frame(SEGMENT_READ, w.build())
    if command == "get_stream_segment_info":
        w.int64(f["request_id"]).utf(f["segment"]).utf(f.get("token", ""))
        return frame(GET_STREAM_SEGMENT_INFO, w.build())
    if command == "stream_segment_info":
        w.int64(f["request_id"]).utf(f["segment"]).bool_(f.get("exists", True)).bool_(f.get("sealed", False))
        w.int64(f.get("write_offset", 0)).int64(f.get("start_offset", 0))
        return frame(STREAM_SEGMENT_INFO, w.build())
    if command == "delete_segment":
        w.int64(f["request_id"]).utf(f["segment"]).utf(f.get("token", ""))
        return frame(DELETE_SEGMENT, w.build())
    if command == "segment_deleted":
        w.int64(f["request_id"]).utf(f["segment"])
        return frame(SEGMENT_DELETED, w.build())
    if command == "seal_segment":
        w.int64(f["request_id"]).utf(f["segment"]).utf(f.get("token", ""))
        return frame(SEAL_SEGMENT, w.build())
    if command == "truncate_segment":
        w.int64(f["request_id"]).utf(f["segment"]).int64(f["offset"]).utf(f.get("token", ""))
        return frame(TRUNCATE_SEGMENT, w.build())
    if command == "segment_truncated":
        w.int64(f["request_id"]).utf(f["segment"])
        return frame(SEGMENT_TRUNCATED, w.build())
    if command == "segment_sealed":
        w.int64(f["request_id"]).utf(f["segment"])
        return frame(SEGMENT_SEALED, w.build())
    if command == "no_such_segment":
        w.int64(f["request_id"]).utf(f["segment"])
        return frame(NO_SUCH_SEGMENT, w.build())
    if command == "keep_alive":
        return frame(KEEP_ALIVE, b"")
    if command == "error_message":
        w.int64(f.get("request_id", -1)).utf(f.get("message", ""))
        return frame(ERROR_MESSAGE, w.build())
    raise ValueError(f"unknown pravega command {command!r}")


def decode(type_: int, payload: bytes) -> tuple[str, dict[str, Any]]:
    r = Reader(payload)
    if type_ == HELLO:
        return "hello", {"high": r.int32(), "low": r.int32()}
    if type_ == SETUP_APPEND:
        return "setup_append", {
            "request_id": r.int64(), "writer_id": r.uuid(),
            "segment": r.utf(), "token": r.utf(),
        }
    if type_ == APPEND_SETUP:
        return "append_setup", {
            "request_id": r.int64(), "segment": r.utf(),
            "writer_id": r.uuid(), "last_event_number": r.int64(),
        }
    if type_ == APPEND_BLOCK_END:
        return "append_block_end", {
            "writer_id": r.uuid(), "size_of_whole_events": r.int32(),
            "data": r.block(), "num_events": r.int32(),
            "last_event_number": r.int64(), "request_id": r.int64(),
        }
    if type_ == DATA_APPENDED:
        return "data_appended", {
            "writer_id": r.uuid(), "event_number": r.int64(),
            "previous_event_number": r.int64(), "request_id": r.int64(),
        }
    if type_ == CREATE_SEGMENT:
        return "create_segment", {
            "request_id": r.int64(), "segment": r.utf(),
            "scale_type": r.int32(), "target_rate": r.int32(), "token": r.utf(),
        }
    if type_ == SEGMENT_CREATED:
        return "segment_created", {"request_id": r.int64(), "segment": r.utf()}
    if type_ == READ_SEGMENT:
        return "read_segment", {
            "segment": r.utf(), "offset": r.int64(),
            "suggested_length": r.int32(), "token": r.utf(),
            "request_id": r.int64(),
        }
    if type_ == SEGMENT_READ:
        return "segment_read", {
            "segment": r.utf(), "offset": r.int64(), "at_tail": r.bool_(),
            "end_of_segment": r.bool_(), "data": r.block(),
            "request_id": r.int64(),
        }
    if type_ == GET_STREAM_SEGMENT_INFO:
        return "get_stream_segment_info", {
            "request_id": r.int64(), "segment": r.utf(), "token": r.utf(),
        }
    if type_ == STREAM_SEGMENT_INFO:
        return "stream_segment_info", {
            "request_id": r.int64(), "segment": r.utf(), "exists": r.bool_(),
            "sealed": r.bool_(), "write_offset": r.int64(),
            "start_offset": r.int64(),
        }
    if type_ == DELETE_SEGMENT:
        return "delete_segment", {
            "request_id": r.int64(), "segment": r.utf(), "token": r.utf(),
        }
    if type_ == SEGMENT_DELETED:
        return "segment_deleted", {"request_id": r.int64(), "segment": r.utf()}
    if type_ == SEAL_SEGMENT:
        return "seal_segment", {
            "request_id": r.int64(), "segment": r.utf(), "token": r.utf(),
        }
    if type_ == TRUNCATE_SEGMENT:
        return "truncate_segment", {
            "request_id": r.int64(), "segment": r.utf(), "offset": r.int64(),
            "token": r.utf(),
        }
    if type_ == SEGMENT_TRUNCATED:
        return "segment_truncated", {"request_id": r.int64(), "segment": r.utf()}
    if type_ == SEGMENT_SEALED:
        return "segment_sealed", {"request_id": r.int64(), "segment": r.utf()}
    if type_ == NO_SUCH_SEGMENT:
        return "no_such_segment", {"request_id": r.int64(), "segment": r.utf()}
    if type_ == KEEP_ALIVE:
        return "keep_alive", {}
    if type_ == ERROR_MESSAGE:
        return "error_message", {"request_id": r.int64(), "message": r.utf()}
    raise ValueError(f"unknown pravega command type {type_}")


# -- event framing -----------------------------------------------------------
# Events inside append blocks AND inside segment bytes carry an 8-byte
# header: [typeCode int32 = 0][length int32][serialized event].


def frame_event(data: bytes) -> bytes:
    return struct.pack(">ii", EVENT_TYPE_CODE, len(data)) + data


def iter_events(data: bytes, base_offset: int = 0):
    """Yield (absolute_offset, event_bytes) for each WHOLE event in ``data``;
    a truncated tail (mid-event read cut) is ignored — the next read resumes
    at its offset."""
    o = 0
    n = len(data)
    while o + 8 <= n:
        type_, length = struct.unpack_from(">ii", data, o)
        if type_ != EVENT_TYPE_CODE:
            raise ValueError(f"corrupt event stream at offset {base_offset + o}")
        if o + 8 + length > n:
            break
        yield base_offset + o, data[o + 8 : o + 8 + length]
        o += 8 + length


@dataclass
class SegmentName:
    """scope/stream/<segment-number>.#epoch.<epoch>"""

    scope: str
    stream: str
    number: int
    epoch: int = 0

    @property
    def qualified(self) -> str:
        return f"{self.scope}/{self.stream}/{self.number}.#epoch.{self.epoch}"

    @staticmethod
    def parse(qualified: str) -> "SegmentName":
        scope, stream, tail = qualified.split("/", 2)
        num_part, _, epoch = tail.partition(".#epoch.")
        return SegmentName(scope, stream, int(num_part), int(epoch or 0))


def routing_key_segment(key: Optional[str], num_segments: int) -> int:
    """Routing key → segment: uniform hash onto [0, 1) then the fixed
    segment ranges [i/N, (i+1)/N). Reconstruction of the client's
    HashHelper.hashToRange (sha-256 based here; the real client uses a
    seeded murmur — byte-level parity pending a capture, but the CONTRACT
    — same key always lands on the same segment — holds)."""
    if key is None or num_segments <= 1:
        return 0
    import hashlib

    h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")
    return int((h / float(1 << 64)) * num_segments)
