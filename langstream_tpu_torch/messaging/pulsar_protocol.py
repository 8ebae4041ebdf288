"""Pulsar binary wire protocol — stdlib-only codec.

Parity: reference `langstream-pulsar-runtime/` speaks to Pulsar through the
official client; this rebuild speaks the broker's binary protocol directly
(the `kafka_protocol.py` approach). The protocol is protobuf-framed
(`PulsarApi.proto`):

    simple command frame:   [totalSize u32][commandSize u32][BaseCommand]
    payload command frame:  [totalSize u32][commandSize u32][BaseCommand]
                            [magic 0x0e01][crc32c u32]
                            [metadataSize u32][MessageMetadata][payload]

where crc32c covers everything after the checksum field. Only the message
fields this runtime uses are modelled; unknown fields are skipped on decode
(standard protobuf forward-compat), so a real broker's richer responses
parse fine.

The protobuf codec here is generic and schema-driven (field tables below),
NOT generated code — there is no protoc dependency and no .proto files at
runtime.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

# ---------------------------------------------------------------------------
# varint + generic protobuf codec
# ---------------------------------------------------------------------------


def write_varint(n: int) -> bytes:
    out = bytearray()
    if n < 0:
        n &= (1 << 64) - 1  # protobuf negative ints are 10-byte varints
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


# Field spec kinds: "varint" (ints/bools/enums), "string", "bytes",
# ("msg", SCHEMA). A trailing "*" on the name marks a repeated field.
Schema = dict[int, tuple[str, Any]]


def encode_message(schema: Schema, values: dict[str, Any]) -> bytes:
    out = bytearray()
    for field_no, (name, kind) in schema.items():
        repeated = name.endswith("*")
        key = name.rstrip("*")
        if key not in values or values[key] is None:
            continue
        items = values[key] if repeated else [values[key]]
        for item in items:
            if kind == "varint":
                out += write_varint(field_no << 3 | 0)
                out += write_varint(int(item))
            elif kind == "string":
                data = item.encode() if isinstance(item, str) else bytes(item)
                out += write_varint(field_no << 3 | 2)
                out += write_varint(len(data))
                out += data
            elif kind == "bytes":
                out += write_varint(field_no << 3 | 2)
                out += write_varint(len(item))
                out += bytes(item)
            elif isinstance(kind, tuple) and kind[0] == "msg":
                body = encode_message(kind[1], item)
                out += write_varint(field_no << 3 | 2)
                out += write_varint(len(body))
                out += body
            else:  # pragma: no cover - schema bug
                raise TypeError(f"bad field kind {kind!r}")
    return bytes(out)


def decode_message(schema: Schema, buf: bytes) -> dict[str, Any]:
    values: dict[str, Any] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field_no, wire_type = tag >> 3, tag & 7
        spec = schema.get(field_no)
        if wire_type == 0:
            raw, pos = read_varint(buf, pos)
            decoded: Any = raw
        elif wire_type == 2:
            length, pos = read_varint(buf, pos)
            chunk = buf[pos : pos + length]
            pos += length
            if spec is None:
                continue
            kind = spec[1]
            if kind == "string":
                decoded = chunk.decode("utf-8", "replace")
            elif kind == "bytes":
                decoded = chunk
            elif isinstance(kind, tuple) and kind[0] == "msg":
                decoded = decode_message(kind[1], chunk)
            else:
                decoded = chunk
        elif wire_type == 5:  # fixed32 — skip (unused by the modelled fields)
            pos += 4
            continue
        elif wire_type == 1:  # fixed64 — skip
            pos += 8
            continue
        else:  # pragma: no cover - malformed
            raise ValueError(f"unsupported wire type {wire_type}")
        if spec is None:
            continue
        name = spec[0]
        if name.endswith("*"):
            values.setdefault(name.rstrip("*"), []).append(decoded)
        else:
            values[name.rstrip("*")] = decoded
    return values


# ---------------------------------------------------------------------------
# message schemas (field numbers from pulsar's PulsarApi.proto)
# ---------------------------------------------------------------------------

MESSAGE_ID: Schema = {
    1: ("ledger_id", "varint"),
    2: ("entry_id", "varint"),
    3: ("partition", "varint"),
    4: ("batch_index", "varint"),
}

KEY_VALUE: Schema = {1: ("key", "string"), 2: ("value", "string")}
KEY_BYTES_VALUE: Schema = {1: ("key", "string"), 2: ("value", "bytes")}

CONNECT: Schema = {
    1: ("client_version", "string"),
    2: ("auth_method", "varint"),
    3: ("auth_data", "bytes"),
    4: ("protocol_version", "varint"),
    5: ("auth_method_name", "string"),
}
CONNECTED: Schema = {
    1: ("server_version", "string"),
    2: ("protocol_version", "varint"),
    3: ("max_message_size", "varint"),
}
SUBSCRIBE: Schema = {
    1: ("topic", "string"),
    2: ("subscription", "string"),
    3: ("sub_type", "varint"),  # 0 exclusive, 1 shared, 2 failover, 3 key_shared
    4: ("consumer_id", "varint"),
    5: ("request_id", "varint"),
    6: ("consumer_name", "string"),
    8: ("durable", "varint"),
    9: ("start_message_id", ("msg", MESSAGE_ID)),
    13: ("initial_position", "varint"),  # 0 latest, 1 earliest
}
PRODUCER: Schema = {
    1: ("topic", "string"),
    2: ("producer_id", "varint"),
    3: ("request_id", "varint"),
    4: ("producer_name", "string"),
}
SEND: Schema = {
    1: ("producer_id", "varint"),
    2: ("sequence_id", "varint"),
    3: ("num_messages", "varint"),
}
SEND_RECEIPT: Schema = {
    1: ("producer_id", "varint"),
    2: ("sequence_id", "varint"),
    3: ("message_id", ("msg", MESSAGE_ID)),
}
SEND_ERROR: Schema = {
    1: ("producer_id", "varint"),
    2: ("sequence_id", "varint"),
    3: ("error", "varint"),
    4: ("message", "string"),
}
MESSAGE: Schema = {
    1: ("consumer_id", "varint"),
    2: ("message_id", ("msg", MESSAGE_ID)),
    3: ("redelivery_count", "varint"),
}
ACK: Schema = {
    1: ("consumer_id", "varint"),
    2: ("ack_type", "varint"),  # 0 individual, 1 cumulative
    3: ("message_id*", ("msg", MESSAGE_ID)),
}
FLOW: Schema = {
    1: ("consumer_id", "varint"),
    2: ("message_permits", "varint"),
}
UNSUBSCRIBE: Schema = {
    1: ("consumer_id", "varint"),
    2: ("request_id", "varint"),
}
SUCCESS: Schema = {1: ("request_id", "varint")}
ERROR: Schema = {
    1: ("request_id", "varint"),
    2: ("error", "varint"),
    3: ("message", "string"),
}
CLOSE_PRODUCER: Schema = {
    1: ("producer_id", "varint"),
    2: ("request_id", "varint"),
}
CLOSE_CONSUMER: Schema = {
    1: ("consumer_id", "varint"),
    2: ("request_id", "varint"),
}
PRODUCER_SUCCESS: Schema = {
    1: ("request_id", "varint"),
    2: ("producer_name", "string"),
    3: ("last_sequence_id", "varint"),
}
PING: Schema = {}
PONG: Schema = {}
PARTITIONED_METADATA: Schema = {
    1: ("topic", "string"),
    2: ("request_id", "varint"),
}
PARTITIONED_METADATA_RESPONSE: Schema = {
    1: ("partitions", "varint"),
    2: ("request_id", "varint"),
    3: ("response", "varint"),  # 0 success, 1 failed
}
LOOKUP: Schema = {
    1: ("topic", "string"),
    2: ("request_id", "varint"),
    3: ("authoritative", "varint"),
}
LOOKUP_RESPONSE: Schema = {
    1: ("broker_service_url", "string"),
    3: ("response", "varint"),  # 0 redirect, 1 connect, 2 failed
    4: ("request_id", "varint"),
    5: ("authoritative", "varint"),
}
SEEK: Schema = {
    1: ("consumer_id", "varint"),
    2: ("request_id", "varint"),
    3: ("message_id", ("msg", MESSAGE_ID)),
    4: ("message_publish_time", "varint"),
}
GET_LAST_MESSAGE_ID: Schema = {
    1: ("consumer_id", "varint"),
    2: ("request_id", "varint"),
}
GET_LAST_MESSAGE_ID_RESPONSE: Schema = {
    1: ("last_message_id", ("msg", MESSAGE_ID)),
    2: ("request_id", "varint"),
}

MESSAGE_METADATA: Schema = {
    1: ("producer_name", "string"),
    2: ("sequence_id", "varint"),
    3: ("publish_time", "varint"),
    4: ("properties*", ("msg", KEY_VALUE)),
    6: ("partition_key", "string"),
    8: ("compression", "varint"),  # CompressionType enum; 0 = NONE
    9: ("uncompressed_size", "varint"),
    11: ("num_messages_in_batch", "varint"),
    15: ("partition_key_b64_encoded", "varint"),  # key is base64 of raw bytes
}

# PulsarApi.proto SingleMessageMetadata — one per entry of a batched payload
# (JVM producers batch by default; each entry is [4-byte size][this][payload])
SINGLE_MESSAGE_METADATA: Schema = {
    1: ("properties*", ("msg", KEY_VALUE)),
    2: ("partition_key", "string"),
    3: ("payload_size", "varint"),
    4: ("compacted_out", "varint"),
    5: ("event_time", "varint"),
    6: ("partition_key_b64_encoded", "varint"),
    8: ("sequence_id", "varint"),
    9: ("null_value", "varint"),
    10: ("null_partition_key", "varint"),
}


def split_batch(payload: bytes, n: int) -> list[tuple[dict[str, Any], bytes]]:
    """Split a batched message payload into ``n`` (SingleMessageMetadata,
    entry payload) pairs — the spec layout is
    ``[int32 metadata_size][SingleMessageMetadata][payload_size bytes]``
    repeated, sizes big-endian."""
    out: list[tuple[dict[str, Any], bytes]] = []
    off = 0
    for _ in range(n):
        if off + 4 > len(payload):
            raise ValueError(
                f"truncated batch payload: {len(payload)} bytes, "
                f"entry header at {off}"
            )
        size = int.from_bytes(payload[off : off + 4], "big")
        off += 4
        smm = decode_message(SINGLE_MESSAGE_METADATA, payload[off : off + size])
        off += size
        psize = int(smm.get("payload_size", 0))
        out.append((smm, payload[off : off + psize]))
        off += psize
    return out

# BaseCommand type enum values + the field that carries each sub-command
_COMMANDS: dict[str, tuple[int, int, Schema]] = {
    # name: (type enum, BaseCommand field number, schema)
    "connect": (2, 2, CONNECT),
    "connected": (3, 3, CONNECTED),
    "subscribe": (4, 4, SUBSCRIBE),
    "producer": (5, 5, PRODUCER),
    "send": (6, 6, SEND),
    "send_receipt": (7, 7, SEND_RECEIPT),
    "send_error": (8, 8, SEND_ERROR),
    "message": (9, 9, MESSAGE),
    "ack": (10, 10, ACK),
    "flow": (11, 11, FLOW),
    "unsubscribe": (12, 12, UNSUBSCRIBE),
    "success": (13, 13, SUCCESS),
    "error": (14, 14, ERROR),
    "close_producer": (15, 15, CLOSE_PRODUCER),
    "close_consumer": (16, 16, CLOSE_CONSUMER),
    "producer_success": (17, 17, PRODUCER_SUCCESS),
    "ping": (18, 18, PING),
    "pong": (19, 19, PONG),
    "partitioned_metadata": (21, 21, PARTITIONED_METADATA),
    "partitioned_metadata_response": (22, 22, PARTITIONED_METADATA_RESPONSE),
    "lookup": (23, 23, LOOKUP),
    "lookup_response": (24, 24, LOOKUP_RESPONSE),
    "seek": (28, 28, SEEK),
    "get_last_message_id": (29, 29, GET_LAST_MESSAGE_ID),
    "get_last_message_id_response": (30, 30, GET_LAST_MESSAGE_ID_RESPONSE),
}
_TYPE_TO_NAME = {type_: name for name, (type_, _, _) in _COMMANDS.items()}

PROTOCOL_VERSION = 21
MAGIC = b"\x0e\x01"


def encode_command(name: str, fields: dict[str, Any]) -> bytes:
    type_enum, field_no, schema = _COMMANDS[name]
    body = encode_message(schema, fields)
    out = bytearray()
    out += write_varint(1 << 3 | 0)  # BaseCommand.type
    out += write_varint(type_enum)
    out += write_varint(field_no << 3 | 2)
    out += write_varint(len(body))
    out += body
    return bytes(out)


def decode_command(buf: bytes) -> tuple[str, dict[str, Any]]:
    pos = 0
    type_enum: Optional[int] = None
    sub: dict[int, bytes] = {}
    while pos < len(buf):
        tag, pos = read_varint(buf, pos)
        field_no, wire_type = tag >> 3, tag & 7
        if wire_type == 0:
            val, pos = read_varint(buf, pos)
            if field_no == 1:
                type_enum = val
        elif wire_type == 2:
            length, pos = read_varint(buf, pos)
            sub[field_no] = buf[pos : pos + length]
            pos += length
        else:  # pragma: no cover - malformed
            raise ValueError(f"unexpected wire type {wire_type} in BaseCommand")
    if type_enum is None:
        raise ValueError("BaseCommand without type")
    name = _TYPE_TO_NAME.get(type_enum)
    if name is None:
        return f"unknown_{type_enum}", {}
    _, field_no, schema = _COMMANDS[name]
    body = sub.get(field_no, b"")
    return name, decode_message(schema, body)


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — pulsar checksums payload frames with it; zlib only
# has IEEE crc32, so table-driven here
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def frame(command: bytes) -> bytes:
    """Simple command frame."""
    return struct.pack(">II", 4 + len(command), len(command)) + command


def payload_frame(command: bytes, metadata: bytes, payload: bytes) -> bytes:
    """SEND / MESSAGE frame with metadata + payload and crc32c."""
    checked = struct.pack(">I", len(metadata)) + metadata + payload
    crc = crc32c(checked)
    rest = MAGIC + struct.pack(">I", crc) + checked
    total = 4 + len(command) + len(rest)
    return struct.pack(">II", total, len(command)) + command + rest


def split_frame(data: bytes) -> tuple[str, dict, Optional[dict], bytes]:
    """Decode one frame body (after totalSize): returns
    (command name, command fields, metadata or None, payload)."""
    (command_size,) = struct.unpack_from(">I", data, 0)
    name, fields = decode_command(data[4 : 4 + command_size])
    rest = data[4 + command_size :]
    if not rest:
        return name, fields, None, b""
    if rest[:2] != MAGIC:
        raise ValueError("payload frame without magic")
    (crc,) = struct.unpack_from(">I", rest, 2)
    checked = rest[6:]
    if crc32c(checked) != crc:
        raise ValueError("crc32c mismatch on payload frame")
    (metadata_size,) = struct.unpack_from(">I", checked, 0)
    metadata = decode_message(MESSAGE_METADATA, checked[4 : 4 + metadata_size])
    payload = checked[4 + metadata_size :]
    return name, fields, metadata, payload
