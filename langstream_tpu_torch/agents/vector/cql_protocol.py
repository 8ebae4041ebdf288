"""Cassandra CQL native protocol v4 — stdlib-only codec; the port's copy
of ``langstream_tpu/agents/vector/cql_protocol.py`` (frames and values
byte-identical to it).

Parity: reference `langstream-vector-agents/.../cassandra/` talks to
Cassandra/Astra through the DataStax Java driver; this rebuild speaks the
native protocol directly (the `kafka_protocol.py` approach — no driver, no
SDK). Framing (protocol spec v4):

    [version u8][flags u8][stream i16][opcode u8][length u32][body]

Request version 0x04, response 0x84. The subset implemented is what the
vector datasource/writer agents need: STARTUP/READY, the SASL-plain
AUTHENTICATE dance (Astra's token auth: user ``token``, password
``AstraCS:...``), QUERY with bound positional values, and RESULT decoding
(Void / Rows / SetKeyspace / SchemaChange) with the common CQL types plus
``vector<float, n>`` (Cassandra 5 / Astra vector search).
"""

from __future__ import annotations

import struct
import uuid as uuid_mod
from typing import Any, Optional

VERSION_REQUEST = 0x04
VERSION_RESPONSE = 0x84

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_AUTH_CHALLENGE = 0x0E
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_PREPARED = 0x0004
RESULT_SCHEMA_CHANGE = 0x0005

CONSISTENCY_ONE = 0x0001
CONSISTENCY_QUORUM = 0x0004
CONSISTENCY_LOCAL_QUORUM = 0x0006

# type option ids (spec §6.2.1)
T_CUSTOM = 0x0000
T_ASCII = 0x0001
T_BIGINT = 0x0002
T_BLOB = 0x0003
T_BOOLEAN = 0x0004
T_COUNTER = 0x0005
T_DECIMAL = 0x0006
T_DOUBLE = 0x0007
T_FLOAT = 0x0008
T_INT = 0x0009
T_TIMESTAMP = 0x000B
T_UUID = 0x000C
T_VARCHAR = 0x000D
T_VARINT = 0x000E
T_TIMEUUID = 0x000F
T_INET = 0x0010
T_SMALLINT = 0x0013
T_TINYINT = 0x0014
T_LIST = 0x0020
T_MAP = 0x0021
T_SET = 0x0022

VECTOR_CLASS = "org.apache.cassandra.db.marshal.VectorType"


class CqlError(RuntimeError):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(f"CQL error 0x{code:04x}: {message}")
        self.code = code
        self.message = message


# ---------------------------------------------------------------------------
# primitive writers / readers
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self) -> None:
        self.buf = bytearray()

    def u8(self, v: int) -> "Writer":
        self.buf += struct.pack(">B", v)
        return self

    def u16(self, v: int) -> "Writer":
        self.buf += struct.pack(">H", v)
        return self

    def i16(self, v: int) -> "Writer":
        self.buf += struct.pack(">h", v)
        return self

    def i32(self, v: int) -> "Writer":
        self.buf += struct.pack(">i", v)
        return self

    def i64(self, v: int) -> "Writer":
        self.buf += struct.pack(">q", v)
        return self

    def string(self, s: str) -> "Writer":
        data = s.encode()
        self.u16(len(data))
        self.buf += data
        return self

    def long_string(self, s: str) -> "Writer":
        data = s.encode()
        self.i32(len(data))
        self.buf += data
        return self

    def bytes_(self, b: Optional[bytes]) -> "Writer":
        if b is None:
            self.i32(-1)
        else:
            self.i32(len(b))
            self.buf += b
        return self

    def short_bytes(self, b: bytes) -> "Writer":
        self.u16(len(b))
        self.buf += b
        return self

    def string_map(self, m: dict[str, str]) -> "Writer":
        self.u16(len(m))
        for k, v in m.items():
            self.string(k)
            self.string(v)
        return self

    def build(self) -> bytes:
        return bytes(self.buf)


class Reader:
    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        (v,) = struct.unpack_from(">B", self.buf, self.pos)
        self.pos += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from(">H", self.buf, self.pos)
        self.pos += 2
        return v

    def i16(self) -> int:
        (v,) = struct.unpack_from(">h", self.buf, self.pos)
        self.pos += 2
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from(">i", self.buf, self.pos)
        self.pos += 4
        return v

    def i64(self) -> int:
        (v,) = struct.unpack_from(">q", self.buf, self.pos)
        self.pos += 8
        return v

    def string(self) -> str:
        n = self.u16()
        s = self.buf[self.pos : self.pos + n].decode()
        self.pos += n
        return s

    def long_string(self) -> str:
        n = self.i32()
        s = self.buf[self.pos : self.pos + n].decode()
        self.pos += n
        return s

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def string_map(self) -> dict[str, str]:
        return {self.string(): self.string() for _ in range(self.u16())}

    def short_bytes(self) -> bytes:
        n = self.u16()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def remaining(self) -> int:
        return len(self.buf) - self.pos


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def frame(opcode: int, body: bytes, stream: int = 0, version: int = VERSION_REQUEST) -> bytes:
    return struct.pack(">BBhBI", version, 0, stream, opcode, len(body)) + body


def parse_header(header: bytes) -> tuple[int, int, int, int]:
    """→ (version, stream, opcode, body length)."""
    version, _flags, stream, opcode, length = struct.unpack(">BBhBI", header)
    return version, stream, opcode, length


HEADER_SIZE = 9


# ---------------------------------------------------------------------------
# type options (result metadata)
# ---------------------------------------------------------------------------


def write_type(w: Writer, type_: Any) -> None:
    """type_ is an int id, ("list", inner), ("set", inner), ("map", k, v) or
    ("vector", n)."""
    if isinstance(type_, int):
        w.u16(type_)
        return
    kind = type_[0]
    if kind == "list":
        w.u16(T_LIST)
        write_type(w, type_[1])
    elif kind == "set":
        w.u16(T_SET)
        write_type(w, type_[1])
    elif kind == "map":
        w.u16(T_MAP)
        write_type(w, type_[1])
        write_type(w, type_[2])
    elif kind == "vector":
        w.u16(T_CUSTOM)
        w.string(f"{VECTOR_CLASS}(FloatType, {type_[1]})")
    else:  # pragma: no cover - schema bug
        raise TypeError(f"bad type {type_!r}")


def read_type(r: Reader) -> Any:
    id_ = r.u16()
    if id_ == T_LIST:
        return ("list", read_type(r))
    if id_ == T_SET:
        return ("set", read_type(r))
    if id_ == T_MAP:
        return ("map", read_type(r), read_type(r))
    if id_ == T_CUSTOM:
        cls = r.string()
        if cls.startswith(VECTOR_CLASS):
            inner = cls[len(VECTOR_CLASS) :].strip("()")
            n = int(inner.split(",")[-1].strip()) if "," in inner else 0
            return ("vector", n)
        return ("custom", cls)
    return id_


# ---------------------------------------------------------------------------
# value codecs (python ↔ CQL binary)
# ---------------------------------------------------------------------------


def encode_value(type_: Any, v: Any) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(type_, tuple):
        kind = type_[0]
        if kind in ("list", "set"):
            out = bytearray(struct.pack(">i", len(v)))
            for item in v:
                b = encode_value(type_[1], item)
                out += struct.pack(">i", -1) if b is None else struct.pack(">i", len(b)) + b
            return bytes(out)
        if kind == "map":
            out = bytearray(struct.pack(">i", len(v)))
            for k, item in v.items():
                kb = encode_value(type_[1], k) or b""
                vb = encode_value(type_[2], item)
                out += struct.pack(">i", len(kb)) + kb
                out += struct.pack(">i", -1) if vb is None else struct.pack(">i", len(vb)) + vb
            return bytes(out)
        if kind == "vector":
            # fixed-length float32 array, NO per-element length prefixes
            return struct.pack(f">{len(v)}f", *[float(x) for x in v])
        raise TypeError(f"bad type {type_!r}")
    if type_ in (T_ASCII, T_VARCHAR):
        return str(v).encode()
    if type_ == T_BLOB:
        return bytes(v)
    if type_ == T_BOOLEAN:
        return b"\x01" if v else b"\x00"
    if type_ in (T_BIGINT, T_TIMESTAMP, T_COUNTER):
        return struct.pack(">q", int(v))
    if type_ == T_INT:
        return struct.pack(">i", int(v))
    if type_ == T_SMALLINT:
        return struct.pack(">h", int(v))
    if type_ == T_TINYINT:
        return struct.pack(">b", int(v))
    if type_ == T_DOUBLE:
        return struct.pack(">d", float(v))
    if type_ == T_FLOAT:
        return struct.pack(">f", float(v))
    if type_ in (T_UUID, T_TIMEUUID):
        u = v if isinstance(v, uuid_mod.UUID) else uuid_mod.UUID(str(v))
        return u.bytes
    if type_ == T_VARINT:
        n = int(v)
        length = max(1, (n.bit_length() + 8) // 8)
        return n.to_bytes(length, "big", signed=True)
    raise TypeError(f"cannot encode CQL type {type_!r}")


def decode_value(type_: Any, b: Optional[bytes]) -> Any:
    if b is None:
        return None
    if isinstance(type_, tuple):
        kind = type_[0]
        if kind in ("list", "set"):
            r = Reader(b)
            n = r.i32()
            return [decode_value(type_[1], r.bytes_()) for _ in range(n)]
        if kind == "map":
            r = Reader(b)
            n = r.i32()
            return {
                decode_value(type_[1], r.bytes_()): decode_value(type_[2], r.bytes_())
                for _ in range(n)
            }
        if kind == "vector":
            n = len(b) // 4
            return list(struct.unpack(f">{n}f", b))
        if kind == "custom":
            return b
        raise TypeError(f"bad type {type_!r}")
    if type_ in (T_ASCII, T_VARCHAR):
        return b.decode()
    if type_ == T_BLOB:
        return b
    if type_ == T_BOOLEAN:
        return b != b"\x00"
    if type_ in (T_BIGINT, T_TIMESTAMP, T_COUNTER):
        return struct.unpack(">q", b)[0]
    if type_ == T_INT:
        return struct.unpack(">i", b)[0]
    if type_ == T_SMALLINT:
        return struct.unpack(">h", b)[0]
    if type_ == T_TINYINT:
        return struct.unpack(">b", b)[0]
    if type_ == T_DOUBLE:
        return struct.unpack(">d", b)[0]
    if type_ == T_FLOAT:
        return struct.unpack(">f", b)[0]
    if type_ in (T_UUID, T_TIMEUUID):
        return str(uuid_mod.UUID(bytes=b))
    if type_ == T_VARINT:
        return int.from_bytes(b, "big", signed=True)
    return b


def guess_type(v: Any) -> Any:
    """Binding helper for un-prepared QUERY values: infer the CQL type from
    the python value (matches how the agents bind positional params)."""
    if isinstance(v, bool):
        return T_BOOLEAN
    if isinstance(v, int):
        return T_BIGINT
    if isinstance(v, float):
        return T_DOUBLE
    if isinstance(v, bytes):
        return T_BLOB
    if isinstance(v, uuid_mod.UUID):
        return T_UUID
    if isinstance(v, (list, tuple)):
        if v and all(isinstance(x, (int, float)) for x in v):
            return ("vector", len(v))
        return ("list", T_VARCHAR)
    if isinstance(v, dict):
        return ("map", T_VARCHAR, T_VARCHAR)
    return T_VARCHAR


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


def startup_body() -> bytes:
    return Writer().string_map({"CQL_VERSION": "3.0.0"}).build()


def auth_response_body(username: str, password: str) -> bytes:
    token = b"\x00" + username.encode() + b"\x00" + password.encode()
    return Writer().bytes_(token).build()


QUERY_FLAG_VALUES = 0x01


def query_body(
    query: str,
    values: Optional[list[Any]] = None,
    consistency: int = CONSISTENCY_LOCAL_QUORUM,
) -> bytes:
    w = Writer().long_string(query)
    w.u16(consistency)
    if values:
        w.u8(QUERY_FLAG_VALUES)
        w.u16(len(values))
        for v in values:
            w.bytes_(encode_value(guess_type(v), v))
    else:
        w.u8(0)
    return w.build()


def prepare_body(query: str) -> bytes:
    return Writer().long_string(query).build()


def execute_body(
    prepared_id: bytes,
    bind_types: list[Any],
    values: list[Any],
    consistency: int = CONSISTENCY_LOCAL_QUORUM,
) -> bytes:
    """EXECUTE of a prepared statement: values encoded with the
    SERVER-declared bind types (native protocol v4 §4.1.6) — the reason
    prepared statements exist: an `int`/`smallint`/`float` column rejects
    the widths guess_type would pick for plain python numbers."""
    if len(values) != len(bind_types):
        raise CqlError(
            0x2200,
            f"statement has {len(bind_types)} bind markers but "
            f"{len(values)} values were supplied",
        )
    w = Writer().short_bytes(prepared_id)
    w.u16(consistency)
    if values:
        w.u8(QUERY_FLAG_VALUES)
        w.u16(len(values))
        for type_, v in zip(bind_types, values):
            w.bytes_(encode_value(type_, v))
    else:
        w.u8(0)
    return w.build()


def prepared_result_body(prepared_id: bytes, bind_types: list[Any]) -> bytes:
    """RESULT/Prepared (v4 §4.2.5.4): id + bind-variable metadata (types the
    client must use in EXECUTE) + empty result metadata (NO_METADATA)."""
    w = Writer().i32(RESULT_PREPARED)
    w.short_bytes(prepared_id)
    w.i32(0)  # metadata flags: no global table spec
    w.i32(len(bind_types))
    w.i32(0)  # pk_count
    for i, type_ in enumerate(bind_types):
        w.string("")  # keyspace
        w.string("")  # table
        w.string(f"p{i}")
        write_type(w, type_)
    w.i32(0x0004)  # result metadata: NO_METADATA
    w.i32(0)
    return w.build()


def parse_prepare_body(body: bytes) -> str:
    return Reader(body).long_string()


def parse_execute_body(body: bytes) -> tuple[bytes, list[Optional[bytes]], int]:
    """Server side: → (prepared id, raw value blobs, consistency)."""
    r = Reader(body)
    prepared_id = r.short_bytes()
    consistency = r.u16()
    flags = r.u8()
    raw_values: list[Optional[bytes]] = []
    if flags & QUERY_FLAG_VALUES:
        n = r.u16()
        raw_values = [r.bytes_() for _ in range(n)]
    return prepared_id, raw_values, consistency


def parse_query_body(body: bytes) -> tuple[str, list[Optional[bytes]], int]:
    """Server side: → (query, raw value blobs, consistency)."""
    r = Reader(body)
    query = r.long_string()
    consistency = r.u16()
    flags = r.u8()
    raw_values: list[Optional[bytes]] = []
    if flags & QUERY_FLAG_VALUES:
        n = r.u16()
        raw_values = [r.bytes_() for _ in range(n)]
    return query, raw_values, consistency


ROWS_FLAG_GLOBAL_TABLES_SPEC = 0x0001


def rows_body(
    keyspace: str,
    table: str,
    columns: list[tuple[str, Any]],
    rows: list[list[Any]],
) -> bytes:
    """RESULT/Rows with global table spec; columns = [(name, type), ...]."""
    w = Writer()
    w.i32(RESULT_ROWS)
    w.i32(ROWS_FLAG_GLOBAL_TABLES_SPEC)
    w.i32(len(columns))
    w.string(keyspace)
    w.string(table)
    for name, type_ in columns:
        w.string(name)
        write_type(w, type_)
    w.i32(len(rows))
    for row in rows:
        for (name, type_), value in zip(columns, row):
            w.bytes_(encode_value(type_, value))
    return w.build()


def void_body() -> bytes:
    return Writer().i32(RESULT_VOID).build()


def schema_change_body(change: str, target: str, keyspace: str, name: str = "") -> bytes:
    w = Writer().i32(RESULT_SCHEMA_CHANGE)
    w.string(change)
    w.string(target)
    w.string(keyspace)
    if target != "KEYSPACE":
        w.string(name)
    return w.build()


def error_body(code: int, message: str) -> bytes:
    return Writer().i32(code).string(message).build()


def parse_result_body(body: bytes) -> dict[str, Any]:
    """Client side: RESULT body → {"kind": ..., "rows": [dict], ...}."""
    r = Reader(body)
    kind = r.i32()
    if kind == RESULT_VOID:
        return {"kind": "void"}
    if kind == RESULT_SET_KEYSPACE:
        return {"kind": "set_keyspace", "keyspace": r.string()}
    if kind == RESULT_SCHEMA_CHANGE:
        return {"kind": "schema_change", "change": r.string(), "target": r.string()}
    if kind == RESULT_PREPARED:
        prepared_id = r.short_bytes()
        flags = r.i32()
        n_cols = r.i32()
        pk_count = r.i32()
        for _ in range(pk_count):
            r.u16()
        if flags & ROWS_FLAG_GLOBAL_TABLES_SPEC:
            r.string()
            r.string()
        bind_types: list[Any] = []
        for _ in range(n_cols):
            if not flags & ROWS_FLAG_GLOBAL_TABLES_SPEC:
                r.string()
                r.string()
            r.string()  # name
            bind_types.append(read_type(r))
        return {"kind": "prepared", "id": prepared_id, "bind_types": bind_types}
    if kind != RESULT_ROWS:
        return {"kind": f"unknown_{kind}"}
    flags = r.i32()
    n_cols = r.i32()
    if flags & 0x0002:  # has_more_pages → paging state
        r.bytes_()
    names: list[str] = []
    types: list[Any] = []
    if not flags & 0x0004:  # no_metadata not set
        if flags & ROWS_FLAG_GLOBAL_TABLES_SPEC:
            r.string()
            r.string()
        for _ in range(n_cols):
            if not flags & ROWS_FLAG_GLOBAL_TABLES_SPEC:
                r.string()
                r.string()
            names.append(r.string())
            types.append(read_type(r))
    n_rows = r.i32()
    rows = []
    for _ in range(n_rows):
        row = {}
        for name, type_ in zip(names, types):
            row[name] = decode_value(type_, r.bytes_())
        rows.append(row)
    return {"kind": "rows", "rows": rows, "columns": names}


def parse_error_body(body: bytes) -> CqlError:
    r = Reader(body)
    return CqlError(r.i32(), r.string())
