"""Dependency-free Avro: schema parser + binary codec + GenericRecord analog
(the port's own copy of ``langstream_tpu/api/avro.py``).

Parity: the reference carries Avro values end-to-end — records read from
Kafka hold GenericRecords, the agents-commons transforms mutate them, and the
gRPC agent protocol interns schemas per stream
(`langstream-agents/langstream-agent-grpc/.../agent.proto:37-48`,
`langstream-agents-commons/.../AvroUtil.java`). This module supplies the
codec those layers need, implemented from the Avro 1.11 specification
(binary encoding + canonical-form fingerprinting); no avro library ships in
the image.

Supported: null, boolean, int, long, float, double, bytes, string, record,
enum, array, map, union, fixed; logical types pass through untouched (the
encoding is that of the underlying type).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Any, Optional

PRIMITIVES = {
    "null", "boolean", "int", "long", "float", "double", "bytes", "string"
}


class AvroError(ValueError):
    pass


@dataclass(frozen=True)
class Schema:
    """A parsed Avro schema node. ``source`` keeps the normalized dict/str
    form for re-serialization; complex types pre-resolve their children."""

    type: str
    source: Any
    name: Optional[str] = None
    fields: tuple[tuple[str, "Schema", Any], ...] = ()  # (name, schema, default)
    items: Optional["Schema"] = None  # array
    values: Optional["Schema"] = None  # map
    symbols: tuple[str, ...] = ()  # enum
    size: int = 0  # fixed
    branches: tuple["Schema", ...] = ()  # union

    def canonical(self) -> str:
        """Parsing-canonical-form JSON (stable intern/fingerprint key).
        Cached on the instance — schemas are immutable and this runs per
        record on the broker produce path."""
        cached = self.__dict__.get("_canonical_cache")
        if cached is None:
            cached = json.dumps(
                _canonical(self.source), separators=(",", ":"), sort_keys=False
            )
            object.__setattr__(self, "_canonical_cache", cached)
        return cached

    def fingerprint(self) -> int:
        """CRC-64-AVRO of the canonical form (Avro spec fingerprinting)."""
        cached = self.__dict__.get("_fingerprint_cache")
        if cached is None:
            cached = _crc64(self.canonical().encode())
            object.__setattr__(self, "_fingerprint_cache", cached)
        return cached


@dataclass
class AvroValue:
    """A datum + its schema — the GenericRecord analog carried as a record
    key/value through the platform."""

    schema: Schema
    data: Any

    def encode(self) -> bytes:
        return encode(self.schema, self.data)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, AvroValue)
            and other.data == self.data
            and other.schema.canonical() == self.schema.canonical()
        )


# ---------------------------------------------------------------------------
# Schema parsing
# ---------------------------------------------------------------------------


def parse_schema(source: Any) -> Schema:
    if isinstance(source, (str, bytes)):
        text = source.decode() if isinstance(source, bytes) else source
        stripped = text.strip()
        if stripped.startswith(("{", "[")) or stripped.startswith('"'):
            source = json.loads(stripped)
        else:
            source = stripped  # bare primitive name
    return _parse(source, {}, namespace=None)


def _fullname(name: str, namespace: Optional[str]) -> str:
    if "." in name or not namespace:
        return name
    return f"{namespace}.{name}"


def _parse(node: Any, named: dict[str, Schema], namespace: Optional[str]) -> Schema:
    if isinstance(node, str):
        if node in PRIMITIVES:
            return Schema(type=node, source=node)
        ref = named.get(_fullname(node, namespace)) or named.get(node)
        if ref is None:
            raise AvroError(f"unknown schema reference {node!r}")
        return ref
    if isinstance(node, list):
        branches = tuple(_parse(b, named, namespace) for b in node)
        return Schema(type="union", source=node, branches=branches)
    if not isinstance(node, dict):
        raise AvroError(f"invalid schema node {node!r}")

    t = node.get("type")
    if t in PRIMITIVES:
        return Schema(type=t, source=node if len(node) > 1 else t)
    if t == "array":
        return Schema(
            type="array", source=node, items=_parse(node["items"], named, namespace)
        )
    if t == "map":
        return Schema(
            type="map", source=node, values=_parse(node["values"], named, namespace)
        )
    if t == "enum":
        name = _fullname(node["name"], node["namespace"] if "namespace" in node else namespace)
        schema = Schema(
            type="enum", source=node, name=name, symbols=tuple(node["symbols"])
        )
        named[name] = schema
        return schema
    if t == "fixed":
        name = _fullname(node["name"], node["namespace"] if "namespace" in node else namespace)
        schema = Schema(type="fixed", source=node, name=name, size=int(node["size"]))
        named[name] = schema
        return schema
    if t == "record" or t == "error":
        ns = node["namespace"] if "namespace" in node else namespace
        name = _fullname(node["name"], ns)
        # two-phase: register a placeholder so recursive references resolve
        fields: list[tuple[str, Schema, Any]] = []
        schema = Schema(type="record", source=node, name=name)
        named[name] = schema
        for f in node.get("fields", []):
            fields.append(
                (f["name"], _parse(f["type"], named, ns), f.get("default", _NO_DEFAULT))
            )
        object.__setattr__(schema, "fields", tuple(fields))
        return schema
    if isinstance(t, (list, dict)):
        return _parse(t, named, namespace)
    raise AvroError(f"unsupported schema type {t!r}")


_NO_DEFAULT = object()


def _canonical(node: Any, namespace: Optional[str] = None) -> Any:
    """Strip non-structural attributes, order keys per the spec's
    parsing-canonical-form field order, and apply the FULLNAMES step:
    every name (and name reference) is resolved to namespace.name before
    the namespace attribute is dropped — so two schemas differing only by
    namespace get DIFFERENT fingerprints, matching spec CRC-64-AVRO."""
    if isinstance(node, str):
        if (
            node in PRIMITIVES
            or node in ("record", "error", "enum", "fixed", "array", "map")
            or "." in node
            or not namespace
        ):
            return node
        return f"{namespace}.{node}"  # named-type reference → fullname
    if isinstance(node, list):
        return [_canonical(b, namespace) for b in node]
    if isinstance(node, dict):
        t = node.get("type")
        if t in PRIMITIVES and len(node) >= 1 and "name" not in node:
            return t
        ns = node["namespace"] if "namespace" in node else namespace
        out: dict[str, Any] = {}
        for key in ("name", "type", "fields", "symbols", "items", "values", "size"):
            if key not in node:
                continue
            v = node[key]
            if key == "name":
                out[key] = v if "." in v else (f"{ns}.{v}" if ns else v)
            elif key == "fields":
                out[key] = [
                    {"name": f["name"], "type": _canonical(f["type"], ns)} for f in v
                ]
            elif key in ("items", "values", "type") and not isinstance(v, (int,)):
                out[key] = _canonical(v, ns)
            else:
                out[key] = v
        return out
    return node


_CRC64_POLY = 0xC15D213AA4D7A795


def _crc64_table() -> list[int]:
    table = []
    for i in range(256):
        fp = i
        for _ in range(8):
            fp = (fp >> 1) ^ (_CRC64_POLY & -(fp & 1))
        table.append(fp)
    return table


_CRC64_TABLE = _crc64_table()
_CRC64_EMPTY = 0xC15D213AA4D7A795


def _crc64(data: bytes) -> int:
    fp = _CRC64_EMPTY
    for b in data:
        fp = (fp >> 8) ^ _CRC64_TABLE[(fp ^ b) & 0xFF]
    return fp


# ---------------------------------------------------------------------------
# Binary encoding
# ---------------------------------------------------------------------------


def _zigzag_encode(out: bytearray, v: int) -> None:
    v = (v << 1) ^ (v >> 63)
    v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def encode(schema: Schema, datum: Any) -> bytes:
    out = bytearray()
    _encode(out, schema, datum)
    return bytes(out)


def _encode(out: bytearray, schema: Schema, datum: Any) -> None:
    t = schema.type
    if t == "null":
        if datum is not None:
            raise AvroError(f"non-null datum for null schema: {datum!r}")
    elif t == "boolean":
        out.append(1 if datum else 0)
    elif t in ("int", "long"):
        _zigzag_encode(out, int(datum))
    elif t == "float":
        out.extend(struct.pack("<f", float(datum)))
    elif t == "double":
        out.extend(struct.pack("<d", float(datum)))
    elif t == "bytes":
        b = bytes(datum)
        _zigzag_encode(out, len(b))
        out.extend(b)
    elif t == "string":
        b = str(datum).encode()
        _zigzag_encode(out, len(b))
        out.extend(b)
    elif t == "fixed":
        b = bytes(datum)
        if len(b) != schema.size:
            raise AvroError(f"fixed {schema.name} needs {schema.size} bytes")
        out.extend(b)
    elif t == "enum":
        try:
            _zigzag_encode(out, schema.symbols.index(datum))
        except ValueError:
            raise AvroError(f"{datum!r} not in enum {schema.name}") from None
    elif t == "array":
        assert schema.items is not None
        items = list(datum)
        if items:
            _zigzag_encode(out, len(items))
            for item in items:
                _encode(out, schema.items, item)
        _zigzag_encode(out, 0)
    elif t == "map":
        assert schema.values is not None
        entries = dict(datum)
        if entries:
            _zigzag_encode(out, len(entries))
            for k, v in entries.items():
                b = str(k).encode()
                _zigzag_encode(out, len(b))
                out.extend(b)
                _encode(out, schema.values, v)
        _zigzag_encode(out, 0)
    elif t == "union":
        idx = _union_branch(schema, datum)
        _zigzag_encode(out, idx)
        _encode(out, schema.branches[idx], datum)
    elif t == "record":
        if not isinstance(datum, dict):
            raise AvroError(f"record {schema.name} needs a dict, got {type(datum)}")
        for name, fschema, default in schema.fields:
            if name in datum:
                _encode(out, fschema, datum[name])
            elif default is not _NO_DEFAULT:
                _encode(out, fschema, _default_value(fschema, default))
            else:
                raise AvroError(f"missing field {name!r} of record {schema.name}")
    else:
        raise AvroError(f"cannot encode type {t!r}")


def _default_value(schema: Schema, default: Any) -> Any:
    # union defaults apply to the FIRST branch; "null" default is None already
    if schema.type == "bytes" and isinstance(default, str):
        return default.encode("latin-1")
    return default


def _union_branch(schema: Schema, datum: Any) -> int:
    def matches(branch: Schema, d: Any) -> bool:
        t = branch.type
        if t == "null":
            return d is None
        if t == "boolean":
            return isinstance(d, bool)
        if t in ("int", "long"):
            return isinstance(d, int) and not isinstance(d, bool)
        if t in ("float", "double"):
            return isinstance(d, float)
        if t == "string":
            return isinstance(d, str)
        if t in ("bytes", "fixed"):
            return isinstance(d, (bytes, bytearray))
        if t == "enum":
            return isinstance(d, str) and d in branch.symbols
        if t == "array":
            return isinstance(d, (list, tuple))
        if t in ("map", "record"):
            return isinstance(d, dict)
        return False

    for i, branch in enumerate(schema.branches):
        if matches(branch, datum):
            return i
    # second pass: int→float promotion
    for i, branch in enumerate(schema.branches):
        if branch.type in ("float", "double") and isinstance(datum, int):
            return i
    raise AvroError(f"datum {datum!r} matches no union branch")


# ---------------------------------------------------------------------------
# Binary decoding
# ---------------------------------------------------------------------------


class _Decoder:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def raw(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise AvroError(f"truncated avro data at {self.pos}")
        self.pos += n
        return out

    def zigzag(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.raw(1)[0]
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)


def decode(schema: Schema, data: bytes) -> Any:
    d = _Decoder(data)
    out = _decode(d, schema)
    return out


def _decode(d: _Decoder, schema: Schema) -> Any:
    t = schema.type
    if t == "null":
        return None
    if t == "boolean":
        return d.raw(1)[0] != 0
    if t in ("int", "long"):
        return d.zigzag()
    if t == "float":
        return struct.unpack("<f", d.raw(4))[0]
    if t == "double":
        return struct.unpack("<d", d.raw(8))[0]
    if t == "bytes":
        return d.raw(d.zigzag())
    if t == "string":
        return d.raw(d.zigzag()).decode()
    if t == "fixed":
        return d.raw(schema.size)
    if t == "enum":
        return schema.symbols[d.zigzag()]
    if t == "array":
        assert schema.items is not None
        out = []
        while True:
            n = d.zigzag()
            if n == 0:
                return out
            if n < 0:  # block with byte-size prefix
                n = -n
                d.zigzag()
            for _ in range(n):
                out.append(_decode(d, schema.items))
    if t == "map":
        assert schema.values is not None
        out_map: dict[str, Any] = {}
        while True:
            n = d.zigzag()
            if n == 0:
                return out_map
            if n < 0:
                n = -n
                d.zigzag()
            for _ in range(n):
                key = d.raw(d.zigzag()).decode()
                out_map[key] = _decode(d, schema.values)
    if t == "union":
        return _decode(d, schema.branches[d.zigzag()])
    if t == "record":
        rec = {}
        for name, fschema, _default in schema.fields:
            rec[name] = _decode(d, fschema)
        return rec
    raise AvroError(f"cannot decode type {t!r}")


# ---------------------------------------------------------------------------
# JSON ↔ Avro datum helpers (agents-commons AvroUtil analog)
# ---------------------------------------------------------------------------


def datum_to_json(datum: Any) -> Any:
    """Avro datum → JSON-compatible object (bytes become latin-1 strings,
    the Avro JSON-encoding convention for bytes/fixed)."""
    if isinstance(datum, (bytes, bytearray)):
        return bytes(datum).decode("latin-1")
    if isinstance(datum, dict):
        return {k: datum_to_json(v) for k, v in datum.items()}
    if isinstance(datum, (list, tuple)):
        return [datum_to_json(v) for v in datum]
    return datum


def json_to_datum(schema: Schema, obj: Any, strict: bool = False) -> Any:
    """JSON object → datum shaped for ``schema`` (inverse of datum_to_json).

    ``strict``: raise AvroError when a record object carries keys the schema
    has no field for — the signal callers use to fall back to JSON instead
    of silently dropping mutated-in fields."""
    t = schema.type
    if t in ("bytes", "fixed") and isinstance(obj, str):
        return obj.encode("latin-1")
    if t == "record" and isinstance(obj, dict):
        out = {}
        known = {name for name, _f, _d in schema.fields}
        if strict:
            extra = set(obj) - known
            if extra:
                raise AvroError(
                    f"record {schema.name} has no fields for {sorted(extra)}"
                )
        for name, fschema, default in schema.fields:
            if name in obj:
                out[name] = json_to_datum(fschema, obj[name], strict)
            elif default is not _NO_DEFAULT:
                out[name] = _default_value(fschema, default)
        return out
    if t == "array" and isinstance(obj, (list, tuple)):
        assert schema.items is not None
        return [json_to_datum(schema.items, v, strict) for v in obj]
    if t == "map" and isinstance(obj, dict):
        assert schema.values is not None
        return {k: json_to_datum(schema.values, v, strict) for k, v in obj.items()}
    if t == "union":
        for branch in schema.branches:
            try:
                datum = json_to_datum(branch, obj, strict)
                _union_branch(schema, datum)  # validates
                return datum
            except AvroError:
                continue
        if strict:
            raise AvroError(f"no union branch of {schema.source} fits {obj!r}")
        return obj
    return obj
