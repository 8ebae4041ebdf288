"""The record under transformation — the part of ``langstream_tpu/agents/
genai/mutable.py`` the port's vector writer needs: ``MutableRecord`` and
``from_record`` (key and value parsed into navigable structures — a JSON
object or array becomes a dict or list —, headers as properties, the
destination-topic header lifted out). Records are duck-typed: anything
with ``key``, ``value``, ``headers`` (objects with ``key`` / ``value``),
``origin`` and ``timestamp``, as the JAX package's ``Record`` is."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

# the header a record's destination-topic override rides in
DESTINATION_HEADER = "langstream-destination-topic"


def _parse_side(raw: Any) -> tuple[Any, bool, Any]:
    """Parse a record side (key or value) → (parsed, was_json, schema).
    JSON objects / arrays become dicts / lists; an Avro value (an object
    with ``data`` and ``schema``) becomes its datum, as far as it is plain
    JSON data."""
    if hasattr(raw, "schema") and hasattr(raw, "data"):
        return raw.data, False, raw.schema
    if isinstance(raw, (bytes, bytearray)):
        try:
            raw = raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw, False, None
    if isinstance(raw, str):
        s = raw.strip()
        if s.startswith("{") or s.startswith("["):
            try:
                return json.loads(s), True, None
            except (json.JSONDecodeError, ValueError):
                return raw, False, None
    return raw, False, None


@dataclass
class MutableRecord:
    key: Any = None
    value: Any = None
    properties: dict[str, Any] = field(default_factory=dict)
    origin: Optional[str] = None
    timestamp: Optional[float] = None
    destination_topic: Optional[str] = None
    dropped: bool = False
    _key_was_json: bool = False
    _value_was_json: bool = False
    _key_avro_schema: Any = None
    _value_avro_schema: Any = None

    @staticmethod
    def from_record(record: Any) -> "MutableRecord":
        key, key_json, key_schema = _parse_side(record.key)
        value, value_json, value_schema = _parse_side(record.value)
        properties = {h.key: h.value for h in (record.headers or ())}
        destination = properties.pop(DESTINATION_HEADER, None)
        return MutableRecord(
            key=key,
            value=value,
            properties=properties,
            origin=record.origin,
            timestamp=record.timestamp,
            destination_topic=destination,
            _key_was_json=key_json,
            _value_was_json=value_json,
            _key_avro_schema=key_schema,
            _value_avro_schema=value_schema,
        )
