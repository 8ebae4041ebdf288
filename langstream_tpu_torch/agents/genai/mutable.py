"""Mutable transform context for GenAI toolkit steps (the port's own copy
of ``langstream_tpu/agents/genai/mutable.py``).

Parity: reference `langstream-agents-commons` `MutableRecord.java` (the
record-under-transformation that all steps mutate) — key/value parsed into
navigable structures, headers as properties, destination-topic override, and
a final materialisation back into a Record.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.api.record import Header, Record, SimpleRecord


def _parse_side(raw: Any) -> tuple[Any, bool, Any]:
    """Parse a record side (key or value) → (parsed, was_json, avro_schema).
    JSON objects/arrays become dicts/lists (was_json=True → serialised back
    to JSON on materialise); Avro values become their JSON-compatible datum
    with the schema remembered for re-encoding (AvroUtil analog)."""
    from langstream_tpu_torch.api.avro import AvroValue, datum_to_json

    if isinstance(raw, AvroValue):
        return datum_to_json(raw.data), False, raw.schema
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
    # Avro provenance: the side re-encodes under this schema on materialise
    # (falls back to JSON if the mutated shape no longer fits the schema)
    _key_avro_schema: Any = None
    _value_avro_schema: Any = None

    @staticmethod
    def from_record(record: Record) -> "MutableRecord":
        from langstream_tpu_torch.runtime.topic_adapters import DESTINATION_HEADER

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

    # -- field-path access ("value", "value.a.b", "key.x", "properties.p",
    #    "destinationTopic", "origin", "timestamp") --------------------------

    def _root(self, name: str) -> Any:
        if name == "value":
            return self.value
        if name == "key":
            return self.key
        if name in ("properties", "headers"):
            return self.properties
        if name == "destinationTopic":
            return self.destination_topic
        if name == "origin":
            return self.origin
        if name in ("timestamp", "eventTime"):
            return self.timestamp
        raise KeyError(f"unknown record part {name!r}")

    def get_field(self, path: str) -> Any:
        parts = path.split(".")
        current = self._root(parts[0])
        for p in parts[1:]:
            if current is None:
                return None
            if isinstance(current, dict):
                current = current.get(p)
            else:
                current = getattr(current, p, None)
        return current

    def set_field(self, path: str, val: Any) -> None:
        parts = path.split(".")
        root = parts[0]
        if len(parts) == 1:
            if root == "value":
                self.value = val
            elif root == "key":
                self.key = val
            elif root == "destinationTopic":
                self.destination_topic = val
            elif root in ("timestamp", "eventTime"):
                self.timestamp = val
            else:
                raise KeyError(f"cannot set record part {path!r}")
            return
        if root in ("properties", "headers"):
            if len(parts) != 2:
                raise KeyError(f"properties paths are flat: {path!r}")
            self.properties[parts[1]] = val
            return
        if root == "value":
            if not isinstance(self.value, dict):
                self.value = {}
                self._value_was_json = True
            container: Any = self.value
        elif root == "key":
            if not isinstance(self.key, dict):
                self.key = {}
                self._key_was_json = True
            container = self.key
        else:
            raise KeyError(f"cannot set into record part {root!r}")
        for p in parts[1:-1]:
            nxt = container.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                container[p] = nxt
            container = nxt
        container[parts[-1]] = val

    def drop_field(self, path: str) -> None:
        parts = path.split(".")
        root = parts[0]
        if root in ("properties", "headers") and len(parts) == 2:
            self.properties.pop(parts[1], None)
            return
        if len(parts) == 1:
            # bare field name → drop from value (reference drop-fields default)
            if isinstance(self.value, dict):
                self.value.pop(parts[0], None)
            return
        container = self._root(root)
        for p in parts[1:-1]:
            if not isinstance(container, dict):
                return
            container = container.get(p)
        if isinstance(container, dict):
            container.pop(parts[-1], None)

    # -- materialisation ----------------------------------------------------

    def _serialise(self, side: Any, was_json: bool, avro_schema: Any) -> Any:
        if avro_schema is not None:
            from langstream_tpu_torch.api.avro import (
                AvroError,
                AvroValue,
                encode,
                json_to_datum,
            )

            try:
                # strict: mutated-in fields the schema lacks must NOT be
                # silently dropped — they force the JSON fallback below
                datum = json_to_datum(avro_schema, side, strict=True)
                encode(avro_schema, datum)  # validates the mutated shape
                return AvroValue(avro_schema, datum)
            except AvroError:
                # schema no longer fits (field added/dropped): degrade to JSON
                if isinstance(side, (dict, list)):
                    return json.dumps(side)
                return side
        if was_json and isinstance(side, (dict, list)):
            return json.dumps(side)
        return side

    def to_record(self) -> SimpleRecord:
        headers = [Header(k, v) for k, v in self.properties.items()]
        if self.destination_topic:
            from langstream_tpu_torch.runtime.topic_adapters import DESTINATION_HEADER

            headers.append(Header(DESTINATION_HEADER, self.destination_topic))
        return SimpleRecord(
            key=self._serialise(self.key, self._key_was_json, self._key_avro_schema),
            value=self._serialise(
                self.value, self._value_was_json, self._value_avro_schema
            ),
            headers=tuple(headers),
            origin=self.origin,
            timestamp=self.timestamp,
        )
