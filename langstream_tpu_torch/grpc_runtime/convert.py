"""Record ↔ proto conversion (the port's own copy of
``langstream_tpu/grpc_runtime/convert.py``; reference grpc_service.py
to_grpc_record / from_grpc_record). Structured values travel as JSON OR as
Avro binary with per-channel schema interning (reference agent.proto:37-48 +
AvroUtil.java):
``SchemaCodec`` assigns each distinct schema an id once per channel and
ships the schema JSON alongside the first value that uses it."""

from __future__ import annotations

import itertools
import json
import time
from typing import Any, Optional

from langstream_tpu_torch.api import avro
from langstream_tpu_torch.api.avro import AvroValue
from langstream_tpu_torch.api.record import Header, Record, SimpleRecord
from langstream_tpu_torch.grpc_runtime import agent_pb2 as pb


def to_value(obj: Any) -> pb.Value:
    value = pb.Value()
    if obj is None:
        return value  # oneof unset = null
    if isinstance(obj, bool):  # before int — bool is an int subclass
        value.bool_value = obj
    elif isinstance(obj, str):
        value.string_value = obj
    elif isinstance(obj, bytes):
        value.bytes_value = obj
    elif isinstance(obj, int):
        value.long_value = obj
    elif isinstance(obj, float):
        value.double_value = obj
    else:
        value.json_value = json.dumps(obj, default=str)
    return value


def from_value(value: pb.Value) -> Any:
    kind = value.WhichOneof("kind")
    if kind is None:
        return None
    if kind == "json_value":
        return json.loads(value.json_value)
    return getattr(value, kind)


def to_grpc_record(record: Record, record_id: int) -> pb.GrpcRecord:
    return pb.GrpcRecord(
        record_id=record_id,
        key=to_value(record.key),
        value=to_value(record.value),
        headers=[pb.Header(key=h.key, value=to_value(h.value)) for h in record.headers],
        origin=record.origin or "",
        timestamp=record.timestamp or 0.0,
    )


def from_grpc_record(message: pb.GrpcRecord) -> SimpleRecord:
    return SimpleRecord(
        value=from_value(message.value),
        key=from_value(message.key),
        headers=tuple(Header(h.key, from_value(h.value)) for h in message.headers),
        origin=message.origin or None,
        timestamp=message.timestamp or time.time(),
    )


class SchemaCodec:
    """Per-channel Avro schema interning. One instance per gRPC channel
    endpoint; ``reset()`` on subprocess restart (the peer's table is gone).

    Non-Avro values fall through to the plain to_value/from_value paths, so
    the codec is a strict superset of the JSON-only protocol."""

    def __init__(self) -> None:
        self._send_ids: dict[str, int] = {}  # canonical schema -> assigned id
        self._ids = itertools.count(1)
        self._recv: dict[int, avro.Schema] = {}

    def reset(self) -> None:
        self.__init__()

    # -- send side ----------------------------------------------------------

    def to_value(self, obj: Any, new_schemas: list[pb.Schema]) -> pb.Value:
        if isinstance(obj, AvroValue):
            canonical = obj.schema.canonical()
            schema_id = self._send_ids.get(canonical)
            if schema_id is None:
                schema_id = next(self._ids)
                self._send_ids[canonical] = schema_id
                new_schemas.append(
                    pb.Schema(schema_id=schema_id, value=canonical.encode())
                )
            return pb.Value(avro_value=obj.encode(), schema_id=schema_id)
        return to_value(obj)

    def to_grpc_record(
        self, record: Record, record_id: int, new_schemas: list[pb.Schema]
    ) -> pb.GrpcRecord:
        return pb.GrpcRecord(
            record_id=record_id,
            key=self.to_value(record.key, new_schemas),
            value=self.to_value(record.value, new_schemas),
            headers=[
                pb.Header(key=h.key, value=self.to_value(h.value, new_schemas))
                for h in record.headers
            ],
            origin=record.origin or "",
            timestamp=record.timestamp or 0.0,
        )

    # -- receive side -------------------------------------------------------

    def register(self, schemas) -> None:
        for s in schemas:
            self._recv[s.schema_id] = avro.parse_schema(s.value.decode())

    def from_value(self, value: pb.Value) -> Any:
        if value.WhichOneof("kind") == "avro_value":
            schema = self._recv.get(value.schema_id)
            if schema is None:
                raise ValueError(
                    f"avro value references unknown schema_id {value.schema_id}"
                )
            return AvroValue(schema, avro.decode(schema, value.avro_value))
        return from_value(value)

    def from_grpc_record(self, message: pb.GrpcRecord) -> SimpleRecord:
        return SimpleRecord(
            value=self.from_value(message.value),
            key=self.from_value(message.key),
            headers=tuple(
                Header(h.key, self.from_value(h.value)) for h in message.headers
            ),
            origin=message.origin or None,
            timestamp=message.timestamp or time.time(),
        )


# hand-written method descriptors (no grpc protoc plugin in the image). The
# proto package stays ``langstream_tpu``: the wire names are those of the JAX
# package's bridge, so either package's bridge drives the other's child.
SERVICE_NAME = "langstream_tpu.AgentService"


def method(name: str) -> str:
    return f"/{SERVICE_NAME}/{name}"


RPCS: dict[str, tuple[Any, Any, bool, bool]] = {
    # name → (request type, response type, request streaming, response streaming)
    "agent_info": (pb.InfoRequest, pb.InfoResponse, False, False),
    "read": (pb.SourceRequest, pb.SourceResponse, True, True),
    "process": (pb.ProcessorRequest, pb.ProcessorResponse, True, True),
    "write": (pb.SinkRequest, pb.SinkResponse, True, True),
    "get_topic_producer_records": (
        pb.TopicProducerWriteResult,
        pb.TopicProducerRecord,
        True,
        True,
    ),
}


def error_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"
