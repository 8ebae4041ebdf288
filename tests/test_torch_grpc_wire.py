"""The port's gRPC agent wire against the JAX package's: the same proto
descriptor byte for byte, the same method names, the same record ↔ proto
conversion and Avro schema interning (``SchemaCodec``), and each package's
CHILD process answering the same requests with the same bytes on every rpc
(``process``, ``read`` with commit and permanent failure, ``write``,
``agent_info``), error texts included. The children run the user agents of
``tests/torch_grpc_user_agents.py`` and ``tests/grpc_user_agents.py``."""

import asyncio
import json
import os
import subprocess
import sys
import threading
from contextlib import asynccontextmanager
from pathlib import Path

import grpc
import pytest

from langstream_tpu.api import avro as jax_avro
from langstream_tpu.api.record import SimpleRecord as JaxRecord
from langstream_tpu.grpc_runtime import agent_pb2 as jax_pb
from langstream_tpu.grpc_runtime import convert as jax_convert
from langstream_tpu_torch.api import avro
from langstream_tpu_torch.api.record import SimpleRecord
from langstream_tpu_torch.grpc_runtime import agent_pb2 as pb
from langstream_tpu_torch.grpc_runtime import convert

from test_avro import USER, USER_SCHEMA

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(Path(__file__).resolve().parent)
CHILDREN = {"jax": "langstream_tpu.grpc_runtime", "port": "langstream_tpu_torch.grpc_runtime"}
OTHER_SCHEMA = ('{"type": "record", "name": "Tag", "namespace": "t", "fields": '
                '[{"name": "v", "type": ["null", "string"], "default": null}]}')


def test_descriptor_and_proto_equal_jax():
    assert pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.package == "langstream_tpu" and pb.DESCRIPTOR.name == "agent.proto"
    proto = "grpc_runtime/proto/agent.proto"
    assert (ROOT / "langstream_tpu_torch" / proto).read_bytes() == (
        ROOT / "langstream_tpu" / proto).read_bytes()
    # one descriptor pool: both modules hold the same message classes
    assert pb.GrpcRecord is jax_pb.GrpcRecord


def test_methods_equal_jax():
    assert convert.SERVICE_NAME == jax_convert.SERVICE_NAME == "langstream_tpu.AgentService"
    assert list(convert.RPCS) == list(jax_convert.RPCS)
    for name, spec in convert.RPCS.items():
        assert spec == jax_convert.RPCS[name]
        assert convert.method(name) == jax_convert.method(name)
    for e in (ValueError("x"), RuntimeError(""), KeyError("k")):
        assert convert.error_text(e) == jax_convert.error_text(e)


VALUES = [None, True, False, 0, -5, 2**62, 1.5, -0.0, "", "héllo", b"", b"\x00\xff",
          {"a": [1, {"b": None}]}, [1, "x", 2.5], {1, 2}]


@pytest.mark.parametrize("value", VALUES, ids=[repr(v)[:16] for v in VALUES])
def test_values_equal_jax(value):
    message = convert.to_value(value)
    assert message.SerializeToString(deterministic=True) == jax_convert.to_value(
        value).SerializeToString(deterministic=True)
    assert convert.from_value(message) == jax_convert.from_value(message)


def _records(record_cls, avro_mod, seed_values):
    user = avro_mod.parse_schema(USER_SCHEMA)
    tag = avro_mod.parse_schema(OTHER_SCHEMA)
    out = []
    for i, v in enumerate(seed_values):
        if v == "user":
            value = avro_mod.AvroValue(user, dict(USER, age=i))
        elif v == "tag":
            value = avro_mod.AvroValue(tag, {"v": f"t{i}"})
        else:
            value = v
        key = avro_mod.AvroValue(tag, {"v": None}) if i % 3 == 0 else f"k{i}"
        out.append(record_cls.of(value, key=key, headers=[("h", i), ("tag", value)]
                                 if v == "tag" else [("h", i)], origin="o", timestamp=10.0 + i))
    return out


SEQUENCE = ["user", "plain", "tag", "user", {"j": 1}, "tag", 7, "user"]


def test_schema_codec_equals_jax():
    """Both codecs intern the same schemas under the same ids, ship each
    schema once with its first value, and build the same bytes; each
    decodes the other's stream; ``reset()`` starts the ids over."""
    sides = []
    for codec_mod, record_cls, avro_mod in ((jax_convert, JaxRecord, jax_avro),
                                            (convert, SimpleRecord, avro)):
        codec = codec_mod.SchemaCodec()
        frames = []
        for round_ in range(2):
            for rid, record in enumerate(_records(record_cls, avro_mod, SEQUENCE)):
                schemas = []
                message = codec.to_grpc_record(record, rid, schemas)
                frames.append((message.SerializeToString(deterministic=True),
                               [s.SerializeToString(deterministic=True) for s in schemas]))
            codec.reset()
        sides.append(frames)
    assert sides[1] == sides[0]
    shipped = [len(s) for _, s in sides[1]]
    assert sum(shipped) == 4  # two schemas, once each per stream
    # each package decodes the other's frames to the same records
    for recv_mod, avro_mod in ((convert, avro), (jax_convert, jax_avro)):
        codec = recv_mod.SchemaCodec()
        for message_bytes, schemas in sides[0][:len(SEQUENCE)]:
            codec.register([pb.Schema.FromString(s) for s in schemas])
            record = codec.from_grpc_record(pb.GrpcRecord.FromString(message_bytes))
            if isinstance(record.value, avro_mod.AvroValue):
                assert record.value.encode() == avro_mod.encode(record.value.schema,
                                                                record.value.data)
    unknown = pb.Value(avro_value=b"\x00", schema_id=9)
    errors = []
    for mod in (jax_convert, convert):
        with pytest.raises(ValueError) as info:
            mod.SchemaCodec().from_value(unknown)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_records_convert_equal_jax():
    for jax_record, record in zip(_records(JaxRecord, jax_avro, ["plain", {"a": 1}, 3]),
                                  _records(SimpleRecord, avro, ["plain", {"a": 1}, 3])):
        if not isinstance(record.key, str):
            continue  # plain conversion has no Avro
        message = convert.to_grpc_record(record, 4)
        assert message.SerializeToString(deterministic=True) == jax_convert.to_grpc_record(
            jax_record, 4).SerializeToString(deterministic=True)
        back, jax_back = convert.from_grpc_record(message), jax_convert.from_grpc_record(message)
        assert (back.value, back.key, back.origin, back.timestamp) == (
            jax_back.value, jax_back.key, jax_back.origin, jax_back.timestamp)
        assert [(h.key, h.value) for h in back.headers] == [
            (h.key, h.value) for h in jax_back.headers]


# ---------------------------------------------------------------------------
# each package's child, spoken to over raw channels
# ---------------------------------------------------------------------------


@asynccontextmanager
async def child(package: str, class_name: str, configuration: dict):
    """Spawn a package's agent child, wait for its banner (30 s at most),
    yield a channel to it; terminate it after."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), TESTS]),
               CUDA_VISIBLE_DEVICES="")
    config = {"className": class_name, "configuration": configuration, "agentId": "a1",
              "agentType": "python-processor"}
    process = subprocess.Popen([sys.executable, "-m", CHILDREN[package], json.dumps(config)],
                               stdout=subprocess.PIPE, env=env, text=True)
    loop = asyncio.get_running_loop()
    banner = loop.create_future()

    def read() -> None:
        for line in process.stdout:
            if line.startswith("LANGSTREAM-GRPC-PORT ") and not banner.done():
                loop.call_soon_threadsafe(banner.set_result, int(line.split()[1]))

    threading.Thread(target=read, daemon=True).start()
    channel = None
    try:
        port = await asyncio.wait_for(banner, 30)
        channel = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        yield channel
    finally:
        if channel is not None:
            await channel.close()
        process.terminate()
        await asyncio.to_thread(process.wait, 10)


def _stream(channel, name):
    req, resp, _, _ = convert.RPCS[name]
    return channel.stream_stream(convert.method(name), request_serializer=req.SerializeToString,
                                 response_deserializer=resp.FromString)()


def _bytes(message) -> bytes:
    return message.SerializeToString(deterministic=True)


async def _process_exchange(package):
    codec = convert.SchemaCodec()
    records = _records(SimpleRecord, avro, ["user", "plain", "tag", "user"])
    records.append(SimpleRecord.of("explode", timestamp=1.0))
    out = []
    async with child(package, "torch_grpc_user_agents.Mixed", {"suffix": "?!"}) as channel:
        call = _stream(channel, "process")
        for batch in (records[:3], records[3:]):
            schemas = []
            messages = [codec.to_grpc_record(r, 100 + i, schemas) for i, r in enumerate(batch)]
            await call.write(pb.ProcessorRequest(records=messages, schemas=schemas))
            out.append(_bytes(await asyncio.wait_for(call.read(), 30)))
        await call.done_writing()
    return out


def test_process_rpc_children_equal():
    jax_out = asyncio.run(_process_exchange("jax"))
    port_out = asyncio.run(_process_exchange("port"))
    assert port_out == jax_out
    first = pb.ProcessorResponse.FromString(port_out[0])
    # the child interns the bumped record's schema with its first use
    assert [s.schema_id for s in first.schemas] == [1, 2]
    last = pb.ProcessorResponse.FromString(port_out[1])
    assert last.results[-1].error == "ValueError: asked to explode"


async def _read_exchange(package, log):
    async with child(package, "torch_grpc_user_agents.RecordingSource",
                     {"limit": 3, "log": str(log)}) as channel:
        call = _stream(channel, "read")
        got = []
        while len(got) < 3:
            response = await asyncio.wait_for(call.read(), 30)
            got.extend(response.records)
        await call.write(pb.SourceRequest(committed_records=[got[0].record_id,
                                                             got[2].record_id]))
        await call.write(pb.SourceRequest(permanent_failure=pb.PermanentFailure(
            record_id=got[1].record_id, error_message="no room")))
        for _ in range(300):
            if log.exists() and len(log.read_text().splitlines()) == 3:
                break
            await asyncio.sleep(0.01)
        await call.done_writing()
    return [_bytes(m) for m in got], log.read_text()


def test_read_rpc_children_equal(tmp_path):
    jax_out = asyncio.run(_read_exchange("jax", tmp_path / "jax.log"))
    port_out = asyncio.run(_read_exchange("port", tmp_path / "port.log"))
    assert port_out == jax_out
    assert port_out[1].splitlines() == ["commit item-1", "commit item-3",
                                        "failure item-2: RuntimeError: no room"]


async def _write_exchange(package, path):
    codec = convert.SchemaCodec()
    out = []
    async with child(package, "grpc_user_agents.FileSink", {"path": str(path)}) as channel:
        call = _stream(channel, "write")
        for i, record in enumerate(_records(SimpleRecord, avro, ["plain", 4, "tag"])):
            schemas = []
            message = codec.to_grpc_record(record, i + 1, schemas)
            await call.write(pb.SinkRequest(record=message, schemas=schemas))
            out.append(_bytes(await asyncio.wait_for(call.read(), 30)))
        await call.done_writing()
    return out


def test_write_rpc_children_equal(tmp_path):
    jax_out = asyncio.run(_write_exchange("jax", tmp_path / "jax.txt"))
    port_out = asyncio.run(_write_exchange("port", tmp_path / "port.txt"))
    assert port_out == jax_out
    assert [pb.SinkResponse.FromString(b).record_id for b in port_out] == [1, 2, 3]
    jax_lines = (tmp_path / "jax.txt").read_text().splitlines()
    port_lines = (tmp_path / "port.txt").read_text().splitlines()
    assert port_lines[:2] == jax_lines[:2] == ["plain", "4"]
    # the sink prints the Avro value's repr: the same text up to the address of
    # the schema's "no default" marker
    assert port_lines[2].split(" at 0x")[0] == jax_lines[2].split(" at 0x")[0]
    # a sink error comes back as its text
    error = asyncio.run(_write_exchange("port", tmp_path / "missing" / "x.txt"))
    jax_error = asyncio.run(_write_exchange("jax", tmp_path / "missing" / "x.txt"))
    assert error == jax_error
    assert pb.SinkResponse.FromString(error[0]).error.startswith("FileNotFoundError: ")


async def _info_exchange(package):
    async with child(package, "grpc_user_agents.Exclaim", {}) as channel:
        stub = channel.unary_unary(convert.method("agent_info"),
                                   request_serializer=pb.InfoRequest.SerializeToString,
                                   response_deserializer=pb.InfoResponse.FromString)
        return json.loads((await asyncio.wait_for(stub(pb.InfoRequest()), 30)).json_info)


def test_agent_info_rpc_children_equal():
    infos = [asyncio.run(_info_exchange(p)) for p in ("jax", "port")]
    assert infos[1] == infos[0]
    assert infos[1]["agent-id"] == "a1" and infos[1]["component-type"] == "processor"
