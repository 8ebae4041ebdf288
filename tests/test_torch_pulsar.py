"""The port's Pulsar runtime: the contract of ``tests/test_pulsar.py`` (wire
codec units + platform end-to-end over the protocol fake, whose admin REST
the port serves on the stdlib), and held against the JAX package: equal
frame bytes (with their CRC-32C) for seeded messages, and either package's
client against the other's fake.

The cross-broker SPI semantics live in test_topic_contract.py; this file
covers what is pulsar-specific: protobuf/frame codec, crc32c, key routing,
partitioned-topic fan-out, shared-subscription redelivery, and the full
platform running with `streamingCluster.type: pulsar`.
"""

import asyncio

import pytest

from langstream_tpu_torch.api.record import SimpleRecord
from langstream_tpu_torch.messaging import pulsar_protocol as wire
from langstream_tpu_torch.messaging.pulsar import (
    PulsarTopicConnectionsRuntime,
    java_string_hash,
)
from langstream_tpu_torch.messaging.pulsar_fake import FakePulsarBroker

# ---------------------------------------------------------------------------
# codec units
# ---------------------------------------------------------------------------


def test_crc32c_known_vector():
    # RFC 3720 test vector for CRC32C (Castagnoli)
    assert wire.crc32c(b"123456789") == 0xE3069283
    assert wire.crc32c(b"") == 0


def test_command_roundtrip():
    cmd = wire.encode_command(
        "subscribe",
        {
            "topic": "persistent://public/default/t",
            "subscription": "sub-1",
            "sub_type": 1,
            "consumer_id": 7,
            "request_id": 3,
            "consumer_name": "c",
            "durable": 1,
            "initial_position": 1,
        },
    )
    name, fields = wire.decode_command(cmd)
    assert name == "subscribe"
    assert fields["topic"] == "persistent://public/default/t"
    assert fields["sub_type"] == 1
    assert fields["consumer_id"] == 7
    assert fields["initial_position"] == 1


def test_payload_frame_roundtrip_and_crc():
    metadata = wire.encode_message(
        wire.MESSAGE_METADATA,
        {
            "producer_name": "p1",
            "sequence_id": 9,
            "publish_time": 1234,
            "partition_key": "k",
            "properties": [{"key": "h1", "value": "v1"}],
        },
    )
    frame = wire.payload_frame(
        wire.encode_command(
            "send", {"producer_id": 1, "sequence_id": 9, "num_messages": 1}
        ),
        metadata,
        b"payload-bytes",
    )
    name, fields, meta, payload = wire.split_frame(frame[4:])
    assert name == "send"
    assert fields["sequence_id"] == 9
    assert meta["partition_key"] == "k"
    assert meta["properties"] == [{"key": "h1", "value": "v1"}]
    assert payload == b"payload-bytes"
    # flip a payload byte → crc must fail
    corrupted = bytearray(frame[4:])
    corrupted[-1] ^= 0xFF
    with pytest.raises(ValueError, match="crc32c"):
        wire.split_frame(bytes(corrupted))


def test_repeated_message_id_ack_roundtrip():
    cmd = wire.encode_command(
        "ack",
        {
            "consumer_id": 2,
            "ack_type": 0,
            "message_id": [
                {"ledger_id": 0, "entry_id": 4},
                {"ledger_id": 0, "entry_id": 9},
            ],
        },
    )
    name, fields = wire.decode_command(cmd)
    assert name == "ack"
    assert [m["entry_id"] for m in fields["message_id"]] == [4, 9]


def test_java_string_hash_matches_jvm():
    # values computed with java.lang.String#hashCode
    assert java_string_hash("") == 0
    assert java_string_hash("a") == 97
    assert java_string_hash("hello") == 99162322
    assert java_string_hash("Aa") == java_string_hash("BB") == 2112  # the collision
    assert java_string_hash("polygenelubricants") == -2147483648


# ---------------------------------------------------------------------------
# fake-broker integration
# ---------------------------------------------------------------------------


@pytest.fixture
def pulsar():
    class Ctx:
        async def start(self):
            self.broker = await FakePulsarBroker().start()
            self.runtime = PulsarTopicConnectionsRuntime()
            await self.runtime.init(
                {
                    "service": {"serviceUrl": self.broker.service_url},
                    "admin": {"serviceUrl": self.broker.admin_url},
                }
            )
            return self.broker, self.runtime

        async def stop(self):
            await self.runtime.close()
            await self.broker.stop()

    return Ctx()


async def _read_n(consumer, n, attempts=100):
    got = []
    for _ in range(attempts):
        got.extend(await consumer.read())
        if len(got) >= n:
            break
    return got


def test_partitioned_topic_key_routing(pulsar, run):
    """Keyed records land on java_string_hash(key) % n — and records with
    the same key always hit the same partition sub-topic."""

    async def main():
        broker, rt = await pulsar.start()
        try:
            admin = rt.create_topic_admin()
            await admin.create_topic("pt", partitions=3)
            producer = rt.create_producer("a", "pt")
            await producer.start()
            for i in range(12):
                await producer.write(SimpleRecord(key=f"k{i % 4}", value=f"v{i}"))
            # each key's 3 records are all in one partition sub-topic
            full = "persistent://public/default/pt"
            placed = {}
            for p in range(3):
                topic = broker.topics[f"{full}-partition-{p}"]
                for metadata_bytes, payload in topic.entries:
                    meta = wire.decode_message(wire.MESSAGE_METADATA, metadata_bytes)
                    placed.setdefault(meta["partition_key"], set()).add(p)
            assert placed, "no messages landed"
            for key, partitions in placed.items():
                assert len(partitions) == 1, f"key {key} split across {partitions}"
                assert partitions == {java_string_hash(key) % 3}
            # consumer over the partitioned topic sees all 12
            consumer = rt.create_consumer("a", "pt")
            await consumer.start()
            got = await _read_n(consumer, 12)
            assert sorted(r.value for r in got) == sorted(f"v{i}" for i in range(12))
            await consumer.commit(got)
            await consumer.close()
            await producer.close()
        finally:
            await pulsar.stop()

    run(main())


def test_shared_subscription_redelivers_on_consumer_crash(pulsar, run):
    """In-flight (delivered, unacked) entries return to the pool when their
    consumer's connection dies, and surviving consumers receive them."""

    async def main():
        broker, rt = await pulsar.start()
        try:
            producer = rt.create_producer("a", "rd")
            await producer.start()
            for i in range(4):
                await producer.write(SimpleRecord.of(f"m{i}"))

            consumer1 = rt.create_consumer("a", "rd")
            await consumer1.start()
            got1 = await _read_n(consumer1, 4)
            assert len(got1) == 4
            await consumer1.commit(got1[:2])  # ack 2, leave 2 in flight
            await consumer1.close()

            consumer2 = rt.create_consumer("a", "rd")
            await consumer2.start()
            got2 = await _read_n(consumer2, 2)
            assert sorted(r.value for r in got2) == ["m2", "m3"]
            await consumer2.commit(got2)
            await consumer2.close()
            await producer.close()
        finally:
            await pulsar.stop()

    run(main())


def test_avro_value_rides_pulsar_properties(pulsar, run):
    """AvroValue round-trips through pulsar message properties (the analog
    of the kafka schema headers)."""

    async def main():
        _, rt = await pulsar.start()
        try:
            from langstream_tpu_torch.api.avro import AvroValue, parse_schema

            schema = parse_schema(
                {
                    "type": "record",
                    "name": "Q",
                    "fields": [{"name": "text", "type": "string"}],
                }
            )
            producer = rt.create_producer("a", "avro-t")
            await producer.start()
            consumer = rt.create_consumer("a", "avro-t")
            await consumer.start()
            await producer.write(
                SimpleRecord.of(AvroValue(schema, {"text": "hello avro"}))
            )
            (got,) = await _read_n(consumer, 1)
            assert isinstance(got.value, AvroValue)
            assert got.value.data == {"text": "hello avro"}
            assert got.value.schema.canonical() == schema.canonical()
            await consumer.commit([got])
            await consumer.close()
            await producer.close()
        finally:
            await pulsar.stop()

    run(main())


def test_platform_end_to_end_over_pulsar(run):
    """The whole platform (deployer, composite agents, topics) runs with
    `streamingCluster.type: pulsar` against the fake broker socket."""
    import yaml

    from langstream_tpu_torch.core.parser import ModelBuilder
    from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner

    pipeline = """
module: default
id: app
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: convert
    type: document-to-json
    input: input-topic
    configuration:
      text-field: q
  - name: extract
    type: compute
    output: output-topic
    configuration:
      fields:
        - name: value
          expression: value.q
"""

    async def main():
        broker = await FakePulsarBroker().start()
        try:
            import tempfile
            from pathlib import Path

            app_dir = Path(tempfile.mkdtemp(prefix="pulsar-e2e-"))
            (app_dir / "pipeline.yaml").write_text(pipeline)
            instance = app_dir / "instance.yaml"
            instance.write_text(
                yaml.safe_dump(
                    {
                        "instance": {
                            "streamingCluster": {
                                "type": "pulsar",
                                "configuration": {
                                    "service": {"serviceUrl": broker.service_url},
                                    "admin": {"serviceUrl": broker.admin_url},
                                },
                            },
                            "computeCluster": {"type": "local"},
                        }
                    }
                )
            )
            pkg = ModelBuilder.build_application_from_path(
                app_dir, instance_path=instance
            )
            runner = LocalApplicationRunner("app", pkg.application)
            await runner.deploy()
            await runner.start()
            try:
                await runner.produce("input-topic", "hello pulsar")
                out = await runner.consume("output-topic", n=1, timeout=15)
                assert out[0].value == "hello pulsar"
                # records actually traversed the wire: the fake broker's
                # topic logs are non-empty
                full_in = "persistent://public/default/input-topic"
                full_out = "persistent://public/default/output-topic"
                assert len(broker.topics[full_in].entries) >= 1
                assert len(broker.topics[full_out].entries) >= 1
            finally:
                await runner.stop()
        finally:
            await broker.stop()

    run(main())


def test_lookup_redirect_to_owner_broker(run):
    """Multi-broker cluster: the service_url broker answers LOOKUP with a
    REDIRECT to the topic's owner; producer and consumer traffic must land
    on the owner's socket, not the entry-point broker's."""

    async def main():
        entry = await FakePulsarBroker().start()
        owner = await FakePulsarBroker().start()
        full = "persistent://public/default/owned-topic"
        entry.lookup_redirects[full] = owner.service_url
        rt = PulsarTopicConnectionsRuntime()
        await rt.init(
            {
                "service": {"serviceUrl": entry.service_url},
                "admin": {"serviceUrl": entry.admin_url},
            }
        )
        try:
            producer = rt.create_producer("a", "owned-topic")
            await producer.start()
            for i in range(3):
                await producer.write(SimpleRecord(key=None, value=f"m{i}"))
            assert full not in entry.topics or not entry.topics[full].entries
            assert len(owner.topics[full].entries) == 3
            consumer = rt.create_consumer("a", "owned-topic")
            await consumer.start()
            got = await _read_n(consumer, 3)
            assert sorted(r.value for r in got) == ["m0", "m1", "m2"]
            await consumer.commit(got)
            await consumer.close()
            await producer.close()
        finally:
            await rt.close()
            await entry.stop()
            await owner.stop()

    run(main())


def test_batched_payload_explodes_per_entry():
    """JVM producers batch by default: num_messages_in_batch>1 with
    [size][SingleMessageMetadata][payload] framing must yield one record
    per entry, per-entry keys/properties authoritative (ADVICE r4)."""
    from langstream_tpu_torch.messaging.pulsar import _explode_frame

    entries = []
    for i in range(3):
        smm = {
            "payload_size": len(f"payload-{i}"),
            "partition_key": f"key-{i}",
            "properties": [{"key": "idx", "value": str(i)}],
        }
        body = wire.encode_message(wire.SINGLE_MESSAGE_METADATA, smm)
        entries.append(
            len(body).to_bytes(4, "big") + body + f"payload-{i}".encode()
        )
    metadata = {
        "producer_name": "p",
        "sequence_id": 9,
        "publish_time": 123000,
        "num_messages_in_batch": 3,
        "partition_key": "outer-key",  # batch-level; entries override
    }
    out = _explode_frame(metadata, b"".join(entries))
    assert len(out) == 3
    for i, (md, payload, bindex, emitted) in enumerate(out):
        assert payload == f"payload-{i}".encode()
        assert md["partition_key"] == f"key-{i}"
        assert bindex == i and emitted == 3
        assert {p["key"]: p["value"] for p in md["properties"]} == {"idx": str(i)}
    # unbatched passes through untouched
    solo = _explode_frame({"publish_time": 1}, b"x")
    assert solo == [({"publish_time": 1}, b"x", -1, 1)]


def test_batched_compression_raises_explicitly():
    from langstream_tpu_torch.messaging.pulsar import (
        PulsarProtocolError,
        _explode_frame,
    )

    with pytest.raises(PulsarProtocolError, match="compression"):
        _explode_frame({"compression": 2, "num_messages_in_batch": 2}, b"zz")


def test_batch_ack_waits_for_all_entries(run):
    """A batch's wire message id must not ack until EVERY emitted entry
    committed — the broker redelivers whole batches."""
    from langstream_tpu_torch.messaging.memory import ConsumedRecord
    from langstream_tpu_torch.messaging.pulsar import PulsarTopicConsumer

    consumer = PulsarTopicConsumer.__new__(PulsarTopicConsumer)
    consumer._inflight = {}
    consumer._batch_left = {}

    acked = []

    class _Conn:
        async def fire(self, name, fields):
            acked.append(fields)

    consumer._subs = {0: {"consumer_id": 7, "conn": _Conn()}}
    mid = {"ledger_id": 3, "entry_id": 44}
    records = []
    for i in range(3):
        consumer._inflight[(0, i)] = {
            "consumer_id": 7,
            "message_id": mid,
            "batch_index": i,
            "batch_emitted": 3,
        }
        records.append(
            ConsumedRecord(
                value=b"", key=None, headers=(), origin="t",
                timestamp=0.0, partition=0, offset=i,
            )
        )
    run(consumer.commit([records[0]]))
    run(consumer.commit([records[1]]))
    assert acked == []  # two of three entries committed: no ack yet
    run(consumer.commit([records[2]]))
    assert len(acked) == 1 and acked[0]["message_id"] == [mid]
    assert consumer._batch_left == {}


def test_pack_mid_wide_entries_roundtrip():
    from langstream_tpu_torch.messaging.pulsar import _pack_mid, _unpack_mid

    for ledger, entry in [(0, 0), (7, 5_000_000), (1 << 40, (1 << 32) - 1)]:
        assert _unpack_mid(_pack_mid(ledger, entry)) == (ledger, entry)
    with pytest.raises(ValueError):
        _pack_mid(1, 1 << 32)


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------


def test_frame_bytes_equal_jax():
    """Seeded SEND frames — metadata with properties, keys and batch counts,
    a batched payload — encode to equal bytes with equal CRC-32C in both
    packages, and each package splits the other's frames alike."""
    import random

    from langstream_tpu.messaging import pulsar_protocol as jax_wire

    rng = random.Random(0)
    for trial in range(16):
        n = rng.randrange(1, 5)
        entries = b""
        for i in range(n):
            single = {"payload_size": rng.randrange(0, 64), "sequence_id": i,
                      "properties": [{"key": f"p{j}", "value": str(rng.randrange(99))}
                                     for j in range(rng.randrange(3))]}
            meta = wire.encode_message(wire.SINGLE_MESSAGE_METADATA, single)
            entries += len(meta).to_bytes(4, "big") + meta + rng.randbytes(single["payload_size"])
        metadata = {
            "producer_name": f"prod-{rng.randrange(100)}",
            "sequence_id": rng.randrange(10**6),
            "publish_time": 1_700_000_000_000 + rng.randrange(10**6),
            "partition_key": f"k{rng.randrange(9)}",
            "properties": [{"key": f"h{j}", "value": rng.choice(["", "x", "é"])}
                           for j in range(rng.randrange(3))],
            "num_messages_in_batch": n,
        }
        send = {"producer_id": rng.randrange(9), "sequence_id": metadata["sequence_id"],
                "num_messages": n}

        def build(w):
            return w.payload_frame(w.encode_command("send", send),
                                   w.encode_message(w.MESSAGE_METADATA, metadata), entries)

        ours, theirs = build(wire), build(jax_wire)
        assert ours == theirs, trial
        assert wire.crc32c(ours[10:]) == jax_wire.crc32c(theirs[10:])
        name, fields, meta, payload = wire.split_frame(theirs[4:])
        assert (name, fields, meta, payload) == jax_wire.split_frame(ours[4:])
        assert wire.split_batch(payload, n) == jax_wire.split_batch(payload, n)
    for name, fields in (("flow", {"consumer_id": 3, "message_permits": 1000}),
                         ("ack", {"consumer_id": 3, "ack_type": 1,
                                  "message_id": [{"ledger_id": 0, "entry_id": 7}]})):
        assert wire.frame(wire.encode_command(name, fields)) == jax_wire.frame(
            jax_wire.encode_command(name, fields))


@pytest.mark.parametrize("client,fake", [("port", "jax"), ("jax", "port")])
def test_cross_package_exchange(client, fake, run):
    """Either package's client against the other's fake broker (the admin
    REST included): records, keys, headers, partitions and the broker's
    acknowledged records equal the JAX client's against the JAX fake."""
    from torch_brokers import exchange

    got = run(exchange(client, fake, "pulsar"))
    want = run(exchange("jax", "jax", "pulsar"))
    assert got == want
    assert len(got["rows"]) == 24 and {p for _, p in got["partitions"]} == {0, 1}
    assert got["committed"] == {"records": 24, "committed": {"g": 24}}
