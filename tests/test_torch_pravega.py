"""The port's Pravega runtime: the contract of ``tests/test_pravega.py``
(wire codec units + platform end-to-end over the protocol fake, whose
controller REST the port serves on the stdlib), and held against the JAX
package: equal command bytes for seeded commands, and either package's
client against the other's fake.

Cross-broker SPI semantics live in test_topic_contract.py; this file covers
what is pravega-specific: WireCommand framing, event framing, routing-key →
fixed-segment placement, the metadata-stream reader-group coordination, and
the full platform running with ``streamingCluster.type: pravega``.
"""

import asyncio
import uuid

import pytest

from langstream_tpu_torch.api.record import SimpleRecord
from langstream_tpu_torch.messaging import pravega_protocol as wire
from langstream_tpu_torch.messaging.pravega import PravegaTopicConnectionsRuntime
from langstream_tpu_torch.messaging.pravega_fake import FakePravega

# ---------------------------------------------------------------------------
# codec units
# ---------------------------------------------------------------------------


def test_wire_command_roundtrip():
    writer_id = uuid.uuid4()
    for name, fields in [
        ("hello", {"high": wire.WIRE_VERSION, "low": wire.OLDEST_COMPATIBLE}),
        ("setup_append", {"request_id": 7, "writer_id": writer_id,
                          "segment": "s/t/0.#epoch.0", "token": ""}),
        ("append_setup", {"request_id": 7, "segment": "s/t/0.#epoch.0",
                          "writer_id": writer_id, "last_event_number": 42}),
        ("data_appended", {"writer_id": writer_id, "event_number": 5,
                           "previous_event_number": 4, "request_id": 5}),
        ("read_segment", {"segment": "s/t/1.#epoch.0", "offset": 128,
                          "suggested_length": 4096, "token": "", "request_id": 9}),
        ("segment_read", {"segment": "s/t/1.#epoch.0", "offset": 128,
                          "at_tail": True, "end_of_segment": False,
                          "data": b"\x01\x02", "request_id": 9}),
        ("stream_segment_info", {"request_id": 3, "segment": "s/t/0.#epoch.0",
                                 "exists": True, "sealed": False,
                                 "write_offset": 777, "start_offset": 0}),
    ]:
        frame_bytes = wire.encode(name, fields)
        type_, length = wire.parse_frame_header(frame_bytes[:8])
        assert length == len(frame_bytes) - 8
        back_name, back = wire.decode(type_, frame_bytes[8:])
        assert back_name == name
        for k, v in fields.items():
            assert back[k] == v, (name, k, back[k], v)


def test_event_framing_and_truncated_tail():
    events = [b"alpha", b"b" * 300, b"gamma"]
    blob = b"".join(wire.frame_event(e) for e in events)
    out = list(wire.iter_events(blob, base_offset=1000))
    assert [e for _, e in out] == events
    assert out[0][0] == 1000
    assert out[1][0] == 1000 + 8 + 5
    # a mid-event cut yields only the whole events before it
    cut = blob[: 8 + 5 + 8 + 100]
    assert [e for _, e in wire.iter_events(cut)] == [b"alpha"]


def test_segment_name_parse_roundtrip():
    name = wire.SegmentName("scope1", "stream-a", 3, epoch=2)
    assert name.qualified == "scope1/stream-a/3.#epoch.2"
    back = wire.SegmentName.parse(name.qualified)
    assert back == name


def test_routing_key_segment_stable_and_spread():
    # stable: same key, same segment — the ordering contract
    for key in ("a", "user-42", "zzz"):
        assert wire.routing_key_segment(key, 8) == wire.routing_key_segment(key, 8)
    # spread: many keys cover more than one segment
    seen = {wire.routing_key_segment(f"k{i}", 8) for i in range(64)}
    assert len(seen) > 4
    assert all(0 <= s < 8 for s in seen)
    assert wire.routing_key_segment(None, 8) == 0


# ---------------------------------------------------------------------------
# fake-broker integration
# ---------------------------------------------------------------------------


async def _runtime(broker):
    rt = PravegaTopicConnectionsRuntime()
    await rt.init({
        "client": {
            "controller-rest-uri": broker.controller_url,
            "segment-store": broker.segment_store_url,
            "scope": "langstream",
        }
    })
    return rt


def test_keyed_records_land_on_hashed_segment(run):
    async def main():
        broker = await FakePravega().start()
        rt = await _runtime(broker)
        try:
            admin = rt.create_topic_admin()
            await admin.create_topic("pt", partitions=4)
            producer = rt.create_producer("a", "pt")
            await producer.start()
            for i in range(16):
                await producer.write(SimpleRecord(key=f"k{i % 5}", value=f"v{i}"))
            # verify each key's events all sit in the predicted segment
            for k in range(5):
                seg_num = wire.routing_key_segment(f"k{k}", 4)
                seg = broker.segments[f"langstream/pt/{seg_num}.#epoch.0"]
                values = [
                    e.decode() for _, e in wire.iter_events(bytes(seg.data))
                ]
                assert any(f'"k{k}"' in v for v in values)
            await producer.close()
        finally:
            await rt.close()
            await broker.stop()

    run(main())


def test_consumer_rebalances_when_member_leaves(run):
    """Metadata-stream coordination: when a member leaves, the survivor
    adopts its segments from the committed snapshot."""

    async def main():
        broker = await FakePravega().start()
        rt = await _runtime(broker)
        try:
            admin = rt.create_topic_admin()
            await admin.create_topic("rb", partitions=2)
            a = rt.create_consumer("agent", "rb")
            b = rt.create_consumer("agent", "rb")
            await asyncio.gather(a.start(), b.start())
            producer = rt.create_producer("agent", "rb")
            await producer.start()
            for i in range(8):
                await producer.write(SimpleRecord(key=f"k{i}", value=f"m{i}"))

            got_a, got_b = [], []
            for _ in range(50):
                ra, rb_ = await asyncio.gather(a.read(), b.read())
                got_a.extend(ra)
                got_b.extend(rb_)
                await asyncio.gather(a.commit(ra), b.commit(rb_))
                if len(got_a) + len(got_b) >= 8:
                    break
            assert sorted(r.value for r in got_a + got_b) == sorted(
                f"m{i}" for i in range(8)
            )
            assert got_a and got_b  # both replicas participated
            # B leaves; new records ALL flow to A
            await b.close()
            for i in range(8, 12):
                await producer.write(SimpleRecord(key=f"k{i}", value=f"m{i}"))
            tail = []
            for _ in range(80):
                ra = await a.read()
                tail.extend(ra)
                await a.commit(ra)
                if len(tail) >= 4:
                    break
            assert sorted(r.value for r in tail) == ["m10", "m11", "m8", "m9"]
            await a.close()
            await producer.close()
        finally:
            await rt.close()
            await broker.stop()

    run(main())


def test_consumers_on_separate_runtimes_started_together_split_segments(run):
    """Two members of one group, each on a runtime (client) of its own as
    replicas run, started together: each record is read once, and both
    members read. A member claims segments at its first read, after both
    joins are in the log, so the split does not hang on which join landed
    first. Several groups in a row, each with its own subscription."""

    async def main():
        broker = await FakePravega().start()
        runtimes = [await _runtime(broker) for _ in range(3)]
        try:
            await runtimes[0].create_topic_admin().create_topic("sep", partitions=2)
            producer = runtimes[0].create_producer("agent", "sep")
            await producer.start()
            for i in range(8):
                await producer.write(SimpleRecord(key=f"k{i}", value=f"m{i}"))
            for round_ in range(6):
                a = runtimes[1].create_consumer(f"group-{round_}", "sep")
                b = runtimes[2].create_consumer(f"group-{round_}", "sep")
                await asyncio.gather(a.start(), b.start())
                got_a, got_b = [], []
                for _ in range(50):
                    ra, rb_ = await asyncio.gather(a.read(), b.read())
                    got_a.extend(ra)
                    got_b.extend(rb_)
                    await asyncio.gather(a.commit(ra), b.commit(rb_))
                    if len(got_a) + len(got_b) >= 8:
                        break
                assert sorted(r.value for r in got_a + got_b) == sorted(
                    f"m{i}" for i in range(8)
                ), round_
                assert got_a and got_b, round_
                assert not {r.partition for r in got_a} & {r.partition for r in got_b}
                await asyncio.gather(a.close(), b.close())
            await producer.close()
        finally:
            for rt in runtimes:
                await rt.close()
            await broker.stop()

    run(main())


def test_offsets_survive_subscription_restart(run):
    async def main():
        broker = await FakePravega().start()
        rt = await _runtime(broker)
        try:
            producer = rt.create_producer("agent", "st")
            await producer.start()
            for i in range(6):
                await producer.write(SimpleRecord.of(f"m{i}"))
            c1 = rt.create_consumer("agent", "st")
            await c1.start()
            got = []
            for _ in range(50):
                got.extend(await c1.read())
                if len(got) >= 6:
                    break
            await c1.commit(got)
            await c1.close()
            # restart: nothing redelivered, only new records flow
            await producer.write(SimpleRecord.of("m6"))
            c2 = rt.create_consumer("agent", "st")
            await c2.start()
            got2 = []
            for _ in range(50):
                got2.extend(await c2.read())
                if got2:
                    break
            assert [r.value for r in got2] == ["m6"]
            await c2.close()
            await producer.close()
        finally:
            await rt.close()
            await broker.stop()

    run(main())


def test_platform_end_to_end_on_pravega(run):
    """Full platform: parse an app, deploy on the local runner with
    ``streamingCluster.type: pravega``, produce through the gateway path,
    and verify bytes traversed the fake segment store."""

    async def main():
        import tempfile
        from pathlib import Path

        import yaml

        from langstream_tpu_torch.core.parser import ModelBuilder
        from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner

        broker = await FakePravega().start()
        try:
            app_dir = Path(tempfile.mkdtemp(prefix="pravega-app-"))
            (app_dir / "pipeline.yaml").write_text(yaml.safe_dump({
                "topics": [
                    {"name": "input-topic", "creation-mode": "create-if-not-exists"},
                    {"name": "output-topic", "creation-mode": "create-if-not-exists"},
                ],
                "pipeline": [{
                    "name": "echo",
                    "type": "compute",
                    "input": "input-topic",
                    "output": "output-topic",
                    "configuration": {"fields": [{
                        "name": "value.out",
                        "expression": "fn:uppercase(value.q)",
                        "type": "STRING",
                    }]},
                }],
            }))
            instance = Path(tempfile.mkdtemp(prefix="pravega-inst-")) / "instance.yaml"
            instance.write_text(yaml.safe_dump({
                "instance": {
                    "streamingCluster": {
                        "type": "pravega",
                        "configuration": {
                            "client": {
                                "controller-rest-uri": broker.controller_url,
                                "segment-store": broker.segment_store_url,
                                "scope": "langstream",
                            }
                        },
                    },
                    "computeCluster": {"type": "none"},
                }
            }))
            pkg = ModelBuilder.build_application_from_path(
                str(app_dir), instance_path=str(instance)
            )
            runner = LocalApplicationRunner("pravega-app", pkg.application)
            await runner.deploy()
            await runner.start()
            try:
                await runner.produce("input-topic", '{"q": "hello pravega"}')
                out = await runner.consume("output-topic", n=1, timeout=15)
                import json

                assert json.loads(out[0].value)["out"] == "HELLO PRAVEGA"
                # bytes actually traversed the fake segment store
                assert any(
                    "langstream/input-topic/" in n for n in broker.segments
                )
                assert any(
                    "langstream/output-topic/" in n for n in broker.segments
                )
            finally:
                await runner.stop()
        finally:
            await broker.stop()

    run(main())


def test_meta_log_compaction_snapshot_and_truncate(run):
    """When the subscription metadata log outgrows the cap, the lowest
    member snapshots + truncates; a fresh joiner replays {snapshot, tail}
    and still resumes from committed offsets."""

    async def main():
        broker = await FakePravega().start()
        rt = await _runtime(broker)
        try:
            producer = rt.create_producer("agent", "cp")
            await producer.start()
            for i in range(4):
                await producer.write(SimpleRecord.of(f"m{i}"))
            c1 = rt.create_consumer("agent", "cp")
            c1.META_COMPACT_BYTES = 200  # tiny cap: compact immediately
            await c1.start()
            got = []
            for _ in range(50):
                got.extend(await c1.read())
                if len(got) >= 4:
                    break
            await c1.commit(got)
            # force heartbeats + refreshes until compaction triggers
            c1._last_heartbeat = 0.0
            c1._last_refresh = 0.0
            await c1.read()
            meta = broker.segments["langstream/_ls_sub_cp_agent/0.#epoch.0"]
            assert meta.start_offset > 0, "metadata log never truncated"
            await c1.close()

            # fresh joiner: replays snapshot+tail, resumes cleanly
            await producer.write(SimpleRecord.of("m4"))
            c2 = rt.create_consumer("agent", "cp")
            await c2.start()
            got2 = []
            for _ in range(50):
                got2.extend(await c2.read())
                if got2:
                    break
            assert [r.value for r in got2] == ["m4"]
            assert c2._meta_offset >= meta.start_offset
            await c2.close()
            await producer.close()
        finally:
            await rt.close()
            await broker.stop()

    run(main())


def test_producer_survives_connection_drop(run):
    """Transient socket drop: the dead connection is replaced, writers
    re-setup on the new socket, and the append retries — a store blip is
    NOT a permanent outage for the runtime."""

    async def main():
        broker = await FakePravega().start()
        rt = await _runtime(broker)
        try:
            producer = rt.create_producer("agent", "rs")
            await producer.start()
            await producer.write(SimpleRecord.of("before"))

            # sever the client's socket out from under it
            conn = await rt.client.conn()
            conn._writer.close()
            for _ in range(100):  # dispatch loop notices EOF → dead
                if conn.dead:
                    break
                await asyncio.sleep(0.02)
            assert conn.dead

            await producer.write(SimpleRecord.of("after"))  # reconnect path
            assert (await rt.client.conn()) is not conn

            consumer = rt.create_consumer("agent", "rs")
            await consumer.start()
            got = []
            for _ in range(50):
                got.extend(await consumer.read())
                if len(got) >= 2:
                    break
            assert sorted(r.value for r in got) == ["after", "before"]
            await consumer.close()
            await producer.close()
        finally:
            await rt.close()
            await broker.stop()

    run(main())


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------


def test_command_bytes_equal_jax():
    """Seeded segment-store commands and events encode to equal bytes in
    both packages, and each package decodes the other's alike."""
    import random
    import uuid

    from langstream_tpu.messaging import pravega_protocol as jax_wire

    rng = random.Random(0)
    for trial in range(8):
        segment = wire.SegmentName("langstream", f"s{rng.randrange(9)}", rng.randrange(4)).qualified
        events = b"".join(wire.frame_event(rng.randbytes(rng.randrange(0, 90)))
                          for _ in range(rng.randrange(1, 5)))
        writer = uuid.UUID(int=rng.getrandbits(128))
        commands = [
            ("hello", {}),
            ("setup_append", {"request_id": rng.randrange(10**6), "writer_id": writer,
                              "segment": segment}),
            ("append_block_end", {"writer_id": writer, "size_of_whole_events": len(events),
                                  "data": events, "num_events": 2,
                                  "last_event_number": rng.randrange(10**6),
                                  "request_id": rng.randrange(10**6)}),
            ("read_segment", {"segment": segment, "offset": rng.randrange(10**6),
                              "suggested_length": 1 << 20, "request_id": 5}),
            ("segment_read", {"segment": segment, "offset": 0, "at_tail": True,
                              "data": events, "request_id": 6}),
            ("stream_segment_info", {"request_id": 1, "segment": segment,
                                     "write_offset": len(events)}),
            ("truncate_segment", {"request_id": 2, "segment": segment, "offset": 8}),
            ("error_message", {"request_id": 3, "message": "é"}),
        ]
        for name, fields in commands:
            ours, theirs = wire.encode(name, fields), jax_wire.encode(name, fields)
            assert ours == theirs, (trial, name)
            type_, _ = wire.parse_frame_header(theirs[:8])
            assert wire.decode(type_, theirs[8:]) == jax_wire.decode(type_, ours[8:])
        assert list(wire.iter_events(events, 40)) == list(jax_wire.iter_events(events, 40))
        for key in (None, "a", f"k{rng.randrange(999)}"):
            assert wire.routing_key_segment(key, 4) == jax_wire.routing_key_segment(key, 4)


@pytest.mark.parametrize("client,fake", [("port", "jax"), ("jax", "port")])
def test_cross_package_exchange(client, fake, run):
    """Either package's client against the other's fake (its controller
    REST included): records, keys, headers, segments, byte offsets and the
    committed records folded from the subscription's metadata log equal the
    JAX client's against the JAX fake."""
    from torch_brokers import exchange

    got = run(exchange(client, fake, "pravega"))
    want = run(exchange("jax", "jax", "pravega"))
    assert got == want
    assert len(got["rows"]) == 24 and {p for _, p in got["partitions"]} == {0, 1}
    assert got["committed"] == {"records": 24, "committed": {"g": 24}}
