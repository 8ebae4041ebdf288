"""The port's memory broker and agent runtime held against the JAX
package's: the JAX package's broker and runtime tests
(``tests/test_memory_broker.py``, ``tests/test_runtime.py``) with the same
inputs through both packages — at-least-once delivery with contiguous-prefix
(ordered) commit, redelivery from the committed offset, key partitioning,
group assignment, reader positions, fusion, the errors policies,
replicas, sources and sinks, the ``/metrics`` + ``/info`` server and
pipelined reads. Each test runs one scenario in each package and requires
the same observations."""

import asyncio
import inspect
import json
import types
import urllib.request

import pytest

import langstream_tpu.api.agent as jax_agent
import langstream_tpu.api.doc as jax_doc
import langstream_tpu.api.record as jax_record
import langstream_tpu.api.topics as jax_topics
import langstream_tpu.core.parser as jax_parser
import langstream_tpu.core.registry as jax_registry
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.api.agent as port_agent
import langstream_tpu_torch.api.doc as port_doc
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.core.registry as port_registry
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local

JAX = types.SimpleNamespace(
    name="jax", agent=jax_agent, doc=jax_doc, record=jax_record, topics=jax_topics,
    parser=jax_parser, registry=jax_registry, memory=jax_memory, local=jax_local,
)
PORT = types.SimpleNamespace(
    name="port", agent=port_agent, doc=port_doc, record=port_record, topics=port_topics,
    parser=port_parser, registry=port_registry, memory=port_memory, local=port_local,
)
INSTANCE = "instance:\n  streamingCluster:\n    type: memory\n"


@pytest.fixture(autouse=True)
def _reset_port_broker():
    port_memory.MemoryBroker.reset()
    yield
    port_memory.MemoryBroker.reset()


def both(scenario):
    """The scenario's observations in each package (fresh brokers)."""
    out = {}
    for pkg in (JAX, PORT):
        pkg.memory.MemoryBroker.reset()
        out[pkg.name] = asyncio.run(scenario(pkg))
    return out["jax"], out["port"]


# -- the broker (tests/test_memory_broker.py) --------------------------------


def test_publish_and_consume():
    async def scenario(pkg):
        rt = pkg.memory.MemoryTopicConnectionsRuntime(pkg.memory.MemoryBroker.instance())
        consumer = rt.create_consumer("agent-1", "t")
        await consumer.start()
        producer = rt.create_producer("agent-1", "t")
        await producer.start()
        for i in range(5):
            await producer.write(pkg.record.SimpleRecord.of(i))
        records = await consumer.read()
        await consumer.commit(records)
        return [r.value for r in records], consumer.get_info()["committed"]

    jax, port = both(scenario)
    assert port == jax == ([0, 1, 2, 3, 4], {"0": 5})


def test_contiguous_prefix_commit():
    async def scenario(pkg):
        rt = pkg.memory.MemoryTopicConnectionsRuntime(pkg.memory.MemoryBroker.instance())
        consumer = rt.create_consumer("a", "t")
        await consumer.start()
        producer = rt.create_producer("a", "t")
        for i in range(4):
            await producer.write(pkg.record.SimpleRecord.of(i))
        records = await consumer.read()
        seen = []
        # out of order: offsets 1, 2 first — the committed offset stays 0
        for acked in ([records[1], records[2]], [records[0]], [records[3]]):
            await consumer.commit(acked)
            seen.append(consumer.get_info()["committed"]["0"])
        return seen

    jax, port = both(scenario)
    assert port == jax == [0, 3, 4]


def test_redelivery_after_restart():
    async def scenario(pkg):
        rt = pkg.memory.MemoryTopicConnectionsRuntime(pkg.memory.MemoryBroker.instance())
        consumer = rt.create_consumer("a", "t", {"group": "g"})
        await consumer.start()
        producer = rt.create_producer("a", "t")
        for i in range(3):
            await producer.write(pkg.record.SimpleRecord.of(i))
        records = await consumer.read()
        await consumer.commit([records[0]])  # only offset 0 committed
        await consumer.close()
        again = rt.create_consumer("a", "t", {"group": "g"})
        await again.start()
        return [r.value for r in await again.read()]

    jax, port = both(scenario)
    assert port == jax == [1, 2]


def test_keyed_records_partition_as_jax():
    async def scenario(pkg):
        broker = pkg.memory.MemoryBroker.instance()
        broker.create_topic("t", partitions=4)
        rt = pkg.memory.MemoryTopicConnectionsRuntime(broker)
        producer = rt.create_producer("a", "t")
        for i in range(16):
            await producer.write(pkg.record.SimpleRecord.of(i, key=f"key-{i % 5}"))
        return [[r.value for r in part.records] for part in broker.topics["t"].partitions]

    jax, port = both(scenario)
    assert port == jax
    assert sum(1 for part in port if part) > 1


def test_group_partition_split():
    async def scenario(pkg):
        broker = pkg.memory.MemoryBroker.instance()
        broker.create_topic("t", partitions=2)
        rt = pkg.memory.MemoryTopicConnectionsRuntime(broker)
        c1 = rt.create_consumer("a", "t", {"group": "g"})
        c2 = rt.create_consumer("a", "t", {"group": "g"})
        await c1.start()
        await c2.start()
        return list(c1._assigned), list(c2._assigned)

    jax, port = both(scenario)
    assert port == jax and sorted(port[0] + port[1]) == [0, 1]


def test_reader_positions():
    async def scenario(pkg):
        rt = pkg.memory.MemoryTopicConnectionsRuntime(pkg.memory.MemoryBroker.instance())
        producer = rt.create_producer("a", "t")
        for i in range(3):
            await producer.write(pkg.record.SimpleRecord.of(i))
        position = pkg.topics.TopicOffsetPosition
        earliest = rt.create_reader("t", position(position="earliest"))
        await earliest.start()
        first = await earliest.read()
        latest = rt.create_reader("t", position(position="latest"))
        await latest.start()
        await producer.write(pkg.record.SimpleRecord.of(99))
        second = await latest.read()
        return ([r.value for r in first.records], first.offset, first.record_offsets,
                [r.value for r in second.records], second.offset)

    jax, port = both(scenario)
    assert port == jax and port[0] == [0, 1, 2] and port[3] == [99]


# -- the runtime (tests/test_runtime.py) -------------------------------------


def _agents(pkg) -> types.SimpleNamespace:
    """The JAX runtime tests' agents, built on the package's SPI and
    registered in its registry."""
    spi, rec = pkg.agent, pkg.record

    class Upper(spi.SingleRecordProcessor):
        async def process_record(self, record):
            return [rec.SimpleRecord.copy_from(record, value=str(record.value).upper())]

    class Explode(spi.SingleRecordProcessor):
        async def process_record(self, record):
            return [rec.SimpleRecord.copy_from(record, value=part)
                    for part in str(record.value).split(",")]

    class FailNTimes(spi.SingleRecordProcessor):
        fails_left: dict = {}

        async def init(self, configuration):
            self._fail_values = set(configuration.get("fail-values", []))
            self._times = int(configuration.get("times", 1000))

        async def process_record(self, record):
            if record.value in self._fail_values:
                left = FailNTimes.fails_left.setdefault(record.value, self._times)
                if left > 0:
                    FailNTimes.fails_left[record.value] = left - 1
                    raise ValueError(f"boom on {record.value}")
            return [record]

    class BadRecord(spi.SingleRecordProcessor):
        async def init(self, configuration):
            self._bad = set(configuration.get("bad-values", []))

        async def process_record(self, record):
            if record.value in self._bad:
                raise spi.BadRecordError(f"bad record {record.value}")
            return [record]

    class Gated(spi.SingleRecordProcessor):
        gate = None
        started: list = []

        async def process_record(self, record):
            Gated.started.append(str(record.value))
            if str(record.value).startswith("slow") and Gated.gate is not None:
                await Gated.gate.wait()
            return [record]

    for type_, cls, composable in (
        ("t-upper", Upper, True), ("t-explode", Explode, True),
        ("t-fail-n-times", FailNTimes, True), ("t-bad-record", BadRecord, True),
        ("t-gated", Gated, False),
    ):
        pkg.registry.REGISTRY.register_agent(pkg.registry.AgentTypeInfo(
            type=type_, component_type=spi.ComponentType.PROCESSOR, factory=cls,
            composable=composable, config_model=pkg.doc.ConfigModel(type=type_,
                                                                    allow_unknown=True),
        ))
    return types.SimpleNamespace(fail=FailNTimes, gated=Gated)


AGENTS = {pkg.name: _agents(pkg) for pkg in (JAX, PORT)}


def make_app(pkg, pipeline: str):
    return pkg.parser.ModelBuilder.build_application_from_files(
        {"pipeline.yaml": pipeline}, instance_text=INSTANCE).application


async def run_app(pkg, pipeline, produce, expect_topic, expect_n, timeout=10.0):
    runner = pkg.local.LocalApplicationRunner("test-app", make_app(pkg, pipeline))
    await runner.run()
    for topic, value, key in produce:
        await runner.produce(topic, value, key=key)
    try:
        records = await runner.consume(expect_topic, expect_n, timeout=timeout)
    finally:
        await runner.stop()
    return records, runner


TOPICS = """id: p
topics:
  - name: in-t
    creation-mode: create-if-not-exists
  - name: out-t
    creation-mode: create-if-not-exists
"""


def test_end_to_end_pipeline():
    pipeline = TOPICS + "pipeline:\n  - type: t-upper\n    id: up\n    input: in-t\n" \
                        "    output: out-t\n"

    async def scenario(pkg):
        records, _ = await run_app(pkg, pipeline, [("in-t", "hello", None),
                                                   ("in-t", "world", None)], "out-t", 2)
        return [r.value for r in records]

    jax, port = both(scenario)
    assert port == jax == ["HELLO", "WORLD"]


def test_fused_chain_end_to_end():
    pipeline = TOPICS + """pipeline:
  - type: t-explode
    id: ex
    input: in-t
  - type: t-upper
    id: up
  - type: identity
    id: idn
    output: out-t
"""

    async def scenario(pkg):
        records, runner = await run_app(pkg, pipeline, [("in-t", "a,b,c", None)], "out-t", 3)
        info = runner.agents_info()
        return ([r.value for r in records], len(runner.runners),
                info[0]["records-in"], info[0]["records-out"])

    jax, port = both(scenario)
    assert port == jax == (["A", "B", "C"], 1, 1, 3)


def test_source_commit_after_sink_write():
    """Ordered commit: the source offset advances only after every sink
    write of its record landed."""
    pipeline = TOPICS + "pipeline:\n  - type: t-explode\n    id: ex\n    input: in-t\n" \
                        "    output: out-t\n"

    async def scenario(pkg):
        runner = pkg.local.LocalApplicationRunner("app", make_app(pkg, pipeline))
        await runner.run()
        await runner.produce("in-t", "1,2,3")
        out = await runner.consume("out-t", 3)
        await runner.wait_for_records_out("ex", 3)
        agent = runner.runners[0]
        await agent.wait_for_no_pending_records()
        committed = agent.source.consumer.get_info()["committed"]
        await runner.stop()
        return [r.value for r in out], committed

    jax, port = both(scenario)
    assert port == jax == (["1", "2", "3"], {"0": 1})


def _errors_pipeline(policy: str, retries: int, agent: str, config: str) -> str:
    return TOPICS + f"""errors:
  on-failure: {policy}
  retries: {retries}
pipeline:
  - type: {agent}
    id: br
    input: in-t
    output: out-t
    configuration:
{config}"""


def test_errors_skip():
    pipeline = _errors_pipeline("skip", 0, "t-bad-record", "      bad-values: [\"poison\"]\n")

    async def scenario(pkg):
        records, runner = await run_app(
            pkg, pipeline, [("in-t", "ok1", None), ("in-t", "poison", None),
                            ("in-t", "ok2", None)], "out-t", 2)
        return [r.value for r in records], runner.agents_info()[0]["failures"]

    jax, port = both(scenario)
    assert port == jax == (["ok1", "ok2"], 1)


def test_errors_retry_then_success():
    pipeline = _errors_pipeline("fail", 3, "t-fail-n-times",
                                "      fail-values: [\"flaky\"]\n      times: 2\n")

    async def scenario(pkg):
        AGENTS[pkg.name].fail.fails_left.clear()
        records, runner = await run_app(pkg, pipeline, [("in-t", "flaky", None)], "out-t", 1)
        return [r.value for r in records], AGENTS[pkg.name].fail.fails_left["flaky"]

    jax, port = both(scenario)
    assert port == jax == (["flaky"], 0)


def test_errors_dead_letter():
    pipeline = _errors_pipeline("dead-letter", 0, "t-bad-record",
                                "      bad-values: [\"poison\"]\n")

    async def scenario(pkg):
        runner = pkg.local.LocalApplicationRunner("app", make_app(pkg, pipeline))
        await runner.run()
        await runner.produce("in-t", "ok")
        await runner.produce("in-t", "poison")
        good = await runner.consume("out-t", 1)
        dead = await runner.consume("in-t-deadletter", 1)
        await runner.stop()
        return (good[0].value, dead[0].value,
                pkg.record.header_value(dead[0], "error-msg"),
                sorted(h.key for h in dead[0].headers))

    jax, port = both(scenario)
    assert port == jax and port[:2] == ("ok", "poison") and "bad record" in port[2]


def test_errors_fail_crashes_application():
    pipeline = _errors_pipeline("fail", 0, "t-bad-record", "      bad-values: [\"poison\"]\n")

    async def scenario(pkg):
        runner = pkg.local.LocalApplicationRunner("app", make_app(pkg, pipeline))
        await runner.run()
        await runner.produce("in-t", "poison")
        await asyncio.sleep(0.3)
        try:
            await runner.stop(drain=False)
        except RuntimeError as e:
            return str(e).split(":")[0]
        return "stopped"

    jax, port = both(scenario)
    assert port == jax == "application failed"


def test_parallelism_replicas():
    pipeline = """id: p
topics:
  - name: in-t
    creation-mode: create-if-not-exists
    partitions: 2
  - name: out-t
    creation-mode: create-if-not-exists
pipeline:
  - type: t-upper
    id: up
    input: in-t
    output: out-t
    resources:
      parallelism: 2
"""

    async def scenario(pkg):
        runner = pkg.local.LocalApplicationRunner("app", make_app(pkg, pipeline))
        await runner.run()
        for i in range(10):
            await runner.produce("in-t", f"v{i}", key=f"k{i}")
        records = await runner.consume("out-t", 10)
        per_replica = [r._records_in for r in runner.runners]
        await runner.stop()
        return sorted(r.value for r in records), per_replica

    jax, port = both(scenario)
    assert port == jax and len(port[0]) == 10 and all(n > 0 for n in port[1])


def test_source_to_sink_agents():
    pipeline = """id: p
pipeline:
  - type: list-source
    id: src
    configuration:
      items: ["a", "b"]
  - type: t-upper
    id: up
  - type: collect-sink
    id: snk
"""

    async def scenario(pkg):
        runner = pkg.local.LocalApplicationRunner("app", make_app(pkg, pipeline))
        await runner.run()
        await runner.wait_for_records_out("src", 2)
        await runner.stop()
        collected = [x.value for r in runner.runners
                     if r.sink is not None and hasattr(r.sink, "collected")
                     for x in r.sink.collected]
        return sorted(collected), [r.node.id for r in runner.runners]

    jax, port = both(scenario)
    assert port == jax and port[0] == ["A", "B"]


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def test_metrics_info_http_server():
    """/metrics (Prometheus text) and /info (agent status): the port's
    runner serves them through its runtime HTTP server."""
    pipeline = (
        "module: default\nid: p\nname: m\ntopics:\n"
        "  - name: input-topic\n  - name: output-topic\n"
        "pipeline:\n  - name: echo\n    type: identity\n"
        "    input: input-topic\n    output: output-topic\n"
    )

    async def scenario(pkg):
        runner = pkg.local.LocalApplicationRunner("metrics-test", make_app(pkg, pipeline))
        await runner.deploy()
        await runner.start()
        server = runner.serve_metrics()
        if inspect.isawaitable(server):
            server = await server
        try:
            await runner.produce("input-topic", "x")
            await runner.consume("output-topic", n=1, timeout=10)
            status, body = await asyncio.to_thread(_get, f"{server.url}/metrics")
            info_status, info = await asyncio.to_thread(_get, f"{server.url}/info")
        finally:
            stopped = server.stop()
            if inspect.isawaitable(stopped):
                await stopped
            await runner.stop()
        info = json.loads(info)
        return (status, "# TYPE" in body.decode(), info_status,
                [(a["agent-id"], a["records-in"], a["records-out"]) for a in info])

    jax, port = both(scenario)
    assert port == jax and port[:3] == (200, True, 200)


def test_pipelined_read_no_batch_head_of_line():
    """A slow record of batch k does not keep batch k + 1 from starting;
    results still land in source order."""
    pipeline = """module: default
id: app
topics:
  - name: in-t
  - name: out-t
pipeline:
  - name: g
    type: t-gated
    input: in-t
    output: out-t
"""

    async def scenario(pkg):
        gated = AGENTS[pkg.name].gated
        gated.gate = asyncio.Event()
        gated.started = []
        runner = pkg.local.LocalApplicationRunner("test-app", make_app(pkg, pipeline))
        await runner.run()
        try:
            await runner.produce("in-t", "slow-1")
            for _ in range(50):
                if "slow-1" in gated.started:
                    break
                await asyncio.sleep(0.02)
            await runner.produce("in-t", "fast-2")
            for _ in range(100):
                if "fast-2" in gated.started:
                    break
                await asyncio.sleep(0.02)
            started = list(gated.started)
            gated.gate.set()
            records = await runner.consume("out-t", 2, timeout=10)
        finally:
            await runner.stop()
        return started, [str(r.value) for r in records]

    jax, port = both(scenario)
    assert port == jax == (["slow-1", "fast-2"], ["slow-1", "fast-2"])
