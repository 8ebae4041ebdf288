"""The port's parser, resolver and planner against the JAX package's on
every application under ``examples/applications``: equal applications
(topics, pipelines, agents, gateways, resources, resolved globals and
secrets) for every app, and equal execution plans (agent nodes after
fusion, connections, topics) for every app whose agent types the port has.
An app with an agent type the port does not have is refused by name
(``UnknownAgentType``), never planned into something else; every example
app plans. The ``camel-source`` app's timer pipeline and the
``kafka-connect`` app (against a stdlib Connect stub) run through the
port's ``run local``."""

import dataclasses
import enum
from pathlib import Path

import pytest

from langstream_tpu.core.parser import ModelBuilder as JaxModelBuilder
from langstream_tpu.core.planner import ClusterRuntime as JaxClusterRuntime
from langstream_tpu.core.resolver import resolve_placeholders as jax_resolve
from langstream_tpu_torch.core.parser import ModelBuilder
from langstream_tpu_torch.core.planner import ClusterRuntime
from langstream_tpu_torch.core.registry import REGISTRY, UnknownAgentType
from langstream_tpu_torch.core.resolver import resolve_placeholders

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
APPS = sorted(p for p in (EXAMPLES / "applications").iterdir() if p.is_dir())
INSTANCE = EXAMPLES / "instances" / "local-memory.yaml"
SECRETS = EXAMPLES / "secrets" / "secrets.yaml"
# the apps the port plans: every agent type they use is ported
PLANNED = {
    "astradb-sink", "azure-document-ingestion", "bedrock-text-completions", "camel-source",
    "chatbot-rag-memory", "chatbot-ui", "compute-tpu-embeddings", "docker-chatbot",
    "event-routing", "flare", "gateway-authentication", "http-request-processor", "kafka-connect",
    "langchain-chat", "langchain-document-loader", "langchain-source", "langserve-invoke",
    "language-router", "llamaindex-cassandra-sink", "moe-chat", "ollama-chatbot",
    "python-agent", "python-source-sink", "query-astradb", "query-milvus", "query-opensearch",
    "query-pinecone", "query-postgresql-chat-history", "query-solr", "rag-aws",
    "react-chatbot-ui", "s3-source", "slack", "text-completions", "text-processing",
    "tpu-completions", "tpu-rag", "vertexai-text-completions", "webcrawler-astra-vector-db",
    "webcrawler-source",
}


def plain(obj):
    """A package-neutral form: dataclasses as (class name, fields), enums
    as their values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def both(app_dir):
    jax_pkg = JaxModelBuilder.build_application_from_path(
        app_dir, instance_path=INSTANCE, secrets_path=SECRETS)
    port_pkg = ModelBuilder.build_application_from_path(
        app_dir, instance_path=INSTANCE, secrets_path=SECRETS)
    return jax_pkg, port_pkg


def test_every_example_app_is_covered():
    assert len(APPS) > 30
    assert PLANNED <= {p.name for p in APPS}
    # every example app plans through the port
    assert {p.name for p in APPS} - PLANNED == set()


@pytest.mark.parametrize("app_dir", APPS, ids=[p.name for p in APPS])
def test_applications_equal_jax(app_dir):
    jax_pkg, port_pkg = both(app_dir)
    assert port_pkg.digest == jax_pkg.digest
    assert plain(port_pkg.application) == plain(jax_pkg.application)
    assert plain(resolve_placeholders(port_pkg.application)) == plain(
        jax_resolve(jax_pkg.application))


@pytest.mark.parametrize("app_dir", APPS, ids=[p.name for p in APPS])
def test_execution_plans_equal_jax(app_dir):
    jax_pkg, port_pkg = both(app_dir)
    want = JaxClusterRuntime().build_execution_plan(
        app_dir.name, jax_resolve(jax_pkg.application))
    app = resolve_placeholders(port_pkg.application)
    if app_dir.name not in PLANNED:
        with pytest.raises(UnknownAgentType) as info:
            ClusterRuntime().build_execution_plan(app_dir.name, app)
        missing = str(info.value).split("'")[1]
        assert not REGISTRY.has_agent(missing)
        assert missing in {a.type for m in app.modules.values()
                            for p in m.pipelines.values() for a in p.agents}
        return
    got = ClusterRuntime().build_execution_plan(app_dir.name, app)
    assert plain(got) == plain(want)
    assert [n.id for n in got.agent_sequence()] == [n.id for n in want.agent_sequence()]


def _run_local(pkg, app_dir, secrets, work):
    """The app through ``pkg``'s local runner, ``work(runner)`` while it
    runs: the port's ``run local`` (a gateway on a free port, no metrics
    server), or JAX's ``LocalApplicationRunner`` over its own parse."""
    import asyncio

    import langstream_tpu.messaging.memory as jax_memory
    import langstream_tpu_torch.messaging.memory as port_memory

    async def main():
        jax_memory.MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        try:
            if pkg == "port":
                from langstream_tpu_torch.cli.main import start_local

                app = await start_local(app_dir, INSTANCE, secrets, gateway_port=0,
                                        metrics_port=-1)
                try:
                    return await work(app.runner)
                finally:
                    await app.stop()
            from langstream_tpu.runtime.local_runner import LocalApplicationRunner

            package = JaxModelBuilder.build_application_from_path(
                app_dir, instance_path=INSTANCE, secrets_path=secrets)
            runner = LocalApplicationRunner(app_dir.name, jax_resolve(package.application))
            await runner.deploy()
            await runner.start()
            try:
                return await work(runner)
            finally:
                await runner.stop()
        finally:
            jax_memory.MemoryBroker.reset()
            port_memory.MemoryBroker.reset()

    return asyncio.run(main())


def _record(r) -> tuple:
    """Key, value and headers, without the runner's random trace id."""
    return (r.key, r.value, [(h.key, h.value) for h in r.headers if h.key != "ls-trace-id"])


def test_camel_source_app_runs_its_timer():
    """camel-source's ``timer:tick?period=1000``: the first two ticks reach
    ``camel-out`` through the port's ``run local`` as they do through JAX's
    runner (values, keys, headers)."""
    import json

    async def work(runner):
        return [_record(r) for r in (await runner.consume("camel-out", n=2, timeout=10))[:2]]

    app = EXAMPLES / "applications" / "camel-source"
    got = _run_local("port", app, SECRETS, work)
    assert got == _run_local("jax", app, SECRETS, work)
    assert [json.loads(value) for _, value, _ in got] == [{"timer": "tick", "count": 1},
                                                          {"timer": "tick", "count": 2}]


def test_kafka_connect_app_against_a_connect_stub(tmp_path):
    """kafka-connect against one stdlib Connect REST stub, through the
    port's ``run local`` and JAX's runner: the same requests (method, path,
    body bytes, content type), so the same connectors, each with its bridge
    topic and without the agent's own keys; a record the source connector
    writes to its bridge reaches ``connect-out``, and a record on
    ``connect-in`` reaches the sink connector's bridge, in both."""
    import json

    from torch_http_stub import Stub

    connectors: dict = {}

    def put_config(call):
        connectors[call.match["name"]] = call.json()
        return 201, {}, {"name": call.match["name"], "config": call.json()}

    def status(call):
        return 200, {}, {"name": call.match["name"], "connector": {"state": "RUNNING"},
                         "tasks": [{"id": 0, "state": "RUNNING"}]}

    async def work(runner):
        await runner.produce("connect-source-bridge", "from the connector", key="k1")
        await runner.produce("connect-in", "to the connector", headers=[("h", "v")])
        out = await runner.consume("connect-out", n=1, timeout=10)
        bridged = await runner.consume("connect-sink-bridge", n=1, timeout=10)
        return _record(out[0]), _record(bridged[0])

    name = "(?P<name>[^/]+)"
    with Stub([("GET", "/", lambda call: (200, {}, {"version": "3.7.0-stub"})),
               ("PUT", f"/connectors/{name}/config", put_config),
               ("GET", f"/connectors/{name}/status", status)]) as stub:
        secrets = tmp_path / "secrets.yaml"
        secrets.write_text("secrets:\n  - id: kafka-connect\n    data:\n"
                           f"      rest-url: {stub.base}\n")
        runs = {}
        for pkg in ("jax", "port"):
            stub.calls.clear()
            connectors.clear()
            records = _run_local(pkg, EXAMPLES / "applications" / "kafka-connect", secrets, work)
            calls = [(c.method, c.path, c.body, c.headers.get("content-type"))
                     for c in stub.calls]
            runs[pkg] = (records, dict(connectors), calls)
    assert runs["port"] == runs["jax"]
    records, connectors, _ = runs["port"]
    assert records == (("k1", "from the connector", []),
                       (None, "to the connector", [("h", "v")]))
    # one connector an agent, named after the agent's id
    assert sorted(connectors) == ["ls-kafka-connect-sink-1", "ls-kafka-connect-source-0"]
    assert connectors["ls-kafka-connect-source-0"]["topic"] == "connect-source-bridge"
    assert connectors["ls-kafka-connect-sink-1"]["topics"] == "connect-sink-bridge"
    for config in connectors.values():
        assert "connect" not in config and "agent.type" not in config
        assert json.dumps(config)
