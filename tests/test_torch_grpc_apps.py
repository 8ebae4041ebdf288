"""The example apps whose steps are user Python, through both packages'
local runners: ``python-agent`` and ``python-source-sink`` (outputs equal
JAX's), the langchain and llama_index apps with ``tests/shims`` on the
child's ``PYTHONPATH`` (stdlib stubs for the remote model and the web page,
a fake Cassandra for the index; outputs equal JAX's), and JAX's
``test_python_processor_subprocess_crash_restart`` scenario through the
port: a child that dies mid-batch is restarted and the record comes back."""

import asyncio
import os
import shutil
import types
from contextlib import contextmanager
from pathlib import Path

import pytest
import yaml
from torch_http_stub import Stub

import langstream_tpu.core.parser as jax_parser
import langstream_tpu.core.resolver as jax_resolver
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.core.resolver as port_resolver
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu_torch.agents.vector.cassandra import CassandraDataSource
from langstream_tpu_torch.agents.vector.cql_fake import FakeCassandra
from langstream_tpu_torch.grpc_runtime.bridge import GrpcAgentProcessor

from test_grpc_agents import INSTANCE as PIPELINE_INSTANCE
from test_grpc_agents import PIPELINE_TEMPLATE

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
INSTANCE = EXAMPLES / "instances" / "local-memory.yaml"
TESTS = str(Path(__file__).resolve().parent)
SHIMS = str(Path(TESTS) / "shims")
JAX = types.SimpleNamespace(name="jax", parser=jax_parser, local=jax_local,
                            resolver=jax_resolver)
PORT = types.SimpleNamespace(name="port", parser=port_parser, local=port_local,
                             resolver=port_resolver)


@pytest.fixture(autouse=True)
def _reset_brokers():
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()
    yield
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()


@contextmanager
def shims_on_agent_path():
    """``tests/shims`` on ``PYTHONPATH``: the children (which inherit it)
    import langchain / llama_index from there."""
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = SHIMS + (os.pathsep + old if old else "")
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old


def secrets_file(tmp_path: Path, overrides: dict) -> Path:
    doc = yaml.safe_load((EXAMPLES / "secrets" / "secrets.yaml").read_text())
    for entry in doc["secrets"]:
        entry["data"] = {**entry["data"], **overrides.get(entry["id"], {})}
    path = tmp_path / "secrets.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


async def run_app(pkg, app: Path, secrets, scenario):
    package = pkg.parser.ModelBuilder.build_application_from_path(
        app, instance_path=INSTANCE, secrets_path=secrets)
    runner = pkg.local.LocalApplicationRunner(app.name, pkg.resolver.resolve_placeholders(
        package.application))
    await runner.deploy()
    await runner.start()
    try:
        return await scenario(runner)
    finally:
        await runner.stop()


def both(app: Path, scenario, secrets=None) -> dict:
    out = {}
    for pkg in (JAX, PORT):
        jax_memory.MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        out[pkg.name] = asyncio.run(run_app(pkg, app, secrets, scenario))
    return out


def test_python_agent_equals_jax():
    """16 keyed records through the example's own user code (its
    ``python/`` directory is the default ``pythonPath``)."""
    async def scenario(runner):
        for i in range(16):
            await runner.produce("input-topic", f"record {i}", key=f"k{i}")
        out = await runner.consume("output-topic", n=16, timeout=60)
        return [(r.key, r.value) for r in out[:16]]

    out = both(EXAMPLES / "applications" / "python-agent", scenario)
    assert out["port"] == out["jax"] == [(f"k{i}", f"record {i}!!") for i in range(16)]


def test_python_source_sink_equals_jax(tmp_path):
    """The source's 10 ticks, shouted by the processor, in the sink's file."""
    files = {}

    async def scenario(runner):
        path = files[runner.application_id]
        for _ in range(3000):
            if path.exists() and len(path.read_text().splitlines()) >= 10:
                break
            await asyncio.sleep(0.02)
        return path.read_text()

    out = {}
    for pkg in (JAX, PORT):
        app = tmp_path / pkg.name / "python-source-sink"
        shutil.copytree(EXAMPLES / "applications" / "python-source-sink", app)
        files[app.name] = tmp_path / f"{pkg.name}-out.txt"
        pipeline = app / "pipeline.yaml"
        text = pipeline.read_text()
        assert 'path: "/tmp/python-trio-out.txt"' in text
        pipeline.write_text(text.replace("/tmp/python-trio-out.txt", str(files[app.name])))
        jax_memory.MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        out[pkg.name] = asyncio.run(run_app(pkg, app, None, scenario))
    assert out["port"] == out["jax"] == "".join(f"TICK-{i}\n" for i in range(9, -1, -1))


def test_python_processor_crash_restart(tmp_path):
    """A child that dies with rc 13 mid-batch: the bridge restarts it, the
    batch fails, the errors policy redelivers, the record then succeeds;
    the restarted child is a new process."""
    marker = tmp_path / "crashed"
    pipeline = PIPELINE_TEMPLATE.format(class_name="grpc_user_agents.CrashOnce",
                                        python_path=TESTS, extra=f"marker-file: {marker}")
    package = port_parser.ModelBuilder.build_application_from_files(
        {"pipeline.yaml": pipeline}, PIPELINE_INSTANCE, None)

    async def scenario():
        runner = port_local.LocalApplicationRunner("py-test", package.application)
        await runner.deploy()
        await runner.start()
        try:
            (agent,) = [r.processor for r in runner.runners
                        if isinstance(r.processor, GrpcAgentProcessor)]
            first = agent.server.process.pid
            await runner.produce("input-topic", "die")
            out = await runner.consume("output-topic", n=1, timeout=60)
            return [r.value for r in out], first, agent.server.process.pid
        finally:
            await runner.stop()

    values, first, second = asyncio.run(scenario())
    assert values == ["survived:die"]
    assert marker.exists() and first != second


def _openai_stub(calls):
    def chat(call):
        body = call.json()
        calls.append(body)
        prompt = body["messages"][-1]["content"]
        return 200, {"Content-Type": "application/json"}, {
            "choices": [{"index": 0, "finish_reason": "stop",
                         "message": {"role": "assistant", "content": f"echo: {prompt}"}}]}

    return Stub([("POST", "/v1/chat/completions", chat)])


HTML_DOC = """<html><head><title>t</title><style>body {}</style></head>
<body><h1>LangStream TPU</h1><p>loader works</p>
<script>ignored()</script></body></html>"""


def _page_stub():
    return Stub([("GET", "/doc", lambda call: (200, {"Content-Type": "text/html"}, HTML_DOC))])


def test_langchain_chat_equals_jax(tmp_path):
    calls = []
    stub = _openai_stub(calls)

    async def scenario(runner):
        await runner.produce("lc-input", "what is a tpu?")
        out = await runner.consume("lc-output", n=1, timeout=60)
        return out[0].value

    try:
        secrets = secrets_file(tmp_path, {"open-ai": {"url": f"{stub.base}/v1",
                                                      "access-key": "sk-test"}})
        with shims_on_agent_path():
            out = both(EXAMPLES / "applications" / "langchain-chat", scenario, secrets)
    finally:
        stub.close()
    assert out["port"] == out["jax"] == "echo: what is a tpu?"
    assert calls[0] == calls[1]
    assert calls[1]["messages"][0]["role"] == "system"
    assert calls[1]["messages"][-1]["content"] == "what is a tpu?"


def test_langchain_source_equals_jax(tmp_path):
    stub = _page_stub()

    async def scenario(runner):
        out = await runner.consume("loaded-docs", n=1, timeout=60)
        return out[0].value, [(h.key, h.value) for h in out[0].headers
                              if h.key != "ls-trace-id"]  # a new id each run

    try:
        secrets = secrets_file(tmp_path, {"crawler": {"seed-url": f"{stub.base}/doc"}})
        with shims_on_agent_path():
            out = both(EXAMPLES / "applications" / "langchain-source", scenario, secrets)
    finally:
        stub.close()
    assert out["port"] == out["jax"]
    text, headers = out["port"]
    assert "loader works" in text and "LangStream TPU" in text and "ignored()" not in text
    assert ("source", f"{stub.base}/doc") in headers


def test_langchain_document_loader_equals_jax():
    stub = _page_stub()

    async def scenario(runner):
        await runner.produce("urls-topic", f"{stub.base}/doc")
        out = await runner.consume("docs-topic", n=1, timeout=60)
        return out[0].value

    try:
        with shims_on_agent_path():
            out = both(EXAMPLES / "applications" / "langchain-document-loader", scenario)
    finally:
        stub.close()
    assert out["port"] == out["jax"]
    assert "loader works" in out["port"]


def test_llamaindex_cassandra_sink_equals_jax(tmp_path):
    async def run(pkg):
        server = await FakeCassandra().start()
        secrets = secrets_file(tmp_path, {"astra": {"contact-points": server.contact_point,
                                                    "token": "AstraCS:test"}})

        async def scenario(runner):
            await runner.produce("docs-topic", "a document about tpus")
            ds = CassandraDataSource({"contact-points": server.contact_point})
            try:
                for _ in range(300):
                    try:
                        rows = await ds.fetch_data(
                            "SELECT row_id, body_blob FROM docs.llama_index", [])
                    except Exception:  # noqa: BLE001 — the table is not there yet
                        rows = []
                    if rows:
                        return rows
                    await asyncio.sleep(0.1)
                raise AssertionError("the document never reached the store")
            finally:
                await ds.close()

        try:
            with shims_on_agent_path():
                return await run_app(pkg, EXAMPLES / "applications" / "llamaindex-cassandra-sink",
                                     secrets, scenario)
        finally:
            await server.stop()

    out = {}
    for pkg in (JAX, PORT):
        jax_memory.MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        out[pkg.name] = asyncio.run(run(pkg))
    # the row id is the shim's uuid4
    bodies = {k: [(r["body_blob"], len(r["row_id"])) for r in rows] for k, rows in out.items()}
    assert bodies["port"] == bodies["jax"] == [("a document about tpus", 36)]
