"""The port's gRPC bridge (``langstream_tpu_torch/grpc_runtime/bridge.py``)
against the JAX package's, across packages: each package's bridge drives
each package's child (four pairs) through ``process`` (plain, JSON and Avro
records, a failing record), ``read`` with commit and permanent failure,
``write`` (and a failing write) and ``agent_info``, with results equal
record for record and error texts included. Then the child's alias finder:
the port's child runs every example's user code and the test shims on the
port's SDK and loads no module of the JAX package, and a name the port
lacks is refused by name."""

import asyncio
import json
import subprocess
import types
from pathlib import Path

import pytest

from langstream_tpu.api import avro as jax_avro
from langstream_tpu.api.record import SimpleRecord as JaxRecord
from langstream_tpu.grpc_runtime import bridge as jax_bridge
from langstream_tpu_torch.api import avro
from langstream_tpu_torch.api.record import SimpleRecord
from langstream_tpu_torch.grpc_runtime import bridge
from langstream_tpu_torch.grpc_runtime.service import PortAlias

from test_avro import USER, USER_SCHEMA

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(Path(__file__).resolve().parent)
SHIMS = str(Path(TESTS) / "shims")
BRIDGES = {"jax": (jax_bridge, JaxRecord, jax_avro), "port": (bridge, SimpleRecord, avro)}
CHILDREN = {"jax": "langstream_tpu.grpc_runtime", "port": "langstream_tpu_torch.grpc_runtime"}
PAIRS = [(b, c) for b in BRIDGES for c in CHILDREN]


def spawning(child: str):
    """A stand-in for a bridge module's ``subprocess``: its ``Popen`` starts
    ``child``'s package's agent child instead of the bridge's own."""
    spawned = []

    def popen(args, **kw):
        args = [CHILDREN[child] if a in CHILDREN.values() else a for a in args]
        spawned.append(args[2])
        return subprocess.Popen(args, **kw)

    return types.SimpleNamespace(Popen=popen, PIPE=subprocess.PIPE,
                                 TimeoutExpired=subprocess.TimeoutExpired, spawned=spawned)


def _value(v):
    if type(v).__name__ == "AvroValue":
        return ("avro", v.schema.canonical(), v.data)
    return v


def _record(r):
    return (_value(r.key), _value(r.value), [(h.key, _value(h.value)) for h in r.headers],
            r.origin, r.timestamp)


def _error(e):
    return None if e is None else (type(e).__name__, str(e))


def _info(info: dict) -> dict:
    """An agent's info without what differs from run to run (the child's
    port, the last record's time)."""
    info = json.loads(json.dumps(info))
    info.get("metrics", {}).pop("last-processed-at", None)
    info.get("subprocess", {}).pop("port", None)
    return info


async def _until(predicate, what: str, timeout_s: float = 30.0):
    for _ in range(int(timeout_s / 0.02)):
        if predicate():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


async def _agent(mod, cls: str, type_: str, configuration: dict):
    agent = getattr(mod, cls)()
    agent.agent_id, agent.agent_type = f"{type_}-agent", type_
    await agent.init({"pythonPath": TESTS, **configuration})
    await asyncio.wait_for(agent.start(), 30)
    return agent


async def _scenario(which: str, tmp: Path, missing: Path) -> dict:
    mod, record, avro_mod = BRIDGES[which]
    out = {}
    schema = avro_mod.parse_schema(USER_SCHEMA)
    proc = await _agent(mod, "GrpcAgentProcessor", "python-processor",
                        {"className": "torch_grpc_user_agents.Mixed", "suffix": "?!"})
    try:
        batches = [
            [record.of("hello", key="k1", headers=[("h", 1)], timestamp=1.0),
             record.of("explode", timestamp=1.0),
             record.of({"structured": True}, timestamp=1.0),
             record.of(avro_mod.AvroValue(schema, dict(USER)), key="u", timestamp=1.0)],
            [record.of(avro_mod.AvroValue(schema, dict(USER, age=3)), timestamp=1.0)],
        ]
        out["process"] = []
        for batch in batches:
            results = await asyncio.wait_for(proc.process(batch), 30)
            out["process"].append([(_record(r.source_record), _error(r.error),
                                    [_record(o) for o in r.records]) for r in results])
        out["process_info"] = [_info(proc.agent_info()), _info(await proc.server.agent_info())]
    finally:
        await proc.close()
    log = tmp / "source.log"
    src = await _agent(mod, "GrpcAgentSource", "python-source",
                       {"className": "torch_grpc_user_agents.RecordingSource", "limit": 3,
                        "log": str(log)})
    try:
        got = []
        while len(got) < 3:
            got.extend(await asyncio.wait_for(src.read(), 30))
        await src.commit([got[0], got[2]])
        await src.permanent_failure(got[1], RuntimeError("no room"))
        await _until(lambda: log.exists() and len(log.read_text().splitlines()) == 3,
                     "the source's log")
        out["read"] = [_record(r) for r in got], log.read_text()
        out["read_info"] = _info(src.agent_info())
    finally:
        await src.close()
    path = tmp / "sink.txt"
    for target in (path, missing):
        sink = await _agent(mod, "GrpcAgentSink", "python-sink",
                            {"className": "grpc_user_agents.FileSink", "path": str(target)})
        try:
            errors = []
            for v in ("a", 2, {"j": [1]}):
                try:
                    await asyncio.wait_for(sink.write(record.of(v, timestamp=1.0)), 30)
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(_error(e))
            out[f"write {target.name}"] = errors
        finally:
            await sink.close()
    out["written"] = path.read_text()
    return out


@pytest.fixture(scope="module")
def pair_outputs(tmp_path_factory):
    """Every (bridge, child) pair's scenario output."""
    outputs = {}
    missing = tmp_path_factory.mktemp("none") / "no-such-dir" / "x.txt"
    with pytest.MonkeyPatch.context() as mp:
        for which, child in PAIRS:
            spawner = spawning(child)
            mp.setattr(BRIDGES[which][0], "subprocess", spawner)
            tmp = tmp_path_factory.mktemp(f"{which}-{child}")
            outputs[which, child] = asyncio.run(_scenario(which, tmp, missing))
            # one child for each of the four agents, all of the asked package
            assert spawner.spawned == [CHILDREN[child]] * 4
    return outputs


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{b}-bridge-{c}-child" for b, c in PAIRS])
def test_bridges_drive_children_as_jax(pair, pair_outputs):
    assert pair_outputs[pair] == pair_outputs["jax", "jax"]


def test_bridge_results(pair_outputs):
    """What the four pairs agree on is what the JAX package's tests expect."""
    out = pair_outputs["port", "port"]
    first, second = out["process"]
    assert first[0][2][0][:2] == ("k1", "hello?!") and first[0][1] is None
    assert first[1][1] == ("RuntimeError", "ValueError: asked to explode")
    assert first[2][2][0][1] == "{'structured': True}?!"
    assert first[3][2][0][1][2]["age"] == USER["age"] + 1
    assert second[0][2][0][1][2]["age"] == 4
    assert out["read"][1].splitlines() == ["commit item-1", "commit item-3",
                                           "failure item-2: RuntimeError: no room"]
    assert out["written"] == "a\n2\n{'j': [1]}\n"
    assert out["write x.txt"][0][1].startswith("FileNotFoundError: ")
    assert out["process_info"][0]["subprocess"] == {"alive": True}
    assert out["process_info"][1]["agent-id"] == "python-processor-agent"


def test_close_waits_off_the_loop():
    """``close()`` waits for the child on a worker thread: the loop keeps
    running while a child that ignores SIGTERM is waited for."""
    async def scenario():
        server = bridge.PythonGrpcServer("x.Y", {})
        server.process = subprocess.Popen(
            ["python3", "-c", "import signal, time; signal.signal(signal.SIGTERM, "
             "signal.SIG_IGN); print('ready', flush=True); time.sleep(30)"],
            stdout=subprocess.PIPE, text=True)
        server.process.stdout.readline()
        process = server.process
        ticks = 0

        async def tick():
            nonlocal ticks
            while True:
                await asyncio.sleep(0.05)
                ticks += 1

        ticker = asyncio.ensure_future(tick())
        await server.close()
        ticker.cancel()
        return process.returncode, ticks

    rc, ticks = asyncio.run(scenario())
    assert rc == -9  # terminate ignored, killed after 5 s
    assert ticks > 50


def test_alias_finder_answers_the_port_modules():
    import langstream_tpu_torch.api.agent as port_agent

    finder = PortAlias()
    spec = finder.find_spec("langstream_tpu.api.agent")
    assert spec.name == "langstream_tpu.api.agent"
    assert finder.create_module(spec) is port_agent
    assert finder.find_spec("langstream_tpu").submodule_search_locations is not None
    assert finder.find_spec("numpy") is None
    assert finder.find_spec("langstream_tpu_torch.api") is None
    with pytest.raises(ModuleNotFoundError) as info:
        finder.find_spec("langstream_tpu.api.no_such_module")
    assert info.value.name == "langstream_tpu.api.no_such_module"
    assert "langstream_tpu_torch.api.no_such_module" in str(info.value)


EXAMPLE_MODULES = {
    "python-agent": ["example_agent"],
    "python-source-sink": ["trio"],
    "langchain-chat": ["langchain_chat"],
    "langchain-document-loader": ["langchain_doc_loader"],
    "langchain-source": ["langchain_loader"],
    "llamaindex-cassandra-sink": ["llamaindex_sink"],
}
SHIM_MODULES = ["cassio", "langchain_core.prompts", "langchain_openai",
                "langchain_community.document_loaders", "llama_index.core",
                "llama_index.vector_stores.cassandra"]


def test_child_loads_no_jax_package_module():
    """Every example's user module and every shim (the llama_index one
    imports ``langstream_tpu.agents.vector.cassandra``) load in the port's
    child on the port's modules: no module of the JAX package is loaded,
    the user classes subclass the port's SDK, the card is hidden."""
    paths = [str(ROOT / "examples" / "applications" / app / "python")
             for app in EXAMPLE_MODULES] + [SHIMS]
    modules = [m for ms in EXAMPLE_MODULES.values() for m in ms] + SHIM_MODULES

    async def scenario():
        probe = await _agent(bridge, "GrpcAgentProcessor", "python-processor", {
            "className": "torch_grpc_user_agents.ModuleProbe", "paths": paths,
            "modules": modules, "jax-package": str(ROOT / "langstream_tpu")})
        try:
            (result,) = await asyncio.wait_for(probe.process([SimpleRecord.of("?")]), 30)
            # the same class under both names, checked in the child
            return json.loads(result.records[0].value)
        finally:
            await probe.close()

    report = asyncio.run(scenario())
    assert report["jax_package_modules"] == []
    assert report["sdk"] == "langstream_tpu_torch.api.agent"
    assert report["cuda_visible_devices"] == ""


def test_child_refuses_a_module_the_port_lacks():
    async def scenario():
        with pytest.raises(RuntimeError, match="exited before becoming ready"):
            await _agent(bridge, "GrpcAgentProcessor", "python-processor", {
                "className": "torch_grpc_user_agents.ModuleProbe",
                "modules": ["langstream_tpu.no_such_module"],
                "jax-package": str(ROOT / "langstream_tpu")})

    asyncio.run(scenario())


def test_plain_child_starts_without_torch():
    """A child whose user code needs no compute module never imports torch."""
    async def scenario():
        probe = await _agent(bridge, "GrpcAgentProcessor", "python-processor", {
            "className": "torch_grpc_user_agents.ModuleProbe",
            "jax-package": str(ROOT / "langstream_tpu")})
        try:
            (result,) = await asyncio.wait_for(probe.process([SimpleRecord.of("?")]), 30)
            return json.loads(result.records[0].value)
        finally:
            await probe.close()

    report = asyncio.run(scenario())
    assert report["torch"] is False and report["jax_package_modules"] == []
