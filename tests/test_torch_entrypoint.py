"""The port's pod entry point (``langstream_tpu_torch/entrypoint.py``) against
the JAX package's (``tests/test_entrypoint.py``): a pod configuration that
the port's deployer wrote boots the port's ``agent-runtime`` — a compute app,
then tpu-completions on tiny-test (``device: cpu``), whose answers equal the
JAX role's on the same pod configurations with one weight tree. A
multi-host follower opens no broker consumer. The ``gateway`` role serves a
chat over a Kafka fake through ``StoreApplicationProvider`` and answers 400
for an app on the in-memory broker."""

import asyncio
import json
import os
import socket
import urllib.request
from pathlib import Path

import pytest

import langstream_tpu.api.topics as jax_topics
import langstream_tpu.entrypoint as jax_entrypoint
import langstream_tpu.k8s.controllers as jax_controllers
import langstream_tpu.k8s.crds as jax_crds
import langstream_tpu.k8s.fake as jax_fake
import langstream_tpu_torch.api.topics as port_topics
import langstream_tpu_torch.entrypoint as port_entrypoint
import langstream_tpu_torch.k8s.controllers as port_controllers
import langstream_tpu_torch.k8s.crds as port_crds
import langstream_tpu_torch.k8s.fake as port_fake
from torch_brokers import JAX, PORT, SESSION, _final, _record, completions_app, f32_configs, \
    tiny_weights

COMPUTE = """
module: default
id: p
name: echo
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: upper
    type: compute
    input: input-topic
    output: output-topic
    configuration:
      fields:
        - name: value
          expression: "fn:uppercase(value)"
"""

ROOT_EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "applications"

CHAT = """
module: default
id: p
name: chat
topics:
  - name: questions-topic
    creation-mode: create-if-not-exists
  - name: answers-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: upper
    type: compute
    input: questions-topic
    output: answers-topic
    configuration:
      fields:
        - name: value
          expression: "fn:uppercase(value)"
"""

GATEWAYS = """
gateways:
  - id: chat
    type: chat
    parameters: [sessionId]
    chat-options:
      questions-topic: questions-topic
      answers-topic: answers-topic
      headers:
        - key: langstream-client-session-id
          value-from-parameters: sessionId
"""


def instance(kind: str = "memory", config: dict | None = None) -> str:
    lines = ["instance:", "  streamingCluster:", f"    type: {kind}"]
    if config:
        lines.append(f"    configuration: {json.dumps(config)}")
    lines += ["  computeCluster:", "    type: kubernetes", "  globals:",
              "    serving-model: tiny-test", ""]
    return "\n".join(lines)


def pod_configurations(files: dict, instance_text: str, crds=port_crds, fake=port_fake,
                       controllers=port_controllers, name: str = "podtest") -> list:
    """The deployer's pod configurations, one per Agent CR."""
    kube = fake.FakeKubeServer()
    controller = controllers.AppController(kube, controllers.InProcessJobExecutor(kube))
    app = crds.ApplicationCustomResource(
        name=name, namespace="langstream-default", tenant="default", package_files=files,
        instance_text=instance_text)
    kube.apply(app.to_manifest())
    assert controller.reconcile(app.to_manifest())["phase"] == "DEPLOYED"
    return [json.loads(kube.get("Secret", "langstream-default", a["spec"]["configSecretRef"])
                       ["stringData"]["pod-configuration"])
            for a in kube.list("Agent", "langstream-default")]


@pytest.fixture(autouse=True)
def _brokers(monkeypatch):
    monkeypatch.setenv("HTTP_HOST", "127.0.0.1")
    JAX.memory.MemoryBroker.reset()
    PORT.memory.MemoryBroker.reset()
    yield
    JAX.memory.MemoryBroker.reset()
    PORT.memory.MemoryBroker.reset()


def earliest(pkg):
    topics = jax_topics if pkg is JAX else port_topics
    return topics.TopicOffsetPosition(position="earliest")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def stop(tasks) -> None:
    for task in tasks:
        task.cancel()
    for task in tasks:
        try:
            await task
        except asyncio.CancelledError:
            pass


def test_deployer_pod_config_boots_agent_runtime():
    files = {"pipeline.yaml": COMPUTE}
    (pod,) = pod_configurations(files, instance())
    (jax_pod,) = pod_configurations(files, instance(), jax_crds, jax_fake, jax_controllers)
    assert json.dumps(pod) == json.dumps(jax_pod)
    assert pod["agent"]["agentType"] == "compute"
    assert pod["agent"]["input"]["topic"] == "input-topic"
    assert pod["streamingCluster"]["type"] == "memory"
    port = free_port()

    async def scenario():
        task = asyncio.create_task(port_entrypoint.run_agent_runtime({**pod, "httpPort": port}))
        runtime = PORT.memory.MemoryTopicConnectionsRuntime()
        await runtime.init({})
        reader = runtime.create_reader("output-topic", earliest(PORT))
        await reader.start()
        producer = runtime.create_producer("test", "input-topic")
        await producer.start()
        await producer.write(PORT.record.SimpleRecord.of("hello pod"))
        got = []
        for _ in range(200):
            got.extend((await reader.read()).records)
            if got:
                break
        info = await asyncio.to_thread(
            lambda: json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/info").read()))
        await stop([task])
        return got, info

    got, info = asyncio.run(scenario())
    assert got and got[0].value == "HELLO POD"
    assert info[0]["agent-id"] == pod["agent"]["agentId"]


async def _serve_pods(pkg, entrypoint, pods: list, questions: list) -> tuple[dict, list]:
    """Each pod's ``run_agent_runtime`` as a task on one loop (the package's
    in-process broker), each question asked in its own session and its
    answer's chunks read to the last, then the debug records."""
    tasks = [asyncio.create_task(entrypoint.run_agent_runtime({**p, "httpPort": 0}))
             for p in pods]
    runtime = pkg.memory.MemoryTopicConnectionsRuntime()
    await runtime.init({})
    producer = runtime.create_producer("test", "questions-topic")
    await producer.start()
    reader = runtime.create_reader("answers-topic", earliest(pkg))
    await reader.start()
    chunks: dict = {}
    try:
        for k, question in enumerate(questions):
            session = f"s{k}"
            await producer.write(pkg.record.SimpleRecord.of(question, headers=[(SESSION, session)]))
            done = False
            for _ in range(4000):
                for record in (await reader.read()).records:
                    headers = {h.key: h.value for h in record.headers}
                    chunks.setdefault(headers[SESSION], []).append(_record(record))
                    done = done or (headers[SESSION] == session
                                    and headers.get("stream-last-message") == "true")
                if done:
                    break
                if any(t.done() for t in tasks):
                    raise AssertionError(f"a pod ended: {[t for t in tasks if t.done()]}")
            assert done, f"no last answer message for {session}"
        debug = runtime.create_reader("debug-topic", earliest(pkg))
        await debug.start()
        final = []
        for _ in range(4000):
            final.extend((await debug.read()).records)
            if len(final) >= len(questions):
                break
    finally:
        await stop(tasks)
    return chunks, [_final(r) for r in final]


def test_tpu_completions_pods_match_jax(tmp_path, monkeypatch):
    """tpu-completions on tiny-test, f32, ``device: cpu``, its chat step
    given a card: the port's deployer writes a pod configuration for each
    of its two agents; the
    port's ``agent-runtime`` and the JAX package's, each booted on those
    configurations with one weight tree, stream the same answer chunks and
    write the same debug records."""
    from langstream_tpu.ai.tpu_serving import TpuServingProvider
    from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    jax_cfg, port_cfg = f32_configs()
    monkeypatch.setitem(JAX_PRESETS, "tiny-test", jax_cfg)
    monkeypatch.setitem(MODEL_PRESETS, "tiny-test", port_cfg)
    jax_tree, port_tree = tiny_weights()
    for cls, tree in ((TpuServingProvider, jax_tree), (TorchServingProvider, port_tree)):
        def init(self, config, _orig=cls.__init__, _tree=tree):
            _orig(self, config)
            self.holder._params = _tree

        monkeypatch.setattr(cls, "__init__", init)
    app = completions_app(tmp_path)
    files = {p.name: p.read_text() for p in app.glob("*.yaml")}
    # a card for the chat step, as the chip's k8s phase asks: its agent is a
    # StatefulSet of its own, fed by the converter's pod over a topic
    step = "  - name: chat\n    type: ai-chat-completions\n"
    files["pipeline.yaml"] = files["pipeline.yaml"].replace(
        step, step + '    resources:\n      tpu:\n        topology: "1"\n')
    pods = pod_configurations(files, instance())
    assert sorted(p["agent"]["agentType"] for p in pods) == [
        "ai-chat-completions", "document-to-json"]
    questions = ["what is a pod?", "say hello", "a longer question about the operator"]
    jax_out = asyncio.run(_serve_pods(JAX, jax_entrypoint, pods, questions))
    port_out = asyncio.run(_serve_pods(PORT, port_entrypoint, pods, questions))
    assert port_out == jax_out
    chunks, final = port_out
    assert sorted(chunks) == ["s0", "s1", "s2"] and len(final) == 3
    assert all(c[-1]["headers"]["stream-last-message"] == "true" for c in chunks.values())


def test_multihost_follower_opens_no_consumer(monkeypatch):
    """Process 1 of a two-pod replica serves /info as a mesh worker and
    never builds a topic runtime; with a tpu-serving resource it builds the
    provider's engine unstarted and replays over its SPMD channel; two
    tpu-serving resources are refused with the JAX package's text."""
    import langstream_tpu_torch.messaging.registry as registry
    import langstream_tpu_torch.parallel.spmd_serving as spmd
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    monkeypatch.setenv("LANGSTREAM_TPU_HOSTS", "2")
    monkeypatch.setenv("POD_NAME", "podtest-upper-1")

    def no_broker(*a, **k):
        raise AssertionError("a follower opened the broker")

    monkeypatch.setattr(registry, "get_topic_connections_runtime", no_broker)
    (pod,) = pod_configurations({"pipeline.yaml": COMPUTE}, instance())
    port = free_port()

    async def parked():
        task = asyncio.create_task(port_entrypoint.run_agent_runtime({**pod, "httpPort": port}))
        for _ in range(200):
            try:
                return await asyncio.to_thread(lambda: json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/info", timeout=1).read()))
            except OSError:
                await asyncio.sleep(0.05)
            finally:
                if task.done():
                    task.result()
        raise AssertionError("the follower never served /info")

    async def run_parked():
        try:
            return await parked()
        finally:
            await stop([t for t in asyncio.all_tasks() if t is not asyncio.current_task()])

    info = asyncio.run(run_parked())
    assert info == [{"agent-id": pod["agent"]["agentId"], "replica": 0, "role": "mesh-worker",
                     "process-index": 1, "spmd-serving": False}]

    calls = []
    monkeypatch.setattr(TorchCompletionsService, "build_engine",
                        lambda self, start=True: calls.append(("build", start)) or "engine")
    monkeypatch.setattr(TorchCompletionsService, "spmd_channel", lambda self: "channel")
    monkeypatch.setattr(spmd, "follower_loop", lambda e, c: calls.append(("loop", e, c)))
    serving = {"type": "tpu-serving", "name": "tpu", "configuration": {
        "model": "tiny-test", "device": "cpu", "mesh": {"data": 2}}}
    asyncio.run(port_entrypoint.run_agent_runtime(
        {**pod, "httpPort": 0, "resources": {"tpu": serving}}))
    assert calls == [("build", False), ("loop", "engine", "channel")]
    with pytest.raises(RuntimeError, match="a multi-host \\(tpu.hosts > 1\\) agent supports "
                                           "exactly one tpu-serving resource, found 2"):
        asyncio.run(port_entrypoint.run_agent_runtime(
            {**pod, "resources": {"a": serving, "b": serving}}))


def test_gateway_role_over_kafka(tmp_path, monkeypatch):
    """The ``gateway`` role over the control plane's disk store: a chat over
    the port's Kafka fake, answered by a pod the port's deployer configured,
    through ``StoreApplicationProvider``; an app on the in-memory broker is
    refused with 400, an unknown one with 404."""
    from langstream_tpu_torch.gateway.websocket import HandshakeError, connect
    from langstream_tpu_torch.messaging.kafka_fake import FakeKafkaBroker
    from langstream_tpu_torch.webservice.service import ApplicationService
    from langstream_tpu_torch.webservice.stores import LocalDiskApplicationStore
    from torch_control_plane import make_zip

    root = tmp_path / "store"
    gw_port = free_port()
    monkeypatch.setenv("STORAGE_ROOT", str(root))
    monkeypatch.setenv("GATEWAY_PORT", str(gw_port))

    async def scenario():
        broker = await FakeKafkaBroker().start()
        tasks = []
        try:
            kafka = instance("kafka", {"admin": {"bootstrap.servers": broker.bootstrap}})
            files = {"pipeline.yaml": CHAT, "gateways.yaml": GATEWAYS}
            service = ApplicationService(LocalDiskApplicationStore(f"{root}/apps"))
            await service.deploy("default", "chat-app", make_zip(files), kafka, None)
            await service.deploy("default", "mem-app", make_zip(files), instance(), None)
            (pod,) = pod_configurations(files, kafka, name="chat-app")
            tasks.append(asyncio.create_task(port_entrypoint.run_agent_runtime(
                {**pod, "httpPort": 0})))
            tasks.append(asyncio.create_task(port_entrypoint.run_gateway()))
            base = f"ws://127.0.0.1:{gw_port}/v1/chat/default"
            for _ in range(200):
                try:
                    ws = await connect(f"{base}/chat-app/chat?param:sessionId=s1")
                    break
                except OSError:
                    await asyncio.sleep(0.05)
            else:
                raise AssertionError("the gateway role never listened")
            await ws.send_str(json.dumps({"value": "hello over kafka"}))
            msg = await asyncio.wait_for(ws.receive(), 60)
            await ws.close()
            refused = {}
            for app_id in ("mem-app", "no-app"):
                with pytest.raises(HandshakeError) as e:
                    await connect(f"{base}/{app_id}/chat?param:sessionId=s2")
                refused[app_id] = e.value
            return json.loads(msg.data), refused
        finally:
            await stop(tasks)
            await broker.stop()

    answer, refused = asyncio.run(scenario())
    assert answer["record"]["value"] == "HELLO OVER KAFKA"
    assert answer["record"]["headers"][SESSION] == "s1"
    assert refused["mem-app"].status == 400
    assert "in-memory broker" in str(refused["mem-app"])
    assert refused["no-app"].status == 404


def test_entrypoint_roles_are_jax_roles():
    """The same eight roles, and an unknown one answers 2."""
    import inspect

    roles = ("agent-runtime", "control-plane", "gateway", "run-local", "operator",
             "deployer-runtime", "application-setup", "agent-code-download")
    for mod in (port_entrypoint, jax_entrypoint):
        source = inspect.getsource(mod.main)
        assert all(f'"{r}"' in source for r in roles)
    assert port_entrypoint.main(["no-such-role"]) == 2
    assert os.environ.get("POD_CONFIGURATION") is None


def test_a_pod_that_asks_for_no_card_runs_without_one(monkeypatch):
    """tpu-completions with a card on its chat step splits into two pods;
    both carry the ``tpu-serving`` resource. The converter's pod (no card
    asked, none visible) runs and converts without building the provider;
    the chat pod refuses the card it does not have."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    files = {p.name: p.read_text()
             for p in (ROOT_EXAMPLES / "tpu-completions").glob("*.yaml")}
    step = "  - name: chat\n    type: ai-chat-completions\n"
    files["pipeline.yaml"] = files["pipeline.yaml"].replace(
        step, step + '    resources:\n      tpu:\n        topology: "1"\n')
    pods = {p["agent"]["agentType"]: p for p in pod_configurations(files, instance())}
    convert, chat = pods["document-to-json"], pods["ai-chat-completions"]
    assert convert["resources"] == chat["resources"]

    async def scenario():
        task = asyncio.create_task(port_entrypoint.run_agent_runtime({**convert, "httpPort": 0}))
        runtime = PORT.memory.MemoryTopicConnectionsRuntime()
        await runtime.init({})
        reader = runtime.create_reader(convert["agent"]["output"]["topic"], earliest(PORT))
        await reader.start()
        producer = runtime.create_producer("test", "questions-topic")
        await producer.start()
        await producer.write(PORT.record.SimpleRecord.of("no card here"))
        got = []
        for _ in range(400):
            got.extend((await reader.read()).records)
            if got or task.done():
                break
        await stop([task])
        return got

    got = asyncio.run(scenario())
    assert got and json.loads(got[0].value) == {"question": "no card here"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(port_entrypoint.run_agent_runtime({**chat, "httpPort": 0}))


def test_lazy_provider_registry_builds_on_demand():
    """The pod's registry builds a resource when an agent first asks for it;
    the first one declared is still the default, and the eager registry
    (the local runner's) is unchanged."""
    from langstream_tpu_torch.ai.provider import ServiceProviderRegistry
    from langstream_tpu_torch.api.model import Application, Resource

    app = Application()
    for rid, rtype in (("vectors", "vector-database"), ("llm", "tpu-serving"),
                       ("other", "tpu-serving")):
        config = {"model": "tiny-test", "device": "cpu", "max-seq-len": 64}
        if rtype == "vector-database":
            config = {"service": "local-vector", "device": "cpu"}
        app.resources[rid] = Resource(id=rid, name=rid, type=rtype, configuration=config)
    lazy = ServiceProviderRegistry(app, lazy=True)
    assert lazy._providers == {} and lazy._datasources == {}
    assert lazy.get_provider() is lazy._providers["llm"]
    assert sorted(lazy._providers) == ["llm"] and sorted(lazy._datasources) == ["vectors"]
    assert lazy.get_provider("other") is lazy._providers["other"]
    with pytest.raises(ValueError, match="no AI service provider for resource 'vectors'"):
        lazy.get_provider("vectors")
    eager = ServiceProviderRegistry(app)
    assert sorted(eager._providers) == ["llm", "other"]
    assert eager.get_provider() is eager._providers["llm"]
    assert eager.get_datasource() is eager._datasources["vectors"]
    for registry in (lazy, eager):
        asyncio.run(registry.close())
