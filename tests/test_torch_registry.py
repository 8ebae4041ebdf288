"""The provider's runtime wiring in the port, against the JAX package's:
``core/registry.py``, ``ServiceProviderRegistry``, ``register()`` /
``register_providers()``, the local vector datasource's registration and
its ``LocalVectorWriter`` (with the port's expression language and
``MutableRecord.from_record``), the Prometheus side of ``api/metrics.py``,
the runtime server's ``/traces`` and ``/flight``, and
``tracing.device_trace``.

One JAX ``Application``, built by the JAX ``ModelBuilder`` from an app
directory with a ``tpu-serving`` resource and a ``local-vector``
datasource, is handed to both registries. Both providers then serve f32
tiny-test on the same weights (set on each holder, as the other provider
tests do), greedy: the text and the chunks are equal."""

import asyncio
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import yaml

from langstream_tpu.ai.provider import ServiceProviderRegistry as JaxRegistry
from langstream_tpu.api.metrics import MetricsReporter as JaxReporter
from langstream_tpu.api.record import Header, SimpleRecord
from langstream_tpu.core import ModelBuilder
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.ai.provider import ServiceProviderRegistry
from langstream_tpu_torch.api.metrics import MetricsReporter
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS

JCFG = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
CFG = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")

PIPELINE = """
topics:
  - name: in-t
    creation-mode: create-if-not-exists
  - name: out-t
    creation-mode: create-if-not-exists
pipeline:
  - name: convert
    type: document-to-json
    input: in-t
    output: out-t
    configuration:
      text-field: question
"""


@pytest.fixture(scope="module")
def application(tmp_path_factory):
    app = tmp_path_factory.mktemp("app")
    (app / "pipeline.yaml").write_text(PIPELINE)
    (app / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {"resources": [
        {"type": "tpu-serving", "name": "llm", "configuration": {
            "model": "tiny-test", "device": "cpu", "max-batch": 2, "max-seq-len": 64,
            "decode-chunk": 4, "prefill-buckets": [16, 32]}},
        {"type": "vector-database", "name": "vectors", "configuration": {
            "service": "local-vector", "device": "cpu"}},
    ]}}))
    instance = tmp_path_factory.mktemp("inst") / "instance.yaml"
    instance.write_text(yaml.safe_dump({"instance": {
        "streamingCluster": {"type": "memory"}, "computeCluster": {"type": "local"}}}))
    return ModelBuilder.build_application_from_path(app, instance_path=instance).application


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def test_registry_resolves_the_same_resources(application):
    from langstream_tpu_torch.agents.vector import LocalVectorDataSource
    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider
    from langstream_tpu_torch.core.registry import REGISTRY

    assert REGISTRY.resource("tpu-serving").factory is TorchServingProvider
    for rtype in ("datasource", "vector-database"):
        assert REGISTRY.resource(rtype).config_model.type == rtype
    assert REGISTRY.resource("no-such-type") is None
    jreg, treg = JaxRegistry(application), ServiceProviderRegistry(application)
    assert sorted(jreg._providers) == sorted(treg._providers) == ["llm"]
    assert sorted(jreg._datasources) == sorted(treg._datasources) == ["vectors"]
    assert isinstance(treg.get_provider("llm"), TorchServingProvider)
    assert isinstance(treg.get_datasource(), LocalVectorDataSource)
    asyncio.run(treg.close())
    asyncio.run(jreg.close())


def test_error_texts_equal_jax(application):
    jreg, treg = JaxRegistry(application), ServiceProviderRegistry(application)
    empty_j, empty_t = JaxRegistry(), ServiceProviderRegistry()
    for call in (lambda r: r.get_provider("nope"), lambda r: r.get_datasource("nope")):
        with pytest.raises(ValueError) as want:
            call(jreg)
        with pytest.raises(ValueError) as got:
            call(treg)
        assert str(got.value) == str(want.value)
    for call in (lambda r: r.get_provider(), lambda r: r.get_datasource()):
        with pytest.raises(ValueError) as want:
            call(empty_j)
        with pytest.raises(ValueError) as got:
            call(empty_t)
        assert str(got.value) == str(want.value)
    sentinel = object()
    empty_t.register("x", sentinel)
    empty_t.register_datasource("d", sentinel)
    assert empty_t.get_provider() is sentinel and empty_t.get_datasource("d") is sentinel


def test_provider_through_registries_gives_jax_tokens(application, weights):
    jprov = JaxRegistry(application).get_provider("llm")
    tprov = ServiceProviderRegistry(application).get_provider("llm")
    jprov.holder._model_config, jprov.holder._params = JCFG, weights[0]
    tprov.holder.model_config, tprov.holder._params = CFG, weights[1]

    async def run(prov):
        chunks = []
        svc = prov.get_completions_service({})
        res = await svc.get_text_completions(
            ["the quick brown fox"], {"max-tokens": 10, "temperature": 0,
                                      "min-chunks-per-message": 4}, chunks.append)
        await prov.close()
        return res.content, [(c.content, c.index, c.last) for c in chunks]

    want, got = asyncio.run(run(jprov)), asyncio.run(run(tprov))
    assert got == want


def _records():
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        value = {"text": f"doc {i}", "embeddings": rng.standard_normal(8).round(4).tolist(),
                 "n": i}
        out.append(SimpleRecord(key=json.dumps({"id": f"k{i}"}), value=json.dumps(value),
                                headers=[Header("src", "test")]))
    return out


def test_local_vector_writer_upserts_what_jax_upserts(application):
    from langstream_tpu.agents.vector import LocalVectorWriter as JaxWriter
    from langstream_tpu_torch.agents.vector import LocalVectorWriter

    jds = JaxRegistry(application).get_datasource("vectors")
    tds = ServiceProviderRegistry(application).get_datasource("vectors")
    config = {"index-name": "docs", "id": "key.id", "vector": "value.embeddings",
              "fields": [{"name": "text", "expression": "value.text"},
                         {"name": "twice", "expression": "value.n * 2"},
                         {"name": "src", "expression": "properties.src"}]}
    jw, tw = JaxWriter(jds, config), LocalVectorWriter(tds, config)

    async def run():
        for r in _records():
            await jw.upsert(r, {})
            await tw.upsert(r, {})
        q = json.dumps({"index": "docs", "vector": _records()[2].value and
                        json.loads(_records()[2].value)["embeddings"], "topK": 4})
        return await jds.fetch_data(q, []), await tds.fetch_data(q, [])

    want, got = asyncio.run(run())
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k != "similarity"} == {
            k: v for k, v in b.items() if k != "similarity"}
        assert abs(a["similarity"] - b["similarity"]) < 1e-5
    jidx, tidx = jds._indexes["docs"], tds._indexes["docs"]
    assert jidx["ids"] == tidx["ids"] and jidx["meta"] == tidx["meta"]
    n = len(jidx["ids"])
    np.testing.assert_allclose(tidx["matrix"][:n], jidx["matrix"][:n], rtol=0, atol=0)


def test_expression_language_and_from_record_equal_jax():
    from langstream_tpu.agents.genai import el as jel
    from langstream_tpu.agents.genai.mutable import MutableRecord as JaxMutable
    from langstream_tpu_torch.agents.genai import el
    from langstream_tpu_torch.agents.genai.mutable import MutableRecord

    for record in _records():
        j, t = JaxMutable.from_record(record), MutableRecord.from_record(record)
        assert (t.key, t.value, t.properties, t.origin, t.timestamp, t.destination_topic) == (
            j.key, j.value, j.properties, j.origin, j.timestamp, j.destination_topic)
        for expr in ("key.id", "value.embeddings", "value.n * 2 + 1", "value.text",
                     "fn:uppercase(value.text)", "properties.src",
                     "value.n > 2 ? 'big' : 'small'", "fn:concat(key.id, '-', value.n)"):
            assert el.evaluate(expr, t) == jel.evaluate(expr, j), expr


def test_prometheus_text_equals_jax():
    """The same operations on both reporters — labeled and plain counters,
    gauges, a prefix, and histograms loaded from an engine's snapshot —
    render the same exposition text."""
    from langstream_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine(CFG, params_from_numpy(jax.tree.map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(0))), CFG, device="cpu"),
        device="cpu", max_batch=2, max_seq_len=64, decode_chunk=4, prefill_buckets=(16, 32))
    engine.start()
    try:
        engine.generate([5, 6, 7], __import__(
            "langstream_tpu_torch.models.configs", fromlist=["x"]).GenerationOptions(
                max_new_tokens=6), timeout=60)
        hists = engine.stats()["histograms"]
    finally:
        engine.stop()
    texts = []
    for reporter in (JaxReporter("agent"), MetricsReporter("agent")):
        r = reporter.with_prefix("chat")
        r.counter("requests-total", "requests").count(3)
        r.counter("shed", "sheds", {"tenant": "a"}).count()
        r.counter("shed", "sheds", {"tenant": "b"}).count(2)
        r.gauge("queue.depth", "depth").set(7)
        for name, snap in sorted(hists.items()):
            h = r.histogram(name, f"{name} seconds", buckets=[b for b, _ in snap["buckets"]])
            h.load(snap)
        texts.append(reporter.prometheus_text())
    assert hists and texts[1] == texts[0]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_traces_and_flight_answer_as_jax():
    from langstream_tpu import tracing as jtracing
    from langstream_tpu.runtime.http_server import RuntimeHttpServer as JaxServer
    from langstream_tpu.serving import observability as jobs
    from langstream_tpu_torch import tracing
    from langstream_tpu_torch.runtime.http_server import RuntimeHttpServer
    from langstream_tpu_torch.serving import observability as tobs

    for tracer in (jtracing.TRACER, tracing.TRACER):
        for i in range(3):
            with tracer.span(f"op-{i}", attrs={"i": i}):
                pass
    jobs.FlightRecorder(capacity=4).dump("engine-restart", counters={"x": 1},
                                         extra={"restart": 1})
    tobs.FlightRecorder(capacity=4).dump("engine-restart", counters={"x": 1},
                                         extra={"restart": 1})
    port = RuntimeHttpServer(metrics_text=lambda: "", agents_info=lambda: [], port=0)
    port.start()
    loop = asyncio.new_event_loop()
    jserver = JaxServer(metrics_text=lambda: "", agents_info=lambda: [], port=0)
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(jserver.start(), loop).result(10)
    try:
        for query in ("", "?limit=2", "?limit=0", "?limit=-3", "?limit=abc"):
            js, jb = _get(jserver.url + "/traces" + query)
            ts, tb = _get(port.url + "/traces" + query)
            assert ts == js, query
            if js == 200:
                want, got = json.loads(jb), json.loads(tb)
                assert isinstance(got, list) and len(got) <= 200
                if query == "?limit=2":  # the newest two: the spans above
                    assert [s["name"] for s in got] == [s["name"] for s in want]
                    assert all(set(a) == set(b) for a, b in zip(got, want))
                elif query != "":
                    assert got == want == []
            else:
                assert tb == jb
        js, jb = _get(jserver.url + "/flight")
        ts, tb = _get(port.url + "/flight")
        assert ts == js == 200
        want, got = json.loads(jb)[-1], json.loads(tb)[-1]
        assert got["reason"] == want["reason"] == "engine-restart"
        assert set(got) == set(want) and got["extra"] == want["extra"]
    finally:
        port.stop()
        asyncio.run_coroutine_threadsafe(jserver.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    import torch

    from langstream_tpu_torch.tracing import device_trace

    with device_trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert traces and json.loads(traces[0].read_text())["traceEvents"]


# -- F13: every AI resource type of the examples is built, as in JAX ---------------

def _example_apps():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "examples"
    return root, sorted(p for p in (root / "applications").iterdir() if p.is_dir())


def _kinds(registry) -> dict:
    """resource id → (provider or datasource, class name), the port's
    serving provider named as JAX's."""
    rename = {"TorchServingProvider": "TpuServingProvider"}
    out = {rid: ("provider", rename.get(type(p).__name__, type(p).__name__))
           for rid, p in registry._providers.items()}
    out.update({rid: ("datasource", type(d).__name__)
                for rid, d in registry._datasources.items()})
    return out


@pytest.mark.parametrize("app_dir", _example_apps()[1], ids=lambda p: p.name)
def test_every_example_resource_builds_as_jax(app_dir):
    """F13: the port's registry builds a provider or datasource of the same
    kind as JAX's for every resource of every example app, and skips a
    resource exactly where JAX's does (the port's ``tpu-serving`` and local
    vector store take ``device: cpu`` here; JAX's ignore the key)."""
    from langstream_tpu.core.resolver import resolve_placeholders as jax_resolve
    from langstream_tpu_torch.core.parser import ModelBuilder as PortBuilder
    from langstream_tpu_torch.core.resolver import resolve_placeholders

    examples, _ = _example_apps()
    paths = {"instance_path": examples / "instances" / "local-memory.yaml",
             "secrets_path": examples / "secrets" / "secrets.yaml"}
    jax_app = jax_resolve(ModelBuilder.build_application_from_path(app_dir, **paths).application)
    port_app = resolve_placeholders(
        PortBuilder.build_application_from_path(app_dir, **paths).application)
    for resource in port_app.resources.values():
        if resource.type == "tpu-serving" or resource.configuration.get("service") in (
                "local-vector", None) and resource.type in ("vector-database", "datasource"):
            resource.configuration["device"] = "cpu"
    jreg, treg = JaxRegistry(jax_app), ServiceProviderRegistry(port_app)
    try:
        assert _kinds(treg) == _kinds(jreg)
        assert set(_kinds(treg)) <= set(port_app.resources)
    finally:
        asyncio.run(treg.close())
        asyncio.run(jreg.close())


@pytest.mark.parametrize("rtype,config", [
    ("mock-ai-configuration", {"response": "canned"}),
    ("open-ai-configuration", {"url": "http://127.0.0.1:9/v1", "access-key": "k"}),
    ("openai-compatible", {"url": "http://127.0.0.1:9/v1", "model": "llama3"}),
    ("bedrock-configuration", {"region": "us-east-1", "access-key": "a", "secret-key": "s"}),
    ("vertex-configuration", {"project": "p", "region": "us-central1", "token": "t"}),
])
def test_remote_provider_types_build_as_jax(tmp_path, rtype, config):
    """F13's direct cases: each of the five types the port lacked is built
    by the port's registry as a provider of JAX's class, and hands out its
    services."""
    app = tmp_path / "app"
    app.mkdir()
    (app / "pipeline.yaml").write_text(PIPELINE)
    (app / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {"resources": [
        {"type": rtype, "name": "remote", "configuration": config}]}}))
    instance = tmp_path / "instance.yaml"
    instance.write_text(yaml.safe_dump({"instance": {
        "streamingCluster": {"type": "memory"}, "computeCluster": {"type": "local"}}}))
    application = ModelBuilder.build_application_from_path(app, instance_path=instance).application
    jreg, treg = JaxRegistry(application), ServiceProviderRegistry(application)
    assert _kinds(treg) == _kinds(jreg) == {"remote": ("provider", _kinds(jreg)["remote"][1])}
    provider = treg.get_provider()
    assert type(provider).__module__.startswith("langstream_tpu_torch.ai.")
    assert provider.get_completions_service({}) is not None
    assert provider.get_embeddings_service({}) is not None
    asyncio.run(treg.close())
    asyncio.run(jreg.close())


PYTHON_TYPES = ["python-source", "python-processor", "python-sink", "python-service",
                "experimental-python-source", "experimental-python-processor",
                "experimental-python-sink", "experimental-python-service", "python-function"]


@pytest.mark.parametrize("type_", PYTHON_TYPES)
def test_python_agent_types_resolve_as_jax(type_):
    """The nine ``python-*`` types resolve in the port's registry to the
    port's gRPC bridge with JAX's component type, description and config
    model (``className`` required, ``pythonPath``, unknown keys allowed)."""
    from langstream_tpu.core.registry import REGISTRY as JAX_REGISTRY
    from langstream_tpu_torch.core.registry import REGISTRY

    jax_info, info = JAX_REGISTRY.agent(type_), REGISTRY.agent(type_)
    assert info.type == jax_info.type and info.aliases == jax_info.aliases
    assert info.component_type.value == jax_info.component_type.value
    assert info.description == jax_info.description
    assert info.composable == jax_info.composable
    assert dataclasses.asdict(info.config_model) == dataclasses.asdict(jax_info.config_model)
    assert info.factory.__module__ == "langstream_tpu_torch.grpc_runtime.bridge"
    assert info.factory.__name__ == jax_info.factory.__name__
    assert info.factory().component_type().value == info.component_type.value
