"""Rules of the PyTorch port, checked statically and at its entry points:
the package and chip_smoke.py import neither JAX nor the JAX package nor
aiohttp, requests, cryptography, PyYAML, click, cgi or bs4, and only the
gRPC agent runtime imports grpc and protobuf;
asking for CUDA where there is none raises instead of running on the CPU;
and the completions service streams text through the port's engine."""

import ast
import asyncio
import dataclasses
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "langstream_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_files_exist():
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in (
        "langstream_tpu_torch/models/transformer.py",
        "langstream_tpu_torch/ops/attention.py",
        "langstream_tpu_torch/serving/engine.py",
        "langstream_tpu_torch/serving/tenancy.py",
        "langstream_tpu_torch/serving/observability.py",
        "langstream_tpu_torch/api/metrics.py",
        "langstream_tpu_torch/tracing.py",
        "langstream_tpu_torch/agents/vector/__init__.py",
        "langstream_tpu_torch/serving/prefix_cache.py",
        "langstream_tpu_torch/ops/kvcopy.py",
        "langstream_tpu_torch/serving/wire.py",
        "langstream_tpu_torch/serving/durable.py",
        "langstream_tpu_torch/serving/migrate.py",
        "langstream_tpu_torch/serving/fleet.py",
        "langstream_tpu_torch/serving/lifecycle.py",
        "langstream_tpu_torch/runtime/http_server.py",
        "langstream_tpu_torch/core/registry.py",
        "langstream_tpu_torch/api/doc.py",
        "langstream_tpu_torch/agents/genai/el.py",
        "langstream_tpu_torch/agents/genai/mutable.py",
        "langstream_tpu_torch/parallel/mesh.py",
        "langstream_tpu_torch/parallel/multihost.py",
        "langstream_tpu_torch/parallel/sharding.py",
        "langstream_tpu_torch/parallel/spmd_serving.py",
        "langstream_tpu_torch/parallel/ring_attention.py",
        "langstream_tpu_torch/parallel/sp.py",
        "langstream_tpu_torch/api/record.py",
        "langstream_tpu_torch/api/topics.py",
        "langstream_tpu_torch/api/agent.py",
        "langstream_tpu_torch/api/model.py",
        "langstream_tpu_torch/api/planner.py",
        "langstream_tpu_torch/core/yaml_reader.py",
        "langstream_tpu_torch/core/parser.py",
        "langstream_tpu_torch/core/resolver.py",
        "langstream_tpu_torch/core/validator.py",
        "langstream_tpu_torch/core/planner.py",
        "langstream_tpu_torch/core/deployer.py",
        "langstream_tpu_torch/native.py",
        "langstream_tpu_torch/messaging/memory.py",
        "langstream_tpu_torch/messaging/registry.py",
        "langstream_tpu_torch/runtime/errors.py",
        "langstream_tpu_torch/runtime/tracker.py",
        "langstream_tpu_torch/runtime/topic_adapters.py",
        "langstream_tpu_torch/runtime/composite.py",
        "langstream_tpu_torch/runtime/runner.py",
        "langstream_tpu_torch/runtime/local_runner.py",
        "langstream_tpu_torch/agents/builtin.py",
        "langstream_tpu_torch/agents/text/__init__.py",
        "langstream_tpu_torch/agents/text/html.py",
        "langstream_tpu_torch/api/storage.py",
        "langstream_tpu_torch/agents/web/__init__.py",
        "langstream_tpu_torch/agents/vector/remote.py",
        "langstream_tpu_torch/agents/vector/milvus.py",
        "langstream_tpu_torch/agents/vector/cql_protocol.py",
        "langstream_tpu_torch/agents/vector/cassandra.py",
        "langstream_tpu_torch/agents/vector/cql_fake.py",
        "langstream_tpu_torch/agents/genai/steps.py",
        "langstream_tpu_torch/agents/genai/completions.py",
        "langstream_tpu_torch/agents/genai/embeddings.py",
        "langstream_tpu_torch/agents/genai/query.py",
        "langstream_tpu_torch/agents/genai/agent.py",
        "langstream_tpu_torch/gateway/core.py",
        "langstream_tpu_torch/gateway/server.py",
        "langstream_tpu_torch/gateway/websocket.py",
        "langstream_tpu_torch/cli/__main__.py",
        "langstream_tpu_torch/cli/main.py",
        "langstream_tpu_torch/auth.py",
        "langstream_tpu_torch/gateway/auth.py",
        "langstream_tpu_torch/runtime/http_client.py",
        "langstream_tpu_torch/ai/mock_provider.py",
        "langstream_tpu_torch/ai/openai_compat.py",
        "langstream_tpu_torch/ai/remote_cloud.py",
        "langstream_tpu_torch/agents/storage/__init__.py",
        "langstream_tpu_torch/agents/flow/__init__.py",
        "langstream_tpu_torch/agents/http/__init__.py",
        "langstream_tpu_torch/api/avro.py",
        "langstream_tpu_torch/grpc_runtime/__init__.py",
        "langstream_tpu_torch/grpc_runtime/__main__.py",
        "langstream_tpu_torch/grpc_runtime/agent_pb2.py",
        "langstream_tpu_torch/grpc_runtime/convert.py",
        "langstream_tpu_torch/grpc_runtime/service.py",
        "langstream_tpu_torch/grpc_runtime/bridge.py",
        "langstream_tpu_torch/agents/python_agents.py",
        "langstream_tpu_torch/runtime/log_stream.py",
        "langstream_tpu_torch/webservice/__init__.py",
        "langstream_tpu_torch/webservice/stores.py",
        "langstream_tpu_torch/webservice/service.py",
        "langstream_tpu_torch/webservice/docs.py",
        "langstream_tpu_torch/webservice/ui.py",
        "langstream_tpu_torch/webservice/server.py",
        "langstream_tpu_torch/cli/config.py",
        "langstream_tpu_torch/cli/client.py",
        "langstream_tpu_torch/cli/mermaid.py",
        "langstream_tpu_torch/messaging/kafka.py",
        "langstream_tpu_torch/messaging/kafka_protocol.py",
        "langstream_tpu_torch/messaging/kafka_fake.py",
        "langstream_tpu_torch/messaging/pulsar.py",
        "langstream_tpu_torch/messaging/pulsar_protocol.py",
        "langstream_tpu_torch/messaging/pulsar_fake.py",
        "langstream_tpu_torch/messaging/pravega.py",
        "langstream_tpu_torch/messaging/pravega_protocol.py",
        "langstream_tpu_torch/messaging/pravega_fake.py",
        "langstream_tpu_torch/messaging/fake_rest.py",
        "langstream_tpu_torch/messaging/fake_process.py",
        "langstream_tpu_torch/agents/connect.py",
        "chip_smoke.py",
    ):
        assert mod in rel


def test_chip_smoke_defines_each_name_once():
    """``chip_smoke.py`` is one long module of phases: a helper defined a
    second time replaces the first for every phase, and the phase that
    called the first fails only on the card."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    assert sorted({n for n in names if names.count(n) > 1}) == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax"), f"{path.name} imports {name}"
        assert top != "langstream_tpu", f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_safetensors_or_ml_dtypes(path):
    """The card's machine has neither package: no port module imports one,
    at module level or inside a function (the loader reads and writes the
    safetensors format itself, bf16 through 16-bit views)."""
    for name in imported_modules(path):
        assert name.split(".")[0] not in ("safetensors", "ml_dtypes"), (
            f"{path.name} imports {name}"
        )


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_aiohttp(path):
    """The card's machine has no aiohttp: the replica server and every
    client of the port are built on the stdlib (``http.server``,
    ``http.client``, ``urllib``)."""
    for name in imported_modules(path):
        assert name.split(".")[0] != "aiohttp", f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_requests(path):
    """The card's machine has no requests: the admin client and every other
    client of the port are on ``urllib`` / ``http.client``; and no module
    takes ``cgi`` (deprecated in 3.12, gone in 3.13): the control plane
    reads multipart forms itself."""
    for name in imported_modules(path):
        assert name.split(".")[0] not in ("requests", "cgi"), f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_cryptography(path):
    """The card's machine has no ``cryptography``: the port verifies RS256
    on the stdlib (``auth.py``: ``pow`` and the EMSA-PKCS1-v1_5 block, a
    minimal DER reader for PEM keys)."""
    for name in imported_modules(path):
        assert name.split(".")[0] != "cryptography", f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_yaml_or_click(path):
    """The card's machine has neither PyYAML nor click: the port reads
    application YAML with its own reader (``core/yaml_reader.py``) and its
    command line is argparse."""
    for name in imported_modules(path):
        assert name.split(".")[0] not in ("yaml", "click"), f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_bs4(path):
    """The card's machine has no BeautifulSoup: the port reads HTML on the
    stdlib ``html.parser`` (``agents/text/html.py``), for the text extractor
    and the crawler's links alike."""
    for name in imported_modules(path):
        assert name.split(".")[0] != "bs4", f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_grpc_only_in_the_agent_runtime(path):
    """``grpc`` and ``google.protobuf`` are imported only by the gRPC agent
    runtime (``grpc_runtime/``) and the python agent types that register
    it: every other module of the port imports without them."""
    rel = path.relative_to(ROOT).as_posix()
    allowed = rel.startswith("langstream_tpu_torch/grpc_runtime/") or (
        rel == "langstream_tpu_torch/agents/python_agents.py")
    for name in imported_modules(path):
        if name.split(".")[0] == "grpc" or name.startswith("google.protobuf"):
            assert allowed, f"{rel} imports {name}"


def test_no_cuda_raises(monkeypatch, tmp_path):
    """Every entry point that takes a device refuses "cuda" without a card."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.loader import load_params, save_params_hf
    from langstream_tpu_torch.models.streamload import load_params_streamed
    from langstream_tpu_torch.models.transformer import make_kv_cache, make_page_pool
    from langstream_tpu_torch.serving.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    params = init_params(cfg, torch.Generator(), device="cpu")
    save_params_hf(params, cfg, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_params(tmp_path, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_params_streamed(tmp_path, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchCompletionsService({"model": "tiny-test", "weights": str(tmp_path)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_page_pool(cfg, 4, 8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchCompletionsService({"model": "tiny-test"})


@pytest.mark.parametrize("app", ["tpu-completions", "gateway-authentication"])
def test_no_cuda_raises_at_run_local(monkeypatch, app):
    """``run local`` of an app whose ``tpu-serving`` resource names no
    device refuses the card it does not have when it deploys — behind a
    gateway with authentication too."""
    from langstream_tpu_torch.cli.main import start_local
    from langstream_tpu_torch.messaging.memory import MemoryBroker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(start_local(
            ROOT / "examples" / "applications" / app,
            ROOT / "examples" / "instances" / "local-memory.yaml",
            ROOT / "examples" / "secrets" / "secrets.yaml",
            gateway_port=0, metrics_port=-1,
        ))
    MemoryBroker.reset()


def test_no_cuda_raises_at_run_local_over_kafka(monkeypatch, tmp_path):
    """``run local`` of tpu-completions with ``streamingCluster.type:
    kafka`` (the production instance's broker, here the port's fake) refuses
    the card it does not have instead of serving on the CPU."""
    from langstream_tpu_torch.cli.main import start_local
    from langstream_tpu_torch.messaging.kafka_fake import FakeKafkaBroker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def main():
        broker = await FakeKafkaBroker().start()
        instance = tmp_path / "instance.yaml"
        instance.write_text(
            "instance:\n  streamingCluster:\n    type: kafka\n    configuration:\n"
            f"      admin:\n        bootstrap.servers: {broker.bootstrap}\n"
            "  computeCluster:\n    type: local\n"
            "  globals:\n    serving-model: tiny-test\n")
        try:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                await start_local(ROOT / "examples" / "applications" / "tpu-completions",
                                  instance, ROOT / "examples" / "secrets" / "secrets.yaml",
                                  gateway_port=0, metrics_port=-1)
        finally:
            await broker.stop()

    asyncio.run(main())


@pytest.mark.parametrize("app", ["tpu-completions", "gateway-authentication"])
def test_no_cuda_raises_at_a_control_plane_deploy(monkeypatch, app):
    """A deploy through the control plane of an app whose ``tpu-serving``
    resource names no device answers an error naming the card it does not
    have, and leaves no runner behind."""
    import json

    from langstream_tpu_torch.cli.client import AdminClient
    from langstream_tpu_torch.messaging.memory import MemoryBroker
    from torch_control_plane import Plane, http

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from langstream_tpu_torch.cli.client import multipart_body

    examples = ROOT / "examples"
    body, ctype = multipart_body({
        "app": ("app.zip", AdminClient.zip_app_dir(examples / "applications" / app), None),
        "instance": ("i.yaml", (examples / "instances" / "local-memory.yaml").read_bytes(), None),
        "secrets": ("s.yaml", (examples / "secrets" / "secrets.yaml").read_bytes(), None),
    })
    with Plane() as plane:
        status, _, data = http("POST", f"{plane.url}/api/applications/default/{app}", body,
                               {"Content-Type": ctype})
        assert status == 500 and "CUDA is not available" in json.loads(data)["error"]
        assert plane.runtime.get_runner("default", app) is None
    MemoryBroker.reset()


def test_no_cuda_raises_at_the_rag_entry_points(monkeypatch):
    """The provider, its embeddings service, the vector store and the dense
    prefix pool refuse "cuda" without a card, and serve the CPU when the
    caller asks for it."""
    from langstream_tpu_torch.agents.vector import LocalVectorDataSource
    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.kvcopy import gather_prefix_local, make_prefix_pool
    from langstream_tpu_torch.serving.prefix_cache import PrefixCachePool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MODEL_PRESETS["tiny-test"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchServingProvider({"model": "tiny-test"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalVectorDataSource({"path": None})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefixCachePool(cfg, 2, 16, (8, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_prefix_pool(cfg, 2, 16)
    pool = make_prefix_pool(cfg, 2, 16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gather_prefix_local(pool, 0, cfg, 16)
    provider = TorchServingProvider({"model": "tiny-test", "device": "cpu", "max-seq-len": 64})
    vectors = asyncio.run(provider.get_embeddings_service({}).compute_embeddings(["a", "b"]))
    assert len(vectors) == 2 and len(vectors[0]) == cfg.d_model
    store = LocalVectorDataSource({"device": "cpu"})
    store.upsert("i", "a", vectors[0], {})
    assert store.search("i", vectors[0], 1)[0]["id"] == "a"
    asyncio.run(provider.close())


def test_completions_service_streams_text():
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
        "page-size": 16, "kv-cache-quantization": "int8",
    })
    chunks = []
    try:
        result = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="hello")],
            {"max-tokens": 6, "min-chunks-per-message": 2},
            chunks.append,
        ))
        stats = svc.engine_stats()
    finally:
        svc.close()
    assert result.completion_tokens == 6 and result.finish_reason in ("length", "stop")
    assert chunks and chunks[-1].last
    assert "".join(c.content for c in chunks) == result.content
    assert svc.model_config.kv_cache_dtype == "int8"
    assert stats["kernels"]["paged_decode_int8"]["cpu_calls"] > 0


def test_completions_service_refuses_what_it_cannot_serve():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    with pytest.raises(FileNotFoundError, match="safetensors"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "weights": "/ckpt"})
    with pytest.raises(ValueError, match="kv-layout"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "kv-layout": "ring"})
    with pytest.raises(ValueError):
        TorchCompletionsService({"model": "no-such-model", "device": "cpu"})
    with pytest.raises(ValueError):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu",
                                 "kv-cache-quantization": "int4"})
    # ring prefill over a sequence axis is served since it was ported (the
    # mesh joins its ranks when the engine is built); any admit-group size
    # is served (MoE groups are padded to it)
    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu", "mesh": {"seq": 2},
                                   "kv-layout": "dense"})
    assert svc.mesh_axes == {"seq": 2} and svc.world == 2
    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu", "prefill-batch": 16})
    assert svc.prefill_batch == 16
    # the fleet keys are served since the fleet's HTTP hop was ported
    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu", "fleet": "auto",
                                   "fleet-role": "prefill", "fleet-replicas": []})
    assert svc.fleet and svc.fleet_role == "prefill"
    # the durable keys are served since the tier was ported
    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu", "durable": "auto",
                                   "durable-dir": "/d", "durable-max-bytes": 1 << 30})
    assert svc.durable == "auto" and svc.durable_dir == "/d"
    with pytest.raises(ValueError, match="brownout"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "brownout": "maybe"})
    with pytest.raises(ValueError, match="constrained-decoding"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu",
                                 "constrained-decoding": "maybe"})


def test_completions_service_default_max_seq_len():
    """max-seq-len defaults to min(2048, the preset's max_seq_len), as in
    the JAX provider: tiny-test's own cap at tiny-test (engine built),
    2048 for llama-3-8b (resolved only, nothing allocated)."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    tiny = MODEL_PRESETS["tiny-test"]
    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu"})
    try:
        assert svc.max_seq_len == min(2048, tiny.max_seq_len)
        assert svc.engine().max_seq_len == min(2048, tiny.max_seq_len)
    finally:
        svc.close()
    llama = TorchCompletionsService({"model": "llama-3-8b", "device": "cpu"})
    assert MODEL_PRESETS["llama-3-8b"].max_seq_len == 8192 and llama.max_seq_len == 2048
    assert llama._engine is None
