"""Example apps through both packages' local runners on the same weights:
``tpu-completions`` (tiny-test) and ``moe-chat`` (tiny-moe-test), f32 on
the CPU, greedy. The port runs them through its own parser, planner,
memory broker, runner, text and GenAI agents and ``tpu-serving`` provider;
the records on the answers topic (the streamed chunks, their grouping and
headers) and on the debug topic (question, answer and the logged prompt)
must equal the JAX package's, apart from ids and timestamps (``stream-id``,
``ls-trace-id``, the logged ``trace-id``)."""

import asyncio
import dataclasses
import functools
import json
import shutil
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import langstream_tpu.core.parser as jax_parser
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS

ROOT = Path(__file__).resolve().parents[1]
INSTANCE = ROOT / "examples" / "instances" / "local-memory.yaml"
SESSION = "langstream-client-session-id"
# per-run values: the answer's stream id, the trace id, the record's time
VOLATILE = ("stream-id", "ls-trace-id")

JAX = types.SimpleNamespace(name="jax", parser=jax_parser, local=jax_local, memory=jax_memory)
PORT = types.SimpleNamespace(name="port", parser=port_parser, local=port_local,
                             memory=port_memory)


@functools.lru_cache(maxsize=None)
def configs(preset: str):
    return (dataclasses.replace(JAX_PRESETS[preset], dtype="float32"),
            dataclasses.replace(MODEL_PRESETS[preset], dtype="float32"))


@functools.lru_cache(maxsize=None)
def weights(preset: str):
    jax_cfg, port_cfg = configs(preset)
    tree = jax_init_params(jax_cfg, jax.random.PRNGKey(0))
    return tree, params_from_numpy(jax.tree.map(np.asarray, tree), port_cfg, device="cpu")


@pytest.fixture
def f32_presets(monkeypatch):
    for preset in ("tiny-test", "tiny-moe-test"):
        monkeypatch.setitem(JAX_PRESETS, preset, configs(preset)[0])
        monkeypatch.setitem(MODEL_PRESETS, preset, configs(preset)[1])


@pytest.fixture(autouse=True)
def _reset_port_broker():
    port_memory.MemoryBroker.reset()
    yield
    port_memory.MemoryBroker.reset()


def app_copy(tmp_path: Path, name: str) -> Path:
    """The example app with ``device: cpu`` in its ``tpu-serving`` resource
    (the port's provider runs on the card otherwise; JAX's ignores it)."""
    app = tmp_path / name
    shutil.copytree(ROOT / "examples" / "applications" / name, app)
    conf = app / "configuration.yaml"
    text = conf.read_text()
    assert "        tokenizer: byte\n" in text
    conf.write_text(text.replace("        tokenizer: byte\n",
                                 "        tokenizer: byte\n        device: cpu\n"))
    return app


def _record(record) -> dict:
    headers = {h.key: h.value for h in record.headers if h.key not in VOLATILE}
    return {"key": record.key, "value": record.value, "headers": headers}


def _debug(record) -> dict:
    out = _record(record)
    value = json.loads(out["value"])
    prompt = json.loads(value["prompt"])
    prompt["options"].pop("trace-id", None)
    value["prompt"] = prompt
    out["value"] = value
    return out


async def serve(pkg, app_dir: Path, preset: str, questions: list[str], inbox: str,
                answers: str, debug: str = ""):
    """Deploy the app on the package's local runner with the shared weights
    in its provider, ask each question in turn (its own session) and read
    the answer's chunks until its last one, then the debug records."""
    pkg.memory.MemoryBroker.reset()
    package = pkg.parser.ModelBuilder.build_application_from_path(
        app_dir, instance_path=INSTANCE)
    runner = pkg.local.LocalApplicationRunner("app", package.application)
    await runner.deploy()
    provider = runner._service_registry.get_provider()
    provider.holder._params = weights(preset)[0 if pkg is JAX else 1]
    await runner.start()
    chunks: dict[str, list] = {}
    try:
        seen = 0
        for k, question in enumerate(questions):
            session = f"s{k}"
            await runner.produce(inbox, question, headers=[(SESSION, session)])
            # each question's answer is whole before the next is asked: the
            # engines then admit the same groups (MoE rows share capacity)
            done = False
            while not done:
                got = await runner.consume(answers, n=seen + 1, timeout=120)
                for record in got[seen:]:
                    headers = {h.key: h.value for h in record.headers}
                    chunks.setdefault(headers[SESSION], []).append(_record(record))
                    done = done or (headers[SESSION] == session
                                    and headers.get("stream-last-message") == "true")
                seen = len(got)
        final = await runner.consume(debug, n=len(questions), timeout=60) if debug else []
    finally:
        await runner.stop()
    return chunks, [_debug(r) for r in final]


QUESTIONS = ["what is a tpu?", "say hello", "a question of some length about streaming"]


def test_tpu_completions_equal_jax(tmp_path, f32_presets):
    app = app_copy(tmp_path, "tpu-completions")
    out = {pkg.name: asyncio.run(serve(pkg, app, "tiny-test", QUESTIONS, "questions-topic",
                                       "answers-topic", "debug-topic"))
           for pkg in (JAX, PORT)}
    port_chunks, port_final = out["port"]
    jax_chunks, jax_final = out["jax"]
    assert port_chunks == jax_chunks
    assert port_final == jax_final
    assert len(port_final) == len(QUESTIONS)
    for k, record in enumerate(port_final):
        answer = "".join(c["value"] for c in port_chunks[f"s{k}"])
        assert record["value"]["answer"] == answer and answer
        assert record["value"]["question"] == QUESTIONS[k]
        indices = [int(c["headers"]["stream-index"]) for c in port_chunks[f"s{k}"]]
        assert indices == list(range(len(indices)))


def test_moe_chat_equal_jax(tmp_path, f32_presets):
    app = app_copy(tmp_path, "moe-chat")
    questions = QUESTIONS[:2]
    out = {pkg.name: asyncio.run(serve(pkg, app, "tiny-moe-test", questions, "moe-input",
                                       "moe-output"))
           for pkg in (JAX, PORT)}
    assert out["port"] == out["jax"]
    for k in range(len(questions)):
        stream = out["port"][0][f"s{k}"]
        assert stream[-1]["headers"]["stream-last-message"] == "true"
        assert "".join(c["value"] for c in stream)


def test_compute_embeddings_app_equals_jax(tmp_path, f32_presets):
    """The compute-tpu-embeddings app (document-to-json, then
    compute-ai-embeddings on the provider's embeddings service): the
    vectors on its output topic equal the JAX package's within f32."""
    app = tmp_path / "compute-tpu-embeddings"
    shutil.copytree(ROOT / "examples" / "applications" / "compute-tpu-embeddings", app)
    conf = app / "configuration.yaml"
    conf.write_text(conf.read_text().replace("        tokenizer: byte\n",
                                             "        tokenizer: byte\n        device: cpu\n"))
    texts = ["a first document", "the second one, a little longer than the first", "3"]

    async def run(pkg):
        pkg.memory.MemoryBroker.reset()
        package = pkg.parser.ModelBuilder.build_application_from_path(
            app, instance_path=INSTANCE)
        runner = pkg.local.LocalApplicationRunner("app", package.application)
        await runner.deploy()
        runner._service_registry.get_provider().holder._params = weights("tiny-test")[
            0 if pkg is JAX else 1]
        await runner.start()
        try:
            for text in texts:
                await runner.produce("texts-topic", text)
            out = await runner.consume("vectors-topic", n=len(texts), timeout=120)
        finally:
            await runner.stop()
        return [json.loads(r.value) for r in out]

    jax_out, port_out = (asyncio.run(run(pkg)) for pkg in (JAX, PORT))
    assert [v["text"] for v in port_out] == [v["text"] for v in jax_out] == texts
    for got, want in zip(port_out, jax_out):
        assert len(got["embeddings"]) == len(want["embeddings"]) == configs("tiny-test")[1].d_model
        np.testing.assert_allclose(got["embeddings"], want["embeddings"], atol=1e-5, rtol=1e-4)
