"""The RAG example apps through both packages' local runners on the same
weights (tiny-test, f32, on the CPU; the port's ``tpu-serving`` resource and
local vector store given ``device: cpu``):

- ``tpu-rag``: the crawl pipeline crawls a stdlib test site
  (``torch_rag_site.py``), extracts, splits, embeds and indexes it; the
  index must hold the chunk count the port's text agents give over the
  site's reachable pages on the host, and the same (text, vector) rows as
  JAX's index; then questions go through the ``ask`` service gateway over
  HTTP, one at a time;
- ``chatbot-rag-memory``: its ``jdbc-table`` and ``vector-index`` assets
  deployed, two turns of one session (the second reads the first from the
  history table);
- ``flare``: questions through the FLARE loop (the completions step fills
  no logprobs, so every answer passes the controller).

The answer records must equal JAX's apart from the volatile ids (the
request and trace ids, the sink's ``fn:uuid()`` ids): the answers and the
retrieved and re-ranked texts exactly; embeddings, similarities and stored
vectors within ``EMBED_TOL`` (f32 encodes in XLA and in torch, summed in
other orders)."""

import asyncio
import dataclasses
import functools
import json
import shutil
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
from torch_rag_site import Site, make_pages

import langstream_tpu.core.parser as jax_parser
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.agents.text import TextExtractorAgent, TextSplitterAgent
from langstream_tpu_torch.api.record import SimpleRecord
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS

ROOT = Path(__file__).resolve().parents[1]
INSTANCE = ROOT / "examples" / "instances" / "local-memory.yaml"
SESSION = "langstream-client-session-id"
# per-run values: the service request id, the trace id, the stream id
VOLATILE_HEADERS = ("langstream-service-request-id", "ls-trace-id", "stream-id")
EMBED_TOL = 1e-5

JAX = types.SimpleNamespace(name="jax", parser=jax_parser, local=jax_local, memory=jax_memory)
PORT = types.SimpleNamespace(name="port", parser=port_parser, local=port_local,
                             memory=port_memory)


@functools.lru_cache(maxsize=None)
def configs():
    return (dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32"),
            dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32"))


@functools.lru_cache(maxsize=None)
def weights():
    jax_cfg, port_cfg = configs()
    tree = jax_init_params(jax_cfg, jax.random.PRNGKey(0))
    return tree, params_from_numpy(jax.tree.map(np.asarray, tree), port_cfg, device="cpu")


@pytest.fixture
def f32_presets(monkeypatch):
    monkeypatch.setitem(JAX_PRESETS, "tiny-test", configs()[0])
    monkeypatch.setitem(MODEL_PRESETS, "tiny-test", configs()[1])


@pytest.fixture(autouse=True)
def _reset_brokers():
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()
    yield
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()


@pytest.fixture(scope="module")
def site():
    # short pages: three re-ranked chunks and the question fit tiny-test's
    # 1024 positions (the example's 512 holds no 400-character chunk x 3)
    s = Site(make_pages(seed=11, n=5, words_per_page=24))
    yield s
    s.close()


def _edit(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert old in text, f"{path.name} changed: {old!r} not found"
    path.write_text(text.replace(old, new))


def app_copy(tmp_path: Path, name: str) -> Path:
    """The example with ``device: cpu`` in its tpu-serving resource and in
    its local vector store (JAX's ignore the key), and tiny-test's whole
    1024 positions as the resource's ``max-seq-len``."""
    app = tmp_path / name
    shutil.copytree(ROOT / "examples" / "applications" / name, app)
    conf = app / "configuration.yaml"
    _edit(conf, "        tokenizer: byte\n", "        tokenizer: byte\n        device: cpu\n")
    _edit(conf, "        service: local-vector\n", "        service: local-vector\n"
          "        device: cpu\n")
    text = conf.read_text()
    conf.write_text(text.replace("        max-seq-len: 512\n", "        max-seq-len: 1024\n"))
    return app


def secrets_file(tmp_path: Path, pkg) -> Path:
    path = tmp_path / f"secrets-{pkg.name}.yaml"
    path.write_text(
        "secrets:\n"
        "  - id: vector-database\n    data:\n"
        f"      path: \"{tmp_path / ('vectors-' + pkg.name)}\"\n"
        "  - id: chat-history\n    data:\n"
        f"      url: \"jdbc:sqlite:{tmp_path / ('history-' + pkg.name + '.db')}\"\n")
    return path


async def deployed(pkg, app: Path, secrets: Path):
    package = pkg.parser.ModelBuilder.build_application_from_path(
        app, instance_path=INSTANCE, secrets_path=secrets)
    runner = pkg.local.LocalApplicationRunner("app", package.application)
    await runner.deploy()
    runner._service_registry.get_provider().holder._params = weights()[0 if pkg is JAX else 1]
    await runner.start()
    return runner


def _clean(record) -> dict:
    headers = {h.key: h.value for h in record.headers if h.key not in VOLATILE_HEADERS}
    return {"key": record.key, "value": json.loads(record.value), "headers": headers}


def _hold(got, want, path="value"):
    """Equal, floats within EMBED_TOL; the keys ``id`` and the volatile
    header names are not compared."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "id" and k not in VOLATILE_HEADERS:
                _hold(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= EMBED_TOL * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, path


def host_chunks(bodies: list[bytes]) -> list[str]:
    """The port's text-extractor and text-splitter (the example's settings)
    over each body, on the host."""
    async def run():
        extract, split = TextExtractorAgent(), TextSplitterAgent()
        await extract.init({})
        await split.init({"chunk_size": 400, "chunk_overlap": 50})
        out = []
        for body in bodies:
            text = (await extract.process_record(SimpleRecord.of(body)))[0]
            out += [r.value for r in await split.process_record(text)]
        return out

    return asyncio.run(run())


def _post(url: str, question: str) -> dict:
    request = urllib.request.Request(url, data=json.dumps({"value": question}).encode(),
                                     method="POST")
    with urllib.request.build_opener(urllib.request.ProxyHandler({})).open(
            request, timeout=300) as resp:
        return json.loads(resp.read())


RAG_QUESTIONS = ["what is a kernel?", "tell me about vector index pages"]


async def run_rag(pkg, tmp_path: Path, site: Site, expected: int):
    app = app_copy(tmp_path / pkg.name, "tpu-rag")
    _edit(app / "crawl.yaml", '      seed-urls: ["https://example.com/"]\n'
          '      allowed-domains: ["example.com"]\n',
          f'      seed-urls: ["{site.base}/p0.html"]\n      allowed-domains: ["127.0.0.1"]\n'
          "      min-time-between-requests: 0\n      max-error-count: 2\n")
    runner = await deployed(pkg, app, secrets_file(tmp_path, pkg))
    try:
        store = runner._service_registry.get_datasource("vdb")
        for _ in range(1200):
            rows = store._indexes.get("docs", {}).get("ids", [])
            if len(rows) >= expected:
                break
            await asyncio.sleep(0.1)
        idx = store._indexes["docs"]
        index = sorted((m["text"], idx["matrix"][i].tolist()) for i, m in enumerate(idx["meta"]))
        gateway = await runner.serve_gateway()
        url = f"{gateway.url}/api/gateways/service/default/app/ask?option:timeout=120"
        replies = [await asyncio.to_thread(_post, url, q) for q in RAG_QUESTIONS]
        await gateway.stop()
    finally:
        await runner.stop()
    return index, replies


def test_tpu_rag_equals_jax(tmp_path, f32_presets, site):
    reachable = [f"/p{i}.html" for i in range(5)] + ["/gz.html", "/doc.txt"]
    chunks = host_chunks([site.page(p) for p in reachable] + [site.page("/p3.html")])
    out = {pkg.name: asyncio.run(run_rag(pkg, tmp_path, site, len(chunks)))
           for pkg in (JAX, PORT)}
    (port_index, port_replies), (jax_index, jax_replies) = out["port"], out["jax"]
    assert len(port_index) == len(jax_index) == len(chunks)
    assert sorted(t for t, _ in port_index) == sorted(chunks)
    _hold([v for _, v in port_index], [v for _, v in jax_index])
    assert [t for t, _ in port_index] == [t for t, _ in jax_index]
    for got, want in zip(port_replies, jax_replies):
        got, want = got["record"], want["record"]
        got_value, want_value = json.loads(got["value"]), json.loads(want["value"])
        assert got_value["answer"] == want_value["answer"]
        assert got_value["context"] == want_value["context"] and len(got_value["context"]) == 3
        assert [r["text"] for r in got_value["related"]] == [
            r["text"] for r in want_value["related"]]
        _hold(got_value, want_value)
        assert {k: v for k, v in got["headers"].items() if k not in VOLATILE_HEADERS} == {
            k: v for k, v in want["headers"].items() if k not in VOLATILE_HEADERS}


async def chat(pkg, app: Path, secrets: Path, inbox: str, answers: str, questions: list):
    runner = await deployed(pkg, app, secrets)
    out = []
    try:
        for k, question in enumerate(questions):
            await runner.produce(inbox, question, headers=[(SESSION, "s0")])
            got = await runner.consume(answers, n=k + 1, timeout=120)
            out.append(_clean(got[k]))
    finally:
        await runner.stop()
    return out


def test_chatbot_rag_memory_equals_jax(tmp_path, f32_presets):
    questions = ["what did I ask?", "and now?"]
    out = {}
    for pkg in (JAX, PORT):
        app = app_copy(tmp_path / pkg.name, "chatbot-rag-memory")
        out[pkg.name] = asyncio.run(chat(pkg, app, secrets_file(tmp_path, pkg),
                                         "memory-questions", "memory-answers", questions))
        assert (tmp_path / f"vectors-{pkg.name}" / "docs.json").exists()  # the asset's index
    _hold(out["port"], out["jax"])
    second = out["port"][1]["value"]
    assert second["history"][0]["question"] == questions[0]
    assert second["history"][0]["answer"] == out["port"][0]["value"]["answer"]
    assert second["inserted"]["count"] == 1 and second["context"] == []


def _seed_index(path: Path, rows: int) -> None:
    """A ``docs`` index at tiny-test's width (``rows`` seeded rows) in the
    store's files: the app has no writer, and a query of a missing index
    fails."""
    from langstream_tpu_torch.agents.vector import LocalVectorDataSource

    rng = np.random.default_rng(5)
    store = LocalVectorDataSource({"path": str(path), "device": "cpu"})
    store.create_index("docs", configs()[1].d_model)
    if rows:
        store.upsert_many("docs", [f"r{i}" for i in range(rows)],
                          rng.standard_normal((rows, configs()[1].d_model)).astype(np.float32),
                          [{"text": f"fact number {i}"} for i in range(rows)])
    store.flush()


@pytest.mark.parametrize("rows", [0, 6])
def test_flare_equals_jax(tmp_path, f32_presets, rows):
    """Over an empty index the records are equal whole. Over seeded rows
    the generate step's prompt carries each hit's f32 similarity in all its
    digits, which the two packages' cosines differ in (within SIM_TOL), so
    the greedy answers of two different prompts are not compared there;
    every other field is."""
    questions = ["what is flare?", "retrieve again"]
    out = {}
    for pkg in (JAX, PORT):
        _seed_index(tmp_path / f"vectors-{pkg.name}", rows)
        app = app_copy(tmp_path / pkg.name, "flare")
        out[pkg.name] = asyncio.run(chat(pkg, app, secrets_file(tmp_path, pkg),
                                         "flare-questions", "flare-answers", questions))
    if rows:
        for record in out["port"] + out["jax"]:
            assert record["value"].pop("answer")
            assert len(record["value"]["context"]) == 5
    _hold(out["port"], out["jax"])
    assert all("flare-query" not in r["value"] for r in out["port"])
