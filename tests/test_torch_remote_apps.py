"""The example apps this slice lets the port run, through both packages'
local runners on the same stdlib stubs (and, where an app serves
``tpu-serving``, the same tiny-test weights, f32 on the CPU, greedy) —
JAX's ``tests/test_examples_e2e.py`` stub scenarios, held port against JAX:

- remote models: ``ollama-chatbot`` (an OpenAI-compatible stub),
  ``bedrock-text-completions`` (SigV4-checked), ``vertexai-text-completions``;
- agents: ``http-request-processor``, ``s3-source``,
  ``azure-document-ingestion``, ``slack`` (summaries on ``tpu-serving``
  posted to a webhook), ``langserve-invoke``, ``language-router``,
  ``event-routing``;
- mixed: ``rag-aws`` (S3 ingest embedded on ``tpu-serving`` into the local
  store, then a question answered by a Bedrock stub from the retrieved
  context) and ``gateway-authentication`` (Google sign-in against a JWKS
  stub in front of a chat on ``tpu-serving``).

The records out must equal JAX's apart from the volatile ids (trace and
stream ids, the sink's ``fn:uuid()`` ids); embeddings within ``EMBED_TOL``
(f32 encodes summed in other orders). Each copy of an app gets ``device:
cpu`` in its ``tpu-serving`` resource and local store (JAX's ignore the
key) and, where its ``vector-index`` asset says ``dimension: 32``, tiny-test's
width (the example's 32 fits no served model: the store refuses a 64-wide
row into a 32-wide index)."""

import asyncio
import base64
import dataclasses
import functools
import json
import shutil
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import padding, rsa
from torch_http_stub import Stub

import langstream_tpu.core.parser as jax_parser
import langstream_tpu.core.resolver as jax_resolver
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.core.resolver as port_resolver
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.gateway import websocket as wsmod
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
INSTANCE = EXAMPLES / "instances" / "local-memory.yaml"
VOLATILE = ("ls-trace-id", "stream-id", "langstream-service-request-id")
EMBED_TOL = 1e-5

JAX = types.SimpleNamespace(name="jax", parser=jax_parser, local=jax_local, memory=jax_memory,
                            resolver=jax_resolver)
PORT = types.SimpleNamespace(name="port", parser=port_parser, local=port_local,
                             memory=port_memory, resolver=port_resolver)


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


# the objects stay in the bucket: in both packages' storage sources a
# commit's DELETE can land between the source's listing and its GET of the
# same object, and the GET's 404 fails the source, so the e2e runs read
# without deletes (the delete path is held in test_torch_flow_http_storage.py)
KEEP_OBJECTS = "      delete-objects: false\n"


def app_copy(tmp_path: Path, name: str, edits: dict | None = None) -> Path:
    """The example under ``tmp_path`` with the CPU edits (module
    docstring) and ``edits`` ({file: [(old, new)]}, each old text present)."""
    app = tmp_path / name
    shutil.copytree(EXAMPLES / "applications" / name, app)
    d_model = configs()[1].d_model
    for path in app.glob("*.yaml"):
        text = path.read_text()
        text = text.replace("        tokenizer: byte\n", "        tokenizer: byte\n"
                            "        device: cpu\n")
        text = text.replace("        service: local-vector\n", "        service: local-vector\n"
                            "        device: cpu\n")
        text = text.replace("      dimension: 32\n", f"      dimension: {d_model}\n")
        for old, new in (edits or {}).get(path.name, []):
            assert old in text, f"{name}/{path.name} changed: {old!r}"
            text = text.replace(old, new)
        path.write_text(text)
    return app


def secrets_file(tmp_path: Path, pkg, overrides: dict) -> Path:
    doc = yaml.safe_load((EXAMPLES / "secrets" / "secrets.yaml").read_text())
    overrides = {"vector-database": {"path": str(tmp_path / f"vectors-{pkg.name}")},
                 **overrides}
    for entry in doc["secrets"]:
        entry["data"] = {**entry["data"], **overrides.get(entry["id"], {})}
    path = tmp_path / f"secrets-{pkg.name}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


async def run_app(pkg, app: Path, secrets: Path, scenario):
    package = pkg.parser.ModelBuilder.build_application_from_path(
        app, instance_path=INSTANCE, secrets_path=secrets)
    runner = pkg.local.LocalApplicationRunner(app.name, pkg.resolver.resolve_placeholders(
        package.application))
    await runner.deploy()
    for provider in runner._service_registry._providers.values():
        if hasattr(provider, "holder"):  # tpu-serving: the shared weights
            provider.holder._params = weights()[0 if pkg is JAX else 1]
    await runner.start()
    try:
        return await scenario(runner)
    finally:
        await runner.stop()


def both(tmp_path: Path, name: str, overrides: dict, scenario, edits=None) -> dict:
    out = {}
    for pkg in (JAX, PORT):
        jax_memory.MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        app = app_copy(tmp_path / pkg.name, name, edits)
        out[pkg.name] = asyncio.run(run_app(pkg, app, secrets_file(tmp_path, pkg, overrides),
                                            scenario))
    return out


def clean(record) -> dict:
    value = record.value
    if isinstance(value, (bytes, str)):
        try:
            value = json.loads(value)
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
    return {"key": record.key, "value": value,
            "headers": {h.key: h.value_as_string() for h in record.headers
                        if h.key not in VOLATILE}}


def hold(got, want, path="record"):
    """Equal, floats within EMBED_TOL; an ``id`` key is not compared."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "id":
                hold(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            hold(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= EMBED_TOL * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, path


def host_chunks(bodies: list, size: int, overlap: int) -> list:
    """The port's text-extractor and text-splitter over each body, on the
    host."""
    from langstream_tpu_torch.agents.text import TextExtractorAgent, TextSplitterAgent
    from langstream_tpu_torch.api.record import SimpleRecord

    async def run():
        extract, split = TextExtractorAgent(), TextSplitterAgent()
        await extract.init({})
        await split.init({"chunk_size": size, "chunk_overlap": overlap})
        out = []
        for body in bodies:
            text = (await extract.process_record(SimpleRecord.of(body)))[0]
            out += [r.value for r in await split.process_record(text)]
        return out

    return asyncio.run(run())


async def topic(runner, name: str, n: int, timeout: float = 120) -> list:
    return [clean(r) for r in (await runner.consume(name, n=n, timeout=timeout))[:n]]


# -- remote models ---------------------------------------------------------------


def test_ollama_chatbot_equals_jax(tmp_path):
    def chat(call):
        body = call.json()
        return 200, {}, {"choices": [{"index": 0, "finish_reason": "stop", "message": {
            "role": "assistant", "content": f"echo: {body['messages'][-1]['content']}"}}],
            "usage": {"prompt_tokens": 3, "completion_tokens": 2}}

    async def scenario(runner):
        await runner.produce("ollama-input", "hi ollama")
        return await topic(runner, "ollama-output", 1, 30)

    with Stub([("POST", "/v1/chat/completions", chat)]) as stub:
        out = both(tmp_path, "ollama-chatbot", {"ollama": {"url": f"{stub.base}/v1"}}, scenario)
        bodies = [c.json() for c in stub.calls]
    assert out["port"] == out["jax"]
    assert out["port"][0]["value"]["answer"] == "echo: hi ollama"
    assert bodies[1] == bodies[0] and bodies[0]["model"] == "llama3"


def test_bedrock_and_vertex_text_completions_equal_jax(tmp_path):
    def invoke(call):
        auth = call.headers.get("authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 Credential=change-me/"):
            return 403, {}, b"unsigned"
        prompt = call.json()["messages"][-1]["content"]
        return 200, {}, {"content": [{"type": "text", "text": f"bedrock: {prompt}"}],
                         "stop_reason": "end_turn"}

    def generate(call):
        text = call.json()["contents"][-1]["parts"][0]["text"]
        return 200, {}, {"candidates": [{"content": {"parts": [{"text": f"vertex: {text}"}]}}]}

    async def bedrock(runner):
        await runner.produce("bedrock-input", "complete me")
        return await topic(runner, "bedrock-output", 1, 30)

    async def vertex(runner):
        await runner.produce("vertex-input", "complete me")
        return await topic(runner, "vertex-output", 1, 30)

    with Stub([("POST", "/model/(?P<m>[^/]+)/invoke", invoke),
               ("POST", "/v1/projects/.+", generate)]) as stub:
        out = both(tmp_path / "b", "bedrock-text-completions",
                   {"bedrock": {"endpoint": stub.base}}, bedrock)
        assert out["port"] == out["jax"]
        assert out["port"][0]["value"]["completion"] == "bedrock: complete me"
        out = both(tmp_path / "v", "vertexai-text-completions",
                   {"vertex": {"url": stub.base}}, vertex)
        assert out["port"] == out["jax"]
        assert out["port"][0]["value"]["completion"] == "vertex: complete me"
        paths = [c.path for c in stub.calls if c.path.startswith("/v1/")]
        assert paths[0] == paths[1] == ("/v1/projects/my-project/locations/us-central1"
                                        "/publishers/google/models/gemini-1.5-flash"
                                        ":generateContent")


# -- agents ------------------------------------------------------------------------


def test_http_request_processor_equals_jax(tmp_path):
    def geocode(call):
        return 200, {}, {"q": call.query["q"], "key": call.query["apiKey"], "lat": 1.5}

    async def scenario(runner):
        await runner.produce("geo-input", "Lisbon")
        return await topic(runner, "geo-output", 1, 30)

    with Stub([("GET", "/geo", geocode)]) as stub:
        out = both(tmp_path, "http-request-processor",
                   {"http-service": {"url": f"{stub.base}/geo", "api-key": "k"}}, scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0]["value"]["api-response"] == {"q": "Lisbon", "key": "k", "lat": 1.5}


def bucket_stub(store: dict, prefix: str, azure: bool = False) -> Stub:
    def listing(call):
        if azure:
            items = "".join(f"<Blob><Name>{k}</Name></Blob>" for k in sorted(store))
            xml = f"<EnumerationResults><Blobs>{items}</Blobs></EnumerationResults>"
        else:
            items = "".join(f"<Contents><Key>{k}</Key></Contents>" for k in sorted(store))
            xml = (f'<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                   f"{items}</ListBucketResult>")
        return 200, {"Content-Type": "application/xml"}, xml

    def obj(call):
        key = call.match["key"]
        if key not in store:
            return 404, {}, b""
        if call.method == "DELETE":
            store.pop(key, None)
            return (202 if azure else 204), {}, b""
        return 200, {"Content-Type": "text/plain"}, store[key]

    return Stub([("GET", prefix, listing), ("*", f"{prefix}/(?P<key>.+)", obj)])


def test_s3_source_equals_jax(tmp_path):
    docs = {"doc.txt": b"alpha bravo " * 60, "image.png": b"\x89PNG"}

    async def scenario(runner):
        chunks = await topic(runner, "s3-chunks", 2, 60)
        await asyncio.sleep(0.5)
        return chunks

    stores = {}
    for pkg in ("jax", "port"):
        stores[pkg] = dict(docs)
    out = {}
    for pkg in (JAX, PORT):
        with bucket_stub(stores[pkg.name], "/langstream-source") as stub:
            app = app_copy(tmp_path / pkg.name, "s3-source", {"pipeline.yaml": [(
                "      idle-time: 5\n", "      idle-time: 5\n" + KEEP_OBJECTS)]})
            secrets = secrets_file(tmp_path, pkg, {"s3": {"endpoint": stub.base}})
            out[pkg.name] = asyncio.run(run_app(pkg, app, secrets, scenario))
    assert out["port"] == out["jax"]
    assert "alpha bravo" in out["port"][0]["value"]
    assert stores["port"] == stores["jax"] == docs


def test_azure_document_ingestion_equals_jax(tmp_path, f32_presets):
    docs = {"d.txt": b"delta echo " * 60}

    async def scenario(runner):
        chunks = await topic(runner, "az-chunks", 2, 120)
        store = runner._service_registry.get_datasource("vdb")
        for _ in range(600):
            if len(store._indexes.get("docs", {}).get("ids", [])) >= 2:
                break
            await asyncio.sleep(0.05)
        idx = store._indexes["docs"]
        rows = sorted((m["text"], idx["matrix"][i].tolist()) for i, m in enumerate(idx["meta"]))
        return chunks, rows

    out = {}
    for pkg in (JAX, PORT):
        with bucket_stub(dict(docs), "/documents", azure=True) as stub:
            app = app_copy(tmp_path / pkg.name, "azure-document-ingestion", {"pipeline.yaml": [(
                "      idle-time: 5\n", "      idle-time: 5\n" + KEEP_OBJECTS)]})
            secrets = secrets_file(tmp_path, pkg, {"azure": {"endpoint": stub.base,
                                                             "sas-token": "sv=fake"}})
            out[pkg.name] = asyncio.run(run_app(pkg, app, secrets, scenario))
    hold(out["port"], out["jax"])
    chunks, rows = out["port"]
    assert len(rows) == 2 and len(chunks[0]["value"]["embeddings"]) == configs()[1].d_model


def test_slack_equals_jax(tmp_path, f32_presets):
    pages = ["a page about TPUs", "a page about GPUs and their memory", "short"]

    def webhook(call):
        return 200, {"Content-Type": "text/plain"}, f"ok {len(call.body)}"

    async def scenario(runner):
        for p in pages:
            await runner.produce("pages-topic", json.dumps({"text": p}))
        return await topic(runner, "notified-topic", len(pages), 300)

    with Stub([("POST", "/services/T/B/X", webhook)]) as stub:
        out = both(tmp_path, "slack", {"slack": {"webhook-url": stub.base + "/services/T/B/X"}},
                   scenario)
        posted = [c.body.decode() for c in stub.calls]
    assert out["port"] == out["jax"]
    half = len(posted) // 2
    assert len(posted) == 2 * len(pages) and posted[half:] == posted[:half]
    for record, body in zip(out["port"], posted[half:]):
        assert body == '{"text": "' + record["value"]["summary"] + '"}'
        assert record["value"]["slack-response"] == f"ok {len(body.encode())}"


def test_langserve_invoke_equals_jax(tmp_path):
    def invoke(call):
        return 200, {}, {"output": f"chain:{call.json()['input']['topic']}"}

    async def scenario(runner):
        await runner.produce("ls-in", "quantum chips")
        return await topic(runner, "ls-out", 1, 60)

    with Stub([("POST", "/chain/invoke", invoke)]) as stub:
        out = both(tmp_path, "langserve-invoke", {"langserve": {"url": stub.base + "/chain/invoke"}},
                   scenario)
    assert out["port"] == out["jax"]
    assert out["port"][0]["value"]["answer"] == "chain:quantum chips"


def test_language_router_and_event_routing_equal_jax(tmp_path):
    async def languages(runner):
        await runner.produce("documents-topic", "The quick brown fox jumps over the lazy dog "
                                                "again and again.")
        await runner.produce("documents-topic", "Le renard brun saute par-dessus le chien "
                                                "paresseux encore et encore.")
        return [await topic(runner, "english-topic", 1, 60),
                await topic(runner, "other-topic", 1, 60)]

    out = both(tmp_path / "lang", "language-router", {}, languages)
    assert out["port"] == out["jax"]
    assert "quick brown fox" in out["port"][0][0]["value"]

    events = ["an order of 3", "alert: disk", "an order alert", "nothing", "alert again"]

    async def routing(runner):
        for e in events:
            await runner.produce("events-topic", e)
        return {t: await topic(runner, t, n, 60) for t, n in (
            ("orders-topic", 2), ("alerts-topic", 1), ("other-topic", 1), ("audit-topic", 3))}

    out = both(tmp_path / "events", "event-routing", {}, routing)
    assert out["port"] == out["jax"]
    assert [r["value"]["body"] for r in out["port"]["orders-topic"]] == [
        "an order of 3", "an order alert"]
    assert all(r["value"]["audited"] == "yes" for r in out["port"]["audit-topic"])


# -- mixed apps ----------------------------------------------------------------------


# the example's ingest embeds ``{{ value.text }}`` and stores ``value.text``
# of the splitter's plain-string chunks (None in both packages): the copy
# structures each chunk first, as tpu-rag's crawl pipeline does
RAG_AWS_TO_JSON = ("  - name: to-structure\n    type: document-to-json\n"
                   "    configuration:\n      text-field: text\n")


def test_rag_aws_equals_jax(tmp_path, f32_presets):
    """Ingest through S3 → extract → split → embed on ``tpu-serving`` → the
    local store; then a question: embed, query the store, Bedrock answers
    from the retrieved context."""
    docs = {"a.txt": b"tensor cores multiply matrices. " * 16,
            "b.md": b"the vector index holds embeddings of chunks. " * 6}

    def invoke(call):
        body = call.json()
        assert body["system"].startswith("Answer from this context: ")
        return 200, {}, {"content": [{"type": "text", "text": "bedrock answer"}],
                         "stop_reason": "end_turn", "usage": {"input_tokens": 5,
                                                             "output_tokens": 3}}

    async def scenario(runner):
        store = runner._service_registry.get_datasource("vdb")
        for _ in range(1200):
            if len(store._indexes.get("aws-docs", {}).get("ids", [])) >= 3:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.5)
        idx = store._indexes["aws-docs"]
        rows = sorted((m["text"], idx["matrix"][i].tolist()) for i, m in enumerate(idx["meta"]))
        await runner.produce("aws-questions", "what do tensor cores do?")
        return rows, await topic(runner, "aws-answers", 1, 120)

    out, systems = {}, {}
    for pkg in (JAX, PORT):
        calls = []
        with bucket_stub(dict(docs), "/langstream-source") as s3, \
                Stub([("POST", "/model/(?P<m>[^/]+)/invoke", invoke)]) as bedrock:
            app = app_copy(tmp_path / pkg.name, "rag-aws", {"ingest.yaml": [
                ('      secret-key: "${secrets.s3.secret-key}"\n',
                 '      secret-key: "${secrets.s3.secret-key}"\n' + KEEP_OBJECTS),
                ("      chunk_overlap: 40\n", "      chunk_overlap: 40\n" + RAG_AWS_TO_JSON)]})
            secrets = secrets_file(tmp_path, pkg, {"s3": {"endpoint": s3.base},
                                                   "bedrock": {"endpoint": bedrock.base}})
            out[pkg.name] = asyncio.run(run_app(pkg, app, secrets, scenario))
            calls = bedrock.calls
            systems[pkg.name] = [c.json()["system"] for c in calls]
            assert all("/s3/aws4_request" in c.headers["authorization"] for c in s3.calls)
            assert all("/bedrock/aws4_request" in c.headers["authorization"] for c in calls)
    hold(out["port"], out["jax"])
    rows, answers = out["port"]
    assert len(rows) == 3 and answers[0]["value"]["answer"] == "bedrock answer"
    assert sorted(t for t, _ in rows) == sorted(host_chunks(list(docs.values()), 400, 40))
    # the prompt carries each hit's f32 similarity in all its digits, which
    # the two packages' cosines differ in (within EMBED_TOL): the Bedrock
    # stub got each retrieved text from both
    context = answers[0]["value"]["context"]
    assert len(systems["port"]) == len(systems["jax"]) == 1 and len(context) == 3
    for hit in context:
        assert hit["text"] in systems["port"][0] and hit["text"] in systems["jax"][0]


KEY = rsa.generate_private_key(public_exponent=65537, key_size=2048)
CLIENT_ID = "example-oauth-client-id.apps.googleusercontent.com"


def google_token(sub: str, **claims) -> str:
    def b64(data: bytes) -> str:
        return base64.urlsafe_b64encode(data).rstrip(b"=").decode()

    payload = {"sub": sub, "aud": CLIENT_ID, "iss": "https://accounts.google.com",
               "exp": time.time() + 600, **claims}
    signed = f"{b64(json.dumps({'alg': 'RS256', 'kid': 'g1'}).encode())}." \
             f"{b64(json.dumps(payload).encode())}"
    return f"{signed}.{b64(KEY.sign(signed.encode(), padding.PKCS1v15(), hashes.SHA256()))}"


def test_gateway_authentication_equals_jax(tmp_path, f32_presets):
    nums = KEY.public_key().public_numbers()

    def enc(n: int) -> str:
        return base64.urlsafe_b64encode(n.to_bytes((n.bit_length() + 7) // 8, "big")) \
            .rstrip(b"=").decode()

    doc = {"keys": [{"kty": "RSA", "kid": "g1", "n": enc(nums.n), "e": enc(nums.e)}]}

    async def scenario(runner):
        server = await runner.serve_gateway()
        base = f"{server.ws_url}/v1/chat/default/gateway-authentication/chat"
        out = {}
        try:
            for label, query in (("none", ""), ("test", "?test-credentials=x"),
                                 ("expired", f"?credentials={google_token('u', exp=1)}"),
                                 ("audience", f"?credentials={google_token('u', aud='x')}")):
                try:
                    await wsmod.connect(base + query)
                    out[label] = "open"
                except wsmod.HandshakeError as e:
                    out[label] = e.status
            for user, question in (("alice", "hello"), ("bob", "who am I?")):
                ws = await wsmod.connect(f"{base}?credentials={google_token(user)}")
                await ws.send_str(json.dumps({"value": question}))
                msg = json.loads((await asyncio.wait_for(ws.receive(), 120)).data)
                headers = {k: v for k, v in msg["record"]["headers"].items()
                           if k not in VOLATILE}
                value = {k: v for k, v in json.loads(msg["record"]["value"]).items()
                         if k not in VOLATILE}
                out[user] = {"value": value, "headers": headers}
                await ws.close()
        finally:
            await server.stop()
        return out

    with Stub([("GET", "/certs", lambda call: (200, {}, doc))]) as stub:
        edits = {"gateways.yaml": [(
            '        client-id: "${secrets.google.client-id}"\n',
            '        client-id: "${secrets.google.client-id}"\n'
            f'        certs-uri: "{stub.base}/certs"\n')]}
        out = both(tmp_path, "gateway-authentication", {}, scenario, edits)
    assert out["port"] == out["jax"]
    got = out["port"]
    assert [got[k] for k in ("none", "test", "expired", "audience")] == [401] * 4
    assert got["alice"]["headers"]["langstream-user"] == "alice"
    assert got["bob"]["headers"]["langstream-user"] == "bob"
    assert got["bob"]["value"]["question"] == "who am I?"
