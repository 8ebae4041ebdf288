"""The port's remote AI providers against the JAX package's on the same
stdlib stubs: ``mock-ai-configuration`` (``ai/mock_provider.py``),
``open-ai-configuration`` / ``openai-compatible`` (``ai/openai_compat.py``:
blocking and SSE-streamed chat completions, embeddings, the error texts),
``bedrock-configuration`` and ``vertex-configuration``
(``ai/remote_cloud.py``: the same request path, body and headers), and the
SigV4 signer (``agents/storage._sigv4_headers``) byte-equal to JAX's with
the clock frozen in both modules. The results must be equal apart from the
timings (``ttft_ms`` / ``total_ms``) and the chunks' random answer ids; a
streamed chunk must reach the consumer on the event loop's thread."""

import asyncio
import dataclasses
import datetime
import json
import random
import threading
import types
from urllib.parse import unquote

import pytest
from torch_http_stub import Stub

import langstream_tpu.agents.storage as jax_storage
import langstream_tpu.ai.mock_provider as jax_mock
import langstream_tpu.ai.openai_compat as jax_openai
import langstream_tpu.ai.provider as jax_provider
import langstream_tpu.ai.remote_cloud as jax_cloud
import langstream_tpu_torch.agents.storage as port_storage
import langstream_tpu_torch.ai.mock_provider as port_mock
import langstream_tpu_torch.ai.openai_compat as port_openai
import langstream_tpu_torch.ai.provider as port_provider
import langstream_tpu_torch.ai.remote_cloud as port_cloud

PKG = {"jax": (jax_provider, jax_mock, jax_openai, jax_cloud),
       "port": (port_provider, port_mock, port_openai, port_cloud)}
MESSAGES = [("system", "be brief"), ("user", "hello there"), ("assistant", "hi"),
            ("user", "tell me about TPUs")]
# the request headers both packages' clients must send alike
SIGNED = ("content-type", "authorization", "host", "x-amz-date", "x-amz-content-sha256")


def result_fields(result) -> dict:
    fields = dataclasses.asdict(result)
    fields.pop("ttft_ms")
    fields.pop("total_ms")
    return fields


async def complete(package: str, provider, options: dict, stream: bool) -> dict:
    """One chat completion through the provider's completions service:
    the result's fields, the chunks (content, index, last) and whether every
    chunk reached the consumer on the loop's thread."""
    provider_mod = PKG[package][0]
    messages = [provider_mod.ChatMessage(r, c) for r, c in MESSAGES]
    chunks, threads = [], set()

    def consume(chunk):
        threads.add(threading.get_ident())
        chunks.append((chunk.content, chunk.index, chunk.last))

    svc = provider.get_completions_service({})
    result = await svc.get_chat_completions(messages, options, consume if stream else None)
    return {"result": result_fields(result), "chunks": chunks,
            "on_loop": threads <= {threading.get_ident()}}


def each_package(scenario) -> dict:
    """``scenario(package)`` on one event loop per package (a JAX provider
    keeps its aiohttp session on the loop that opened it)."""
    return {p: asyncio.run(scenario(p)) for p in PKG}


def test_mock_provider_equals_jax():
    for config in ({}, {"response": "a canned answer of some length", "chunk-size": 5,
                        "embedding-dim": 16}):
        async def scenario(p):
            provider = PKG[p][1].MockAIProvider(config)
            return [await complete(p, provider, {"max-tokens": 3}, False),
                    await complete(p, provider, {}, True),
                    await provider.get_embeddings_service({}).compute_embeddings(
                        ["alpha", "beta", ""])]

        got = each_package(scenario)
        assert got["port"] == got["jax"] and got["port"][1]["chunks"][-1][2]


def sse(events: list, tail: bytes = b"") -> list:
    return [f"data: {json.dumps(e) if not isinstance(e, str) else e}\n\n".encode()
            for e in events] + ([tail] if tail else [])


def openai_stub(calls: dict) -> Stub:
    def chat(call):
        body = call.json()
        calls.setdefault("chat", []).append((body, call.headers.get("authorization"),
                                             call.headers.get("content-type")))
        if body["messages"][-1]["content"] == "fail":
            return 503, {}, b"overloaded"
        if body.get("stream"):
            deltas = [{"choices": [{"delta": {"role": "assistant"}}]}]
            deltas += [{"choices": [{"delta": {"content": w}}]} for w in ("TPUs ", "are ", "fast")]
            deltas += [{"choices": [{"delta": {}, "finish_reason": "length"}]}]
            events = sse(deltas)
            events.insert(2, b": keep-alive\n\nevent: ping\n")
            return iter(events + sse(["[DONE]"]) + sse([{"choices": [{"delta": {
                "content": "after done"}}]}]))
        return 200, {}, {"choices": [{"index": 0, "finish_reason": "stop", "message": {
            "role": "assistant", "content": "echo: " + body["messages"][-1]["content"]}}],
            "usage": {"prompt_tokens": 11, "completion_tokens": 3}}

    def unterminated(call):
        deltas = [{"choices": [{"delta": {"content": w}}]} for w in ("a", "b")]
        return iter(sse(deltas, tail=b'data: {"choices": [{"delta": {"content": "cut"}}]}'))

    def embeddings(call):
        body = call.json()
        calls.setdefault("embeddings", []).append(body)
        rows = [{"index": i, "embedding": [float(len(t)), 0.5, -i]}
                for i, t in enumerate(body["input"])]
        return 200, {}, {"data": list(reversed(rows))}

    return Stub([("POST", "/v1/chat/completions", chat),
                 ("POST", "/cut/chat/completions", unterminated),
                 ("POST", "/v1/embeddings", embeddings)])


def test_openai_compat_equals_jax():
    calls = {}
    with openai_stub(calls) as stub:
        config = {"url": f"{stub.base}/v1", "access-key": "sk-1", "model": "llama3",
                  "embeddings-model": "embed-1"}
        async def scenario(p):
            provider = PKG[p][2].OpenAICompatProvider(config)
            cut = PKG[p][2].OpenAICompatProvider({**config, "url": f"{stub.base}/cut"})
            got = {
                "blocking": await complete(p, provider, {"max-tokens": 7, "temperature": 0.1},
                                           False),
                "stream": await complete(p, provider, {"max-new-tokens": 5, "top-p": 0.9,
                                                       "stop": ["x"], "model": "other"}, True),
                "embed": await provider.get_embeddings_service({}).compute_embeddings(
                    ["a", "bcd", "ef"]),
                "cut": await complete(p, cut, {}, True),
            }
            for stream in (False, True):
                try:
                    await provider.get_completions_service({}).get_chat_completions(
                        [PKG[p][0].ChatMessage("user", "fail")], {},
                        (lambda c: None) if stream else None)
                except RuntimeError as e:
                    got[f"error-{stream}"] = str(e)
            await provider.close()
            await cut.close()
            return got

        out = each_package(scenario)
        assert out["port"] == out["jax"]
        got = out["port"]
        assert got["blocking"]["result"]["content"] == "echo: tell me about TPUs"
        assert got["stream"]["chunks"] == [("TPUs ", 0, False), ("are ", 1, False),
                                           ("fast", 2, False), ("", 3, True)]
        assert got["stream"]["on_loop"] and got["stream"]["result"]["finish_reason"] == "length"
        assert got["cut"]["chunks"] == [("a", 0, False), ("b", 1, False), ("", 2, True)]
        assert got["embed"] == [[1.0, 0.5, 0.0], [3.0, 0.5, -1.0], [2.0, 0.5, -2.0]]
        assert got["error-True"] == "streaming request failed (503): b'overloaded'"
        chat = calls["chat"]
        half = len(chat) // 2
        assert chat[half:] == chat[:half]  # the port's requests equal JAX's
        assert chat[0][1:] == ("Bearer sk-1", "application/json")
        assert calls["embeddings"][0] == calls["embeddings"][1] == {
            "model": "embed-1", "input": ["a", "bcd", "ef"]}


def cloud_stub(calls: list, raw_paths: list) -> Stub:
    def bedrock(call):
        # the path unquoted: aiohttp (yarl) sends the ``%3A`` of a model id
        # as ``:``, the port the URL it signed (``_sigv4_headers`` signs the
        # quoted path)
        calls.append(("bedrock", unquote(call.path), call.json(),
                      {k: call.headers.get(k) for k in SIGNED}))
        raw_paths.append(call.path)
        body = call.json()
        if "inputText" in body:
            return 200, {}, {"embedding": [len(body["inputText"]), 0.25]}
        if call.match["model"] == "broken":
            return 400, {}, b"ValidationException"
        return 200, {}, {"content": [{"type": "text", "text": "bedrock "},
                                     {"type": "tool_use"}, {"type": "text", "text": "answer"}],
                         "stop_reason": "end_turn", "usage": {"input_tokens": 9,
                                                             "output_tokens": 2}}

    def vertex(call):
        calls.append(("vertex", call.path, call.json(),
                      {k: call.headers.get(k) for k in SIGNED}))
        if call.path.endswith(":predict"):
            return 200, {}, {"predictions": [
                {"embeddings": {"values": [len(i["content"]), 1]}}
                for i in call.json()["instances"]]}
        return 200, {}, {"candidates": [{"content": {"parts": [{"text": "vertex "},
                                                               {"text": "answer"}]}}],
                         "usageMetadata": {"promptTokenCount": 4,
                                           "candidatesTokenCount": 2}}

    return Stub([("POST", r"/model/(?P<model>[^/]+)/invoke", bedrock),
                 ("POST", r"/v1/projects/.+", vertex)])


class FrozenClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 3, 14, 15, 9, 26, tzinfo=tz)


@pytest.fixture
def frozen_clock(monkeypatch):
    clock = types.SimpleNamespace(datetime=FrozenClock, timezone=datetime.timezone)
    for mod in (jax_storage, port_storage):
        monkeypatch.setattr(mod, "datetime", clock)


def test_bedrock_and_vertex_equal_jax(frozen_clock):
    calls: list = []
    raw_paths: list = []
    with cloud_stub(calls, raw_paths) as stub:
        bedrock = {"region": "eu-west-1", "endpoint": stub.base, "access-key": "AKIA1",
                   "secret-key": "s3cr3t", "model": "anthropic.claude:0",
                   "embeddings-model": "amazon.titan-embed"}
        vertex = {"url": stub.base, "project": "proj", "region": "europe-west4",
                  "token": "ya29.t", "model": "gemini-1.5-flash",
                  "embeddings-model": "text-embedding-004"}
        async def scenario(p):
            cloud = PKG[p][3]
            b, v = cloud.BedrockProvider(bedrock), cloud.VertexProvider(vertex)
            got = {
                "bedrock": await complete(p, b, {"max-tokens": 12,
                                                 "parameters": {"top_k": 3}}, False),
                "bedrock_stream": await complete(p, b, {"model": "meta.llama"}, True),
                "bedrock_embed": await b.get_embeddings_service({}).compute_embeddings(
                    ["one", "three"]),
                "vertex": await complete(p, v, {"max-new-tokens": 8, "temperature": 0.0}, False),
                "vertex_stream": await complete(p, v, {}, True),
                "vertex_embed": await v.get_embeddings_service({}).compute_embeddings(
                    ["x", "yz"]),
            }
            try:
                await b.invoke("broken", {})
            except RuntimeError as e:
                got["error"] = str(e)
            await b.close()
            await v.close()
            return got

        out = each_package(scenario)
        assert out["port"] == out["jax"]
        assert out["port"]["bedrock"]["result"]["content"] == "bedrock answer"
        assert out["port"]["vertex_stream"]["chunks"] == [("vertex answer", 0, False),
                                                          ("", 1, True)]
        half = len(calls) // 2
        assert calls[half:] == calls[:half]
        assert calls[0][1] == "/model/anthropic.claude:0/invoke"
        assert raw_paths[len(raw_paths) // 2] == "/model/anthropic.claude%3A0/invoke"
        auth = calls[0][3]["authorization"]
        assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIA1/20260314/eu-west-1/bedrock/")


def test_sigv4_is_byte_equal_to_jax(frozen_clock):
    rng = random.Random(3)
    chars = "abcXYZ019-_.~ /%+=&:@é"
    for _ in range(300):
        method = rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"])
        path = "/" + "/".join("".join(rng.choice(chars[:15]) for _ in range(rng.randrange(1, 8)))
                              for _ in range(rng.randrange(0, 4)))
        query = "&".join(f"{''.join(rng.choice(chars) for _ in range(rng.randrange(1, 5)))}="
                         f"{''.join(rng.choice(chars) for _ in range(rng.randrange(0, 5)))}"
                         for _ in range(rng.randrange(0, 4)))
        url = f"https://host{rng.randrange(9)}.example:{rng.choice([443, 9000])}{path}" + (
            f"?{query}" if query else "")
        payload = rng.randbytes(rng.randrange(0, 64))
        args = (method, url, rng.choice(["us-east-1", "eu-central-1"]),
                rng.choice(["AKIA", "minioadmin"]), rng.choice(["secret", "k/+="]), payload,
                rng.choice(["s3", "bedrock"]))
        assert port_storage._sigv4_headers(*args) == jax_storage._sigv4_headers(*args)
