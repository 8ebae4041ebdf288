"""The port's gateway (an asyncio stdlib server with its own RFC 6455
websockets) against the JAX package's aiohttp gateway, across packages:
the port's websocket client against JAX's server and aiohttp's client
against the port's server, on the same app, give the same frames and
produce answers. Then the websocket edges (masking, a 64-bit length,
fragments with a ping between them, the close handshake, protocol faults),
a gateway with ``authentication`` refusing what it must, and ``run local
--once``."""

import asyncio
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import aiohttp
import pytest
import torch

import langstream_tpu.core.parser as jax_parser
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu_torch.gateway import websocket as wsmod
from langstream_tpu_torch.gateway.core import AuthFailedException, authenticate_and_validate

ROOT = Path(__file__).resolve().parents[1]

GATEWAYS = """
gateways:
  - id: produce-in
    type: produce
    topic: input-topic
    parameters: [sessionId]
    produce-options:
      headers:
        - key: session-id
          value-from-parameters: sessionId
  - id: consume-out
    type: consume
    topic: output-topic
    parameters: [sessionId]
    consume-options:
      filters:
        headers:
          - key: session-id
            value-from-parameters: sessionId
  - id: chat
    type: chat
    chat-options:
      questions-topic: input-topic
      answers-topic: output-topic
      headers:
        - key: session-id
          value-from-parameters: sessionId
    parameters: [sessionId]
  - id: svc
    type: service
    service-options:
      input-topic: input-topic
      output-topic: output-topic
"""
SECURED = """
  - id: secured
    type: produce
    topic: input-topic
    authentication:
      provider: jwt
      configuration:
        secret-key: s3cret
"""
PIPELINE = """
module: default
id: p
name: echo
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: echo
    type: identity
    input: input-topic
    output: output-topic
"""
INSTANCE = "instance:\n  streamingCluster:\n    type: memory\n  computeCluster:\n    type: local\n"
# per-run values a frame carries
VOLATILE = ("ls-trace-id", "langstream-service-request-id")


@pytest.fixture(autouse=True)
def _reset_port_broker():
    port_memory.MemoryBroker.reset()
    yield
    port_memory.MemoryBroker.reset()


async def platform(package: str, gateways: str = GATEWAYS):
    """The echo app on the package's runner and gateway, on fresh brokers."""
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()
    parser, local = (jax_parser, jax_local) if package == "jax" else (port_parser, port_local)
    app = parser.ModelBuilder.build_application_from_files(
        {"pipeline.yaml": PIPELINE, "gateways.yaml": gateways}, INSTANCE, None).application
    runner = local.LocalApplicationRunner("gw-test", app)
    await runner.deploy()
    await runner.start()
    server = await runner.serve_gateway()
    return runner, server


class AioClient:
    """aiohttp's client."""

    def __init__(self) -> None:
        self.session = aiohttp.ClientSession()

    async def ws(self, url: str):
        try:
            return AioSocket(await self.session.ws_connect(url))
        except aiohttp.WSServerHandshakeError as e:
            return ("refused", e.status)

    async def http(self, method: str, url: str, body: bytes) -> tuple:
        async with self.session.request(method, url, data=body) as resp:
            return resp.status, await resp.text()

    async def close(self) -> None:
        await self.session.close()


class AioSocket:
    def __init__(self, ws) -> None:
        self.ws = ws

    async def send(self, text: str) -> None:
        await self.ws.send_str(text)

    async def recv(self) -> str:
        msg = await asyncio.wait_for(self.ws.receive(), 10)
        assert msg.type == aiohttp.WSMsgType.TEXT, msg
        return msg.data

    async def close(self) -> None:
        await self.ws.close()


class PortClient:
    """The port's stdlib client (``gateway/websocket.py``)."""

    async def ws(self, url: str):
        try:
            return PortSocket(await wsmod.connect(url))
        except wsmod.HandshakeError as e:
            return ("refused", e.status)

    async def http(self, method: str, url: str, body: bytes) -> tuple:
        status, _, data = await wsmod.http_request(method, url, body)
        return status, data.decode()

    async def close(self) -> None:
        pass


class PortSocket:
    def __init__(self, ws) -> None:
        self.ws = ws

    async def send(self, text: str) -> None:
        await self.ws.send_str(text)

    async def recv(self) -> str:
        msg = await asyncio.wait_for(self.ws.receive(), 10)
        assert msg.kind == "text", msg
        return msg.data

    async def close(self) -> None:
        await self.ws.close()


def norm(message: str) -> dict:
    doc = json.loads(message)
    record = doc.get("record")
    if isinstance(record, dict):
        record["headers"] = {k: v for k, v in record["headers"].items() if k not in VOLATILE}
    return doc


async def traffic(url: str, client) -> list:
    """One pass of every gateway kind, each answer recorded."""
    ws_url = url.replace("http://", "ws://")
    base = f"{ws_url}/v1"
    obs = []
    produce = await client.ws(f"{base}/produce/default/gw-test/produce-in?param:sessionId=s1")
    for payload in ('{"value": "hello", "key": "k"}', "not json", '{"headers": {"a": "b"}}',
                    '{"value": {"nested": [1, 2]}, "headers": {"h": "v"}}'):
        await produce.send(payload)
        obs.append(json.loads(await produce.recv()))
    await produce.close()
    consume = await client.ws(
        f"{base}/consume/default/gw-test/consume-out?param:sessionId=s1&option:position=earliest")
    obs.append([norm(await consume.recv()) for _ in range(2)])
    await consume.close()
    chat = await client.ws(f"{base}/chat/default/gw-test/chat?param:sessionId=s2")
    await chat.send('{"value": "question", "headers": {"x": "y"}}')
    obs.append(norm(await chat.recv()))
    await chat.send("bad")
    obs.append(json.loads(await chat.recv()))
    await chat.close()
    api = f"{url}/api/gateways"
    obs.append(await client.http("POST", f"{api}/produce/default/gw-test/produce-in"
                                         "?param:sessionId=s3", b'{"value": "v"}'))
    obs.append(await client.http("POST", f"{api}/produce/default/gw-test/produce-in",
                                 b'{"value": "v"}'))
    status, body = await client.http("POST", f"{api}/service/default/gw-test/svc",
                                     b'{"value": "ping"}')
    obs.append((status, norm(body)))
    obs.append(await client.http("GET", f"{api}/service/default/gw-test/svc", b""))
    obs.append(await client.http("POST", f"{api}/produce/default/gw-test/nope", b"{}"))
    obs.append(await client.ws(f"{base}/chat/default/gw-test/nope?param:sessionId=x"))
    obs.append(await client.ws(f"{base}/chat/default/gw-test/produce-in?param:sessionId=x"))
    obs.append(await client.ws(f"{base}/chat/default/no-app/chat?param:sessionId=x"))
    obs.append(await client.ws(f"{base}/chat/default/gw-test/chat?bogus=1"))
    obs.append(await client.http("GET", f"{url}/healthz", b""))
    return obs


def run_traffic(server_pkg: str, client_cls) -> list:
    async def main():
        runner, server = await platform(server_pkg)
        client = client_cls()
        try:
            return await traffic(server.url, client)
        finally:
            await client.close()
            await server.stop()
            await runner.stop()

    return asyncio.run(main())


def test_port_client_against_jax_server_equals_aiohttp():
    assert run_traffic("jax", PortClient) == run_traffic("jax", AioClient)


def test_aiohttp_client_against_port_server_equals_jax_server():
    assert run_traffic("port", AioClient) == run_traffic("jax", AioClient)


def test_port_client_against_port_server_equals_jax():
    got = run_traffic("port", PortClient)
    assert got == run_traffic("jax", AioClient)
    assert got[0] == {"status": "OK", "reason": None}
    assert got[1]["status"] == "BAD_REQUEST"
    assert got[5]["record"]["value"] == "question"
    assert got[5]["record"]["headers"] == {"session-id": "s2", "langstream-tenant": "default",
                                           "x": "y"}


# -- websocket edges -----------------------------------------------------------


async def _raw(url: str):
    ws = await wsmod.connect(url)
    return ws, ws.reader, ws.writer


async def _read_frame(reader) -> tuple[int, bytes]:
    b1, b2 = await asyncio.wait_for(reader.readexactly(2), 10)
    n = b2 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", await reader.readexactly(8))
    return b1 & 0x0F, await reader.readexactly(n)


async def edges(url: str) -> dict:
    ws_url = url.replace("http://", "ws://")
    produce = f"{ws_url}/v1/produce/default/gw-test/produce-in?param:sessionId=e"
    out = {}
    # fragments with a ping between them: the pong first, then the answer
    ws, reader, writer = await _raw(produce)
    parts = [b'{"value": ', b'"frag', b'mented"}']
    writer.write(wsmod.encode_frame(wsmod.OP_TEXT, parts[0], fin=False, mask=True))
    writer.write(wsmod.encode_frame(wsmod.OP_PING, b"are you there", mask=True))
    writer.write(wsmod.encode_frame(wsmod.OP_CONT, parts[1], fin=False, mask=True))
    writer.write(wsmod.encode_frame(wsmod.OP_CONT, parts[2], fin=True, mask=True))
    await writer.drain()
    out["fragments"] = [await _read_frame(reader), await _read_frame(reader)]
    # a 64-bit length both ways: a 70,000-byte message in, and read back
    big = "x" * 70_000
    writer.write(wsmod.encode_frame(wsmod.OP_TEXT, json.dumps({"value": big}).encode(),
                                    mask=True))
    await writer.drain()
    out["big_answer"] = await _read_frame(reader)
    # the close handshake: the server answers a close (any code) with 1000
    writer.write(wsmod.encode_frame(wsmod.OP_CLOSE, struct.pack("!H", 4001), mask=True))
    await writer.drain()
    op, payload = await _read_frame(reader)
    out["close"] = (op, struct.unpack("!H", payload[:2])[0])
    writer.close()
    consume = await wsmod.connect(
        f"{ws_url}/v1/consume/default/gw-test/consume-out?param:sessionId=e"
        "&option:position=earliest")
    messages = [json.loads((await consume.receive()).data)["record"]["value"]
                for _ in range(2)]
    out["read_back"] = [messages[0], len(messages[1])]
    await consume.close()
    return out


def run_edges(server_pkg: str) -> dict:
    async def main():
        runner, server = await platform(server_pkg)
        try:
            return await edges(server.url)
        finally:
            await server.stop()
            await runner.stop()

    return asyncio.run(main())


def test_websocket_edges_equal_jax():
    got = run_edges("port")
    assert got == run_edges("jax")
    ok = json.dumps({"status": "OK", "reason": None}).encode()
    assert got["fragments"] == [(wsmod.OP_PONG, b"are you there"), (wsmod.OP_TEXT, ok)]
    assert got["big_answer"] == (wsmod.OP_TEXT, ok)
    assert got["close"] == (wsmod.OP_CLOSE, wsmod.CLOSE_OK)
    assert got["read_back"] == ["fragmented", 70_000]


@pytest.mark.parametrize("fault,code", [
    ("unmasked", wsmod.CLOSE_PROTOCOL_ERROR),
    ("bad_utf8", wsmod.CLOSE_INVALID_DATA),
    ("orphan_continuation", wsmod.CLOSE_PROTOCOL_ERROR),
    ("long_ping", wsmod.CLOSE_PROTOCOL_ERROR),
])
def test_port_server_closes_on_protocol_faults(fault, code):
    frames = {
        "unmasked": wsmod.encode_frame(wsmod.OP_TEXT, b'{"value": 1}', mask=False),
        "bad_utf8": wsmod.encode_frame(wsmod.OP_TEXT, b"\xff\xfe", mask=True),
        "orphan_continuation": wsmod.encode_frame(wsmod.OP_CONT, b"x", mask=True),
        "long_ping": wsmod.encode_frame(wsmod.OP_PING, b"p" * 126, mask=True),
    }

    async def main():
        runner, server = await platform("port")
        try:
            _, reader, writer = await _raw(
                f"{server.url.replace('http', 'ws')}/v1/produce/default/gw-test/produce-in"
                "?param:sessionId=f")
            writer.write(frames[fault])
            await writer.drain()
            op, payload = await _read_frame(reader)
            writer.close()
            return op, struct.unpack("!H", payload[:2])[0]
        finally:
            await server.stop()
            await runner.stop()

    assert asyncio.run(main()) == (wsmod.OP_CLOSE, code)


def test_port_client_masks_and_reads_64_bit_lengths():
    """Frames of the port's client are masked with a fresh key; lengths of
    7, 16 and 64 bits round-trip through the server-side reader."""
    for n in (0, 125, 126, 65535, 65536, 70_000):
        frame = wsmod.encode_frame(wsmod.OP_BINARY, b"a" * n, mask=True)
        assert frame[1] & 0x80
        width = 1 if n < 126 else (3 if n < 65536 else 9)
        key = frame[1 + width:5 + width]
        assert frame[5 + width:] == wsmod._unmask(b"a" * n, key)

    async def main():
        reader = asyncio.StreamReader()
        for n in (0, 125, 126, 65535, 65536, 70_000):
            reader.feed_data(wsmod.encode_frame(wsmod.OP_BINARY, bytes([n % 251]) * n,
                                                mask=True))
        ws = wsmod.WebSocket(reader, writer=None, masked_in=True, mask_out=False)
        return [len((await ws.receive()).data) for _ in range(6)]

    assert asyncio.run(main()) == [0, 125, 126, 65535, 65536, 70_000]


# -- authentication ------------------------------------------------------------


def test_gateway_with_authentication_is_refused():
    """A gateway that declares ``authentication`` serves, and refuses a
    request without credentials, with a bad token or with test credentials
    (no test provider is set, as in ``run local``) with a 401, as JAX's does;
    a good token is served."""
    import base64
    import hashlib
    import hmac

    def token(secret: str) -> str:
        def b64(doc: dict) -> str:
            return base64.urlsafe_b64encode(json.dumps(doc).encode()).rstrip(b"=").decode()

        signed = f"{b64({'alg': 'HS256', 'typ': 'JWT'})}.{b64({'sub': 'alice'})}"
        sig = hmac.new(secret.encode(), signed.encode(), hashlib.sha256).digest()
        return f"{signed}.{base64.urlsafe_b64encode(sig).rstrip(b'=').decode()}"

    async def main(package: str):
        runner, server = await platform(package, GATEWAYS + SECURED)
        client = PortClient()
        base = f"{server.ws_url}/v1/produce/default/gw-test/secured"
        try:
            out = [await client.ws(base), await client.ws(f"{base}?credentials={token('wrong')}"),
                   await client.ws(f"{base}?test-credentials=anything")]
            ws = await client.ws(f"{base}?credentials={token('s3cret')}")
            await ws.send('{"value": "hi"}')
            out.append(json.loads(await ws.recv()))
            await ws.close()
            app = port_parser.ModelBuilder.build_application_from_files(
                {"pipeline.yaml": PIPELINE, "gateways.yaml": GATEWAYS + SECURED},
                INSTANCE, None).application
            secured = next(g for g in app.gateways if g.id == "secured")
            with pytest.raises(AuthFailedException, match="malformed JWT"):
                await authenticate_and_validate("default", "gw-test", app, secured,
                                                {"credentials": "token"})
        finally:
            await server.stop()
            await runner.stop()
        return out

    got = asyncio.run(main("port"))
    assert got == asyncio.run(main("jax"))
    assert got == [("refused", 401)] * 3 + [{"status": "OK", "reason": None}]


# -- run local ---------------------------------------------------------------


def _run_local(app: Path, *extra: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "langstream_tpu_torch.cli", "run", "local", str(app),
         "-i", str(ROOT / "examples" / "instances" / "local-memory.yaml"),
         "--gateway-port", "0", "--metrics-port", "0", "--once", *extra],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT,
    )


def test_run_local_once_starts_and_stops(tmp_path):
    app = tmp_path / "tpu-completions"
    shutil.copytree(ROOT / "examples" / "applications" / "tpu-completions", app)
    conf = app / "configuration.yaml"
    conf.write_text(conf.read_text().replace("tokenizer: byte", "tokenizer: byte\n"
                                             "        device: cpu"))
    done = _run_local(app, "--name", "demo")
    assert done.returncode == 0, done.stderr
    lines = done.stdout.splitlines()
    assert lines[0].startswith("gateway:       http://127.0.0.1:")
    assert lines[1].startswith("metrics:       http://127.0.0.1:")
    assert lines[2] == "application:   demo (tenant default)"


def test_run_local_refuses_cuda_without_a_card():
    """The example's resource asks for no device, so the provider takes the
    card: without one the deploy raises, as every entry point does."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    done = _run_local(ROOT / "examples" / "applications" / "tpu-completions")
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr


# -- a chat disconnect cancels its session's generation ------------------------

GATEWAYS_LS = """
gateways:
  - id: chat
    type: chat
    chat-options:
      questions-topic: input-topic
      answers-topic: output-topic
      headers:
        - key: langstream-client-session-id
          value-from-parameters: sessionId
    parameters: [sessionId]
"""
CANCEL_CONFIG = """
configuration:
  resources:
    - type: tpu-serving
      name: tpu
      configuration:
        model: tiny-test
        tokenizer: byte
        device: cpu
        max-seq-len: 2048
        max-batch: 1
"""
CANCEL_PIPELINE = """
module: default
id: p
name: chat
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: convert
    type: document-to-json
    input: input-topic
    configuration:
      text-field: question
  - name: chat
    type: ai-chat-completions
    configuration:
      model: tiny-test
      stream-to-topic: output-topic
      stream-response-completion-field: value
      min-chunks-per-message: 5
      completion-field: value.answer
      max-tokens: 100000
      messages:
        - role: user
          content: "{{ value.question }}"
"""


def test_chat_disconnect_cancels_the_sessions_generation():
    """The port's gateway, the port's runner and the port's engine (CPU):
    closing a chat websocket mid-stream cancels the session's generation
    (the JAX gateway test's end-to-end case). The engine's only slot frees
    within seconds and the engine counts the cancellation; decoding to the
    2048-token cap would take far longer. With tracing on, the cancel marks
    the request's trace with one ``gateway.disconnect-cancel`` span carrying
    the session key (JAX's ``lifecycle._trace_disconnect``)."""
    from langstream_tpu_torch.serving import lifecycle
    from langstream_tpu_torch.tracing import TRACER

    async def main():
        port_memory.MemoryBroker.reset()
        app = port_parser.ModelBuilder.build_application_from_files(
            {"pipeline.yaml": CANCEL_PIPELINE, "gateways.yaml": GATEWAYS_LS,
             "configuration.yaml": CANCEL_CONFIG}, INSTANCE, None).application
        runner = port_local.LocalApplicationRunner("gw-e2e", app)
        await runner.deploy()
        await runner.start()
        server = await runner.serve_gateway()
        assert TRACER.enabled
        TRACER.clear()
        try:
            ws = await wsmod.connect(f"{server.ws_url}/v1/chat/default/gw-e2e/chat"
                                     "?param:sessionId=sess-e2e")
            await ws.send_str(json.dumps({"value": "hi"}))
            msg = await asyncio.wait_for(ws.receive(), 120)
            assert msg.kind == "text"
            assert "sess-e2e" in lifecycle.active_keys()
            await ws.close()
            for _ in range(600):
                if "sess-e2e" not in lifecycle.active_keys():
                    break
                await asyncio.sleep(0.05)
            assert "sess-e2e" not in lifecycle.active_keys()
            engine = runner._service_registry.get_provider().holder._engine
            assert engine.stats()["cancelled-total"] >= 1
            roots = TRACER.find("engine.request")
            spans = TRACER.find("gateway.disconnect-cancel")
            assert len(roots) == 1 and len(spans) == 1
            assert spans[0].trace_id == roots[0].trace_id
            assert spans[0].attributes == {"session": "sess-e2e"}
        finally:
            await server.stop()
            await runner.stop()

    asyncio.run(main())
