"""The port's flow, HTTP and object-storage agents against the JAX
package's on the same records, stubs and files:

- ``dispatch``, ``trigger-event``, ``log-event`` (records and log lines),
  ``timer-source`` (bounded waits: records until a deadline, never a sleep
  held to the millisecond);
- ``http-request`` (GET with a query string, a templated JSON body, a form
  body, a text answer, redirects followed and not, a cookie kept across
  requests, and a 5xx answer's error) and ``langserve-invoke`` (``/invoke``
  and the ``/stream`` SSE path with its chunks on a side topic), on one
  stdlib stub for both packages: the same records and the same requests;
- ``local-directory-source``, ``s3-source`` (ListObjectsV2 with its XML
  namespace, GETs and DELETEs signed SigV4) and ``azure-blob-storage-source``
  (SAS token), through read and commit: the same records, the same calls,
  the same objects left.

Records compare as (key, value, headers, origin); a timestamp only where
both packages take it from the input."""

import asyncio
import json
import logging
import time
import types
from urllib.parse import unquote

import pytest
from torch_http_stub import Stub

import langstream_tpu.agents.flow as jax_flow
import langstream_tpu.agents.http as jax_http
import langstream_tpu.agents.storage as jax_storage
import langstream_tpu.api.record as jax_record
import langstream_tpu_torch.agents.flow as port_flow
import langstream_tpu_torch.agents.http as port_http
import langstream_tpu_torch.agents.storage as port_storage
import langstream_tpu_torch.api.record as port_record

JAX = types.SimpleNamespace(name="jax", flow=jax_flow, http=jax_http, storage=jax_storage,
                            record=jax_record)
PORT = types.SimpleNamespace(name="port", flow=port_flow, http=port_http, storage=port_storage,
                             record=port_record)
PKGS = (JAX, PORT)


def norm(record) -> dict:
    value = record.value
    if isinstance(value, bytes):
        value = ("bytes", value)
    elif isinstance(value, (dict, list)):
        value = ("obj", value)
    elif isinstance(value, str):
        try:
            value = ("json", json.loads(value))
        except json.JSONDecodeError:
            value = ("str", value)
    return {"key": record.key, "value": value, "origin": record.origin,
            "headers": [(h.key, h.value_as_string()) for h in record.headers]}


class _Producer:
    def __init__(self, sink: list) -> None:
        self.sink = sink

    async def write(self, record) -> None:
        self.sink.append(norm(record))


class _Context:
    """The one service the agents here ask of their context: a side-topic
    producer (``langserve-invoke``'s chunks)."""

    def __init__(self) -> None:
        self.topics: dict[str, list] = {}

    def get_topic_producer(self, topic: str) -> _Producer:
        return _Producer(self.topics.setdefault(topic, []))


async def make(pkg, module: str, cls: str, config: dict, agent_type: str = ""):
    agent = getattr(getattr(pkg, module), cls)()
    agent.agent_type = agent_type
    await agent.init(config)
    agent.set_context(_Context())
    await agent.start()
    return agent


def each(scenario) -> dict:
    """``scenario(pkg)`` for both packages, one event loop each; the
    results must be equal."""
    out = {pkg.name: asyncio.run(scenario(pkg)) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


EVENTS = ["an order of 3 items", "alert: disk full", "an order alert", "nothing here",
          "ALERT upper case", "drop me"]


def records(pkg, texts=EVENTS):
    return [pkg.record.SimpleRecord.of(json.dumps({"body": t}), key=f"k{i}",
                                       headers=[("h", str(i))], timestamp=1000.0 + i)
            for i, t in enumerate(texts)]


def test_dispatch_equals_jax():
    config = {"routes": [
        {"when": "fn:contains(value.body, 'drop')", "action": "drop"},
        {"when": "fn:contains(value.body, 'order')", "destination": "orders-topic"},
        {"when": "fn:contains(value.body, 'alert')", "destination": "alerts-topic"},
        {"when": "fn:contains(value.body, 'ALERT')"},
    ]}

    async def scenario(pkg):
        agent = await make(pkg, "flow", "DispatchAgent", config)
        out = []
        for r in records(pkg):
            got = await agent.process_record(r)
            out.append([(norm(x), x.timestamp) for x in got])
        routed = pkg.record.SimpleRecord.of(
            "x", headers=[("langstream-destination-topic", "old")])
        again = await make(pkg, "flow", "DispatchAgent",
                           {"routes": [{"destination": "new-topic"}]})
        out.append([norm(x) for x in await again.process_record(routed)])
        return out

    got = each(scenario)
    assert [len(r) for r in got[:6]] == [1, 1, 1, 1, 1, 0]
    assert got[0][0][0]["headers"][-1] == ("langstream-destination-topic", "orders-topic")
    assert got[6][0]["headers"] == [("langstream-destination-topic", "new-topic")]


@pytest.mark.parametrize("keep", [True, False])
def test_trigger_event_equals_jax(keep):
    config = {"when": "fn:contains(value.body, 'alert')", "destination": "audit-topic",
              "continue-processing": keep,
              "fields": [{"name": "value.audited", "expression": "'yes'"},
                         {"name": "value.source", "expression": "value.body"},
                         {"name": "key", "expression": "key"}]}

    async def scenario(pkg):
        agent = await make(pkg, "flow", "TriggerEventProcessor", config)
        return [[norm(x) for x in await agent.process_record(r)] for r in records(pkg)]

    got = each(scenario)
    assert got[1][0]["value"] == ("obj", {"audited": "yes", "source": "alert: disk full"})
    assert len(got[1]) == (2 if keep else 1) and len(got[0]) == 1


def test_log_event_equals_jax(caplog):
    config = {"when": "fn:contains(value.body, 'alert')", "message": "alert seen",
              "fields": [{"name": "body", "expression": "value.body"},
                         {"expression": "key"}]}
    logs = {}

    async def scenario(pkg):
        agent = await make(pkg, "flow", "LogEventProcessor", config)
        everything = await make(pkg, "flow", "LogEventProcessor", {"message": "all"})
        caplog.clear()
        with caplog.at_level(logging.INFO):
            out = [[norm(x) for x in await agent.process_record(r)] for r in records(pkg)]
            out += [[norm(x) for x in await everything.process_record(r)]
                    for r in records(pkg)[:2]]
        logs[pkg.name] = [r.getMessage() for r in caplog.records
                          if r.name.endswith("agents.flow")]
        return out

    got = each(scenario)
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 4
    assert [len(r) for r in got] == [1] * 8


def test_timer_source_equals_jax():
    config = {"period-seconds": 0.05,
              "fields": [{"name": "value.kind", "expression": "'tick'"},
                         {"name": "key", "expression": "'timer-key'"}]}

    async def scenario(pkg):
        out = []
        for cfg in (config, {"period-seconds": 0.05}):
            agent = await make(pkg, "flow", "TimerSource", cfg)
            got, deadline = [], time.monotonic() + 20
            while len(got) < 3:
                assert time.monotonic() < deadline, "timer-source stopped emitting"
                got += await agent.read()
            stamps = [r.timestamp for r in got]
            assert stamps == sorted(stamps)
            for r in got[:3]:
                rec = norm(r)
                if cfg is not config:  # {"fired-at": <time>}: its key only
                    rec["value"] = sorted(rec["value"][1])
                out.append(rec)
        return out

    got = each(scenario)
    assert got[0] == {"key": "timer-key", "value": ("obj", {"kind": "tick"}),
                      "origin": "timer-source", "headers": []}
    assert got[3]["value"] == ["fired-at"]


# -- http-request and langserve-invoke -------------------------------------------


def http_stub() -> Stub:
    def geo(call):
        return 200, {}, {"q": call.query.get("q"), "key": call.query.get("apiKey"),
                         "lat": 1.5}

    def echo(call):
        return 200, {"Content-Type": "text/plain; charset=utf-8"}, (
            f"{call.method} {call.headers.get('content-type')} {call.body.decode()}")

    def status(call):
        return int(call.match["code"]), {"Content-Type": "text/plain"}, b"nope"

    def redirect(call):
        return 302, {"Location": "/echo"}, b"moved"

    def cookie_set(call):
        return 200, {"Set-Cookie": "session=abc; Path=/"}, b"set"

    def cookie_read(call):
        return 200, {"Content-Type": "application/json"}, {"cookie": call.headers.get("cookie")}

    def invoke(call):
        body = call.json()
        return 200, {}, {"output": {"content": f"chain:{body['input']['topic']}"},
                         "metadata": {"run_id": "r1"}}

    def stream(call):
        body = call.json()
        words = [f"{body['input']['topic']} ", "is ", "a ", "fine ", "thing"]
        events = [b"event: metadata\r\ndata: {\"run_id\": \"r1\"}\r\n\r\n"]
        events += [f"event: data\ndata: {json.dumps({'content': w})}\n\n".encode()
                   for w in words]
        events += [b"event: data\ndata: not json\n\n", b"event: end\n\n"]
        return iter(events)

    return Stub([("GET", "/geo", geo), ("*", "/echo", echo),
                 ("*", r"/status/(?P<code>\d+)", status), ("GET", "/redirect", redirect),
                 ("GET", "/cookie/set", cookie_set), ("GET", "/cookie/read", cookie_read),
                 ("POST", "/chain/invoke", invoke), ("POST", "/chain/stream", stream)])


def test_http_request_equals_jax():
    with http_stub() as stub:
        base = stub.base
        localhost = base.replace("127.0.0.1", "localhost")
        configs = [
            {"url": f"{base}/geo", "output-field": "value.api",
             "query-string": {"q": "{{ value.city }}", "apiKey": "k-1"}},
            {"url": f"{base}/echo", "method": "POST", "output-field": "value.posted",
             "body": '{"text": "{{ value.city }}"}',
             "headers": {"Content-Type": "application/json", "X-City": "{{ value.city }}"}},
            {"url": f"{base}/echo", "method": "put", "body": "plain {{ value.city }}"},
            {"url": f"{base}/echo", "method": "POST", "output-field": "value.form",
             "body": {"a": "1", "b": "two words"}},
            {"url": f"{base}/redirect", "output-field": "value.followed"},
            {"url": f"{base}/redirect", "output-field": "value.kept",
             "allow-redirects": False},
            {"url": f"{base}/echo?x=1", "query-string": {"y": "2"}, "output-field": "value.q"},
        ]

        async def scenario(pkg):
            before = len(stub.calls)
            out = []
            for config in configs:
                agent = await make(pkg, "http", "HttpRequestAgent", config)
                record = pkg.record.SimpleRecord.of(json.dumps({"city": "Lisbon"}), key="c")
                out.append([norm(r) for r in await agent.process_record(record)])
                await agent.close()
            for config in ({"url": f"{localhost}/cookie/set"},
                           {"url": f"{base}/cookie/set"}):
                agent = await make(pkg, "http", "HttpRequestAgent", config)
                await agent.process_record(pkg.record.SimpleRecord.of("{}"))
                agent.url = config["url"].replace("/set", "/read")
                out.append([norm(r) for r in await agent.process_record(
                    pkg.record.SimpleRecord.of("{}"))])
                await agent.close()
            failing = await make(pkg, "http", "HttpRequestAgent",
                                 {"url": f"{base}/status/503"})
            try:
                await failing.process_record(pkg.record.SimpleRecord.of("{}"))
            except Exception as e:  # noqa: BLE001 — aiohttp's or the port's
                out.append(["raised", str(e)])
            await failing.close()
            calls = [(c.method, c.path, c.query, c.body, c.headers.get("content-type"),
                      c.headers.get("x-city")) for c in stub.calls[before:]]
            return out, calls

        out, calls = each(scenario)
        assert out[0][0]["value"][1]["api"] == {"q": "Lisbon", "key": "k-1", "lat": 1.5}
        assert out[1][0]["value"][1]["posted"] == 'POST application/json {"text": "Lisbon"}'
        assert out[2][0]["value"] == ("str", "PUT text/plain; charset=utf-8 plain Lisbon")
        assert out[3][0]["value"][1]["form"] == (
            "POST application/x-www-form-urlencoded a=1&b=two+words")
        assert out[4][0]["value"][1]["followed"].startswith("GET ")
        assert out[5][0]["value"][1]["kept"] == "moved"
        assert out[7][0]["value"] == ("json", {"cookie": "session=abc"})
        assert out[8][0]["value"] == ("json", {"cookie": None})  # an IP host keeps none
        assert out[9] == ["raised", f"503, message='Service Unavailable', "
                                    f"url='{base}/status/503'"]
        assert ("GET", "/echo", {"x": "1", "y": "2"}, b"", None, None) in calls


def test_langserve_invoke_equals_jax():
    with http_stub() as stub:
        async def scenario(pkg):
            out = []
            invoke = await make(pkg, "http", "LangServeInvokeAgent", {
                "url": f"{stub.base}/chain/invoke", "output-field": "value.answer",
                "fields": [{"name": "topic", "expression": "value.topic"}]})
            streaming = await make(pkg, "http", "LangServeInvokeAgent", {
                "url": f"{stub.base}/chain/stream", "output-field": "value.answer",
                "content-field": "content", "stream-to-topic": "chunks",
                "min-chunks-per-message": 2,
                "fields": [{"name": "topic", "expression": "value.topic"}]})
            for agent in (invoke, streaming):
                record = pkg.record.SimpleRecord.of(json.dumps({"topic": "tpus"}), key="q1",
                                                    origin="src")
                out.append([norm(r) for r in await agent.process_record(record)])
            out.append(streaming.context.topics["chunks"])
            failing = await make(pkg, "http", "LangServeInvokeAgent",
                                 {"url": f"{stub.base}/status/404"})
            try:
                await failing.process_record(pkg.record.SimpleRecord.of("{}"))
            except Exception as e:  # noqa: BLE001
                out.append(str(e))
            return out

        got = each(scenario)
        assert got[0][0]["value"] == ("json", {"topic": "tpus", "answer": "chain:tpus"})
        assert got[1][0]["value"][1]["answer"] == "tpus is a fine thingnot json"
        assert [c["value"] for c in got[2]] == [
            ("str", "tpus "), ("str", "is a "), ("str", "fine thing"), ("str", "not json")]
        assert got[2][-1]["headers"] == [("stream-index", "3"), ("stream-last-message", "true")]
        assert got[3].startswith("404, message='Not Found'")


# -- object storage ------------------------------------------------------------------


async def drain(agent, want: int, commit: bool = True) -> list:
    """Read until ``want`` records (bounded), committing each batch."""
    got, deadline = [], time.monotonic() + 20
    while len(got) < want:
        assert time.monotonic() < deadline, f"{len(got)} of {want} records"
        batch = await agent.read()
        if commit and batch:
            await agent.commit(batch)
        got += batch
    extra = await agent.read()  # nothing more (sleeps idle-time)
    return [norm(r) for r in got + extra]


FILES = {"a.txt": b"alpha " * 10, "notes/b.md": b"# bravo", "c.pdf": b"%PDF-1.4 charlie",
         "skip.bin": b"\x00\x01", "d.TXT": b"upper delta", "dir with space/e.html": b"<p>e</p>"}


@pytest.mark.parametrize("delete", [True, False])
def test_local_directory_source_equals_jax(tmp_path, delete):
    async def scenario(pkg):
        root = tmp_path / pkg.name
        for name, data in FILES.items():
            (root / name).parent.mkdir(parents=True, exist_ok=True)
            (root / name).write_bytes(data)
        agent = await make(pkg, "storage", "LocalDirectorySource",
                           {"directory": str(root), "idle-time": 0.01,
                            "delete-objects": delete}, agent_type="local-directory-source")
        got = await drain(agent, 5)
        for r in got:
            r["headers"] = [(k, v.replace(str(root), "<dir>")) for k, v in r["headers"]]
        left = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
        return got, left

    got, left = each(scenario)
    assert [r["key"] for r in got] == ["a.txt", "c.pdf", "d.TXT", "dir with space/e.html",
                                       "notes/b.md"]
    assert left == (["skip.bin"] if delete else sorted(FILES))


S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def s3_stub(store: dict) -> Stub:
    def listing(call):
        assert call.query == {"list-type": "2"}
        keys = "".join(f"<Contents><Key>{k}</Key><Size>{len(v)}</Size></Contents>"
                       for k, v in sorted(store.items()))
        return 200, {"Content-Type": "application/xml"}, (
            f'<?xml version="1.0" encoding="UTF-8"?><ListBucketResult xmlns="{S3_NS}">'
            f"<Name>bucket</Name>{keys}</ListBucketResult>")

    def obj(call):
        auth = call.headers.get("authorization", "")
        if not (auth.startswith("AWS4-HMAC-SHA256 Credential=ak/")
                and "/us-west-2/s3/aws4_request" in auth):
            return 403, {}, b"unsigned"
        key = unquote(call.match["key"])
        if call.method == "DELETE":
            store.pop(key, None)
            return 204, {}, b""
        return (200, {}, store[key]) if key in store else (404, {}, b"")

    return Stub([("GET", "/bucket", listing), ("*", "/bucket/(?P<key>.+)", obj)])


@pytest.mark.parametrize("delete", [True, False])
def test_s3_source_equals_jax(delete):
    async def scenario(pkg):
        store = dict(FILES)
        with s3_stub(store) as stub:
            agent = await make(pkg, "storage", "S3Source", {
                "bucketName": "bucket", "endpoint": stub.base, "access-key": "ak",
                "secret-key": "sk", "region": "us-west-2", "idle-time": 0.01,
                "delete-objects": delete}, agent_type="s3-source")
            got = await drain(agent, 5)
            await agent.close()
            calls = [(c.method, c.path) for c in stub.calls]
            signed = all(c.headers.get("x-amz-date") and "Signature=" in
                         c.headers.get("authorization", "") for c in stub.calls)
        return got, sorted(store), calls, signed

    got, left, calls, signed = each(scenario)
    assert signed and [r["key"] for r in got] == ["a.txt", "c.pdf", "d.TXT",
                                                  "dir with space/e.html", "notes/b.md"]
    assert got[0]["headers"] == [("name", "a.txt"), ("bucket", "bucket")]
    assert ("GET", "/bucket/dir%20with%20space/e.html") in calls
    assert left == (["skip.bin"] if delete else sorted(FILES))


def test_azure_blob_source_equals_jax():
    async def scenario(pkg):
        store = dict(FILES)

        def listing(call):
            assert call.query == {"restype": "container", "comp": "list", "sv": "2024",
                                  "sig": "abc"}
            blobs = "".join(f"<Blob><Name>{k}</Name></Blob>" for k in sorted(store))
            return 200, {"Content-Type": "application/xml"}, (
                f"<EnumerationResults><Blobs>{blobs}</Blobs></EnumerationResults>")

        def blob(call):
            if call.query != {"sv": "2024", "sig": "abc"}:
                return 403, {}, b"no sas"
            key = unquote(call.match["key"])
            if call.method == "DELETE":
                store.pop(key, None)
                return 202, {}, b""
            return 200, {}, store[key]

        with Stub([("GET", "/docs", listing), ("*", "/docs/(?P<key>.+)", blob)]) as stub:
            agent = await make(pkg, "storage", "AzureBlobStorageSource", {
                "container": "docs", "endpoint": stub.base + "/", "sas-token": "?sv=2024&sig=abc",
                "idle-time": 0.01, "file-extensions": "txt,md"},
                agent_type="azure-blob-storage-source")
            got = await drain(agent, 3)
            await agent.close()
            calls = [(c.method, c.path) for c in stub.calls]
        return got, sorted(store), calls

    got, left, calls = each(scenario)
    assert [r["key"] for r in got] == ["a.txt", "d.TXT", "notes/b.md"]
    assert got[0]["value"] == ("bytes", FILES["a.txt"])
    assert left == ["c.pdf", "dir with space/e.html", "skip.bin"]
