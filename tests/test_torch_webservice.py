"""The port's control plane (``webservice/``) against the JAX package's: the
port's counterpart of every test in ``tests/test_webservice.py``, each
package's client driving the other's server with equal JSON, either
package reading a disk root the other wrote, the multipart reader over
other encoders' bodies, a python agent deployed through the control plane
running its user code from the materialised directory, and ``safe_dump``
round-tripped through PyYAML."""

import asyncio
import io
import json
import tempfile
import threading
import time
import zipfile
from pathlib import Path

import pytest
import yaml

from langstream_tpu_torch.messaging import memory as port_memory
from torch_control_plane import (
    INSTANCE,
    PIPELINE,
    Plane,
    deploy,
    deploy_form,
    http,
)
from torch_http_stub import Stub

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset_port_broker():
    port_memory.MemoryBroker.reset()
    yield
    port_memory.MemoryBroker.reset()


def get_json(url, **kw):
    status, _, body = http("GET", url, **kw)
    return status, json.loads(body) if body else None


def produce_consume(plane, name, value, tenant="default"):
    runner = plane.runtime.get_runner(tenant, name)
    plane.call(runner.produce("input-topic", value))
    return [r.value for r in plane.call(runner.consume("output-topic", n=1, timeout=10))]


# -- the counterparts of tests/test_webservice.py ------------------------------


def test_deploy_describe_delete():
    with Plane() as plane:
        status, body = deploy(plane)
        assert status == 200, body
        status, _ = deploy(plane)
        assert status == 409
        status, desc = get_json(f"{plane.url}/api/applications/default/app1")
        assert desc["status"]["status"] == "DEPLOYED"
        assert desc["agents"][0]["type"] == "identity"
        assert "input-topic" in desc["topics"]
        status, apps = get_json(f"{plane.url}/api/applications/default")
        assert [a["application-id"] for a in apps] == ["app1"]
        assert produce_consume(plane, "app1", "ping") == ["ping"]
        status, _, text = http("GET", f"{plane.url}/api/applications/default/app1/logs")
        assert "identity" in text.decode()
        status, _, _ = http("DELETE", f"{plane.url}/api/applications/default/app1")
        assert status == 200
        status, _ = get_json(f"{plane.url}/api/applications/default/app1")
        assert status == 404


def test_update_redeploys():
    with Plane() as plane:
        assert deploy(plane)[0] == 200
        changed = PIPELINE.replace("- name: echo", "- name: echo2", 1)
        status, _ = deploy(plane, method="PATCH", files={"pipeline.yaml": changed})
        assert status == 200
        _, desc = get_json(f"{plane.url}/api/applications/default/app1")
        assert desc["agents"][0]["id"] == "echo2"


def test_update_without_instance_keeps_stored_one():
    """PATCH that omits instance/secrets must reuse the stored documents."""
    with Plane() as plane:
        assert deploy(plane)[0] == 200
        status, body = deploy(plane, method="PATCH", instance=None)
        assert status == 200, body
        assert produce_consume(plane, "app1", "still-works") == ["still-works"]


def test_invalid_app_rejected():
    with Plane() as plane:
        status, body = deploy(plane, name="bad",
                              files={"pipeline.yaml": "pipeline: [{type: nope}]"})
        assert status == 400 and "nope" in body["error"]
        status, _ = deploy(plane, tenant="ghost")
        assert status == 404


def test_tenants_crud():
    with Plane() as plane:
        status, _, _ = http("PUT", f"{plane.url}/api/tenants/acme")
        assert status == 200
        _, tenants = get_json(f"{plane.url}/api/tenants")
        assert "acme" in tenants and "default" in tenants
        assert deploy(plane, tenant="acme")[0] == 200
        status, _, _ = http("DELETE", f"{plane.url}/api/tenants/acme")
        assert status == 200
        assert get_json(f"{plane.url}/api/tenants/acme")[0] == 404


def test_auth_token():
    """The static admin token, and a JWT (HS256) through the port's
    ``auth.py``; /healthz and /ui stay open."""
    from test_torch_gateway_auth import hs256

    secret = "jwt-secret"
    with Plane(auth_token="sekrit", auth_jwt={"secret-key": secret}) as plane:
        assert http("GET", f"{plane.url}/api/tenants")[0] == 401
        assert http("GET", f"{plane.url}/api/tenants",
                    headers={"Authorization": "Bearer sekrit"})[0] == 200
        token = hs256({"sub": "admin"}, secret)
        assert http("GET", f"{plane.url}/api/tenants",
                    headers={"Authorization": f"Bearer {token}"})[0] == 200
        assert http("GET", f"{plane.url}/api/tenants",
                    headers={"Authorization": f"Bearer {hs256({'sub': 'x'}, 'other')}"})[0] == 401
        assert http("GET", f"{plane.url}/healthz")[0] == 200
        status, _, body = http("GET", f"{plane.url}/api/docs")
        assert (status, json.loads(body)) == (401, {"error": "unauthorized"})


def test_disk_store_persistence(tmp_path):
    root = str(tmp_path / "cp")
    with Plane(root=root) as plane:
        status, body = deploy(plane)
        assert status == 200 and body["code-archive-id"]
        status, headers, data = http("GET", f"{plane.url}/api/applications/default/app1/code")
        assert status == 200 and headers["content-type"] == "application/zip"
        assert "pipeline.yaml" in zipfile.ZipFile(io.BytesIO(data)).namelist()
    with Plane(root=root) as plane:  # a NEW control plane over the same root
        status, desc = get_json(f"{plane.url}/api/applications/default/app1")
        assert status == 200 and desc["agents"][0]["type"] == "identity"


def _archetype(tmp_path):
    arch_root = tmp_path / "archetypes" / "echo-arch"
    (arch_root / "application").mkdir(parents=True)
    (arch_root / "archetype.yaml").write_text(
        "archetype:\n  title: Echo\n  description: echo pipeline\n")
    (arch_root / "application" / "pipeline.yaml").write_text(PIPELINE)
    (arch_root / "instance.yaml").write_text(
        INSTANCE + "  globals:\n    kept: from the archetype\n")
    return str(tmp_path / "archetypes")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_archetypes(tmp_path, pkg):
    """The catalog and a deploy from an archetype (its instance's globals
    plus the posted parameters, written back with ``safe_dump`` in the
    port); both packages store the same instance globals."""
    with Plane(pkg, archetypes_path=_archetype(tmp_path)) as plane:
        _, archetypes = get_json(f"{plane.url}/api/archetypes/default")
        assert archetypes == [{"id": "echo-arch", "title": "Echo",
                               "description": "echo pipeline"}]
        _, one = get_json(f"{plane.url}/api/archetypes/default/echo-arch")
        assert one["archetype"]["title"] == "Echo"
        params = {"some-param": "x: y", "n": 3, "nested": {"a": [1, "two", None]}}
        status, _, body = http(
            "POST", f"{plane.url}/api/archetypes/default/echo-arch/applications/from-arch",
            json.dumps(params).encode())
        assert status == 200, body
        assert get_json(f"{plane.url}/api/applications/default/from-arch")[0] == 200
        stored = plane.applications.store.get("default", "from-arch")
        assert stored.application.instance.globals_ == {"kept": "from the archetype", **params}
        assert get_json(f"{plane.url}/api/archetypes/default/nope")[0] == 404


def test_ui_served():
    from langstream_tpu.webservice.ui import UI_HTML

    with Plane() as plane:
        status, headers, body = http("GET", f"{plane.url}/ui")
        assert status == 200 and headers["content-type"].startswith("text/html")
        assert body.decode() == UI_HTML
        assert "langstream-tpu" in body.decode() and "/v1/chat/" in body.decode()


# -- code storage over the stdlib stub -----------------------------------------


def s3_stub(objects):
    def put(call):
        assert call.headers.get("authorization", "").startswith("AWS4-HMAC-SHA256")
        objects[call.match["key"]] = call.body
        return 200, {}, b""

    def get(call):
        key = call.match["key"]
        return (200, {}, objects[key]) if key in objects else (404, {}, b"")

    def delete(call):
        objects.pop(call.match["key"], None)
        return 204, {}, b""

    return Stub([("PUT", "/code-bucket/(?P<key>.*)", put),
                 ("GET", "/code-bucket/(?P<key>.*)", get),
                 ("DELETE", "/code-bucket/(?P<key>.*)", delete)])


def test_s3_code_storage_roundtrip():
    from langstream_tpu_torch.webservice.stores import S3CodeStorage

    objects = {}
    with s3_stub(objects) as stub:
        storage = S3CodeStorage(stub.base, bucket="code-bucket", region="us-east-1")
        meta = storage.store("t1", "app1", b"zip-bytes-here")
        assert (meta.tenant, meta.application_id) == ("t1", "app1")
        assert f"t1/{meta.code_store_id}.zip" in objects
        assert storage.download("t1", meta.code_store_id) == b"zip-bytes-here"
        storage.delete("t1", meta.code_store_id)
        with pytest.raises(FileNotFoundError):
            storage.download("t1", meta.code_store_id)


def test_control_plane_deploy_download_via_s3():
    from langstream_tpu_torch.webservice.stores import S3CodeStorage

    objects = {}
    with s3_stub(objects) as stub:
        with Plane(code_storage=S3CodeStorage(stub.base, bucket="code-bucket")) as plane:
            assert deploy(plane, name="s3app")[0] == 200
            assert len(objects) == 1
            status, _, data = http("GET", f"{plane.url}/api/applications/default/s3app/code")
            assert status == 200
        assert data == next(iter(objects.values()))
        assert "pipeline.yaml" in zipfile.ZipFile(io.BytesIO(data)).namelist()


def test_azure_code_storage_roundtrip():
    from langstream_tpu_torch.webservice.stores import AzureBlobCodeStorage, make_code_storage

    blobs = {}

    def put(call):
        assert call.query.get("sig") == "abc"
        assert call.headers.get("x-ms-blob-type") == "BlockBlob"
        blobs[call.match["key"]] = call.body
        return 201, {}, b""

    def get(call):
        key = call.match["key"]
        return (200, {}, blobs[key]) if key in blobs else (404, {}, b"")

    def delete(call):
        blobs.pop(call.match["key"], None)
        return 202, {}, b""

    with Stub([("PUT", "/code-container/(?P<key>.*)", put),
               ("GET", "/code-container/(?P<key>.*)", get),
               ("DELETE", "/code-container/(?P<key>.*)", delete)]) as stub:
        storage = make_code_storage({"type": "azure", "configuration": {
            "endpoint": stub.base, "container": "code-container",
            "sas-token": "?sv=2021&sig=abc"}})
        assert isinstance(storage, AzureBlobCodeStorage)
        meta = storage.store("t1", "app1", b"azure-zip-bytes")
        assert f"t1/{meta.code_store_id}.zip" in blobs
        assert storage.download("t1", meta.code_store_id) == b"azure-zip-bytes"
        storage.delete("t1", meta.code_store_id)
        with pytest.raises(FileNotFoundError):
            storage.download("t1", meta.code_store_id)


# -- live logs -----------------------------------------------------------------


class Follower:
    """A follow stream read on a thread with the port's client."""

    def __init__(self, plane, name="app1", replica="", n=None):
        from langstream_tpu_torch.cli.client import AdminClient

        self.entries, self.ended = [], threading.Event()
        self._n = n
        gen = AdminClient(plane.url).follow_logs(name, replica)

        def read():
            try:
                for e in gen:
                    self.entries.append(e)
                    if self._n is not None and len(self.entries) >= self._n:
                        break
            finally:
                gen.close()
                self.ended.set()

        threading.Thread(target=read, daemon=True).start()

    def wait(self, timeout=20):
        assert self.ended.wait(timeout), "the follow stream did not end"
        return self.entries


def test_logs_follow_streams_live_lines():
    """History first, then lines emitted after the stream opened, tagged
    per replica; ?filter narrows to one agent; the one-shot snapshot holds
    the hub's history."""
    with Plane() as plane:
        assert deploy(plane)[0] == 200
        hub = plane.runtime.get_runner("default", "app1").log_hub
        status, headers, _ = http("GET", f"{plane.url}/api/applications/default/app1/logs"
                                  "?filter=nobody", timeout=5)  # one-shot: not a stream
        assert status == 200 and headers["content-type"].startswith("text/plain")
        follow = Follower(plane, n=3)
        time.sleep(0.3)
        plane.loop.call_soon_threadsafe(hub.emit, "echo-0", "INFO", "live line one")
        plane.loop.call_soon_threadsafe(hub.emit, "other-0", "INFO", "noise")
        lines = follow.wait()
        assert "live line one" in [e["message"] for e in lines]
        assert any(e["replica"] == "echo-0" for e in lines)
        narrow = Follower(plane, replica="echo-0", n=2)  # its history, then "kept"
        time.sleep(0.3)
        plane.loop.call_soon_threadsafe(hub.emit, "other-0", "INFO", "filtered out")
        plane.loop.call_soon_threadsafe(hub.emit, "echo-0", "INFO", "kept")
        assert [(e["replica"], e["message"]) for e in narrow.wait()] == [
            ("echo-0", "live line one"), ("echo-0", "kept")]
        _, _, text = http("GET", f"{plane.url}/api/applications/default/app1/logs")
        assert "live line one" in text.decode()
        # both clients went away: their streams' handlers unsubscribed
        deadline = time.monotonic() + 10
        while hub._subscribers and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not hub._subscribers


def test_logs_follow_sees_agent_runtime_records():
    """Records of the ``langstream_tpu_torch`` loggers land in the hub
    tagged with their replica — also from a foreign thread while a follower
    listens — and an update ends the old run's stream."""
    import logging

    with Plane() as plane:
        assert deploy(plane)[0] == 200
        runner = plane.runtime.get_runner("default", "app1")
        assert produce_consume(plane, "app1", "ping") == ["ping"]
        follow = Follower(plane)
        time.sleep(0.3)
        logging.getLogger("langstream_tpu_torch.test").info("framework line")
        history = runner.log_hub.history()
        assert any("framework line" in e["message"] for e in history)
        assert any(e["message"].endswith("application app1 starting") for e in history)
        assert deploy(plane, method="PATCH")[0] == 200
        entries = follow.wait()
        assert [e["message"] for e in entries if "framework line" in e["message"]]
        assert len({e["seq"] for e in entries}) == len(entries)


def test_logs_follow_dedupes_out_of_order_history():
    """Entries emitted between subscribe() and the history snapshot land in
    BOTH the ring and the live queue; the live loop skips them by seq, and
    the replay tracks max(seq), not the last entry's."""
    with Plane() as plane:
        assert deploy(plane)[0] == 200
        hub = plane.runtime.get_runner("default", "app1").log_hub

        def entry(seq, msg):
            return {"seq": seq, "timestamp": 0.0, "replica": "echo-0", "level": "INFO",
                    "message": msg}

        e2, e1, e3 = entry(1002, "two"), entry(1001, "one"), entry(1003, "new")
        hub._ring.extend([e2, e1])
        real_subscribe = hub.subscribe

        def racy_subscribe():
            q = real_subscribe()
            for e in (e2, e1, e3):
                q.put_nowait(e)
            return q

        hub.subscribe = racy_subscribe
        seen = []
        follow = Follower(plane)
        deadline = time.monotonic() + 20
        while 1003 not in seen and time.monotonic() < deadline:
            seen = [e["seq"] for e in follow.entries if e["seq"] >= 1000]
            time.sleep(0.05)
        assert seen == [1002, 1001, 1003], seen


# -- across packages -----------------------------------------------------------


def _client(pkg, url):
    if pkg == "port":
        from langstream_tpu_torch.cli.client import AdminClient, AdminClientError
    else:
        from langstream_tpu.cli.client import AdminClient, AdminClientError
    return AdminClient(url, backoff_s=0.05), AdminClientError


def _script(client_pkg, plane, app_dir, instance):
    """Deploy, dry-run, get, list, the error answers and the tenant routes
    through one client: every JSON answer, or the error's status and text."""
    client, error = _client(client_pkg, plane.url)
    out = []

    def step(label, fn, *args, **kw):
        try:
            out.append((label, fn(*args, **kw)))
        except error as e:
            out.append((label, e.status, str(e)))

    step("deploy", client.deploy, "app1", app_dir, instance)
    step("again", client.deploy, "app1", app_dir, instance)
    step("dry-run", client.deploy, "dry", app_dir, instance, dry_run=True)
    step("get", client.get, "app1")
    step("list", client.list)
    step("update", client.deploy, "app1", app_dir, update=True)
    step("update-missing", client.deploy, "ghost", app_dir, update=True)
    step("logs", lambda: client.logs("app1", "nobody"))
    step("tenant-put", client.tenant_put, "acme")
    step("tenant-get", client.tenant_get, "acme")
    step("tenant-list", client.tenant_list)
    step("tenant-get-missing", client.tenant_get, "ghost")
    step("delete", client.delete, "app1")
    step("get-deleted", client.get, "app1")
    step("tenant-delete", client.tenant_delete, "acme")
    step("list-empty", client.list)
    client.tenant = "ghost"
    step("list-ghost", client.list)
    client.tenant = "Bad_Name"
    step("list-bad-name", client.list)
    return out


def test_clients_and_servers_across_packages(tmp_path):
    """JAX's AdminClient (requests) and the port's (urllib) against JAX's
    server (aiohttp) and the port's (stdlib): the same answers in all four
    pairings."""
    app_dir = tmp_path / "app"
    app_dir.mkdir()
    (app_dir / "pipeline.yaml").write_text(PIPELINE)
    instance = tmp_path / "instance.yaml"
    instance.write_text(INSTANCE)
    from langstream_tpu.messaging.memory import MemoryBroker

    got = {}
    for server in ("jax", "port"):
        for client in ("jax", "port"):
            MemoryBroker.reset()
            port_memory.MemoryBroker.reset()
            with Plane(server) as plane:
                got[(client, server)] = _script(client, plane, app_dir, instance)
    want = got[("jax", "jax")]
    assert want[0][1]["code-archive-id"] and want[3][1]["status"]["status"] == "DEPLOYED"
    assert [s[1] for s in want if len(s) == 3] == [409, 404, 404, 404, 404, 400]
    for pair, steps in got.items():
        assert steps == want, pair


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_admin_client_retries(pkg):
    """A 5xx answer is retried with backoff and a 4xx is not, as JAX's
    client does; a refused connection fails after the retries."""
    from torch_http_stub import closed_port_url

    answers = iter([(503, {}, {"error": "busy"}), (500, {}, "oops"), (200, {}, [])])
    with Stub([("GET", "/api/applications/default", lambda call: next(answers)),
               ("GET", "/api/tenants/x", lambda call: (404, {}, {"error": "tenant not found"}))]
              ) as stub:
        client, error = _client(pkg, stub.base)
        assert client.list() == [] and len(stub.calls) == 3
        with pytest.raises(error) as e:
            client.tenant_get("x")
        assert (e.value.status, str(e.value), len(stub.calls)) == (
            404, "GET /api/tenants/x → 404: tenant not found", 4)
    client, error = _client(pkg, closed_port_url())
    with pytest.raises(error, match="GET /api/tenants failed"):
        client.tenant_list()


def test_error_answers_equal_jax():
    """Unknown routes, wrong methods, a bad body and an internal error: the
    same status and body as JAX's server (aiohttp's text for the routing
    errors, the error middleware's JSON for the rest)."""
    requests_ = [
        ("GET", "/api/nothing", None, {}),
        ("PUT", "/api/applications/default", None, {}),
        ("PUT", "/api/tenants/acme", b"[1, 2]", {}),
        ("PUT", "/api/tenants/acme", b"{nope", {}),
        ("GET", "/api/applications/default/app1/code", None, {}),
        ("POST", "/api/applications/default/app1", b"not a zip", {}),
        ("POST", "/api/applications/default/app1", None, {}),
        ("GET", "/api/archetypes/default", None, {}),
        ("GET", "/api/archetypes/default/x", None, {}),
    ]
    got = {}
    for pkg in ("jax", "port"):
        with Plane(pkg) as plane:
            got[pkg] = []
            for method, path, body, headers in requests_:
                status, hdrs, data = http(method, plane.url + path, body, headers)
                kind = hdrs.get("content-type", "").split(";")[0]
                got[pkg].append((status, kind, json.loads(data) if kind.endswith("json")
                                 else data.decode()))
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == [404, 405, 400, 400, 404, 400, 400, 200, 404]


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_disk_roots_across_packages(tmp_path):
    """The same deploys through each package write the same files (layout
    and bytes), and each package's control plane serves the other's root."""
    from langstream_tpu.messaging.memory import MemoryBroker

    body, headers = deploy_form(secrets="secrets:\n  - id: s\n    data:\n      k: v\n")
    described = {}
    for pkg in ("jax", "port"):
        MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        with Plane(pkg, root=str(tmp_path / pkg)) as plane:
            for name in ("app1", "app2"):
                assert http("POST", f"{plane.url}/api/applications/default/{name}",
                            body, headers)[0] == 200
            http("PUT", f"{plane.url}/api/tenants/acme", b'{"limit": 3}')
            http("DELETE", f"{plane.url}/api/applications/default/app2")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for reader, writer in (("port", "jax"), ("jax", "port"), ("jax", "jax")):
        with Plane(reader, root=str(tmp_path / writer)) as plane:
            described[(reader, writer)] = (
                get_json(f"{plane.url}/api/applications/default/app1")[1],
                get_json(f"{plane.url}/api/applications/default")[1],
                get_json(f"{plane.url}/api/tenants")[1],
                http("GET", f"{plane.url}/api/applications/default/app1/code")[2],
            )
    assert described[("port", "jax")] == described[("jax", "port")] == described[("jax", "jax")]
    assert described[("port", "jax")][0]["status"] == {"status": "UNKNOWN"}


# -- the multipart reader ------------------------------------------------------


def _binary_zip() -> bytes:
    """A zip whose bytes hold CRLFs, a boundary-like line and NULs."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("pipeline.yaml", PIPELINE)
        zf.writestr("blob.bin", b"\r\n--boundary\r\n\x00\xff" * 50)
    return buf.getvalue()


def test_multipart_reader_takes_other_encoders_bodies():
    """Bodies from requests, urllib3 and the port's client: the same parts,
    byte for byte (CRLFs in the text, a binary zip)."""
    import requests
    import urllib3

    from langstream_tpu_torch.cli.client import multipart_body
    from langstream_tpu_torch.webservice.server import parse_multipart

    data = _binary_zip()
    text = "instance:\r\n  streamingCluster:\n    type: memory\r\n"
    fields = {"app": ("app.zip", data, "application/zip"), "instance": ("i.yaml", text, None)}
    want = [("app", data), ("instance", text.encode())]
    prepared = requests.Request("POST", "http://x/", files=fields).prepare()
    assert parse_multipart(prepared.body, prepared.headers["Content-Type"]) == want
    body, ctype = urllib3.encode_multipart_formdata(
        {"app": ("app.zip", data, "application/zip"), "instance": text})
    assert parse_multipart(body, ctype) == want
    body, ctype = multipart_body({"app": ("app.zip", data, "application/zip"),
                                  "instance": ("i.yaml", text.encode(), None)})
    assert parse_multipart(body, ctype) == want
    # a quoted boundary, a preamble and an epilogue
    quoted = (b"preamble\r\n--b\"q\r\nContent-Disposition: form-data; name=\"secrets\"\r\n\r\n"
              b"s: 1\r\n--b\"q--\r\nepilogue")
    assert parse_multipart(quoted, 'multipart/form-data; boundary="b\\"q"') == [
        ("secrets", b"s: 1")]
    from langstream_tpu_torch.webservice.service import ApplicationServiceError

    with pytest.raises(ApplicationServiceError):
        parse_multipart(b"--x\r\nContent-Disposition: form-data; name=a\r\n\r\nno end",
                        "multipart/form-data; boundary=x")


def test_aiohttp_form_deploys_on_the_port():
    """JAX's test client (aiohttp ``FormData``) deploys a binary zip on the
    port's server; the stored archive is the posted bytes."""
    import aiohttp

    data = _binary_zip()
    with Plane() as plane:
        async def post():
            form = aiohttp.FormData()
            form.add_field("app", data, filename="app.zip")
            form.add_field("instance", INSTANCE.replace("\n", "\r\n"))
            async with aiohttp.ClientSession() as session:
                async with session.post(f"{plane.url}/api/applications/default/bin",
                                        data=form) as resp:
                    return resp.status, await resp.json()

        status, body = asyncio.run(post())
        assert status == 200, body
        assert http("GET", f"{plane.url}/api/applications/default/bin/code")[2] == data
        assert produce_consume(plane, "bin", "crlf") == ["crlf"]


# -- a python agent through the control plane ----------------------------------


def test_python_agent_deployed_through_the_control_plane():
    """examples/applications/python-agent: the zip's python/ is materialised
    for the gRPC child, which imports the user's class from there."""
    from langstream_tpu_torch.cli.client import AdminClient

    app = ROOT / "examples" / "applications" / "python-agent"
    instance = ROOT / "examples" / "instances" / "local-memory.yaml"
    with Plane() as plane:
        client = AdminClient(plane.url)
        assert client.deploy("py-app", app, instance)["application-id"] == "py-app"
        code_dir = Path(tempfile.gettempdir()) / "langstream-tpu-torch-code" / "default" / "py-app"
        assert (code_dir / "python" / "example_agent.py").read_text() == (
            app / "python" / "example_agent.py").read_text()
        runner = plane.runtime.get_runner("default", "py-app")
        assert runner.application.code_directory == str(code_dir)
        for i in range(3):
            plane.call(runner.produce("input-topic", f"record {i}", key=f"k{i}"))
        got = plane.call(runner.consume("output-topic", n=3, timeout=60), timeout=90)
        assert [(r.key, r.value) for r in got[:3]] == [(f"k{i}", f"record {i}!!")
                                                       for i in range(3)]
        client.delete("py-app")
        assert not code_dir.exists()


# -- safe_dump -----------------------------------------------------------------


@pytest.mark.parametrize("value", [
    {"instance": {"globals": {"a": 1, "b": "x: y", "c": [1, 2.5, {"d": None, "e": [[1], []]}],
                              "f": {}, "g": 1e-5, "h": float("inf"), "i": True, "j": "yes",
                              "k": "012", "l": "", "m": " lead", "n": "😀 é"}}},
    {"s": "multi\nline\r\ttab \\ \" ' \x85     ﻿ \x7f \x00 # not a comment"},
    [1, [2, [3, {"x": [4]}]], {"y": {}}, []],
    {"neg": -3, "big": 2**70, "f": -0.5, "nan-free": 1.0e300, "keys": {1: "int", "2": "str"}},
    "a scalar", None, {}, [],
], ids=lambda v: type(v).__name__)
def test_safe_dump_round_trips_through_pyyaml(value):
    from langstream_tpu_torch.core.yaml_reader import safe_dump, safe_load

    text = safe_dump(value)
    assert yaml.safe_load(text) == value
    assert safe_load(text) == value
    if isinstance(value, (dict, list)):  # PyYAML ends a scalar document with "..."
        assert safe_load(yaml.safe_dump(value)) == value


def test_safe_dump_refuses_what_it_cannot_write():
    from langstream_tpu_torch.core.yaml_reader import safe_dump

    with pytest.raises(TypeError):
        safe_dump({"x": object()})
