"""A control plane of either package on its own event-loop thread, for the
port's control-plane and CLI tests: the JAX package's (aiohttp) or the
port's (stdlib) ``ControlPlaneServer`` over ``make_local_service``, driven
from the test's thread by blocking clients (urllib, requests, the CLIs).

    with Plane("port", root=None) as plane:
        status, headers, body = http("GET", f"{plane.url}/api/tenants")
        runner = plane.runtime.get_runner("default", "app1")
        plane.call(runner.produce("input-topic", "ping"))
"""

from __future__ import annotations

import asyncio
import io
import json
import threading
import urllib.error
import urllib.request
import zipfile
from typing import Any, Optional

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

INSTANCE = """
instance:
  streamingCluster:
    type: memory
  computeCluster:
    type: local
"""


def make_zip(files: dict[str, str]) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, text in files.items():
            zf.writestr(name, text)
    return buf.getvalue()


class Plane:
    def __init__(self, pkg: str = "port", root: Optional[str] = None,
                 code_storage: Any = None, **server_kw: Any) -> None:
        if pkg == "port":
            from langstream_tpu_torch.webservice.server import ControlPlaneServer
            from langstream_tpu_torch.webservice.service import make_local_service
        else:
            from langstream_tpu.webservice.server import ControlPlaneServer
            from langstream_tpu.webservice.service import make_local_service
        self.pkg = pkg
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()

        async def boot():
            applications, tenants, runtime = make_local_service(root, code_storage)
            server = ControlPlaneServer(applications, tenants, port=0, **server_kw)
            await server.start()
            return applications, tenants, runtime, server

        self.applications, self.tenants, self.runtime, self.server = self.call(boot())
        self.url = self.server.url

    def call(self, coro, timeout: float = 60.0) -> Any:
        """Run a coroutine on the plane's loop and wait for its result."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        async def shutdown():
            await self.runtime.close()
            await self.server.stop()

        try:
            self.call(shutdown())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(10)
            self.loop.close()

    def __enter__(self) -> "Plane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def http(method: str, url: str, body: Optional[bytes] = None,
         headers: Optional[dict[str, str]] = None,
         timeout: float = 60.0) -> tuple[int, dict[str, str], bytes]:
    """One request: (status, lower-cased headers, body); error statuses
    are answers, not exceptions."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


def deploy_form(files: Optional[dict[str, str]] = None, instance: Optional[str] = INSTANCE,
                secrets: Optional[str] = None) -> tuple[bytes, dict[str, str]]:
    """A deploy's multipart body and headers (the port client's encoder)."""
    from langstream_tpu_torch.cli.client import multipart_body

    fields = {"app": ("app.zip", make_zip(files or {"pipeline.yaml": PIPELINE}),
                      "application/zip")}
    if instance is not None:
        fields["instance"] = ("instance.yaml", instance.encode(), None)
    if secrets is not None:
        fields["secrets"] = ("secrets.yaml", secrets.encode(), None)
    body, content_type = multipart_body(fields)
    return body, {"Content-Type": content_type}


def deploy(plane: Plane, name: str = "app1", tenant: str = "default", method: str = "POST",
           **form: Any) -> tuple[int, Any]:
    body, headers = deploy_form(**form)
    status, _, data = http(method, f"{plane.url}/api/applications/{tenant}/{name}", body,
                           headers)
    return status, json.loads(data)
