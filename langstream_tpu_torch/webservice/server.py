"""Control-plane REST server on the stdlib (the port's own copy of
``langstream_tpu/webservice/server.py``, on ``asyncio.start_server`` and
the port's HTTP helpers, ``gateway/websocket.py``: the card's machine has
no aiohttp). The same routes, status codes and JSON bodies:

  POST   /api/applications/{tenant}/{name}           multipart deploy (app zip + instance + secrets)
  PATCH  /api/applications/{tenant}/{name}           update (same form)
  GET    /api/applications/{tenant}                  list
  GET    /api/applications/{tenant}/{name}           describe (+status)
  DELETE /api/applications/{tenant}/{name}           delete
  GET    /api/applications/{tenant}/{name}/logs      runtime logs (?follow=1: NDJSON stream)
  GET    /api/applications/{tenant}/{name}/code      download code archive
  PUT/GET/DELETE /api/tenants[/{name}]               tenant CRUD (TenantResource)
  GET    /api/archetypes/{tenant}[/{id}]             archetype catalog (ArchetypeResource)
  POST   /api/archetypes/{tenant}/{id}/applications/{name}   create app from archetype
  GET    /api/docs, /ui, /healthz

Bearer-token auth (reference TokenAuthFilter) via a static admin token,
and JWT bearer verification (``auth.py``); either credential is accepted.
A follow stream ends when its client goes away or its application stops
(a delete or an update: follow the new deploy with a new request).
"""

from __future__ import annotations

import asyncio
import email.message
import email.utils
import io
import json
import logging
import re
import urllib.parse
import zipfile
from pathlib import Path
from typing import Any, Awaitable, Callable, Optional

from langstream_tpu_torch.core.yaml_reader import safe_dump, safe_load
from langstream_tpu_torch.gateway.websocket import (
    HttpError,
    Request,
    Response,
    serve_connection,
)
from langstream_tpu_torch.webservice.service import (
    ApplicationService,
    ApplicationServiceError,
    TenantService,
)

log = logging.getLogger(__name__)

# a quiet follow stream writes a blank line this often: a client that went
# away without closing shows only on a write
KEEPALIVE_S = 2.0


def _json(doc: Any, status: int = 200) -> Response:
    return Response.json(doc, status)


def parse_multipart(body: bytes, content_type: str) -> list[tuple[str, bytes]]:
    """The ``(name, bytes)`` parts of a ``multipart/form-data`` body (RFC
    7578): the boundary from ``content_type``, each part's name from its
    ``Content-Disposition``; the bytes as sent (CRLFs and binary kept).
    ``ApplicationServiceError`` (400) for a body that is not one."""
    header = email.message.Message()
    header["content-type"] = content_type
    boundary = header.get_param("boundary")
    if not isinstance(boundary, str) or not boundary:
        raise ApplicationServiceError("multipart body without a boundary")
    delim = b"--" + boundary.encode("latin-1")
    start = body.find(delim)
    if start < 0 or (start > 0 and body[start - 2:start] != b"\r\n"):
        raise ApplicationServiceError("multipart body without its first boundary")
    parts: list[tuple[str, bytes]] = []
    pos = start + len(delim)
    while not body.startswith(b"--", pos):  # the close delimiter
        eol = body.find(b"\r\n", pos)
        if eol < 0:
            raise ApplicationServiceError("truncated multipart body")
        head_end = body.find(b"\r\n\r\n", eol)
        if head_end < 0:
            raise ApplicationServiceError("truncated multipart part head")
        end = body.find(b"\r\n" + delim, head_end + 4)
        if end < 0:
            raise ApplicationServiceError("truncated multipart part")
        disposition = email.message.Message()
        for line in body[eol + 2:head_end].decode("latin-1").split("\r\n"):
            key, sep, value = line.partition(":")
            if sep and key.strip().lower() == "content-disposition":
                disposition["content-disposition"] = value.strip()
        name = disposition.get_param("name", header="content-disposition")
        if isinstance(name, tuple):  # an RFC 2231 value
            name = email.utils.collapse_rfc2231_value(name)
        parts.append((str(name or ""), body[head_end + 4:end]))
        pos = end + 2 + len(delim)
    return parts


class ControlPlaneServer:
    def __init__(
        self,
        applications: ApplicationService,
        tenants: TenantService,
        host: str = "127.0.0.1",
        port: int = 8090,
        auth_token: Optional[str] = None,
        archetypes_path: Optional[str] = None,
        auth_jwt: Optional[dict] = None,
    ) -> None:
        """``auth_jwt``: JWT bearer verification config (secret-key /
        public-key / jwks-uri + audience/issuer — ``auth.py``, reference
        langstream-auth-jwt on the control plane). May be combined with
        ``auth_token`` (either credential is accepted)."""
        self.applications = applications
        self.tenants = tenants
        self.host = host
        self.port = port
        self.auth_token = auth_token
        self.jwt_verifier = None
        if auth_jwt:
            from langstream_tpu_torch.auth import JwtVerifier

            self.jwt_verifier = JwtVerifier(auth_jwt)
        self.archetypes_path = Path(archetypes_path) if archetypes_path else None
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set[asyncio.Task] = set()
        app = r"/api/applications/(?P<tenant>[^/]+)"
        arch = r"/api/archetypes/(?P<tenant>[^/]+)"
        handlers: list[tuple[str, str, Callable[[Request], Awaitable[Optional[Response]]]]] = [
            ("POST", rf"{app}/(?P<name>[^/]+)", self._deploy),
            ("PATCH", rf"{app}/(?P<name>[^/]+)", self._update),
            ("GET", app, self._list),
            ("GET", rf"{app}/(?P<name>[^/]+)", self._get),
            ("DELETE", rf"{app}/(?P<name>[^/]+)", self._delete),
            ("GET", rf"{app}/(?P<name>[^/]+)/logs", self._logs),
            ("GET", rf"{app}/(?P<name>[^/]+)/code", self._code),
            ("PUT", r"/api/tenants/(?P<name>[^/]+)", self._tenant_put),
            ("GET", r"/api/tenants/(?P<name>[^/]+)", self._tenant_get),
            ("DELETE", r"/api/tenants/(?P<name>[^/]+)", self._tenant_delete),
            ("GET", r"/api/tenants", self._tenant_list),
            ("GET", arch, self._archetype_list),
            ("GET", rf"{arch}/(?P<id>[^/]+)", self._archetype_get),
            ("POST", rf"{arch}/(?P<id>[^/]+)/applications/(?P<name>[^/]+)",
             self._archetype_deploy),
            ("GET", r"/api/docs", self._docs),
            ("GET", r"/ui", self._ui),
            ("GET", r"/healthz", self._healthz),
        ]
        self._routes = [(m, re.compile(f"^{p}$"), h) for m, p, h in handlers]

    async def _ui(self, request: Request) -> Response:
        from langstream_tpu_torch.webservice.ui import UI_HTML

        return Response(200, UI_HTML.encode(), "text/html; charset=utf-8")

    async def _docs(self, request: Request) -> Response:
        from langstream_tpu_torch.webservice.docs import generate_documentation_model

        return _json(generate_documentation_model())

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._connection, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        log.info("control plane listening on %s:%s", self.host, self.port)

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()
            for task in list(self._connections):
                task.cancel()
            await asyncio.gather(*self._connections, return_exceptions=True)
            await server.wait_closed()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def _healthz(self, request: Request) -> Response:
        return _json({"status": "OK"})

    # -- connections, auth and errors (JAX's middlewares) ---------------------

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        await serve_connection(reader, writer, self._dispatch, self._connections)

    async def _dispatch(self, request: Request) -> Optional[Response]:
        protected = self.auth_token is not None or self.jwt_verifier is not None
        if protected and request.path not in ("/healthz", "/ui"):
            if not await self._authorized(request.headers.get("authorization", "")):
                return _json({"error": "unauthorized"}, 401)
        path = urllib.parse.unquote(request.path)
        allowed = False
        for method, pattern, handler in self._routes:
            m = pattern.match(path)
            if m is None:
                continue
            if method != request.method:
                allowed = True
                continue
            request.match_info = m.groupdict()
            try:
                return await handler(request)
            except ApplicationServiceError as e:
                return _json({"error": str(e)}, e.status)
            except HttpError as e:
                return Response.error(e)
            except Exception as e:  # noqa: BLE001
                log.exception("internal error on %s %s", request.method, request.path)
                return _json({"error": str(e)}, 500)
        return Response.error(HttpError(405 if allowed else 404))

    async def _authorized(self, header: str) -> bool:
        if not header.startswith("Bearer "):
            return False
        token = header[len("Bearer "):]
        if self.auth_token is not None and token == self.auth_token:
            return True
        if self.jwt_verifier is not None:
            from langstream_tpu_torch.auth import JwtError

            try:
                await self.jwt_verifier.verify(token)
                return True
            except JwtError:
                return False
        return False

    # -- applications --------------------------------------------------------

    _NAME_RE = re.compile(r"^[a-z0-9][a-z0-9-]{0,62}$")

    @classmethod
    def _check_name(cls, kind: str, name: str) -> str:
        """DNS-label style names only (reference K8s naming constraints) —
        also forecloses path traversal through ids used in storage paths."""
        if not cls._NAME_RE.match(name):
            raise ApplicationServiceError(
                f"invalid {kind} name {name!r}: must match {cls._NAME_RE.pattern}"
            )
        return name

    def _check_tenant(self, tenant: str) -> None:
        self._check_name("tenant", tenant)
        if not self.tenants.exists(tenant):
            raise ApplicationServiceError(f"tenant {tenant!r} not found", status=404)

    @staticmethod
    def _read_deploy_form(
        request: Request,
    ) -> tuple[Optional[bytes], Optional[str], Optional[str], bool]:
        archive: Optional[bytes] = None
        instance: Optional[str] = None
        secrets: Optional[str] = None
        dry_run = request.query.get("dry-run", "false").lower() == "true"
        content_type = request.headers.get("content-type", "")
        if content_type.lower().startswith("multipart/"):
            for name, data in parse_multipart(request.body, content_type):
                if name == "app":
                    archive = data
                elif name == "instance":
                    instance = data.decode()
                elif name == "secrets":
                    secrets = data.decode()
        else:
            archive = request.body or None
        return archive, instance, secrets, dry_run

    async def _deploy(self, request: Request, allow_update: bool = False) -> Response:
        tenant = request.match_info["tenant"]
        name = self._check_name("application", request.match_info["name"])
        self._check_tenant(tenant)
        archive, instance, secrets, dry_run = self._read_deploy_form(request)
        result = await self.applications.deploy(
            tenant, name, archive, instance, secrets, allow_update=allow_update,
            dry_run=dry_run,
        )
        return _json(result)

    async def _update(self, request: Request) -> Response:
        return await self._deploy(request, allow_update=True)

    async def _list(self, request: Request) -> Response:
        tenant = request.match_info["tenant"]
        self._check_tenant(tenant)
        return _json(self.applications.list(tenant))

    async def _get(self, request: Request) -> Response:
        tenant = request.match_info["tenant"]
        self._check_tenant(tenant)
        # the status may come from a Kubernetes API server (a blocking
        # client): read it on a worker thread, never on this loop
        return _json(await asyncio.to_thread(
            self.applications.describe, tenant, request.match_info["name"]))

    async def _delete(self, request: Request) -> Response:
        tenant = request.match_info["tenant"]
        self._check_tenant(tenant)
        await self.applications.delete(tenant, request.match_info["name"])
        return _json({"deleted": request.match_info["name"]})

    async def _logs(self, request: Request) -> Optional[Response]:
        """Application logs. Default: one-shot text snapshot. With
        ``?follow=1``: an unbounded NDJSON stream (chunked) of live log
        lines (history first, then new lines as agents emit them),
        optionally narrowed with ``?filter=<replica>`` — the reference's
        pod-log Flux (ApplicationResource.java:312-330) mapped onto the
        local runtime's per-replica LogHub."""
        tenant = request.match_info["tenant"]
        self._check_tenant(tenant)
        name = request.match_info["name"]
        follow = request.query.get("follow") in ("1", "true", "yes")
        replica = request.query.get("filter") or None
        if not follow:
            lines = await asyncio.to_thread(self.applications.logs, tenant, name)
            if replica:
                lines = [ln for ln in lines if ln.startswith(f"{replica}:")]
            return Response(200, "\n".join(lines).encode(), "text/plain; charset=utf-8")
        hub = self.applications.log_hub(tenant, name)
        if hub is None:
            raise ApplicationServiceError(
                "log streaming is not available for this runtime", status=501
            )
        writer = request.writer
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n")
        queue = hub.subscribe()
        # the client sends nothing more: a read that ends means it went away
        gone = asyncio.ensure_future(request.reader.read(1))
        get: Optional[asyncio.Future] = None

        async def send(data: bytes) -> None:
            writer.write(b"%x\r\n%s\r\n" % (len(data), data) if data else b"0\r\n\r\n")
            await writer.drain()

        try:
            # entries emitted between subscribe() and this snapshot land in
            # BOTH the ring and the queue; their seq lets the live loop skip
            # what the history replay already wrote
            last_seq = 0
            for entry in hub.history(replica):
                # max, not last-write: ring entries may replay out of seq
                # order, and tracking only the final entry's seq would
                # re-emit (duplicate) every history line above it below
                last_seq = max(last_seq, entry["seq"])
                await send(json.dumps(entry).encode() + b"\n")
            while not gone.done():
                get = asyncio.ensure_future(queue.get())
                done, _ = await asyncio.wait({get, gone}, timeout=KEEPALIVE_S,
                                             return_when=asyncio.FIRST_COMPLETED)
                if get not in done:
                    get.cancel()
                    if not gone.done():
                        await send(b"\n")  # keepalive blank line
                    continue
                entry = get.result()
                if entry is None:  # the application stopped
                    await send(b"")
                    break
                if entry["seq"] <= last_seq:
                    continue
                if replica and entry["replica"] != replica:
                    continue
                await send(json.dumps(entry).encode() + b"\n")
        except ConnectionError:
            pass  # client went away — the normal end of a follow
        finally:
            gone.cancel()
            if get is not None:
                get.cancel()
            hub.unsubscribe(queue)
        return None

    async def _code(self, request: Request) -> Response:
        tenant = request.match_info["tenant"]
        self._check_tenant(tenant)
        # code storage may be remote (S3): off the event loop
        data = await asyncio.to_thread(
            self.applications.download_code, tenant, request.match_info["name"]
        )
        return Response(200, data, "application/zip")

    # -- tenants -------------------------------------------------------------

    async def _tenant_put(self, request: Request) -> Response:
        name = self._check_name("tenant", request.match_info["name"])
        body: dict[str, Any] = {}
        if request.body:
            try:
                body = json.loads(request.text() or "{}")
            except (json.JSONDecodeError, UnicodeDecodeError):
                raise ApplicationServiceError("tenant body must be JSON") from None
            if not isinstance(body, dict):
                raise ApplicationServiceError("tenant body must be a JSON object")
        self.tenants.put(name, {"name": name, **body})
        return _json({"name": name})

    async def _tenant_get(self, request: Request) -> Response:
        config = self.tenants.get(request.match_info["name"])
        if config is None:
            raise ApplicationServiceError("tenant not found", status=404)
        return _json(config)

    async def _tenant_delete(self, request: Request) -> Response:
        name = request.match_info["name"]
        for app_id in list(self.applications.store.list(name)):
            await self.applications.delete(name, app_id)
        self.tenants.delete(name)
        return _json({"deleted": name})

    async def _tenant_list(self, request: Request) -> Response:
        return _json(self.tenants.list())

    # -- archetypes ----------------------------------------------------------

    def _archetype_dir(self, archetype_id: str) -> Path:
        if self.archetypes_path is None:
            raise ApplicationServiceError("no archetypes configured", status=404)
        path = (self.archetypes_path / archetype_id).resolve()
        if not path.is_relative_to(self.archetypes_path.resolve()) or not path.is_dir():
            raise ApplicationServiceError(f"archetype {archetype_id!r} not found", status=404)
        return path

    async def _archetype_list(self, request: Request) -> Response:
        if self.archetypes_path is None or not self.archetypes_path.is_dir():
            return _json([])
        out = []
        for child in sorted(self.archetypes_path.iterdir()):
            if (child / "archetype.yaml").exists():
                meta = safe_load((child / "archetype.yaml").read_text()) or {}
                out.append({"id": child.name, **meta.get("archetype", {})})
        return _json(out)

    async def _archetype_get(self, request: Request) -> Response:
        path = self._archetype_dir(request.match_info["id"])
        meta = safe_load((path / "archetype.yaml").read_text()) or {}
        return _json({"id": request.match_info["id"], **meta})

    async def _archetype_deploy(self, request: Request) -> Response:
        """Materialize an archetype into an application: the posted JSON
        parameters become instance globals (ArchetypeResource deploy path)."""
        tenant = request.match_info["tenant"]
        self._check_tenant(tenant)
        path = self._archetype_dir(request.match_info["id"])
        name = request.match_info["name"]
        try:
            parameters = json.loads(request.text() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise ApplicationServiceError("parameters must be JSON") from None

        app_dir = path / "application"
        if not app_dir.is_dir():
            raise ApplicationServiceError("archetype has no application/ dir", status=500)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            for p in sorted(app_dir.rglob("*")):
                if p.is_file():
                    zf.write(p, str(p.relative_to(app_dir)))
        instance_file = path / "instance.yaml"
        instance_data = (
            safe_load(instance_file.read_text()) if instance_file.exists() else None
        )
        if not isinstance(instance_data, dict):
            instance_data = {}
        if not isinstance(instance_data.get("instance"), dict):
            instance_data["instance"] = {}
        if not isinstance(instance_data["instance"].get("globals"), dict):
            instance_data["instance"]["globals"] = {}
        instance_data["instance"]["globals"].update(parameters)
        result = await self.applications.deploy(
            tenant,
            name,
            buf.getvalue(),
            safe_dump(instance_data),
            None,
            allow_update=False,
        )
        return _json(result)
