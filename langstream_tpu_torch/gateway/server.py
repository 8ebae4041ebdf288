"""The gateway server of the port: websocket and HTTP endpoints on an
asyncio stdlib server (``asyncio.start_server``, ``gateway/websocket.py``;
the card's machine has no aiohttp). The port's own copy of
``langstream_tpu/gateway/server.py``, with the same routes, statuses and
messages:

  WS  /v1/produce/{tenant}/{application}/{gateway}   (ProduceHandler)
  WS  /v1/consume/{tenant}/{application}/{gateway}   (ConsumeHandler)
  WS  /v1/chat/{tenant}/{application}/{gateway}      (ChatHandler.java:63)
  POST /api/gateways/produce/{tenant}/{application}/{gateway}  (GatewayResource.java:95)
  *   /api/gateways/service/{tenant}/{application}/{gateway}   (GatewayResource.java:72,335:
       topic request-reply via the langstream-service-request-id header, or
       HTTP proxy to the agent's service pod when service-options.agent-id set)
  GET /healthz

The server is storage-agnostic: an ``ApplicationProvider`` resolves
``(tenant, application)`` → parsed Application + its topic-connections
runtime (the local runner implements it). A gateway that declares
``authentication`` checks each request's ``credentials`` through its
provider (``gateway/auth.py``); ``test-credentials`` pass only where the
gateway allows test mode and the server was given a ``test_auth_provider``.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import re
import urllib.parse
import uuid
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Optional, Protocol

from langstream_tpu_torch.api.model import Application, Gateway
from langstream_tpu_torch.api.record import Header, Record
from langstream_tpu_torch.api.topics import TopicConnectionsRuntime
from langstream_tpu_torch.gateway.core import (
    AuthFailedException,
    ConsumeGateway,
    GatewayRequestContext,
    ProduceException,
    ProduceGateway,
    authenticate_and_validate,
    build_message_filters,
    resolve_common_headers,
)
from langstream_tpu_torch.gateway.websocket import (
    HttpError,
    Request,
    Response,
    WebSocket,
    serve_connection,
)
from langstream_tpu_torch.serving.tenancy import (
    RETRY_AFTER_PROPERTY,
    SHED_PROPERTY,
    TENANT_HEADER,
)

log = logging.getLogger(__name__)

SERVICE_REQUEST_ID_HEADER = "langstream-service-request-id"


def _with_tenant(headers: list[Header], tenant: str) -> list[Header]:
    """Stamp the langstream tenant id onto every produced record's common
    headers (multi-tenant overload control, docs/SERVING.md §19) — the
    completions step reads it into GenerationOptions.tenant. A header the
    gateway's own mappings (or, later, the client payload — record-level
    headers append after common ones) already set WINS: front doors may
    map their own identity onto serving tenants."""
    if any(h.key == TENANT_HEADER for h in headers):
        return headers
    return [*headers, Header(TENANT_HEADER, tenant)]


def _cancel_session_requests(headers: list[Header]) -> None:
    """Client gone → cancel the session's in-flight generations so the
    serving engine frees their slots at the next chunk boundary instead of
    decoding to max_new_tokens for nobody (serving/lifecycle.py; effective
    when the engine shares this process — local runner / embedded gateway).

    CHAT sockets only: a chat disconnect ends the conversation, so its
    pending answers are dead work. Produce/consume sockets must NOT do
    this — the split produce/consume flow closes the produce socket while
    still reading answers elsewhere, and the consume gateway's offset
    tokens exist precisely so a dropped reader can reconnect and resume."""
    from langstream_tpu_torch.serving.lifecycle import SESSION_HEADER, cancel

    for h in headers or []:
        if h.key == SESSION_HEADER:
            try:
                cancel(h.value_as_string())
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.exception("session cancellation failed")


@dataclass
class GatewayApplication:
    application: Application
    topic_runtime: TopicConnectionsRuntime


class ApplicationProvider(Protocol):
    async def get_application(self, tenant: str, application_id: str) -> GatewayApplication: ...

    def agent_service_uri(self, tenant: str, application_id: str, agent_id: str) -> Optional[str]:
        """Base URI of a deployed service agent (for service-gateway proxying);
        None when unknown (local mode without pods)."""
        return None


class DictApplicationProvider:
    """In-memory provider for tests and the local runner."""

    def __init__(self) -> None:
        self._apps: dict[tuple[str, str], GatewayApplication] = {}
        self._service_uris: dict[tuple[str, str, str], str] = {}

    def put(
        self,
        tenant: str,
        application_id: str,
        application: Application,
        topic_runtime: TopicConnectionsRuntime,
    ) -> None:
        self._apps[(tenant, application_id)] = GatewayApplication(application, topic_runtime)

    def put_service_uri(self, tenant: str, application_id: str, agent_id: str, uri: str) -> None:
        self._service_uris[(tenant, application_id, agent_id)] = uri

    async def get_application(self, tenant: str, application_id: str) -> GatewayApplication:
        key = (tenant, application_id)
        if key not in self._apps:
            raise KeyError(f"application {tenant}/{application_id} not found")
        return self._apps[key]

    def agent_service_uri(self, tenant: str, application_id: str, agent_id: str) -> Optional[str]:
        return self._service_uris.get((tenant, application_id, agent_id))


class UnsupportedTopologyError(Exception):
    """The application exists but its configuration cannot be served from
    this process (maps to HTTP 400, not 404)."""


class StoreApplicationProvider:
    """Resolves applications from a control-plane ApplicationStore (the
    standalone-gateway deployment: gateway pod + control plane share the
    store; reference gateway resolves via the k8s application store). A
    broker-backed application gets one topic runtime, made once from the
    port's ``messaging/registry.py``; the in-memory broker is refused."""

    def __init__(self, store: Any) -> None:
        self.store = store
        self._runtimes: dict[tuple[str, str], TopicConnectionsRuntime] = {}

    async def get_application(self, tenant: str, application_id: str) -> GatewayApplication:
        stored = self.store.get(tenant, application_id)
        if stored is None:
            raise KeyError(f"application {tenant}/{application_id} not found")
        key = (tenant, application_id)
        runtime = self._runtimes.get(key)
        if runtime is None:
            from langstream_tpu_torch.messaging.registry import get_topic_connections_runtime

            streaming = stored.application.instance.streaming_cluster
            if streaming.type == "memory":
                # the in-memory broker is process-local: a standalone gateway
                # cannot reach the agents' broker in another process — this
                # topology needs a real broker (kafka/pulsar/pravega)
                raise UnsupportedTopologyError(
                    f"application {tenant}/{application_id} uses the in-memory "
                    "broker, which a standalone gateway process cannot reach; "
                    "use `run local` (embedded gateway) or a broker-backed "
                    "streamingCluster"
                )
            runtime = get_topic_connections_runtime(streaming.type)
            await runtime.init(streaming.configuration)
            # another request may have made one while this one awaited
            runtime = self._runtimes.setdefault(key, runtime)
        return GatewayApplication(stored.application, runtime)

    def agent_service_uri(self, tenant: str, application_id: str, agent_id: str) -> Optional[str]:
        return None


class GatewayServer:
    def __init__(
        self,
        provider: ApplicationProvider,
        host: str = "127.0.0.1",
        port: int = 8091,
        test_auth_provider: Optional[Any] = None,
    ) -> None:
        """``test_auth_provider``: server-level provider validating
        ``test-credentials``; when None (production default) test mode is
        rejected (reference GatewayRequestHandler.authenticate:229-240)."""
        self.provider = provider
        self.host = host
        self.port = port
        self.test_auth_provider = test_auth_provider
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set[asyncio.Task] = set()
        seg = r"(?P<tenant>[^/]+)/(?P<application>[^/]+)/(?P<gateway>[^/]+)"
        self._routes: list[tuple[str, re.Pattern, Callable[[Request], Awaitable[Any]]]] = [
            ("GET", re.compile(rf"^/v1/produce/{seg}$"), self._ws_produce),
            ("GET", re.compile(rf"^/v1/consume/{seg}$"), self._ws_consume),
            ("GET", re.compile(rf"^/v1/chat/{seg}$"), self._ws_chat),
            ("POST", re.compile(rf"^/api/gateways/produce/{seg}$"), self._http_produce),
            ("*", re.compile(rf"^/api/gateways/service/{seg}(?P<tail>/.*)?$"), self._http_service),
            ("GET", re.compile(r"^/healthz$"), self._healthz),
        ]

    async def _healthz(self, request: Request) -> Response:
        return Response.json({"status": "OK"})

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._connection, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        log.info("gateway listening on %s:%s", self.host, self.port)

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

    @property
    def ws_url(self) -> str:
        return f"ws://{self.host}:{self.port}"

    # -- connections ---------------------------------------------------------

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        await serve_connection(reader, writer, self._dispatch, self._connections)

    async def _dispatch(self, request: Request) -> Optional[Response]:
        path = urllib.parse.unquote(request.path)
        allowed = False
        for method, pattern, handler in self._routes:
            m = pattern.match(path)
            if m is None:
                continue
            if method not in ("*", request.method):
                allowed = True
                continue
            request.match_info = {k: v or "" for k, v in m.groupdict().items()}
            try:
                return await handler(request)
            except HttpError as e:
                return Response.error(e)
            except Exception:  # noqa: BLE001 — a handler fault is a 500
                log.exception("gateway handler failed")
                return Response.error(HttpError(500))
        return Response.error(HttpError(405 if allowed else 404))

    # -- shared request setup ------------------------------------------------

    async def _context(
        self, request: Request, expected_type: str
    ) -> tuple[GatewayRequestContext, GatewayApplication]:
        tenant = request.match_info["tenant"]
        application_id = request.match_info["application"]
        gateway_id = request.match_info["gateway"]
        try:
            gw_app = await self.provider.get_application(tenant, application_id)
        except UnsupportedTopologyError as e:
            raise HttpError(400, str(e)) from e
        except KeyError as e:
            raise HttpError(404, str(e)) from e
        gateway = self._find_gateway(gw_app.application, gateway_id, expected_type)
        try:
            context = await authenticate_and_validate(
                tenant,
                application_id,
                gw_app.application,
                gateway,
                dict(request.query),
                test_auth_provider=self.test_auth_provider,
            )
        except AuthFailedException as e:
            raise HttpError(401, str(e)) from e
        except ValueError as e:
            raise HttpError(400, str(e)) from e
        return context, gw_app

    @staticmethod
    def _find_gateway(application: Application, gateway_id: str, expected_type: str) -> Gateway:
        for g in application.gateways:
            if g.id == gateway_id:
                if g.type != expected_type:
                    raise HttpError(
                        400, f"gateway {gateway_id!r} is of type {g.type}, not {expected_type}"
                    )
                return g
        raise HttpError(404, f"gateway {gateway_id!r} not found")

    # -- websocket handlers --------------------------------------------------

    async def _ws_produce(self, request: Request) -> None:
        context, gw_app = await self._context(request, "produce")
        topic = context.gateway.topic
        if not topic:
            raise HttpError(400, "produce gateway has no topic")
        mappings = (
            context.gateway.produce_options.headers if context.gateway.produce_options else []
        )
        headers = _with_tenant(
            resolve_common_headers(
                mappings, context.user_parameters, context.principal_values
            ),
            context.tenant,
        )
        ws = await WebSocket.accept(request)
        produce = ProduceGateway(gw_app.topic_runtime)
        try:
            await produce.start(topic, headers)
            await self._publish_event("ClientConnected", context, gw_app)
            async for msg in ws:
                if msg.kind != "text":
                    continue
                await ws.send_json(await self._safe_produce(produce, msg.data))
        finally:
            await produce.close()
            await self._publish_event("ClientDisconnected", context, gw_app)
            await ws.close()
        return None

    @staticmethod
    async def _safe_produce(
        produce: ProduceGateway, payload: str, ensure_trace: bool = False
    ) -> dict[str, Any]:
        try:
            if ensure_trace:
                # chat messages get a trace id at the FRONT DOOR (client-
                # supplied header wins): the pipeline propagates it record
                # to record, the completions step hands it to the serving
                # engine, and the streamed answer chunks echo it back — so
                # a chat request's whole gateway→engine→fetch path
                # stitches into one trace on /traces. Clients correlate by
                # the id they sent, or read the stamped one off any chunk
                # (chat sockets do not ack successful produces).
                from langstream_tpu_torch.tracing import TRACE_HEADER

                request = ProduceGateway.parse_produce_request(payload)
                headers = request.get("headers")
                if not isinstance(headers, dict):
                    headers = {}
                if not headers.get(TRACE_HEADER):
                    headers[TRACE_HEADER] = uuid.uuid4().hex[:16]
                request["headers"] = headers
                await produce.produce(request)
                return {"status": "OK", "reason": None}
            await produce.produce_payload(payload)
            return {"status": "OK", "reason": None}
        except ProduceException as e:
            return {"status": e.status, "reason": str(e)}

    async def _ws_consume(self, request: Request) -> None:
        context, gw_app = await self._context(request, "consume")
        topic = context.gateway.topic
        if not topic:
            raise HttpError(400, "consume gateway has no topic")
        mappings = (
            (context.gateway.consume_options.filters or {}).get("headers", [])
            if context.gateway.consume_options
            else []
        )
        filters = build_message_filters(
            mappings, context.user_parameters, context.principal_values
        )
        ws = await WebSocket.accept(request)
        consume = ConsumeGateway(gw_app.topic_runtime)
        try:
            await consume.setup(topic, filters, context.options.get("position"))
            consume.start_reading(ws.send_str, on_error=lambda e: ws.close())
            await self._publish_event("ClientConnected", context, gw_app)
            async for _ in ws:  # client messages are ignored; close ends the loop
                pass
        finally:
            await consume.close()
            # NO cancellation here: consume sockets reconnect with offset
            # tokens — a transient drop must resume into a complete answer,
            # not a truncated one
            await self._publish_event("ClientDisconnected", context, gw_app)
            await ws.close()
        return None

    async def _ws_chat(self, request: Request) -> None:
        """One socket: produce to questions-topic, filtered consume from
        answers-topic (reference ChatHandler.java:63-140)."""
        context, gw_app = await self._context(request, "chat")
        chat = context.gateway.chat_options
        if chat is None or not chat.questions_topic or not chat.answers_topic:
            raise HttpError(
                400, "chat gateway requires chat-options.questions-topic and answers-topic"
            )
        headers = _with_tenant(
            resolve_common_headers(
                chat.headers, context.user_parameters, context.principal_values
            ),
            context.tenant,
        )
        filters = build_message_filters(
            chat.headers, context.user_parameters, context.principal_values
        )
        ws = await WebSocket.accept(request)
        produce = ProduceGateway(gw_app.topic_runtime)
        consume = ConsumeGateway(gw_app.topic_runtime)
        try:
            await produce.start(chat.questions_topic, headers)
            await consume.setup(chat.answers_topic, filters, context.options.get("position"))
            consume.start_reading(ws.send_str, on_error=lambda e: ws.close())
            await self._publish_event("ClientConnected", context, gw_app)
            async for msg in ws:
                if msg.kind != "text":
                    continue
                response = await self._safe_produce(
                    produce, msg.data, ensure_trace=True
                )
                if response["status"] != "OK":
                    await ws.send_json(response)
        finally:
            await consume.close()
            await produce.close()
            _cancel_session_requests(headers)
            await self._publish_event("ClientDisconnected", context, gw_app)
            await ws.close()
        return None

    async def _publish_event(
        self, event: str, context: GatewayRequestContext, gw_app: GatewayApplication
    ) -> None:
        """Emit a gateway lifecycle event when the gateway declares an
        events-topic (reference api/events GatewayEventData)."""
        if not context.gateway.events_topic:
            return
        try:
            await publish_gateway_event(
                gw_app.topic_runtime, context.gateway.events_topic, event, context
            )
        except Exception:  # noqa: BLE001 — events are best-effort
            log.exception("failed to publish gateway event")

    # -- HTTP handlers -------------------------------------------------------

    async def _http_produce(self, request: Request) -> Response:
        context, gw_app = await self._context(request, "produce")
        topic = context.gateway.topic
        if not topic:
            raise HttpError(400, "produce gateway has no topic")
        mappings = (
            context.gateway.produce_options.headers if context.gateway.produce_options else []
        )
        headers = _with_tenant(
            resolve_common_headers(
                mappings, context.user_parameters, context.principal_values
            ),
            context.tenant,
        )
        produce = ProduceGateway(gw_app.topic_runtime)
        await produce.start(topic, headers)
        try:
            response = await self._safe_produce(produce, request.text())
        finally:
            await produce.close()
        status = 200 if response["status"] == "OK" else 400
        return Response.json(response, status=status)

    async def _http_service(self, request: Request) -> Response:
        context, gw_app = await self._context(request, "service")
        service = context.gateway.service_options
        if service is None:
            raise HttpError(400, "service gateway requires service-options")

        if service.agent_id:
            return await self._proxy_to_agent(request, context, service.agent_id)

        if request.method != "POST":
            raise HttpError(400, "Only POST method is supported")
        if not service.input_topic or not service.output_topic:
            raise HttpError(400, "service gateway requires input-topic and output-topic")

        request_id = str(uuid.uuid4())
        try:
            produce_request = ProduceGateway.parse_produce_request(request.text())
        except ProduceException as e:
            return Response.json({"status": e.status, "reason": str(e)}, status=400)
        passed_headers = dict(produce_request.get("headers") or {})
        passed_headers[SERVICE_REQUEST_ID_HEADER] = request_id
        produce_request["headers"] = passed_headers
        try:
            timeout = float(context.options.get("timeout", "30"))
        except ValueError:
            raise HttpError(400, "option:timeout must be a number") from None

        filters = build_message_filters(
            service.headers, context.user_parameters, context.principal_values
        )

        def request_id_filter(record: Record) -> bool:
            for h in record.headers:
                if h.key == SERVICE_REQUEST_ID_HEADER:
                    return h.value_as_string() == request_id
            return False

        filters.append(request_id_filter)

        reply: asyncio.Future[str] = asyncio.get_running_loop().create_future()

        def on_message(message: str) -> None:
            if not reply.done():
                reply.set_result(message)

        consume = ConsumeGateway(gw_app.topic_runtime)
        produce = ProduceGateway(gw_app.topic_runtime)
        try:
            await consume.setup(service.output_topic, filters, "latest")
            consume.start_reading(on_message)
            headers = _with_tenant(
                resolve_common_headers(
                    service.headers, context.user_parameters, context.principal_values
                ),
                context.tenant,
            )
            await produce.start(service.input_topic, headers)
            await produce.produce(produce_request)
            try:
                message = await asyncio.wait_for(reply, timeout)
            except asyncio.TimeoutError:
                raise HttpError(504, "no reply from pipeline") from None
            reply_doc = json.loads(message)
            # quota/overload shed: the completions step answers a service
            # roundtrip's shed with a reply record carrying the shed
            # properties — map them to HTTP 429 with Retry-After from the
            # engine's own estimate
            reply_headers = (reply_doc.get("record") or {}).get("headers") or {}
            if str(reply_headers.get(SHED_PROPERTY, "")).lower() == "true":
                try:
                    retry_after = max(
                        float(reply_headers.get(RETRY_AFTER_PROPERTY, 1.0)),
                        0.05,
                    )
                except (TypeError, ValueError):
                    retry_after = 1.0
                return Response.json(
                    {
                        "error": "shed",
                        "reason": "engine overloaded or tenant over quota",
                        "retry_after_s": retry_after,
                    },
                    status=429,
                    headers={"Retry-After": f"{retry_after:.3f}"},
                )
            return Response.json(reply_doc)
        except ProduceException as e:
            return Response.json({"status": e.status, "reason": str(e)}, status=400)
        finally:
            await consume.close()
            await produce.close()

    async def _proxy_to_agent(
        self, request: Request, context: GatewayRequestContext, agent_id: str
    ) -> Response:
        """Forward the HTTP request to a service agent (GatewayResource:335-360)."""
        uri = self.provider.agent_service_uri(context.tenant, context.application_id, agent_id)
        if uri is None:
            raise HttpError(502, f"no service URI known for agent {agent_id!r}")
        tail = request.match_info.get("tail", "")
        target = urllib.parse.urlsplit(uri.rstrip("/") + (tail or "/"))
        path = target.path + (f"?{request.query_string}" if request.query_string else "")
        headers = {
            k: v for k, v in request.headers.items()
            if k not in ("host", "connection", "content-length", "transfer-encoding")
        }

        def forward() -> tuple[int, str, bytes]:
            conn = http.client.HTTPConnection(target.hostname, target.port or 80, timeout=60)
            try:
                conn.request(request.method, path, body=request.body or None, headers=headers)
                resp = conn.getresponse()
                ctype = resp.getheader("Content-Type", "application/octet-stream")
                return resp.status, ctype, resp.read()
            finally:
                conn.close()

        status, ctype, data = await asyncio.get_running_loop().run_in_executor(None, forward)
        return Response(status, data, ctype)


def gateway_events_record(event: str, context: GatewayRequestContext) -> dict[str, Any]:
    """Lifecycle event payload (reference api/events EventRecord/GatewayEventData)."""
    return {
        "category": "Gateway",
        "type": event,
        "source": f"{context.tenant}/{context.application_id}/{context.gateway.id}",
        "data": {
            "gateway-id": context.gateway.id,
            "gateway-type": context.gateway.type,
            "user-parameters": context.user_parameters,
            "options": context.options,
        },
    }


async def publish_gateway_event(
    topic_runtime: TopicConnectionsRuntime,
    events_topic: str,
    event: str,
    context: GatewayRequestContext,
) -> None:
    producer = topic_runtime.create_producer("gateway-events", events_topic)
    await producer.start()
    try:
        from langstream_tpu_torch.api.record import SimpleRecord

        payload = gateway_events_record(event, context)
        await producer.write(
            SimpleRecord.of(json.dumps(payload), headers=[Header("ls-event-type", event)])
        )
    finally:
        await producer.close()
