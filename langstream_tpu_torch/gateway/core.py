"""Gateway request handling core: auth + params, produce/consume gateways
(the port's own copy of ``langstream_tpu/gateway/core.py``; the
authentication providers are ``gateway/auth.py``).

Parity: reference ``apigateway/gateways/`` — ``GatewayRequestHandler`` (query
params split into ``param:<name>`` / ``option:<name>``, required-parameter
validation, auth dispatch), ``ProduceGateway`` (common headers resolved from
``value`` / ``value-from-parameters`` / ``value-from-authentication``
mappings, Gateway.java:75-95), ``ConsumeGateway`` (offset-positioned reader +
header filters, ConsumeGateway.java:96-260).

Wire DTOs (api/ProduceRequest|ProduceResponse|ConsumePushMessage):
  produce request  {"key":…, "value":…, "headers":{…}}
  produce response {"status":"OK"|"BAD_REQUEST"|"PRODUCER_ERROR", "reason":…}
  consume push     {"record":{"key":…,"value":…,"headers":{…}}, "offset":"…"}
The consume ``offset`` is an opaque base64 token a client passes back as
``option:position`` to resume.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from langstream_tpu_torch.api.model import Application, Gateway
from langstream_tpu_torch.api.record import Header, Record, SimpleRecord
from langstream_tpu_torch.api.topics import (
    TopicConnectionsRuntime,
    TopicOffsetPosition,
    TopicProducer,
    TopicReader,
)
from langstream_tpu_torch.gateway.auth import GatewayAuthenticationRegistry

log = logging.getLogger(__name__)

# provider instances are cached per (name, config) so per-provider state —
# notably the JwtVerifier's JWKS kid cache — survives across requests
# instead of being rebuilt (and refetched) per WS connect / HTTP produce
_auth_provider_cache: dict = {}


def _cached_auth_provider(name: str, configuration: dict):
    key = (name, json.dumps(configuration or {}, sort_keys=True, default=str))
    provider = _auth_provider_cache.get(key)
    if provider is None:
        provider = GatewayAuthenticationRegistry.load(name, configuration)
        _auth_provider_cache[key] = provider
    return provider

class AuthFailedException(Exception):
    pass


class ProduceException(Exception):
    def __init__(self, message: str, status: str = "PRODUCER_ERROR") -> None:
        super().__init__(message)
        self.status = status


@dataclass
class GatewayRequestContext:
    """Authenticated, validated request context
    (reference AuthenticatedGatewayRequestContext)."""

    tenant: str
    application_id: str
    application: Application
    gateway: Gateway
    user_parameters: dict[str, str] = field(default_factory=dict)
    options: dict[str, str] = field(default_factory=dict)
    principal_values: dict[str, str] = field(default_factory=dict)
    test_mode: bool = False


def split_query_params(params: dict[str, str]) -> tuple[dict[str, str], dict[str, str], Optional[str], bool]:
    """Split raw query params into (user_parameters, options, credentials,
    test_mode). Unknown non-prefixed keys raise (GatewayRequestHandler:105-116).
    """
    user: dict[str, str] = {}
    options: dict[str, str] = {}
    credentials: Optional[str] = None
    test_mode = False
    for key, value in params.items():
        if key == "credentials":
            if test_mode:
                raise ValueError("credentials and test-credentials cannot be used together")
            credentials = value
        elif key == "test-credentials":
            if credentials is not None and not test_mode:
                raise ValueError("credentials and test-credentials cannot be used together")
            credentials = value
            test_mode = True
        elif key.startswith("option:"):
            options[key[len("option:") :]] = value
        elif key.startswith("param:"):
            user[key[len("param:") :]] = value
        else:
            raise ValueError(
                f"unknown query parameter {key!r}. Use param:<name> for gateway "
                "parameters and option:<name> for options."
            )
    return user, options, credentials, test_mode


def test_mode_principal_values(credentials: str) -> dict[str, str]:
    """Deterministic synthetic principal for test mode (reference
    GatewayRequestHandler.getPrincipalValues:263-290 hashes the credential)."""
    import hashlib

    subject = hashlib.sha256(credentials.encode()).hexdigest()
    return {
        "subject": subject,
        "email": f"{subject}@localhost",
        "name": subject,
        "login": subject,
    }


async def authenticate_and_validate(
    tenant: str,
    application_id: str,
    application: Application,
    gateway: Gateway,
    raw_params: dict[str, str],
    test_auth_provider: Optional[Any] = None,
) -> GatewayRequestContext:
    """``test_auth_provider`` is the server-level provider that validates
    test credentials; test mode FAILS when the deployment configures none
    (reference GatewayRequestHandler.authenticate:229-240)."""
    user, options, credentials, test_mode = split_query_params(raw_params)

    for required in gateway.parameters:
        if required not in user:
            raise ValueError(f"missing required parameter {required!r}")
    unknown = set(user) - set(gateway.parameters)
    if unknown:
        raise ValueError(f"unknown parameters {sorted(unknown)}")

    principal: dict[str, str] = {}
    auth = gateway.authentication
    if auth is not None and auth.provider:
        if credentials is None:
            raise AuthFailedException("missing credentials")
        if test_mode:
            if not auth.allow_test_mode:
                raise AuthFailedException(
                    f"Gateway {gateway.id} does not allow test mode."
                )
            if test_auth_provider is None:
                raise AuthFailedException("No test auth provider specified")
            result = await test_auth_provider.authenticate(credentials)
            if not result.authenticated:
                raise AuthFailedException(result.reason or "authentication failed")
            principal = test_mode_principal_values(credentials)
            principal.update(result.principal_values)
        else:
            provider = _cached_auth_provider(auth.provider, auth.configuration)
            try:
                result = await provider.authenticate(credentials)
            except Exception as e:  # noqa: BLE001 — IdP outages are auth
                # failures (401 with a reason), never unhandled 500s
                log.warning("auth provider %s errored: %s", auth.provider, e)
                raise AuthFailedException(f"authentication error: {e}") from e
            if not result.authenticated:
                raise AuthFailedException(result.reason or "authentication failed")
            principal = result.principal_values

    return GatewayRequestContext(
        tenant=tenant,
        application_id=application_id,
        application=application,
        gateway=gateway,
        user_parameters=user,
        options=options,
        principal_values=principal,
        test_mode=test_mode,
    )


# ---------------------------------------------------------------------------
# Header mappings and consume filters
# ---------------------------------------------------------------------------


def _resolve_mapping_value(
    mapping: dict[str, Any],
    user_parameters: dict[str, str],
    principal_values: dict[str, str],
) -> Optional[str]:
    value = mapping.get("value")
    if value is None and mapping.get("value-from-parameters"):
        value = user_parameters.get(mapping["value-from-parameters"])
    if value is None and mapping.get("value-from-authentication"):
        value = principal_values.get(mapping["value-from-authentication"])
    return None if value is None else str(value)


def resolve_common_headers(
    header_mappings: list[dict[str, Any]],
    user_parameters: dict[str, str],
    principal_values: dict[str, str],
) -> list[Header]:
    """Produce-side headers attached to every record
    (ProduceGateway.getProducerCommonHeaders / Gateway.java KeyValueComparison)."""
    headers: list[Header] = []
    for mapping in header_mappings or []:
        key = mapping.get("key")
        if not key:
            continue
        value = _resolve_mapping_value(mapping, user_parameters, principal_values)
        if value is not None:
            headers.append(Header(key, value))
    return headers


def build_message_filters(
    header_mappings: list[dict[str, Any]],
    user_parameters: dict[str, str],
    principal_values: dict[str, str],
) -> list[Callable[[Record], bool]]:
    """Consume-side record filters (ConsumeGateway.createMessageFilters:247-251)."""
    filters: list[Callable[[Record], bool]] = []
    for mapping in header_mappings or []:
        key = mapping.get("key")
        if not key:
            continue
        expected = _resolve_mapping_value(mapping, user_parameters, principal_values)
        if expected is None:
            continue

        def matches(record: Record, key: str = key, expected: str = expected) -> bool:
            for h in record.headers:
                if h.key == key:
                    return h.value_as_string() == expected
            return False

        filters.append(matches)
    return filters


def encode_offset(offsets: dict[int, int]) -> str:
    # urlsafe: the token round-trips through ?option:position=… query params
    return base64.urlsafe_b64encode(json.dumps(offsets).encode()).decode()


def decode_offset(token: str) -> dict[int, int]:
    raw = base64.urlsafe_b64decode(token + "=" * (-len(token) % 4))
    return {int(k): int(v) for k, v in json.loads(raw).items()}


# ---------------------------------------------------------------------------
# Produce / consume gateways
# ---------------------------------------------------------------------------


class ProduceGateway:
    """Writes client JSON payloads to one topic with common headers
    (reference ProduceGateway.java:100-200)."""

    def __init__(self, topic_runtime: TopicConnectionsRuntime) -> None:
        self._topic_runtime = topic_runtime
        self._producer: Optional[TopicProducer] = None
        self._common_headers: list[Header] = []

    async def start(self, topic: str, common_headers: list[Header]) -> None:
        self._common_headers = list(common_headers)
        self._producer = self._topic_runtime.create_producer("gateway", topic)
        await self._producer.start()

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.close()
            self._producer = None

    @staticmethod
    def parse_produce_request(payload: str) -> dict[str, Any]:
        try:
            request = json.loads(payload)
        except json.JSONDecodeError as e:
            raise ProduceException(f"Error while parsing JSON payload: {e}", "BAD_REQUEST") from e
        if not isinstance(request, dict):
            raise ProduceException("payload must be a JSON object", "BAD_REQUEST")
        return request

    async def produce_payload(self, payload: str) -> None:
        await self.produce(self.parse_produce_request(payload))

    async def produce(self, request: dict[str, Any]) -> None:
        if request.get("value") is None and request.get("key") is None:
            raise ProduceException("Either key or value must be set.", "BAD_REQUEST")
        if self._producer is None:
            raise ProduceException("Producer not initialized", "PRODUCER_ERROR")
        headers = list(self._common_headers)
        passed = request.get("headers") or {}
        if not isinstance(passed, dict):
            raise ProduceException("headers must be an object", "BAD_REQUEST")
        headers.extend(Header(str(k), v) for k, v in passed.items())
        record = SimpleRecord.of(
            request.get("value"), key=request.get("key"), headers=headers
        )
        try:
            await self._producer.write(record)
        except Exception as e:  # noqa: BLE001
            raise ProduceException(str(e), "PRODUCER_ERROR") from e


class ConsumeGateway:
    """Reads one topic from an offset position, applies filters, pushes
    serialized messages to a callback (reference ConsumeGateway.java)."""

    def __init__(self, topic_runtime: TopicConnectionsRuntime) -> None:
        self._topic_runtime = topic_runtime
        self._reader: Optional[TopicReader] = None
        self._filters: list[Callable[[Record], bool]] = []
        self._task: Optional[asyncio.Task] = None

    async def setup(
        self,
        topic: str,
        filters: list[Callable[[Record], bool]],
        position_option: Optional[str] = None,
    ) -> None:
        self._filters = list(filters)
        position = position_option or "latest"
        if position == "latest":
            offset = TopicOffsetPosition(position="latest")
        elif position == "earliest":
            offset = TopicOffsetPosition(position="earliest")
        else:
            offset = TopicOffsetPosition.absolute(decode_offset(position))
        self._reader = self._topic_runtime.create_reader(topic, offset)
        await self._reader.start()

    def start_reading(
        self,
        on_message: Callable[[str], Any],
        on_error: Optional[Callable[[BaseException], Any]] = None,
    ) -> None:
        """Spawn the read loop; ``on_message`` gets each serialized push
        message (a coroutine function is awaited).  A read or delivery
        failure invokes ``on_error`` (e.g. to close the client socket)
        instead of leaving the connection silently dead."""
        assert self._reader is not None, "setup() first"

        async def loop() -> None:
            assert self._reader is not None
            while True:
                result = await self._reader.read()
                for i, record in enumerate(result.records):
                    if self._filters and not all(f(record) for f in self._filters):
                        continue
                    per_record = (
                        result.record_offsets[i]
                        if result.record_offsets is not None
                        else result.offset
                    )
                    message = json.dumps(
                        {
                            "record": {
                                "key": record.key,
                                "value": record.value,
                                "headers": {
                                    h.key: h.value_as_string() for h in record.headers
                                },
                            },
                            "offset": encode_offset(per_record),
                        }
                    )
                    out = on_message(message)
                    if asyncio.iscoroutine(out):
                        await out

        async def guarded() -> None:
            try:
                await loop()
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # noqa: BLE001 — surface to the client
                log.exception("consume gateway read loop failed")
                if on_error is not None:
                    out = on_error(e)
                    if asyncio.iscoroutine(out):
                        try:
                            await out
                        except Exception:  # noqa: BLE001
                            pass

        self._task = asyncio.create_task(guarded())

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        if self._reader is not None:
            await self._reader.close()
            self._reader = None
