"""Gateway authentication SPI + built-in providers (the port's own copy of
``langstream_tpu/gateway/auth.py``).

Parity: reference ``api/gateway/GatewayAuthenticationProvider.java`` and the
``langstream-api-gateway-auth`` plugin modules (jwt incl. RS256/JWKS, http
webhook, google id-token, github access-token; test credentials via
``GatewayRequestHandler``).

A gateway declares ``authentication: {provider, configuration,
allow-test-mode}``; clients pass ``credentials`` (or ``test-credentials``)
as a query parameter.  The provider validates the credential and returns
*principal values* that header mappings and consume filters can reference
via ``value-from-authentication``.

The GitHub and webhook providers call out with ``urllib`` in a worker
thread (``runtime/http_client.py``), reading the answers as JAX's aiohttp
client does: a status other than the expected one is a failure with JAX's
reason, and a body is parsed as JSON whatever its content type.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from langstream_tpu_torch.runtime import http_client

# JAX's client timeout of the GitHub and webhook calls (aiohttp ``total=10``)
AUTH_TIMEOUT_S = 10.0


@dataclass
class GatewayAuthenticationResult:
    authenticated: bool
    reason: Optional[str] = None
    principal_values: dict[str, str] = field(default_factory=dict)

    @staticmethod
    def success(principal_values: Optional[dict[str, str]] = None) -> "GatewayAuthenticationResult":
        return GatewayAuthenticationResult(True, None, dict(principal_values or {}))

    @staticmethod
    def failure(reason: str) -> "GatewayAuthenticationResult":
        return GatewayAuthenticationResult(False, reason, {})


class GatewayAuthenticationProvider(abc.ABC):
    """One auth scheme (reference GatewayAuthenticationProvider)."""

    @abc.abstractmethod
    def initialize(self, configuration: dict[str, Any]) -> None: ...

    @abc.abstractmethod
    async def authenticate(self, credentials: str) -> GatewayAuthenticationResult: ...


class NoAuthProvider(GatewayAuthenticationProvider):
    def initialize(self, configuration: dict[str, Any]) -> None:
        pass

    async def authenticate(self, credentials: str) -> GatewayAuthenticationResult:
        return GatewayAuthenticationResult.success()


class JwtAuthProvider(GatewayAuthenticationProvider):
    """JWT validation (reference auth-jwt AuthenticationProviderToken +
    JwksUriSigningKeyResolver): HS256 via ``secret-key``, RS256 via a PEM
    ``public-key`` or a ``jwks-uri`` resolved by ``kid``; ``audience`` /
    ``issuer`` optional checks. Principal values = all string claims."""

    def initialize(self, configuration: dict[str, Any]) -> None:
        from langstream_tpu_torch.auth import JwtVerifier

        self._verifier = JwtVerifier(configuration)

    async def authenticate(self, credentials: str) -> GatewayAuthenticationResult:
        from langstream_tpu_torch.auth import JwtError, claims_to_principal

        try:
            payload = await self._verifier.verify(credentials)
        except JwtError as e:
            return GatewayAuthenticationResult.failure(str(e))
        return GatewayAuthenticationResult.success(claims_to_principal(payload))


class GoogleAuthProvider(GatewayAuthenticationProvider):
    """Google sign-in: the credential is a Google ID token, verified RS256
    against Google's JWKS with the OAuth client id as audience (reference
    langstream-api-gateway-auth GoogleAuthenticationProvider).

    configuration: ``client-id`` (required); ``certs-uri`` overrides the
    Google JWKS endpoint (tests point it at a local stub, the reference's
    WireMock pattern)."""

    GOOGLE_CERTS = "https://www.googleapis.com/oauth2/v3/certs"
    GOOGLE_ISSUERS = ["https://accounts.google.com", "accounts.google.com"]

    def initialize(self, configuration: dict[str, Any]) -> None:
        from langstream_tpu_torch.auth import JwtVerifier

        client_id = configuration.get("client-id")
        if not client_id:
            raise ValueError("google auth requires configuration.client-id")
        self._verifier = JwtVerifier(
            {
                "jwks-uri": configuration.get("certs-uri", self.GOOGLE_CERTS),
                "audience": client_id,
                "issuer": configuration.get("issuer", self.GOOGLE_ISSUERS),
            }
        )

    async def authenticate(self, credentials: str) -> GatewayAuthenticationResult:
        from langstream_tpu_torch.auth import JwtError, claims_to_principal

        try:
            payload = await self._verifier.verify(credentials)
        except JwtError as e:
            return GatewayAuthenticationResult.failure(str(e))
        values = claims_to_principal(payload)
        if "email" in payload:
            values.setdefault("login", str(payload["email"]))
        return GatewayAuthenticationResult.success(values)


class GitHubAuthProvider(GatewayAuthenticationProvider):
    """GitHub OAuth: the credential is an access token, validated by calling
    the user API (reference GitHubAuthenticationProvider).

    configuration: ``api-url`` overrides https://api.github.com (local stub
    in tests); ``allowed-organizations`` optionally restricts access by org
    membership (checked via /user/orgs)."""

    def initialize(self, configuration: dict[str, Any]) -> None:
        self._api = str(configuration.get("api-url", "https://api.github.com")).rstrip("/")
        self._allowed_orgs = set(configuration.get("allowed-organizations", []) or [])

    async def authenticate(self, credentials: str) -> GatewayAuthenticationResult:
        headers = {
            "Authorization": f"Bearer {credentials}",
            "Accept": "application/vnd.github+json",
        }
        resp = await http_client.request("GET", f"{self._api}/user", headers=headers,
                                         timeout=AUTH_TIMEOUT_S)
        if resp.status != 200:
            return GatewayAuthenticationResult.failure(
                f"github user lookup returned {resp.status}"
            )
        user = resp.json()
        if self._allowed_orgs:
            resp = await http_client.request("GET", f"{self._api}/user/orgs", headers=headers,
                                             timeout=AUTH_TIMEOUT_S)
            orgs = resp.json() if resp.status == 200 else []
            names = {o.get("login") for o in orgs if isinstance(o, dict)}
            if not names & self._allowed_orgs:
                return GatewayAuthenticationResult.failure(
                    "user not in an allowed organization"
                )
        values = {
            k: str(v)
            for k, v in user.items()
            if isinstance(v, (str, int)) and k in ("login", "id", "name", "email")
        }
        values.setdefault("subject", values.get("login", ""))
        return GatewayAuthenticationResult.success(values)


class HttpWebhookAuthProvider(GatewayAuthenticationProvider):
    """POSTs the credential to an external endpoint; 2xx = authenticated
    (reference langstream-api-gateway-auth ``http`` provider)."""

    def initialize(self, configuration: dict[str, Any]) -> None:
        self._base_url = str(configuration.get("base-url", ""))
        self._path = str(configuration.get("path-template", "/auth"))
        self._headers = dict(configuration.get("headers", {}))
        if not self._base_url:
            raise ValueError("http auth requires configuration.base-url")

    async def authenticate(self, credentials: str) -> GatewayAuthenticationResult:
        url = self._base_url.rstrip("/") + self._path
        resp = await http_client.request(
            "POST", url, headers={"Authorization": f"Bearer {credentials}", **self._headers},
            timeout=AUTH_TIMEOUT_S,
        )
        if 200 <= resp.status < 300:
            try:
                body = resp.json()
            except Exception:  # noqa: BLE001 — an unreadable body carries no values
                body = {}
            values = {k: str(v) for k, v in body.items()} if isinstance(body, dict) else {}
            return GatewayAuthenticationResult.success(values)
        return GatewayAuthenticationResult.failure(f"webhook returned {resp.status}")


class GatewayAuthenticationRegistry:
    """provider name → factory (reference GatewayAuthenticationProviderRegistry)."""

    _factories: dict[str, Callable[[], GatewayAuthenticationProvider]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[[], GatewayAuthenticationProvider]) -> None:
        cls._factories[name] = factory

    @classmethod
    def load(cls, name: str, configuration: dict[str, Any]) -> GatewayAuthenticationProvider:
        cls._ensure_builtins()
        factory = cls._factories.get(name)
        if factory is None:
            known = ", ".join(sorted(cls._factories))
            raise ValueError(f"unknown auth provider {name!r}; known: {known}")
        provider = factory()
        provider.initialize(configuration)
        return provider

    @classmethod
    def _ensure_builtins(cls) -> None:
        cls._factories.setdefault("none", NoAuthProvider)
        cls._factories.setdefault("jwt", JwtAuthProvider)
        cls._factories.setdefault("http", HttpWebhookAuthProvider)
        cls._factories.setdefault("google", GoogleAuthProvider)
        cls._factories.setdefault("github", GitHubAuthProvider)
