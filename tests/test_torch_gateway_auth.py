"""The port's gateway authentication (``langstream_tpu_torch/gateway/auth.py``
and the auth dispatch of its ``gateway/core.py`` / ``gateway/server.py``)
against the JAX package's:

- each provider (``none``, ``jwt``, ``google``, ``github``, ``http``) on the
  same stdlib stubs (a JWKS endpoint, a GitHub API, a webhook): the same
  result, reason and principal values, and the same configuration errors;
- the registry's unknown-provider text and the provider cache;
- each package's gateway server on one app with a secured produce gateway
  (JAX's ``tests/test_gateway.py`` ``test_jwt_auth`` and
  ``test_test_credentials_with_server_provider``): the same status codes,
  and the same header values from ``value-from-authentication`` on the
  records produced."""

import asyncio
import base64
import hashlib
import hmac
import json
import time

import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import padding, rsa
from torch_http_stub import Stub

import langstream_tpu.core.parser as jax_parser
import langstream_tpu.gateway.auth as jax_gw_auth
import langstream_tpu.gateway.core as jax_core
import langstream_tpu.gateway.server as jax_server
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.gateway.auth as port_gw_auth
import langstream_tpu_torch.gateway.core as port_core
import langstream_tpu_torch.gateway.server as port_server
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu_torch.gateway import websocket as wsmod

KEY = rsa.generate_private_key(public_exponent=65537, key_size=2048)
CLIENT_ID = "client-123.apps.googleusercontent.com"


def b64u(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def rs256(claims: dict, kid: str = "g1") -> str:
    signed = (f"{b64u(json.dumps({'alg': 'RS256', 'kid': kid}).encode())}."
              f"{b64u(json.dumps(claims).encode())}")
    return f"{signed}.{b64u(KEY.sign(signed.encode(), padding.PKCS1v15(), hashes.SHA256()))}"


def hs256(claims: dict, secret: str = "s3cret") -> str:
    signed = (f"{b64u(json.dumps({'alg': 'HS256', 'typ': 'JWT'}).encode())}."
              f"{b64u(json.dumps(claims).encode())}")
    return f"{signed}.{b64u(hmac.new(secret.encode(), signed.encode(), hashlib.sha256).digest())}"


def jwks() -> dict:
    nums = KEY.public_key().public_numbers()

    def enc(n: int) -> str:
        return b64u(n.to_bytes((n.bit_length() + 7) // 8, "big"))

    return {"keys": [{"kty": "RSA", "kid": "g1", "n": enc(nums.n), "e": enc(nums.e)}]}


def result(mod, name: str, config: dict, credentials: str):
    provider = mod.GatewayAuthenticationRegistry.load(name, config)
    r = asyncio.run(provider.authenticate(credentials))
    return (r.authenticated, r.reason, r.principal_values)


def same(name: str, config: dict, credentials: list) -> list:
    got = [result(port_gw_auth, name, config, c) for c in credentials]
    assert got == [result(jax_gw_auth, name, config, c) for c in credentials]
    return got


def test_none_and_jwt_providers_equal_jax():
    assert same("none", {}, ["anything"]) == [(True, None, {})]
    now = time.time()
    got = same("jwt", {"secret-key": "s3cret"}, [
        hs256({"sub": "alice", "email": "a@x", "n": 4, "exp": now + 60}),
        hs256({"sub": "alice"}, secret="wrong"), "garbage"])
    assert got[0][0] and got[0][2]["subject"] == "alice" and got[0][2]["n"] == "4"
    assert got[1] == (False, "bad signature", {})
    assert got[2][1].startswith("malformed JWT")


def test_google_provider_equals_jax():
    now = time.time()
    with Stub([("GET", "/certs", lambda call: (200, {}, jwks()))]) as stub:
        config = {"client-id": CLIENT_ID, "certs-uri": f"{stub.base}/certs"}
        good = {"sub": "1077", "aud": CLIENT_ID, "iss": "https://accounts.google.com",
                "email": "u@gmail.com", "exp": now + 300}
        got = same("google", config, [
            rs256(good), rs256({**good, "aud": "someone-else"}),
            rs256({**good, "iss": "evil.example"}), rs256({**good, "exp": now - 5}),
            rs256(good, kid="unknown"), rs256({k: v for k, v in good.items() if k != "email"})])
        assert got[0] == (True, None, {**{k: str(v) for k, v in good.items()},
                                      "subject": "1077", "login": "u@gmail.com"})
        assert [g[1] for g in got[1:5]] == ["bad audience", "bad issuer", "token expired",
                                            "no JWKS key for kid 'unknown'"]
        assert "login" not in got[5][2]
        same("google", {**config, "issuer": "my-issuer"},
             [rs256({**good, "iss": "my-issuer"}), rs256(good)])
    for mod in (jax_gw_auth, port_gw_auth):
        with pytest.raises(ValueError, match="google auth requires configuration.client-id"):
            mod.GatewayAuthenticationRegistry.load("google", {})


def github_stub() -> Stub:
    users = {"good": {"login": "octo", "id": 42, "name": "Octo Cat", "email": None,
                      "site_admin": False, "plan": {"name": "pro"}},
             "noorg": {"login": "solo", "id": 7}}
    orgs = {"good": [{"login": "langstream"}, {"login": "other"}], "noorg": []}

    def user(call):
        token = call.headers.get("authorization", "").removeprefix("Bearer ")
        if call.headers.get("accept") != "application/vnd.github+json":
            return 400, {}, b"bad accept"
        if token not in users:
            return 401, {}, {"message": "Bad credentials"}
        # a body parsed whatever its content type (JAX: json(content_type=None))
        return 200, {"Content-Type": "text/plain"}, json.dumps(users[token])

    def user_orgs(call):
        token = call.headers.get("authorization", "").removeprefix("Bearer ")
        return 200, {}, orgs.get(token, [])

    return Stub([("GET", "/user", user), ("GET", "/user/orgs", user_orgs)])


def test_github_provider_equals_jax():
    with github_stub() as stub:
        got = same("github", {"api-url": stub.base + "/"}, ["good", "bad", "noorg"])
        assert got[0] == (True, None, {"login": "octo", "id": "42", "name": "Octo Cat",
                                       "subject": "octo"})
        assert got[1] == (False, "github user lookup returned 401", {})
        got = same("github", {"api-url": stub.base, "allowed-organizations": ["langstream"]},
                   ["good", "noorg"])
        assert got[0][0] and got[1] == (False, "user not in an allowed organization", {})


def test_http_webhook_provider_equals_jax():
    def auth(call):
        token = call.headers.get("authorization", "").removeprefix("Bearer ")
        if call.headers.get("x-api") != "k":
            return 500, {}, b"no api header"
        return {"ok": (200, {}, {"subject": token, "level": 3}),
                "text": (200, {"Content-Type": "text/plain"}, b"welcome"),
                "empty": (204, {}, b""),
                "list": (202, {}, [1, 2]),
                "no": (403, {}, b"forbidden")}[token]

    with Stub([("POST", "/check/auth", auth)]) as stub:
        config = {"base-url": stub.base + "/check/", "path-template": "/auth",
                  "headers": {"x-api": "k"}}
        got = same("http", config, ["ok", "text", "empty", "list", "no"])
        assert got == [(True, None, {"subject": "ok", "level": "3"}), (True, None, {}),
                       (True, None, {}), (True, None, {}), (False, "webhook returned 403", {})]
        assert all(c.method == "POST" for c in stub.calls)
    for mod in (jax_gw_auth, port_gw_auth):
        with pytest.raises(ValueError, match="http auth requires configuration.base-url"):
            mod.GatewayAuthenticationRegistry.load("http", {})


def test_unknown_provider_text_and_cache_equal_jax():
    with pytest.raises(ValueError) as want:
        jax_gw_auth.GatewayAuthenticationRegistry.load("kerberos", {})
    with pytest.raises(ValueError) as got:
        port_gw_auth.GatewayAuthenticationRegistry.load("kerberos", {})
    assert str(got.value) == str(want.value)
    a = port_core._cached_auth_provider("jwt", {"secret-key": "x"})
    b = port_core._cached_auth_provider("jwt", {"secret-key": "x"})
    c = port_core._cached_auth_provider("jwt", {"secret-key": "y"})
    assert a is b and a is not c
    assert port_core.test_mode_principal_values("t") == jax_core.test_mode_principal_values("t")


# -- the gateway servers -------------------------------------------------------

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
GATEWAYS = """
gateways:
  - id: secured
    type: produce
    topic: input-topic
    authentication:
      provider: jwt
      configuration:
        secret-key: s3cret
    produce-options:
      headers:
        - key: user
          value-from-authentication: subject
        - key: mail
          value-from-authentication: email
  - id: strict
    type: produce
    topic: input-topic
    authentication:
      provider: jwt
      allow-test-mode: false
      configuration:
        secret-key: s3cret
"""
INSTANCE = "instance:\n  streamingCluster:\n    type: memory\n  computeCluster:\n    type: local\n"
PACKAGES = {"jax": (jax_parser, jax_local, jax_server, jax_gw_auth),
            "port": (port_parser, port_local, port_server, port_gw_auth)}


async def gateway_run(package: str, test_provider: bool) -> dict:
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()
    parser, local, server_mod, auth_mod = PACKAGES[package]
    app = parser.ModelBuilder.build_application_from_files(
        {"pipeline.yaml": PIPELINE, "gateways.yaml": GATEWAYS}, INSTANCE, None).application
    runner = local.LocalApplicationRunner("gw-auth", app)
    await runner.deploy()
    await runner.start()
    provider = server_mod.DictApplicationProvider()
    provider.put("default", "gw-auth", runner.application, runner._topic_runtime)
    server = server_mod.GatewayServer(
        provider, port=0, test_auth_provider=auth_mod.NoAuthProvider() if test_provider else None)
    await server.start()
    base = f"{server.ws_url}/v1/produce/default/gw-auth"
    statuses, produced = {}, 0
    try:
        for label, query in (
                ("none", ""), ("bad", f"?credentials={hs256({'sub': 'x'}, 'wrong')}"),
                ("good", f"?credentials={hs256({'sub': 'alice', 'email': 'a@x'})}"),
                ("test", "?test-credentials=anything"),
                ("both", "?credentials=a&test-credentials=b")):
            for gateway in ("secured", "strict"):
                try:
                    ws = await wsmod.connect(f"{base}/{gateway}{query}")
                except wsmod.HandshakeError as e:
                    statuses[f"{gateway}/{label}"] = e.status
                    continue
                await ws.send_str(json.dumps({"value": f"{gateway}/{label}"}))
                statuses[f"{gateway}/{label}"] = json.loads((await ws.receive()).data)["status"]
                produced += 1
                await ws.close()
        status, _, _ = await wsmod.http_request(
            "POST", f"{server.url}/api/gateways/produce/default/gw-auth/secured"
            f"?credentials={hs256({'sub': 'http-user'})}", b'{"value": "over http"}')
        statuses["http"] = status
        produced += status == 200
        records = await runner.consume("output-topic", n=produced, timeout=30)
        headers = {r.value: {h.key: h.value_as_string() for h in r.headers
                             if h.key in ("user", "mail")} for r in records}
    finally:
        await server.stop()
        await runner.stop()
    return {"statuses": statuses, "headers": headers}


@pytest.mark.parametrize("test_provider", [False, True], ids=["no-test-provider",
                                                              "test-provider"])
def test_gateway_server_auth_equals_jax(test_provider):
    got = asyncio.run(gateway_run("port", test_provider))
    assert got == asyncio.run(gateway_run("jax", test_provider))
    st = got["statuses"]
    assert st["secured/none"] == st["secured/bad"] == 401 and st["strict/test"] == 401
    assert st["secured/good"] == "OK" and st["http"] == 200 and st["secured/both"] == 400
    assert got["headers"]["secured/good"] == {"user": "alice", "mail": "a@x"}
    assert got["headers"]["over http"] == {"user": "http-user"}
    if test_provider:
        subject = hashlib.sha256(b"anything").hexdigest()
        assert st["secured/test"] == "OK"
        assert got["headers"]["secured/test"] == {"user": subject, "mail": f"{subject}@localhost"}
    else:
        assert st["secured/test"] == 401
