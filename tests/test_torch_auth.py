"""The port's JWT verifier (``langstream_tpu_torch/auth.py``, on the stdlib)
against the JAX package's (``langstream_tpu/auth.py``, on ``cryptography``
and aiohttp) on the same tokens: HS256; RS256 from a PEM in both PEM forms
(SubjectPublicKeyInfo and PKCS#1); RS256 through a JWKS endpoint on a
stdlib stub (the kid cache, the kid-less single key, an unknown kid, a
failing and a dead endpoint); the claim checks (garbage and past ``exp``,
``nbf``, audience lists, issuer lists). Both must give the same claims, or
a ``JwtError`` with the same text.

Then the stdlib RSASSA-PKCS1-v1_5 check itself against ``cryptography``'s
on 200 seeded messages, valid and tampered (a flipped bit, a signature one
byte short, one of the modulus's value or above, another hash's
DigestInfo, a broken padding), and a non-RSA PEM refused at configuration
time with JAX's text."""

import asyncio
import base64
import hashlib
import json
import random
import time

import pytest
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, ed25519, padding, rsa
from torch_http_stub import Stub, closed_port_url

import langstream_tpu.auth as jax_auth
import langstream_tpu_torch.auth as port_auth

KEYS = {
    "k1": rsa.generate_private_key(public_exponent=65537, key_size=2048),
    "k2": rsa.generate_private_key(public_exponent=65537, key_size=2048),
}


def b64u(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def b64u_int(n: int) -> str:
    return b64u(n.to_bytes((n.bit_length() + 7) // 8, "big"))


def make_jwt(claims: dict, key: str = "k1", kid: object = "k1", alg: str = "RS256",
             secret: str = "s3cret") -> str:
    header = {"alg": alg, "typ": "JWT"}
    if kid is not None:
        header["kid"] = kid
    signed = f"{b64u(json.dumps(header).encode())}.{b64u(json.dumps(claims).encode())}"
    if alg == "HS256":
        import hmac

        sig = hmac.new(secret.encode(), signed.encode(), hashlib.sha256).digest()
    else:
        sig = KEYS[key].sign(signed.encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{signed}.{b64u(sig)}"


def jwk(kid, key: str) -> dict:
    nums = KEYS[key].public_key().public_numbers()
    out = {"kty": "RSA", "n": b64u_int(nums.n), "e": b64u_int(nums.e), "alg": "RS256"}
    if kid is not None:
        out["kid"] = kid
    return out


def pem(key: str, fmt) -> str:
    return KEYS[key].public_key().public_bytes(serialization.Encoding.PEM, fmt).decode()


def outcome(mod, verifier, token: str):
    """("ok", claims) or ("error", text) — a JwtError of the verifier's own
    package."""
    try:
        return ("ok", asyncio.run(verifier.verify(token)))
    except mod.JwtError as e:
        return ("error", str(e))


def both(config: dict, tokens: list) -> list:
    """The outcomes of each package's verifier (one verifier each, over the
    tokens in order) — must be equal."""
    j, p = jax_auth.JwtVerifier(config), port_auth.JwtVerifier(config)
    want = [outcome(jax_auth, j, t) for t in tokens]
    got = [outcome(port_auth, p, t) for t in tokens]
    assert got == want
    return got


def test_hs256_equals_jax():
    now = time.time()
    got = both({"secret-key": "s3cret"}, [
        make_jwt({"sub": "alice", "exp": now + 60}, alg="HS256"),
        make_jwt({"sub": "alice"}, alg="HS256", secret="wrong"),
        make_jwt({"sub": "alice"}),  # RS256, no key configured
        make_jwt({"sub": "alice"}, alg="none"),
        "not.a-token",
        "a.b",
    ])
    assert got[0][0] == "ok" and got[1] == ("error", "bad signature")
    assert got[2] == ("error", "RS256 token but no public-key / jwks-uri configured")
    assert got[4][1].startswith("malformed JWT")


@pytest.mark.parametrize("fmt", [serialization.PublicFormat.SubjectPublicKeyInfo,
                                 serialization.PublicFormat.PKCS1],
                         ids=["spki", "pkcs1"])
def test_rs256_from_pem_equals_jax(fmt):
    good = make_jwt({"sub": "bob", "email": "bob@x"})
    head, body, sig = good.split(".")
    flipped = bytearray(base64.urlsafe_b64decode(sig + "=="))
    flipped[10] ^= 1
    got = both({"public-key": pem("k1", fmt)}, [
        good,
        make_jwt({"sub": "bob"}, key="k2"),
        f"{head}.{body}.{b64u(bytes(flipped))}",
        f"{head}.{b64u(json.dumps({'sub': 'mallory'}).encode())}.{sig}",
        make_jwt({"sub": "bob"}, alg="HS256"),
    ])
    assert got[0] == ("ok", {"sub": "bob", "email": "bob@x"})
    assert [g[1] for g in got[1:4]] == ["bad signature"] * 3
    assert got[4] == ("error", "HS256 token but no secret-key configured")


def test_claim_checks_equal_jax():
    now = time.time()
    config = {"secret-key": "s", "audience": ["app-a", "app-b"],
              "issuer": ["https://issuer-1", "issuer-2"]}

    def tok(**claims):
        return make_jwt({"sub": "carol", **claims}, alg="HS256", secret="s")

    got = both(config, [
        tok(aud="app-a", iss="issuer-2", exp=now + 60, nbf=now - 60),
        tok(aud=["other", "app-b"], iss="https://issuer-1"),
        tok(aud=["other"], iss="issuer-2"),
        tok(aud="app-a", iss="issuer-3"),
        tok(aud="app-a", iss="issuer-2", exp=now - 1),
        tok(aud="app-a", iss="issuer-2", nbf=now + 600),
        tok(aud="app-a", iss="issuer-2", exp="soon"),
        tok(aud="app-a", iss="issuer-2", nbf=[1]),
        tok(aud=[{"x": 1}], iss="issuer-2"),
        tok(iss="issuer-2"),
        tok(aud="app-a", iss="issuer-2", exp=str(now + 60)),
    ])
    assert [g[0] for g in got[:2]] == ["ok", "ok"]
    assert [g[1] for g in got[2:10]] == [
        "bad audience", "bad issuer", "token expired", "token not yet valid",
        "non-numeric exp claim", "non-numeric nbf claim", "bad audience", "bad audience"]
    assert got[10][0] == "ok"
    both({"secret-key": "s", "audience": "solo", "issuer": "only"},
         [tok(aud="solo", iss="only"), tok(aud=["solo"], iss="other")])


def jwks_stub(doc: dict, status: int = 200) -> Stub:
    return Stub([("GET", "/certs", lambda call: (status, {}, doc))])


def test_rs256_through_jwks_equals_jax():
    doc = {"keys": [jwk("k1", "k1"), jwk("k2", "k2"), {"kty": "EC", "kid": "e1"}]}
    with jwks_stub(doc) as stub:
        config = {"jwks-uri": f"{stub.base}/certs"}
        tokens = [make_jwt({"sub": "a"}, kid="k1"), make_jwt({"sub": "b"}, key="k2", kid="k2"),
                  make_jwt({"sub": "c"}, kid="k1"), make_jwt({"sub": "d"}, kid="k9"),
                  make_jwt({"sub": "e"}, key="k2", kid="k1"), make_jwt({"sub": "f"}, kid=None)]
        j, p = jax_auth.JwtVerifier(config), port_auth.JwtVerifier(config)
        want, fetches = [], []
        for verifier, mod in ((j, jax_auth), (p, port_auth)):
            before = len(stub.calls)
            out = [outcome(mod, verifier, t) for t in tokens]
            fetches.append(len(stub.calls) - before)
            want.append(out)
        assert want[1] == want[0]
        # one fetch for k1 / k2 (cached), one per unknown kid (k9, None)
        assert fetches == [3, 3]
        assert want[1][3] == ("error", "no JWKS key for kid 'k9'")
        assert want[1][4] == ("error", "bad signature")
        assert want[1][5] == ("error", "no JWKS key for kid None")


def test_kidless_single_key_is_cached_as_jax():
    with jwks_stub({"keys": [jwk(None, "k1")]}) as stub:
        config = {"jwks-uri": f"{stub.base}/certs"}
        tokens = [make_jwt({"sub": f"u{i}"}, kid=None) for i in range(3)]
        for mod in (jax_auth, port_auth):
            before = len(stub.calls)
            verifier = mod.JwtVerifier(config)
            assert [outcome(mod, verifier, t)[0] for t in tokens] == ["ok"] * 3
            assert len(stub.calls) - before == 1
            assert set(verifier._jwks_keys) == {None}


def test_jwks_endpoint_failures_equal_jax():
    with jwks_stub({"keys": []}, status=500) as stub:
        got = both({"jwks-uri": f"{stub.base}/certs"}, [make_jwt({"sub": "a"})])
        assert got == [("error", "jwks fetch failed: HTTP 500")]
    # a dead endpoint: a JwtError from both; its text ends with the
    # transport's own words (aiohttp's connector error, urllib's URLError)
    dead = {"jwks-uri": f"{closed_port_url()}/certs"}
    for mod in (jax_auth, port_auth):
        kind, text = outcome(mod, mod.JwtVerifier(dead), make_jwt({"sub": "a"}))
        assert kind == "error" and text.startswith("jwks fetch failed: ")


def test_claims_to_principal_equals_jax():
    claims = {"sub": "x", "email": "x@y", "n": 3, "f": 1.5, "list": [1], "obj": {"a": 1},
              "ok": True}
    assert port_auth.claims_to_principal(claims) == jax_auth.claims_to_principal(claims)
    assert port_auth.claims_to_principal({"a": "b"}) == jax_auth.claims_to_principal({"a": "b"})


@pytest.mark.parametrize("kind", ["ec", "ed25519"])
def test_non_rsa_pem_refused_at_configuration_as_jax(kind):
    private = (ec.generate_private_key(ec.SECP256R1()) if kind == "ec"
               else ed25519.Ed25519PrivateKey.generate())
    text = private.public_key().public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo).decode()
    with pytest.raises(ValueError) as want:
        jax_auth.JwtVerifier({"public-key": text})
    with pytest.raises(ValueError) as got:
        port_auth.JwtVerifier({"public-key": text})
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("public-key must be an RSA public key, got ")


def test_no_key_configured_equals_jax():
    for mod in (jax_auth, port_auth):
        with pytest.raises(ValueError, match="requires one of secret-key"):
            mod.JwtVerifier({"audience": "x"})
    with pytest.raises(ValueError, match="Could not deserialize key data"):
        port_auth.JwtVerifier({"public-key": "-----BEGIN PUBLIC KEY-----\nAAAA\n"
                                             "-----END PUBLIC KEY-----"})


# -- the stdlib RSA check against cryptography's --------------------------------

DIGEST_INFO = {  # DER prefixes of other hashes' DigestInfo (RFC 8017 §9.2)
    "sha1": bytes.fromhex("3021300906052b0e03021a05000414"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
    "sha256-no-null": bytes.fromhex("302f300b0609608648016503040201" "0420"),
}


def raw_sign(key, block: bytes) -> bytes:
    """``block`` (the whole encoded message) signed with the private
    exponent, no padding added."""
    priv = key.private_numbers()
    n = priv.public_numbers.n
    k = (n.bit_length() + 7) // 8
    c = int.from_bytes(block, "big")
    m1, m2 = pow(c, priv.dmp1, priv.p), pow(c, priv.dmq1, priv.q)  # CRT
    return (m2 + (priv.iqmp * (m1 - m2) % priv.p) * priv.q).to_bytes(k, "big")


def emsa(k: int, t: bytes, block_type: int = 1, fill: int = 0xFF) -> bytes:
    return bytes([0, block_type]) + bytes([fill]) * (k - len(t) - 3) + b"\x00" + t


def crypto_ok(key, sig: bytes, msg: bytes) -> bool:
    try:
        key.public_key().verify(sig, msg, padding.PKCS1v15(), hashes.SHA256())
        return True
    except InvalidSignature:
        return False


def test_stdlib_rsa_check_equals_cryptography():
    rng = random.Random(7)
    keys = [KEYS["k1"], rsa.generate_private_key(public_exponent=3, key_size=1024),
            rsa.generate_private_key(public_exponent=65537, key_size=1536)]
    seen = {"valid": 0, "invalid": 0}
    for i in range(200):
        key = keys[i % len(keys)]
        nums = key.public_key().public_numbers()
        port_key = port_auth.RsaPublicKey(nums.n, nums.e)
        k = port_key.size
        msg = rng.randbytes(rng.randrange(0, 300))
        good = key.sign(msg, padding.PKCS1v15(), hashes.SHA256())
        digest = hashlib.sha256(msg).digest()
        flipped = bytearray(good)
        flipped[rng.randrange(k)] ^= 1 << rng.randrange(8)
        other = rng.choice(list(DIGEST_INFO))
        other_digest = hashlib.new(other.split("-")[0], msg).digest()
        cases = [
            good,
            bytes(flipped),
            good[1:],  # one byte short
            b"\x00" + good,  # one byte long
            nums.n.to_bytes(k, "big"),  # the modulus itself
            (nums.n + rng.randrange(1, 1000)).to_bytes(k, "big")
            if (nums.n + 1000).bit_length() <= 8 * k else good,  # above the modulus
            raw_sign(key, emsa(k, DIGEST_INFO[other] + other_digest)),  # another hash
            raw_sign(key, emsa(k, port_auth._SHA256_DIGEST_INFO + digest, block_type=2)),
            raw_sign(key, emsa(k, port_auth._SHA256_DIGEST_INFO + digest, fill=0xFE)),
            raw_sign(key, emsa(k, port_auth._SHA256_DIGEST_INFO + digest)),  # valid, by hand
            b"",
        ]
        for sig in cases:
            want = crypto_ok(key, sig, msg)
            assert port_auth._verify_rs256(port_key, sig, msg) == want, (i, sig.hex()[:40])
            seen["valid" if want else "invalid"] += 1
    assert seen["valid"] == 400 and seen["invalid"] == 200 * 11 - 400
