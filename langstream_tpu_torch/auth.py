"""JWT verification shared by the gateway's authentication providers (the
port's own copy of ``langstream_tpu/auth.py``), on the stdlib: the card's
machine has no ``cryptography``.

Parity: reference ``langstream-auth-jwt`` (AuthenticationProviderToken +
JwksUriSigningKeyResolver.java) — HS256 via a shared secret, RS256 via a
configured PEM public key, or RS256 via a JWKS endpoint resolved by ``kid``
with caching.

RS256 is RSASSA-PKCS1-v1_5 over SHA-256 (RFC 8017 §8.2.2): a signature
whose length is not the modulus length, or whose value is not below the
modulus, is refused; else ``s^e mod n`` must equal, byte for byte, the
whole EMSA-PKCS1-v1_5 encoding of the payload's SHA-256 DigestInfo (the
expected block is built and compared, the decrypted one is never parsed).
Public keys are read from a PEM ``PUBLIC KEY`` (SubjectPublicKeyInfo) or
``RSA PUBLIC KEY`` (PKCS#1) block by a minimal DER reader, or from a JWK's
``n`` and ``e``. The JWKS document is fetched with ``urllib`` in a worker
thread (``runtime/http_client.py``), with a 10 s timeout.

Configuration keys (all providers pick the first that applies):
  secret-key        HS256 shared secret
  public-key        RS256 PEM public key (inline, ``-----BEGIN ...``)
  jwks-uri          RS256 JWKS endpoint; keys cached, refreshed on unknown kid
  audience / issuer optional claim checks (audience accepts list claims)
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import http.client
import json
import time
from dataclasses import dataclass
from typing import Any, Optional


class JwtError(ValueError):
    pass


def _b64d(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def decode_unverified(token: str) -> tuple[dict, dict, bytes, bytes]:
    """(header, payload, signature, signed_bytes) — no verification."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64d(header_b64))
        payload = json.loads(_b64d(payload_b64))
        signature = _b64d(sig_b64)
    except Exception as e:  # noqa: BLE001 — any malformation is the same error
        raise JwtError(f"malformed JWT: {e}") from e
    return header, payload, signature, f"{header_b64}.{payload_b64}".encode()


@dataclass(frozen=True)
class RsaPublicKey:
    n: int
    e: int

    @property
    def size(self) -> int:
        """The modulus length in bytes."""
        return (self.n.bit_length() + 7) // 8


# DER of the DigestInfo AlgorithmIdentifier for SHA-256 (RFC 8017 §9.2 note 1)
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_RSA_OID = "1.2.840.113549.1.1.1"
# the key types a SubjectPublicKeyInfo may name besides RSA, by the class
# name ``cryptography`` gives each (JAX's refusal names that class)
_OTHER_KEY_TYPES = {
    "1.2.840.10045.2.1": "ECPublicKey",
    "1.3.101.112": "Ed25519PublicKey",
    "1.3.101.113": "Ed448PublicKey",
    "1.3.101.110": "X25519PublicKey",
    "1.3.101.111": "X448PublicKey",
    "1.2.840.10040.4.1": "DSAPublicKey",
    "1.2.840.113549.1.3.1": "DHPublicKey",
    "1.2.840.10046.2.1": "DHPublicKey",
}


def _der(data: bytes, pos: int) -> tuple[int, bytes, int]:
    """One DER element at ``pos`` → (tag, contents, position after it)."""
    if pos + 2 > len(data):
        raise ValueError("truncated DER")
    tag, length = data[pos], data[pos + 1]
    pos += 2
    if length & 0x80:
        count = length & 0x7F
        if count == 0 or count > 4 or pos + count > len(data):
            raise ValueError("bad DER length")
        length = int.from_bytes(data[pos:pos + count], "big")
        pos += count
    if pos + length > len(data):
        raise ValueError("truncated DER")
    return tag, data[pos:pos + length], pos + length


def _der_seq(data: bytes) -> list[tuple[int, bytes]]:
    """The elements of a SEQUENCE's contents."""
    out, pos = [], 0
    while pos < len(data):
        tag, body, pos = _der(data, pos)
        out.append((tag, body))
    return out


def _der_oid(body: bytes) -> str:
    parts = [body[0] // 40, body[0] % 40]
    value = 0
    for b in body[1:]:
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            parts.append(value)
            value = 0
    return ".".join(map(str, parts))


def _rsa_from_pkcs1(der: bytes) -> RsaPublicKey:
    tag, body, end = _der(der, 0)
    items = _der_seq(body) if tag == 0x30 else []
    if end != len(der) or len(items) != 2 or any(t != 0x02 for t, _ in items):
        raise ValueError("not an RSAPublicKey")
    n, e = (int.from_bytes(b, "big", signed=True) for _, b in items)
    if n <= 0 or e <= 0:
        raise ValueError("not an RSAPublicKey")
    return RsaPublicKey(n, e)


def _rsa_key_from_jwk(jwk: dict) -> RsaPublicKey:
    n = int.from_bytes(_b64d(jwk["n"]), "big")
    e = int.from_bytes(_b64d(jwk["e"]), "big")
    return RsaPublicKey(n, e)


def _rsa_key_from_pem(pem: str) -> RsaPublicKey:
    """An RSA public key from a PEM ``PUBLIC KEY`` or ``RSA PUBLIC KEY``
    block; another key type is refused with JAX's text, at configuration
    time (an EC / Ed25519 key would otherwise fail every RS256 check)."""
    text = pem.strip()
    for label in ("PUBLIC KEY", "RSA PUBLIC KEY"):
        head, tail = f"-----BEGIN {label}-----", f"-----END {label}-----"
        if text.startswith(head) and text.endswith(tail):
            break
    else:
        raise ValueError("Could not deserialize key data: not a PEM public key block")
    try:
        der = base64.b64decode("".join(text[len(head):-len(tail)].split()), validate=True)
        if label == "RSA PUBLIC KEY":
            return _rsa_from_pkcs1(der)
        tag, body, end = _der(der, 0)
        items = _der_seq(body) if tag == 0x30 else []
        if end != len(der) or len(items) != 2 or items[0][0] != 0x30 or items[1][0] != 0x03:
            raise ValueError("not a SubjectPublicKeyInfo")
        algorithm = _der_seq(items[0][1])
        if not algorithm or algorithm[0][0] != 0x06:
            raise ValueError("not a SubjectPublicKeyInfo")
        oid = _der_oid(algorithm[0][1])
    except (ValueError, IndexError, binascii.Error) as e:
        raise ValueError(f"Could not deserialize key data: {e}") from e
    if oid in _OTHER_KEY_TYPES:
        raise ValueError(
            f"public-key must be an RSA public key, got {_OTHER_KEY_TYPES[oid]}"
        )
    if oid != _RSA_OID:
        raise ValueError(f"Could not deserialize key data: unsupported key type {oid}")
    bits = items[1][1]
    if not bits or bits[0] != 0:
        raise ValueError("Could not deserialize key data: bad BIT STRING")
    return _rsa_from_pkcs1(bits[1:])


def _verify_rs256(key: RsaPublicKey, signature: bytes, signed: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 verification with SHA-256 (RFC 8017 §8.2.2)."""
    k = key.size
    t = _SHA256_DIGEST_INFO + hashlib.sha256(signed).digest()
    if len(signature) != k or k < len(t) + 11:
        return False
    s = int.from_bytes(signature, "big")
    if s >= key.n:
        return False
    em = pow(s, key.e, key.n).to_bytes(k, "big")
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, expected)


class JwtVerifier:
    """Verifies bearer JWTs per the configuration (see module docstring)."""

    # JAX's client timeout for the JWKS fetch (aiohttp ``total=10``)
    JWKS_TIMEOUT_S = 10.0

    def __init__(self, configuration: dict[str, Any]) -> None:
        self._secret: Optional[str] = configuration.get("secret-key")
        self._public_key_pem: Optional[str] = configuration.get("public-key")
        self._jwks_uri: Optional[str] = configuration.get("jwks-uri")
        self._audience = configuration.get("audience")
        self._issuer = configuration.get("issuer")
        if not (self._secret or self._public_key_pem or self._jwks_uri):
            raise ValueError(
                "jwt verification requires one of secret-key / public-key / jwks-uri"
            )
        self._pem_key = (
            _rsa_key_from_pem(self._public_key_pem) if self._public_key_pem else None
        )
        self._jwks_keys: dict[Optional[str], RsaPublicKey] = {}  # kid → rsa public key

    async def _resolve_jwks_key(self, kid: Optional[str]) -> RsaPublicKey:
        """kid → key, fetching/refreshing the JWKS on a miss
        (JwksUriSigningKeyResolver semantics)."""
        if kid in self._jwks_keys:
            return self._jwks_keys[kid]
        from langstream_tpu_torch.runtime import http_client

        assert self._jwks_uri is not None
        try:
            resp = await http_client.request("GET", self._jwks_uri,
                                             timeout=self.JWKS_TIMEOUT_S)
        except (OSError, http.client.HTTPException) as e:
            # network faults must fail AUTH, not escape as raw exceptions
            raise JwtError(f"jwks fetch failed: {e}") from e
        if resp.status != 200:
            raise JwtError(f"jwks fetch failed: HTTP {resp.status}")
        doc = resp.json()
        for jwk in doc.get("keys", []):
            if jwk.get("kty") == "RSA":
                self._jwks_keys[jwk.get("kid")] = _rsa_key_from_jwk(jwk)
        if kid not in self._jwks_keys:
            if kid is None and len(self._jwks_keys) == 1:
                # kid-less issuer with a single key: cache under None so the
                # hot path stops refetching the document per verification
                self._jwks_keys[None] = next(iter(self._jwks_keys.values()))
                return self._jwks_keys[None]
            raise JwtError(f"no JWKS key for kid {kid!r}")
        return self._jwks_keys[kid]

    async def verify(self, token: str) -> dict[str, Any]:
        """Returns the validated claims; raises JwtError otherwise."""
        header, payload, signature, signed = decode_unverified(token)
        alg = header.get("alg")
        if alg == "HS256":
            if not self._secret:
                raise JwtError("HS256 token but no secret-key configured")
            expected = hmac.new(self._secret.encode(), signed, hashlib.sha256).digest()
            if not hmac.compare_digest(signature, expected):
                raise JwtError("bad signature")
        elif alg == "RS256":
            if self._pem_key is not None:
                key = self._pem_key
            elif self._jwks_uri:
                key = await self._resolve_jwks_key(header.get("kid"))
            else:
                raise JwtError("RS256 token but no public-key / jwks-uri configured")
            if not _verify_rs256(key, signature, signed):
                raise JwtError("bad signature")
        else:
            raise JwtError(f"unsupported alg {alg!r}")

        now = time.time()

        def numeric(claim: str) -> Optional[float]:
            if claim not in payload:
                return None
            try:
                return float(payload[claim])
            except (TypeError, ValueError) as e:
                raise JwtError(f"non-numeric {claim} claim") from e

        exp, nbf = numeric("exp"), numeric("nbf")
        if exp is not None and now > exp:
            raise JwtError("token expired")
        if nbf is not None and now < nbf:
            raise JwtError("token not yet valid")
        if self._audience is not None:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            accepted = (
                self._audience
                if isinstance(self._audience, list)
                else [self._audience]
            )
            # accept on any intersection (mirrors the issuer-list handling);
            # equality — not set() — so a malformed unhashable aud entry
            # still yields a clean JwtError → 401, not a TypeError
            if not any(a in auds for a in accepted):
                raise JwtError("bad audience")
        if self._issuer is not None:
            issuers = (
                self._issuer if isinstance(self._issuer, list) else [self._issuer]
            )
            if payload.get("iss") not in issuers:
                raise JwtError("bad issuer")
        return payload


def claims_to_principal(payload: dict[str, Any]) -> dict[str, str]:
    """Flatten string-ish claims into principal values for header mappings
    and consume filters (value-from-authentication)."""
    values = {
        k: str(v) for k, v in payload.items() if isinstance(v, (str, int, float))
    }
    if "sub" in payload:
        values.setdefault("subject", str(payload["sub"]))
    return values
