"""Object-storage sources (the port's own copy of
``langstream_tpu/agents/storage/__init__.py``).

Parity: reference `langstream-agent-s3` (`s3-source`: poll bucket, emit one
record per object, delete-on-commit) and
`langstream-agent-azure-blob-storage-source` (SURVEY §2.5). The reference
uses the minio/azure SDKs; neither is bundled here, so:

- `s3-source` speaks the S3 REST API directly (SigV4 signing via stdlib
  hmac/hashlib; ListObjectsV2/GetObject/DeleteObject) — works against
  minio/S3-compatible endpoints,
- `azure-blob-storage-source` uses SAS-token auth over the Blob REST API,
- `local-directory-source` is the filesystem analogue used for local mode
  and tests (same emit/delete-on-commit contract).

The listings are XML read by ``xml.etree``; every HTTP call runs ``urllib``
in a worker thread (``runtime/http_client.py``; JAX's use aiohttp).
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
from pathlib import Path
from typing import Any
from urllib.parse import quote, urlparse
from xml.etree import ElementTree

from langstream_tpu_torch.api.agent import AgentSource, ComponentType
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo
from langstream_tpu_torch.runtime import http_client

DEFAULT_EXTENSIONS = "pdf,docx,html,htm,md,txt"


class _ObjectStorageSource(AgentSource):
    """Shared poll→emit→delete-on-commit loop (reference S3Source.java)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.idle_time = float(configuration.get("idle-time", 5))
        extensions = configuration.get("file-extensions", DEFAULT_EXTENSIONS)
        self.extensions = [e.strip().lower() for e in str(extensions).split(",") if e.strip()]
        self.delete_objects = bool(configuration.get("delete-objects", True))
        self._in_flight: set[str] = set()
        # committed-but-kept objects (delete-objects=false) must not re-emit;
        # in-memory like the reference → restart re-emits (at-least-once)
        self._done: set[str] = set()

    def _extension_ok(self, name: str) -> bool:
        if not self.extensions:
            return True
        return name.rsplit(".", 1)[-1].lower() in self.extensions

    async def list_objects(self) -> list[str]:
        raise NotImplementedError

    async def get_object(self, name: str) -> bytes:
        raise NotImplementedError

    async def delete_object(self, name: str) -> None:
        raise NotImplementedError

    async def read(self) -> list[Record]:
        for name in await self.list_objects():
            if name in self._in_flight or name in self._done:
                continue
            if not self._extension_ok(name):
                continue
            body = await self.get_object(name)
            self._in_flight.add(name)
            self.processed(1)
            return [
                SimpleRecord.of(
                    body,
                    key=name,
                    headers=[("name", name), ("bucket", getattr(self, "bucket", ""))],
                    origin=self.agent_type,
                )
            ]
        await asyncio.sleep(self.idle_time)
        return []

    async def commit(self, records: list[Record]) -> None:
        for r in records:
            name = str(r.key)
            self._in_flight.discard(name)
            if self.delete_objects:
                await self.delete_object(name)
            else:
                self._done.add(name)


# ---------------------------------------------------------------------------
# local directory
# ---------------------------------------------------------------------------


class LocalDirectorySource(_ObjectStorageSource):
    """`local-directory-source`: same contract against a filesystem dir."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.directory = Path(configuration.get("directory", "."))
        self.bucket = str(self.directory)

    async def list_objects(self) -> list[str]:
        if not self.directory.exists():
            return []
        return sorted(
            str(p.relative_to(self.directory))
            for p in self.directory.rglob("*")
            if p.is_file()
        )

    async def get_object(self, name: str) -> bytes:
        return (self.directory / name).read_bytes()

    async def delete_object(self, name: str) -> None:
        try:
            (self.directory / name).unlink()
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# S3 (SigV4 REST)
# ---------------------------------------------------------------------------


def _sigv4_headers(
    method: str,
    url: str,
    region: str,
    access_key: str,
    secret_key: str,
    payload: bytes = b"",
    service: str = "s3",
) -> dict[str, str]:
    """Minimal AWS Signature V4 signing (S3 by default; any AWS service —
    the bedrock provider signs with service="bedrock")."""
    parsed = urlparse(url)
    host = parsed.netloc
    # callers build URLs with already-percent-encoded paths (quote(name)),
    # so the path is the canonical URI as-is; re-quoting would double-encode
    canonical_uri = parsed.path or "/"
    # canonical query: sorted key=value with URI-encoded parts
    query_pairs = []
    if parsed.query:
        for pair in parsed.query.split("&"):
            k, _, v = pair.partition("=")
            query_pairs.append((quote(k, safe="-_.~"), quote(v, safe="-_.~")))
    canonical_query = "&".join(f"{k}={v}" for k, v in sorted(query_pairs))

    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()

    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [method, canonical_uri, canonical_query, canonical_headers, signed_headers, payload_hash]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )

    def sign(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_date = sign(f"AWS4{secret_key}".encode(), datestamp)
    k_region = sign(k_date, region)
    k_service = sign(k_region, service)
    k_signing = sign(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()

    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return headers


class S3Source(_ObjectStorageSource):
    """`s3-source` against any S3-compatible endpoint (minio in the reference
    test/deploy stack). Path-style addressing: {endpoint}/{bucket}/{key}."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.bucket = configuration.get("bucketName", "langstream-source")
        self.endpoint = configuration.get("endpoint", "http://minio-endpoint.-not-set:9090").rstrip("/")
        self.access_key = configuration.get("access-key", "minioadmin")
        self.secret_key = configuration.get("secret-key", "minioadmin")
        self.region = configuration.get("region", "us-east-1")

    async def _request(self, method: str, url: str) -> tuple[int, bytes]:
        headers = _sigv4_headers(method, url, self.region, self.access_key, self.secret_key)
        resp = await http_client.request(method, url, headers=headers)
        return resp.status, resp.body

    async def list_objects(self) -> list[str]:
        url = f"{self.endpoint}/{self.bucket}?list-type=2"
        status, body = await self._request("GET", url)
        if status != 200:
            raise RuntimeError(f"S3 list failed ({status}): {body[:200]!r}")
        root = ElementTree.fromstring(body)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[: root.tag.index("}") + 1]
        return [
            c.findtext(f"{ns}Key", "")
            for c in root.iter(f"{ns}Contents")
            if c.findtext(f"{ns}Key")
        ]

    async def get_object(self, name: str) -> bytes:
        url = f"{self.endpoint}/{self.bucket}/{quote(name)}"
        status, body = await self._request("GET", url)
        if status != 200:
            raise RuntimeError(f"S3 get {name} failed ({status})")
        return body

    async def delete_object(self, name: str) -> None:
        url = f"{self.endpoint}/{self.bucket}/{quote(name)}"
        status, _ = await self._request("DELETE", url)
        if status not in (200, 204, 404):
            raise RuntimeError(f"S3 delete {name} failed ({status})")


# ---------------------------------------------------------------------------
# Azure Blob (SAS token)
# ---------------------------------------------------------------------------


class AzureBlobStorageSource(_ObjectStorageSource):
    """`azure-blob-storage-source` via SAS-token auth (the SDK-free path;
    the reference supports sas-token alongside account keys)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.container = configuration.get("container", "langstream-source")
        endpoint = configuration.get("endpoint", "")
        if not endpoint:
            account = configuration.get("storage-account-name", "")
            endpoint = f"https://{account}.blob.core.windows.net"
        self.endpoint = endpoint.rstrip("/")
        self.sas_token = configuration.get("sas-token", "").lstrip("?")
        self.bucket = self.container

    def _url(self, path: str, query: str = "") -> str:
        parts = [q for q in (query, self.sas_token) if q]
        suffix = ("?" + "&".join(parts)) if parts else ""
        return f"{self.endpoint}/{path}{suffix}"

    async def list_objects(self) -> list[str]:
        url = self._url(self.container, "restype=container&comp=list")
        resp = await http_client.request("GET", url)
        if resp.status != 200:
            raise RuntimeError(f"Azure list failed ({resp.status}): {resp.body[:200]!r}")
        root = ElementTree.fromstring(resp.body)
        return [b.findtext("Name", "") for b in root.iter("Blob") if b.findtext("Name")]

    async def get_object(self, name: str) -> bytes:
        resp = await http_client.request("GET", self._url(f"{self.container}/{quote(name)}"))
        if resp.status != 200:
            raise RuntimeError(f"Azure get {name} failed ({resp.status})")
        return resp.body

    async def delete_object(self, name: str) -> None:
        resp = await http_client.request("DELETE",
                                         self._url(f"{self.container}/{quote(name)}"))
        if resp.status not in (200, 202, 404):
            raise RuntimeError(f"Azure delete {name} failed ({resp.status})")


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

_COMMON = (
    ConfigProperty("idle-time", "poll sleep when empty (s)", type="number", default=5),
    ConfigProperty("file-extensions", "comma list filter", default=DEFAULT_EXTENSIONS),
    ConfigProperty("delete-objects", "delete after commit", type="boolean", default=True),
)


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="s3-source",
            component_type=ComponentType.SOURCE,
            factory=S3Source,
            description="Poll an S3 bucket; emit objects; delete on commit.",
            config_model=ConfigModel(
                type="s3-source",
                properties=props(
                    ConfigProperty("bucketName", "bucket", default="langstream-source"),
                    ConfigProperty("endpoint", "S3 endpoint url", required=True),
                    ConfigProperty("access-key", "access key"),
                    ConfigProperty("secret-key", "secret key"),
                    ConfigProperty("region", "region", default="us-east-1"),
                    *_COMMON,
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="azure-blob-storage-source",
            component_type=ComponentType.SOURCE,
            factory=AzureBlobStorageSource,
            description="Poll an Azure Blob container; emit blobs; delete on commit.",
            config_model=ConfigModel(
                type="azure-blob-storage-source",
                properties=props(
                    ConfigProperty("container", "container", default="langstream-source"),
                    ConfigProperty("endpoint", "blob endpoint url"),
                    ConfigProperty("storage-account-name", "account (builds endpoint)"),
                    ConfigProperty("sas-token", "SAS token"),
                    *_COMMON,
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="local-directory-source",
            component_type=ComponentType.SOURCE,
            factory=LocalDirectorySource,
            description="Poll a directory; emit files; delete on commit.",
            config_model=ConfigModel(
                type="local-directory-source",
                properties=props(
                    ConfigProperty("directory", "dir to poll", required=True),
                    *_COMMON,
                ),
            ),
        )
    )


_register()
