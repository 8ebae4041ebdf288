"""Application / metadata / code stores for the control plane (the port's
own copy of ``langstream_tpu/webservice/stores.py``: the same on-disk
layout and file contents, so either package reads a root the other wrote).

Parity: reference ``langstream-k8s-storage`` (apps as CRD+Secret →
KubernetesApplicationStore.java:138-195) and ``langstream-core``
``LocalDiskCodeStorage`` / ``LocalStore``.  The TPU rebuild's local mode
persists the *source package* (the YAML files) plus the instance/secrets
documents, and re-parses on load — the package is the source of truth the
same way the CRD-serialized app is in the reference.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Any, Optional

from langstream_tpu_torch.api.model import Application, Secrets
from langstream_tpu_torch.api.storage import (
    ApplicationStore,
    CodeArchiveMetadata,
    CodeStorage,
    GlobalMetadataStore,
    StoredApplication,
)
from langstream_tpu_torch.core.parser import ModelBuilder, is_pipeline_document


class InMemoryApplicationStore(ApplicationStore):
    """Test/local store (reference runtime-tester InMemoryApplicationStore)."""

    def __init__(self) -> None:
        self._apps: dict[tuple[str, str], StoredApplication] = {}
        self._secrets: dict[tuple[str, str], Secrets] = {}
        self._raw: dict[tuple[str, str], tuple[Optional[str], Optional[str]]] = {}
        self._files: dict[tuple[str, str], dict[str, str]] = {}

    def put_package(
        self,
        tenant: str,
        application_id: str,
        package_files: dict[str, str],
        instance_text: Optional[str],
        secrets_text: Optional[str],
        code_archive_id: Optional[str],
    ) -> StoredApplication:
        pkg = ModelBuilder.build_application_from_files(
            {k: v for k, v in package_files.items() if is_pipeline_document(k)},
            instance_text,
            secrets_text,
        )
        self.put(tenant, application_id, pkg.application, code_archive_id)
        self._raw[(tenant, application_id)] = (instance_text, secrets_text)
        self._files[(tenant, application_id)] = dict(package_files)
        stored = self.get(tenant, application_id)
        assert stored is not None
        return stored

    def get_raw_documents(
        self, tenant: str, application_id: str
    ) -> tuple[Optional[str], Optional[str]]:
        """(instance_text, secrets_text) as last deployed — updates that omit
        them must fall back to these rather than dropping the environment."""
        return self._raw.get((tenant, application_id), (None, None))

    def get_package_files(self, tenant: str, application_id: str) -> dict[str, str]:
        return dict(self._files.get((tenant, application_id), {}))

    def put(
        self,
        tenant: str,
        application_id: str,
        application: Application,
        code_archive_id: Optional[str],
    ) -> None:
        self._apps[(tenant, application_id)] = StoredApplication(
            application_id=application_id,
            application=application,
            code_archive_id=code_archive_id,
        )
        self._secrets[(tenant, application_id)] = application.secrets

    def get(self, tenant: str, application_id: str) -> Optional[StoredApplication]:
        return self._apps.get((tenant, application_id))

    def delete(self, tenant: str, application_id: str) -> None:
        self._apps.pop((tenant, application_id), None)
        self._secrets.pop((tenant, application_id), None)
        self._raw.pop((tenant, application_id), None)
        self._files.pop((tenant, application_id), None)

    def list(self, tenant: str) -> dict[str, StoredApplication]:
        return {
            app_id: stored
            for (t, app_id), stored in self._apps.items()
            if t == tenant
        }

    def get_secrets(self, tenant: str, application_id: str) -> Optional[Secrets]:
        return self._secrets.get((tenant, application_id))


class LocalDiskApplicationStore(ApplicationStore):
    """Persists app packages under ``root/{tenant}/{app}/``:

        package/…yaml   the application files as deployed
        instance.yaml   environment document
        secrets.yaml    secrets document (plain on disk — local mode only;
                        the reference stores these in a K8s Secret)
        meta.json       code_archive_id + status
    """

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _dir(self, tenant: str, application_id: str) -> Path:
        return self.root / tenant / application_id

    def put_package(
        self,
        tenant: str,
        application_id: str,
        package_files: dict[str, str],
        instance_text: Optional[str],
        secrets_text: Optional[str],
        code_archive_id: Optional[str],
    ) -> StoredApplication:
        """Store the raw documents and return the parsed application."""
        app_dir = self._dir(tenant, application_id)
        pkg_dir = app_dir / "package"
        if pkg_dir.exists():
            shutil.rmtree(pkg_dir)
        pkg_dir.mkdir(parents=True)
        for rel, text in package_files.items():
            target = pkg_dir / rel
            if not target.resolve().is_relative_to(pkg_dir.resolve()):
                raise ValueError(f"package path escapes the package dir: {rel}")
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(text)
        if instance_text is not None:
            (app_dir / "instance.yaml").write_text(instance_text)
        if secrets_text is not None:
            (app_dir / "secrets.yaml").write_text(secrets_text)
        meta = {"code_archive_id": code_archive_id, "status": {}}
        (app_dir / "meta.json").write_text(json.dumps(meta))
        stored = self.get(tenant, application_id)
        assert stored is not None
        return stored

    def put(
        self,
        tenant: str,
        application_id: str,
        application: Application,
        code_archive_id: Optional[str],
    ) -> None:
        raise NotImplementedError(
            "LocalDiskApplicationStore persists source packages; use put_package()"
        )

    def get_raw_documents(
        self, tenant: str, application_id: str
    ) -> tuple[Optional[str], Optional[str]]:
        app_dir = self._dir(tenant, application_id)
        instance_file = app_dir / "instance.yaml"
        secrets_file = app_dir / "secrets.yaml"
        return (
            instance_file.read_text() if instance_file.exists() else None,
            secrets_file.read_text() if secrets_file.exists() else None,
        )

    def get_package_files(self, tenant: str, application_id: str) -> dict[str, str]:
        pkg_dir = self._dir(tenant, application_id) / "package"
        if not pkg_dir.is_dir():
            return {}
        return {
            str(p.relative_to(pkg_dir)): p.read_text()
            for p in sorted(pkg_dir.rglob("*"))
            if p.is_file()
        }

    def get(self, tenant: str, application_id: str) -> Optional[StoredApplication]:
        app_dir = self._dir(tenant, application_id)
        pkg_dir = app_dir / "package"
        if not pkg_dir.is_dir():
            return None
        files: dict[str, str] = {}
        for p in sorted(pkg_dir.rglob("*")):
            # only pipeline documents parse; python/ user code etc. is
            # carried by get_package_files / the code archive
            rel = str(p.relative_to(pkg_dir))
            if p.is_file() and is_pipeline_document(rel):
                files[rel] = p.read_text()
        instance_file = app_dir / "instance.yaml"
        secrets_file = app_dir / "secrets.yaml"
        pkg = ModelBuilder.build_application_from_files(
            files,
            instance_file.read_text() if instance_file.exists() else None,
            secrets_file.read_text() if secrets_file.exists() else None,
        )
        meta_file = app_dir / "meta.json"
        meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
        return StoredApplication(
            application_id=application_id,
            application=pkg.application,
            code_archive_id=meta.get("code_archive_id"),
            status=meta.get("status", {}),
        )

    def update_status(self, tenant: str, application_id: str, status: dict[str, Any]) -> None:
        app_dir = self._dir(tenant, application_id)
        meta_file = app_dir / "meta.json"
        meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
        meta["status"] = status
        meta_file.write_text(json.dumps(meta))

    def delete(self, tenant: str, application_id: str) -> None:
        app_dir = self._dir(tenant, application_id)
        if app_dir.exists():
            shutil.rmtree(app_dir)

    def list(self, tenant: str) -> dict[str, StoredApplication]:
        """Lightweight listing: ids + meta only — no package re-parse (that
        would be one full ModelBuilder run per app per list call)."""
        tenant_dir = self.root / tenant
        if not tenant_dir.is_dir():
            return {}
        out: dict[str, StoredApplication] = {}
        for child in sorted(tenant_dir.iterdir()):
            if not child.is_dir() or not (child / "package").is_dir():
                continue
            meta_file = child / "meta.json"
            meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
            out[child.name] = StoredApplication(
                application_id=child.name,
                application=Application(),
                code_archive_id=meta.get("code_archive_id"),
                status=meta.get("status", {}),
            )
        return out

    def get_secrets(self, tenant: str, application_id: str) -> Optional[Secrets]:
        stored = self.get(tenant, application_id)
        return stored.application.secrets if stored else None


class LocalDiskGlobalMetadataStore(GlobalMetadataStore):
    """Key/value store backed by one JSON file (reference LocalStore /
    KubernetesGlobalMetadataStore-on-ConfigMaps)."""

    def __init__(self, root: str | Path) -> None:
        self.path = Path(root) / "global-metadata.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            self.path.write_text("{}")

    def _load(self) -> dict[str, str]:
        return json.loads(self.path.read_text())

    def _save(self, data: dict[str, str]) -> None:
        self.path.write_text(json.dumps(data, indent=2))

    def put(self, key: str, value: str) -> None:
        data = self._load()
        data[key] = value
        self._save(data)

    def get(self, key: str) -> Optional[str]:
        return self._load().get(key)

    def delete(self, key: str) -> None:
        data = self._load()
        data.pop(key, None)
        self._save(data)

    def list(self) -> dict[str, str]:
        return self._load()


class InMemoryGlobalMetadataStore(GlobalMetadataStore):
    def __init__(self) -> None:
        self._data: dict[str, str] = {}

    def put(self, key: str, value: str) -> None:
        self._data[key] = value

    def get(self, key: str) -> Optional[str]:
        return self._data.get(key)

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def list(self) -> dict[str, str]:
        return dict(self._data)


class InMemoryCodeStorage(CodeStorage):
    """Archive store for the all-in-one local mode (keeps `apps download`
    and diagram generation working without a disk root)."""

    def __init__(self) -> None:
        self._archives: dict[tuple[str, str], bytes] = {}

    def store(
        self, tenant: str, application_id: str, archive_bytes: bytes
    ) -> CodeArchiveMetadata:
        digest = hashlib.sha256(archive_bytes).hexdigest()
        code_store_id = f"{application_id}-{digest[:16]}"
        self._archives[(tenant, code_store_id)] = archive_bytes
        return CodeArchiveMetadata(
            tenant=tenant,
            code_store_id=code_store_id,
            application_id=application_id,
            digests={"archive": digest},
        )

    def download(self, tenant: str, code_store_id: str) -> bytes:
        data = self._archives.get((tenant, code_store_id))
        if data is None:
            raise FileNotFoundError(f"code archive {tenant}/{code_store_id} not found")
        return data

    def delete(self, tenant: str, code_store_id: str) -> None:
        self._archives.pop((tenant, code_store_id), None)


class LocalDiskCodeStorage(CodeStorage):
    """Archive store under ``root/{tenant}/{id}.zip`` (reference
    LocalDiskCodeStorage.java / S3CodeStorage)."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def store(
        self, tenant: str, application_id: str, archive_bytes: bytes
    ) -> CodeArchiveMetadata:
        digest = hashlib.sha256(archive_bytes).hexdigest()
        code_store_id = f"{application_id}-{digest[:16]}"
        tenant_dir = self.root / tenant
        tenant_dir.mkdir(parents=True, exist_ok=True)
        (tenant_dir / f"{code_store_id}.zip").write_bytes(archive_bytes)
        return CodeArchiveMetadata(
            tenant=tenant,
            code_store_id=code_store_id,
            application_id=application_id,
            digests={"archive": digest},
        )

    def download(self, tenant: str, code_store_id: str) -> bytes:
        path = self.root / tenant / f"{code_store_id}.zip"
        if not path.exists():
            raise FileNotFoundError(f"code archive {tenant}/{code_store_id} not found")
        return path.read_bytes()

    def delete(self, tenant: str, code_store_id: str) -> None:
        path = self.root / tenant / f"{code_store_id}.zip"
        if path.exists():
            path.unlink()


class S3CodeStorage(CodeStorage):
    """Archive store on any S3-compatible endpoint (reference
    ``S3CodeStorage.java`` — minio in its deploy stack). Objects live at
    ``{bucket}/{tenant}/{code_store_id}.zip``; requests are SigV4-signed
    with the same stdlib signer the s3-source agent uses
    (agents/storage/_sigv4_headers), no SDK."""

    def __init__(
        self,
        endpoint: str,
        bucket: str = "langstream-code-storage",
        access_key: str = "minioadmin",
        secret_key: str = "minioadmin",
        region: str = "us-east-1",
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    @staticmethod
    def from_config(config: dict[str, Any]) -> "S3CodeStorage":
        return S3CodeStorage(
            endpoint=config["endpoint"],
            bucket=config.get("bucket-name", "langstream-code-storage"),
            access_key=config.get("access-key", "minioadmin"),
            secret_key=config.get("secret-key", "minioadmin"),
            region=config.get("region", "us-east-1"),
        )

    def _request(self, method: str, key: str, payload: bytes = b"") -> tuple[int, bytes]:
        import urllib.error
        import urllib.request

        from langstream_tpu_torch.agents.storage import _sigv4_headers

        url = f"{self.endpoint}/{self.bucket}/{key}"
        headers = _sigv4_headers(
            method, url, self.region, self.access_key, self.secret_key, payload
        )
        req = urllib.request.Request(
            url, data=payload if method == "PUT" else None, method=method
        )
        for k, v in headers.items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _key(self, tenant: str, code_store_id: str) -> str:
        return f"{tenant}/{code_store_id}.zip"

    def store(
        self, tenant: str, application_id: str, archive_bytes: bytes
    ) -> CodeArchiveMetadata:
        digest = hashlib.sha256(archive_bytes).hexdigest()
        code_store_id = f"{application_id}-{digest[:16]}"
        status, body = self._request(
            "PUT", self._key(tenant, code_store_id), archive_bytes
        )
        if status not in (200, 201, 204):
            raise RuntimeError(f"S3 code upload failed ({status}): {body[:200]!r}")
        return CodeArchiveMetadata(
            tenant=tenant,
            code_store_id=code_store_id,
            application_id=application_id,
            digests={"archive": digest},
        )

    def download(self, tenant: str, code_store_id: str) -> bytes:
        status, body = self._request("GET", self._key(tenant, code_store_id))
        if status == 404:
            raise FileNotFoundError(f"code archive {tenant}/{code_store_id} not found")
        if status != 200:
            raise RuntimeError(f"S3 code download failed ({status}): {body[:200]!r}")
        return body

    def delete(self, tenant: str, code_store_id: str) -> None:
        self._request("DELETE", self._key(tenant, code_store_id))


class AzureBlobCodeStorage(CodeStorage):
    """Archive store on Azure Blob (reference ``AzureBlobCodeStorage.java``).
    Blobs live at ``{container}/{tenant}/{code_store_id}.zip``. Auth is
    either a SAS token (appended to every URL, the SDK-free path the
    azure-blob-storage-source agent uses) or an account key via SharedKey
    signing. ``endpoint`` overrides the account URL for Azurite/local stubs."""

    def __init__(
        self,
        endpoint: str,
        container: str = "langstream-code-storage",
        sas_token: str = "",
        account_name: str = "",
        account_key: str = "",
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.container = container
        self.sas_token = sas_token.lstrip("?")
        self.account_name = account_name
        self.account_key = account_key

    @staticmethod
    def from_config(config: dict[str, Any]) -> "AzureBlobCodeStorage":
        account = config.get("storage-account-name", "")
        endpoint = config.get("endpoint") or f"https://{account}.blob.core.windows.net"
        return AzureBlobCodeStorage(
            endpoint=endpoint,
            container=config.get("container", "langstream-code-storage"),
            sas_token=config.get("sas-token", ""),
            account_name=account,
            account_key=config.get("storage-account-key", ""),
        )

    def _shared_key_headers(
        self, method: str, path: str, payload: bytes, extra: dict[str, str]
    ) -> dict[str, str]:
        # Azure SharedKey: string-to-sign over canonicalized headers/resource
        import base64
        import email.utils
        import hmac

        headers = {
            "x-ms-date": email.utils.formatdate(usegmt=True),
            "x-ms-version": "2021-08-06",
            **extra,
        }
        ms_headers = "\n".join(
            f"{k.lower()}:{v}" for k, v in sorted(headers.items())
            if k.lower().startswith("x-ms-")
        )
        content_length = str(len(payload)) if payload else ""
        # Content-Type must be signed AND sent explicitly — urllib would
        # otherwise auto-add x-www-form-urlencoded to PUT bodies and break
        # the signature
        content_type = headers.get("Content-Type", "")
        string_to_sign = "\n".join([
            method, "", "", content_length, "", content_type, "", "", "", "",
            "", "",
            ms_headers,
            f"/{self.account_name}{path}",
        ])
        signature = base64.b64encode(
            hmac.new(
                base64.b64decode(self.account_key),
                string_to_sign.encode(),
                hashlib.sha256,
            ).digest()
        ).decode()
        headers["Authorization"] = f"SharedKey {self.account_name}:{signature}"
        return headers

    def _request(self, method: str, key: str, payload: bytes = b"") -> tuple[int, bytes]:
        import urllib.error
        import urllib.request

        path = f"/{self.container}/{key}"
        url = f"{self.endpoint}{path}"
        extra = (
            {"x-ms-blob-type": "BlockBlob", "Content-Type": "application/zip"}
            if method == "PUT"
            else {}
        )
        if self.sas_token:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}{self.sas_token}"
            headers = extra
        elif self.account_key:
            headers = self._shared_key_headers(method, path, payload, extra)
        else:
            headers = extra
        req = urllib.request.Request(
            url, data=payload if method == "PUT" else None, method=method
        )
        for k, v in headers.items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _key(self, tenant: str, code_store_id: str) -> str:
        return f"{tenant}/{code_store_id}.zip"

    def store(
        self, tenant: str, application_id: str, archive_bytes: bytes
    ) -> CodeArchiveMetadata:
        digest = hashlib.sha256(archive_bytes).hexdigest()
        code_store_id = f"{application_id}-{digest[:16]}"
        status, body = self._request(
            "PUT", self._key(tenant, code_store_id), archive_bytes
        )
        if status not in (200, 201, 204):
            raise RuntimeError(f"Azure code upload failed ({status}): {body[:200]!r}")
        return CodeArchiveMetadata(
            tenant=tenant,
            code_store_id=code_store_id,
            application_id=application_id,
            digests={"archive": digest},
        )

    def download(self, tenant: str, code_store_id: str) -> bytes:
        status, body = self._request("GET", self._key(tenant, code_store_id))
        if status == 404:
            raise FileNotFoundError(f"code archive {tenant}/{code_store_id} not found")
        if status != 200:
            raise RuntimeError(f"Azure code download failed ({status}): {body[:200]!r}")
        return body

    def delete(self, tenant: str, code_store_id: str) -> None:
        self._request("DELETE", self._key(tenant, code_store_id))


def make_code_storage(config: dict[str, Any]) -> CodeStorage:
    """``codeStorage`` config block → implementation (reference
    CodeStorageRegistry: type s3 | azure | local | memory)."""
    kind = (config.get("type") or "memory").lower()
    if kind == "s3":
        return S3CodeStorage.from_config(config.get("configuration", config))
    if kind in ("azure", "azure-blob-storage"):
        return AzureBlobCodeStorage.from_config(config.get("configuration", config))
    if kind in ("local", "disk"):
        cfg = config.get("configuration", config)
        return LocalDiskCodeStorage(cfg.get("path", "/var/lib/langstream-tpu/code"))
    if kind in ("memory", "none"):
        return InMemoryCodeStorage()
    raise ValueError(f"unknown code storage type {kind!r}")
