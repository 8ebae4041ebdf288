"""Admin HTTP client with retries (the port's own copy of
``langstream_tpu/cli/client.py``, on ``urllib`` and ``http.client``: the
card's machine has no requests; reference ``langstream-admin-client``
AdminClient / HttpClientFacade / ExponentialRetryPolicy)."""

from __future__ import annotations

import http.client
import io
import json
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
import zipfile
from pathlib import Path
from typing import Any, Iterator, Optional


class AdminClientError(Exception):
    def __init__(self, message: str, status: Optional[int] = None) -> None:
        super().__init__(message)
        self.status = status


def multipart_body(fields: dict[str, tuple[str, bytes, Optional[str]]]) -> tuple[bytes, str]:
    """``{name: (filename, bytes, content type or None)}`` as a
    ``multipart/form-data`` body and its Content-Type (requests' layout)."""
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, (filename, data, content_type) in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        out.write(f'Content-Disposition: form-data; name="{name}"; '
                  f'filename="{filename}"\r\n'.encode())
        if content_type:
            out.write(f"Content-Type: {content_type}\r\n".encode())
        out.write(b"\r\n" + data + b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


class AdminClient:
    def __init__(
        self,
        base_url: str,
        tenant: str = "default",
        token: Optional[str] = None,
        retries: int = 3,
        backoff_s: float = 0.5,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.tenant = tenant
        self.token = token
        self.retries = retries
        self.backoff_s = backoff_s

    # -- plumbing ------------------------------------------------------------

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    def _request(
        self,
        method: str,
        path: str,
        params: Optional[dict[str, str]] = None,
        body: Optional[bytes] = None,
        content_type: Optional[str] = None,
    ) -> bytes:
        """The response body of one call; a refused connection or a 5xx
        answer is retried ``retries`` times with exponential backoff, a
        4xx (or the last 5xx) raises ``AdminClientError`` with the
        server's ``error`` text."""
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = self._headers()
        if content_type:
            headers["Content-Type"] = content_type
        last: Optional[Exception] = None
        for attempt in range(self.retries):
            req = urllib.request.Request(url, data=body, method=method, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.read()
            except urllib.error.HTTPError as e:
                status, text = e.code, e.read().decode("utf-8", "replace")
            except (urllib.error.URLError, ConnectionError) as e:
                last = e
                if attempt + 1 < self.retries:
                    time.sleep(self.backoff_s * (2**attempt))
                continue
            if status >= 500 and attempt + 1 < self.retries:
                time.sleep(self.backoff_s * (2**attempt))
                continue
            try:
                reason = json.loads(text).get("error", text)
            except Exception:  # noqa: BLE001
                reason = text
            raise AdminClientError(f"{method} {path} → {status}: {reason}", status)
        raise AdminClientError(f"{method} {path} failed: {last}")

    def _json(self, method: str, path: str, **kwargs: Any) -> Any:
        return json.loads(self._request(method, path, **kwargs))

    # -- applications --------------------------------------------------------

    @staticmethod
    def zip_app_dir(app_dir: str | Path) -> bytes:
        """Zip an application directory, honouring .gitignore-style exclusion
        of hidden files (reference AbstractDeployApplicationCmd zipping)."""
        app_dir = Path(app_dir)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for p in sorted(app_dir.rglob("*")):
                rel = p.relative_to(app_dir)
                if p.is_file() and not any(part.startswith(".") for part in rel.parts):
                    zf.write(p, str(rel))
        return buf.getvalue()

    def deploy(
        self,
        name: str,
        app_dir: str | Path,
        instance_path: Optional[str | Path] = None,
        secrets_path: Optional[str | Path] = None,
        update: bool = False,
        dry_run: bool = False,
    ) -> dict[str, Any]:
        fields = {"app": ("app.zip", self.zip_app_dir(app_dir), "application/zip")}
        if instance_path:
            fields["instance"] = ("instance.yaml", Path(instance_path).read_bytes(), None)
        if secrets_path:
            fields["secrets"] = ("secrets.yaml", Path(secrets_path).read_bytes(), None)
        body, content_type = multipart_body(fields)
        return self._json(
            "PATCH" if update else "POST",
            f"/api/applications/{self.tenant}/{name}",
            params={"dry-run": "true"} if dry_run else None,
            body=body,
            content_type=content_type,
        )

    def get(self, name: str) -> dict[str, Any]:
        return self._json("GET", f"/api/applications/{self.tenant}/{name}")

    def list(self) -> list[dict[str, Any]]:
        return self._json("GET", f"/api/applications/{self.tenant}")

    def delete(self, name: str) -> dict[str, Any]:
        return self._json("DELETE", f"/api/applications/{self.tenant}/{name}")

    def logs(self, name: str, replica: str = "") -> str:
        return self._request(
            "GET",
            f"/api/applications/{self.tenant}/{name}/logs",
            params={"filter": replica} if replica else None,
        ).decode("utf-8")

    def follow_logs(self, name: str, replica: str = "") -> Iterator[dict[str, Any]]:
        """Yield live log entries (dicts) from the NDJSON follow stream —
        the CLI `apps logs -f` tail, read line by line. Blocks until the
        server ends the stream or the caller stops iterating; the
        connection closes either way."""
        params = {"follow": "1"}
        if replica:
            params["filter"] = replica
        split = urllib.parse.urlsplit(self.base_url)
        conn_cls = (http.client.HTTPSConnection if split.scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(split.hostname, split.port, timeout=10)  # the connect's limit
        try:
            conn.request(
                "GET",
                f"{split.path}/api/applications/{self.tenant}/{name}/logs?"
                + urllib.parse.urlencode(params),
                headers=self._headers(),
            )
            assert conn.sock is not None
            conn.sock.settimeout(None)  # a quiet stream waits as long as it must
            resp = conn.getresponse()
            if resp.status >= 400:
                raise AdminClientError(
                    f"logs follow → {resp.status}: {resp.read().decode('utf-8', 'replace')}",
                    resp.status,
                )
            while True:
                line = resp.readline()
                if not line:
                    return
                if line.strip():
                    yield json.loads(line)
        finally:
            conn.close()

    def download(self, name: str) -> bytes:
        return self._request("GET", f"/api/applications/{self.tenant}/{name}/code")

    # -- tenants -------------------------------------------------------------

    def tenant_put(self, name: str) -> dict[str, Any]:
        return self._json("PUT", f"/api/tenants/{name}")

    def tenant_get(self, name: str) -> dict[str, Any]:
        return self._json("GET", f"/api/tenants/{name}")

    def tenant_delete(self, name: str) -> dict[str, Any]:
        return self._json("DELETE", f"/api/tenants/{name}")

    def tenant_list(self) -> dict[str, Any]:
        return self._json("GET", "/api/tenants")

    # -- archetypes ----------------------------------------------------------

    def archetype_list(self) -> list[dict[str, Any]]:
        return self._json("GET", f"/api/archetypes/{self.tenant}")

    def archetype_get(self, archetype_id: str) -> dict[str, Any]:
        return self._json("GET", f"/api/archetypes/{self.tenant}/{archetype_id}")

    def archetype_deploy(
        self, archetype_id: str, name: str, parameters: dict[str, Any]
    ) -> dict[str, Any]:
        return self._json(
            "POST",
            f"/api/archetypes/{self.tenant}/{archetype_id}/applications/{name}",
            body=json.dumps(parameters).encode(),
        )
