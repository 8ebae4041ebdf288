"""Stdlib Kubernetes API client — the real-cluster counterpart of
``k8s/fake.py`` (the port's own copy of ``langstream_tpu/k8s/client.py``).

Speaks the same five verbs the reconcilers use (apply / get / list /
delete / patch_status) against a live API server over HTTPS, so
``AppController`` / ``AgentController`` / ``InProcessJobExecutor`` run
unchanged on either store (duck typing is the contract, like the
reference's fabric8 ``KubernetesClient`` interface —
``AppController.java:54``, ``Main.java:42-45``).

No client library: urllib + ssl from the stdlib; a kubeconfig is read with
the port's YAML reader (``core/yaml_reader.py``). Auth comes from a
kubeconfig (``KUBECONFIG`` / ``~/.kube/config``: bearer token or client
certificate) or the in-cluster service account
(``/var/run/secrets/kubernetes.io/serviceaccount``).

Every call blocks on a socket: async code calls the client through
``asyncio.to_thread`` (``k8s/runtime_manager.py``), never on its event loop.
``k8s/http_fake.py`` serves the fake store over real HTTP with the same
paths, verbs, status codes and content types, so every request the operator
would make to a live API server crosses an actual socket in the tests.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile
import time
import urllib.error
import urllib.request
from typing import Any, Optional

# kind → (api path prefix, plural, namespaced)
KIND_ROUTES: dict[str, tuple[str, str, bool]] = {
    "Secret": ("/api/v1", "secrets", True),
    "Service": ("/api/v1", "services", True),
    "Pod": ("/api/v1", "pods", True),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "Namespace": ("/api/v1", "namespaces", False),
    "StatefulSet": ("/apis/apps/v1", "statefulsets", True),
    "Deployment": ("/apis/apps/v1", "deployments", True),
    "Job": ("/apis/batch/v1", "jobs", True),
    "Application": ("/apis/langstream.tpu/v1alpha1", "applications", True),
    "Agent": ("/apis/langstream.tpu/v1alpha1", "agents", True),
    "CustomResourceDefinition": (
        "/apis/apiextensions.k8s.io/v1",
        "customresourcedefinitions",
        False,
    ),
}

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeWatchExpired(RuntimeError):
    """The watch's resourceVersion fell behind the server's event horizon
    (HTTP/in-stream 410 Gone): re-list, then watch from the fresh version."""


class KubeApiError(RuntimeError):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"kubernetes api error {status}: {message}")
        self.status = status


class KubeApiClient:
    """Minimal typed-path client over one API server."""

    def __init__(
        self,
        server: str,
        token: Optional[str] = None,
        ca_cert_path: Optional[str] = None,
        client_cert_path: Optional[str] = None,
        client_key_path: Optional[str] = None,
        insecure_skip_tls_verify: bool = False,
        timeout: float = 30.0,
    ) -> None:
        self.server = server.rstrip("/")
        self.token = token
        self.timeout = timeout
        # bounded retries for optimistic-concurrency conflicts / API blips
        self.max_conflict_retries = 5
        self._context: Optional[ssl.SSLContext] = None
        if self.server.startswith("https"):
            if insecure_skip_tls_verify:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            elif ca_cert_path:
                ctx = ssl.create_default_context(cafile=ca_cert_path)
            else:
                ctx = ssl.create_default_context()
            if client_cert_path:
                ctx.load_cert_chain(client_cert_path, client_key_path)
            self._context = ctx

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_env() -> "KubeApiClient":
        """KUBE_API_SERVER (tests / port-forwards) → kubeconfig → in-cluster."""
        server = os.environ.get("KUBE_API_SERVER")
        if server:
            return KubeApiClient(
                server,
                token=os.environ.get("KUBE_API_TOKEN"),
                insecure_skip_tls_verify=os.environ.get("KUBE_API_INSECURE") == "true",
            )
        kubeconfig = os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
        if os.path.exists(kubeconfig):
            return KubeApiClient.from_kubeconfig(kubeconfig)
        if os.path.exists(os.path.join(SERVICE_ACCOUNT_DIR, "token")):
            return KubeApiClient.in_cluster()
        raise RuntimeError(
            "no Kubernetes credentials: set KUBE_API_SERVER, provide a "
            "kubeconfig, or run in-cluster with a service account"
        )

    @staticmethod
    def in_cluster() -> "KubeApiClient":
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(SERVICE_ACCOUNT_DIR, "token")) as f:
            token = f.read().strip()
        return KubeApiClient(
            f"https://{host}:{port}",
            token=token,
            ca_cert_path=os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt"),
        )

    @staticmethod
    def from_kubeconfig(path: str, context: Optional[str] = None) -> "KubeApiClient":
        from langstream_tpu_torch.core.yaml_reader import safe_load

        with open(path) as f:
            cfg = safe_load(f.read())
        ctx_name = context or cfg.get("current-context")
        ctx = next(
            c["context"] for c in cfg.get("contexts", []) if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"] for c in cfg.get("clusters", []) if c["name"] == ctx["cluster"]
        )
        user = next(
            u["user"] for u in cfg.get("users", []) if u["name"] == ctx["user"]
        )

        owned: list[str] = []

        def materialize(source: dict, data_key: str, path_key: str) -> Optional[str]:
            # inline base64 *-data fields win over file paths, per kubectl
            data = source.get(data_key)
            if data:
                fd, name = tempfile.mkstemp(suffix=".pem")
                os.fchmod(fd, 0o600)
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(data))
                owned.append(name)
                return name
            return source.get(path_key)

        ca = materialize(cluster, "certificate-authority-data", "certificate-authority")
        cert = materialize(user, "client-certificate-data", "client-certificate")
        key = materialize(user, "client-key-data", "client-key")
        try:
            return KubeApiClient(
                cluster["server"],
                token=user.get("token"),
                ca_cert_path=ca,
                client_cert_path=cert,
                client_key_path=key,
                insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")),
            )
        finally:
            # the SSLContext reads the PEMs eagerly in __init__; don't leave
            # decoded private-key material behind in /tmp
            for name in owned:
                try:
                    os.unlink(name)
                except OSError:
                    pass

    # -- plumbing ------------------------------------------------------------

    def _path(self, kind: str, namespace: Optional[str], name: Optional[str]) -> str:
        try:
            prefix, plural, namespaced = KIND_ROUTES[kind]
        except KeyError:
            raise KubeApiError(400, f"unmapped kind {kind!r}") from None
        if namespaced:
            path = f"{prefix}/namespaces/{namespace or 'default'}/{plural}"
        else:
            path = f"{prefix}/{plural}"
        if name:
            path += f"/{name}"
        return path

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict[str, Any]] = None,
        content_type: str = "application/json",
    ) -> Optional[dict[str, Any]]:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.server + path, data=data, method=method
        )
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout, context=self._context
            ) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise KubeApiError(e.code, e.read().decode(errors="replace")) from e
        return json.loads(payload) if payload else {}

    # -- the five reconciler verbs ------------------------------------------

    def get(self, kind: str, namespace: str, name: str) -> Optional[dict[str, Any]]:
        return self._request("GET", self._path(kind, namespace, name))

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        resource_version: Optional[str] = None,
        timeout_seconds: int = 30,
    ):
        """Yield (type, object) watch events until the server ends the
        stream (timeoutSeconds). Raises KubeWatchExpired on an in-stream
        410 (the bounded event horizon passed the requested
        resourceVersion) — the caller re-lists and restarts the watch, the
        standard list-then-watch loop."""
        prefix, plural, namespaced = KIND_ROUTES[kind]
        if namespaced and namespace is None:
            path = f"{prefix}/{plural}"
        else:
            path = self._path(kind, namespace, None)
        query = f"?watch=1&timeoutSeconds={int(timeout_seconds)}"
        if resource_version is not None:
            query += f"&resourceVersion={resource_version}"
        req = urllib.request.Request(self.server + path + query, method="GET")
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(
                req, timeout=timeout_seconds + self.timeout, context=self._context
            ) as resp:
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    event = json.loads(line)
                    if (
                        event.get("type") == "ERROR"
                        and event.get("object", {}).get("code") == 410
                    ):
                        raise KubeWatchExpired(str(resource_version))
                    yield event.get("type", ""), event.get("object", {})
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise KubeWatchExpired(str(resource_version)) from e
            raise KubeApiError(e.code, e.read().decode(errors="replace")) from e

    def list(self, kind: str, namespace: Optional[str] = None) -> list[dict[str, Any]]:
        prefix, plural, namespaced = KIND_ROUTES[kind]
        if namespaced and namespace is None:
            # cluster-wide list of a namespaced kind
            path = f"{prefix}/{plural}"
        else:
            path = self._path(kind, namespace, None)
        out = self._request("GET", path)
        return list(out.get("items", [])) if out else []

    def apply(self, manifest: dict[str, Any]) -> dict[str, Any]:
        """Create-or-replace (the reconcilers' idempotent write)."""
        kind = manifest["kind"]
        meta = manifest.get("metadata", {})
        namespace = meta.get("namespace", "default")
        name = meta["name"]
        # conflict-aware upsert: a 409 means a concurrent writer moved the
        # object (stale resourceVersion on PUT, or create raced an existing
        # object) — re-read and retry with the fresh rv (reference JOSDK
        # operators get this from the framework's retry policy)
        last: Optional[KubeApiError] = None
        for attempt in range(self.max_conflict_retries):
            existing = self.get(kind, namespace, name)
            try:
                if existing is None:
                    created = self._request(
                        "POST", self._path(kind, namespace, None), manifest
                    )
                    assert created is not None
                    return created
                # carry the live resourceVersion forward (optimistic concurrency)
                attempt_manifest = dict(manifest)
                attempt_manifest["metadata"] = dict(meta)
                rv = existing.get("metadata", {}).get("resourceVersion")
                if rv is not None:
                    attempt_manifest["metadata"]["resourceVersion"] = rv
                updated = self._request(
                    "PUT", self._path(kind, namespace, name), attempt_manifest
                )
                assert updated is not None
                return updated
            except KubeApiError as e:
                if e.status != 409:
                    raise
                last = e
                time.sleep(min(0.05 * 2**attempt, 1.0))
        assert last is not None
        raise last

    def delete(self, kind: str, namespace: str, name: str) -> bool:
        out = self._request("DELETE", self._path(kind, namespace, name))
        return out is not None

    def patch_status(
        self, kind: str, namespace: str, name: str, status: dict[str, Any]
    ) -> Optional[dict[str, Any]]:
        # status patches retry on 409/transient-5xx: the patch is a merge
        # (no rv), so a conflict or blip just means "send it again"
        last: Optional[KubeApiError] = None
        for attempt in range(self.max_conflict_retries):
            try:
                return self._request(
                    "PATCH",
                    self._path(kind, namespace, name) + "/status",
                    {"status": status},
                    content_type="application/merge-patch+json",
                )
            except KubeApiError as e:
                if e.status not in (409, 429, 500, 502, 503, 504):
                    raise
                last = e
                time.sleep(min(0.05 * 2**attempt, 1.0))
        assert last is not None
        raise last
