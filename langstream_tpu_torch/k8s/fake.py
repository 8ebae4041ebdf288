"""In-memory Kubernetes API store (the port's own copy of
``langstream_tpu/k8s/fake.py``; reference KubeTestServer — the fabric8 mock
server reused by operator and deployer tests, SURVEY §4 tier 3).

Objects are plain manifest dicts keyed by (kind, namespace, name).  The
store implements the minimal verbs the controllers need (get / list /
apply / delete / patch-status) with a monotonic "resourceVersion" bump
and a bounded EVENT LOG so ?watch=1 streams (http_fake.py) and the
SpecDiffer both work against it. Every verb takes the store's lock, so the
HTTP fake's request threads call it directly.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Optional


class FakeKubeServer:
    def __init__(self) -> None:
        self._objects: dict[tuple[str, str, str], dict[str, Any]] = {}
        self._version = 0
        self._lock = threading.Lock()
        # hooks: kind → callback(manifest) invoked after every apply
        self._on_apply: list[Callable[[dict[str, Any]], None]] = []
        # bounded watch event log: (resourceVersion, type, object)
        self._events: list[tuple[int, str, dict[str, Any]]] = []
        self.event_window = 1000  # entries kept; older watches get 410

    def _record_event(self, type_: str, obj: dict[str, Any]) -> None:
        """Append under self._lock (callers hold it)."""
        self._events.append((self._version, type_, copy.deepcopy(obj)))
        if len(self._events) > self.event_window:
            del self._events[: len(self._events) - self.event_window]

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def events_since(
        self, resource_version: int, kind: Optional[str] = None,
        namespace: Optional[str] = None,
    ) -> Optional[list[tuple[int, str, dict[str, Any]]]]:
        """Events with rv > resource_version, oldest first; None = the
        requested horizon fell out of the bounded log (k8s: 410 Gone)."""
        with self._lock:
            # rvs are consecutive (every bump records one event), so the
            # horizon is simply the oldest retained event's predecessor
            if self._events and resource_version < self._events[0][0] - 1:
                return None
            out = []
            for rv, type_, obj in self._events:
                if rv <= resource_version:
                    continue
                if kind is not None and obj.get("kind") != kind:
                    continue
                if namespace is not None and (
                    obj.get("metadata", {}).get("namespace", "default") != namespace
                ):
                    continue
                out.append((rv, type_, copy.deepcopy(obj)))
            return out

    # -- verbs ---------------------------------------------------------------

    def apply(self, manifest: dict[str, Any]) -> dict[str, Any]:
        kind = manifest.get("kind", "")
        meta = manifest.setdefault("metadata", {})
        namespace = meta.get("namespace", "default")
        name = meta.get("name", "")
        if not kind or not name:
            raise ValueError("manifest requires kind and metadata.name")
        with self._lock:
            self._version += 1
            key = (kind, namespace, name)
            existing = self._objects.get(key)
            stored = copy.deepcopy(manifest)
            stored["metadata"]["resourceVersion"] = str(self._version)
            if existing is not None and existing.get("spec") != manifest.get("spec"):
                stored["metadata"]["generation"] = (
                    int(existing.get("metadata", {}).get("generation", 1)) + 1
                )
            self._objects[key] = stored
            self._record_event("ADDED" if existing is None else "MODIFIED", stored)
            out = copy.deepcopy(stored)
        for hook in self._on_apply:
            hook(out)
        return out

    def get(self, kind: str, namespace: str, name: str) -> Optional[dict[str, Any]]:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, kind: str, namespace: Optional[str] = None) -> list[dict[str, Any]]:
        with self._lock:
            return [
                copy.deepcopy(obj)
                for (k, ns, _), obj in sorted(self._objects.items())
                if k == kind and (namespace is None or ns == namespace)
            ]

    def delete(self, kind: str, namespace: str, name: str) -> bool:
        with self._lock:
            obj = self._objects.pop((kind, namespace, name), None)
            if obj is not None:
                self._version += 1
                self._record_event("DELETED", obj)
            return obj is not None

    def patch_status(
        self, kind: str, namespace: str, name: str, status: dict[str, Any]
    ) -> Optional[dict[str, Any]]:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                return None
            self._version += 1
            obj["status"] = copy.deepcopy(status)
            obj["metadata"]["resourceVersion"] = str(self._version)
            self._record_event("MODIFIED", obj)
            return copy.deepcopy(obj)

    def on_apply(self, hook: Callable[[dict[str, Any]], None]) -> None:
        self._on_apply.append(hook)
