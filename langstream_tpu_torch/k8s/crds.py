"""Custom resources (the port's own copy of ``langstream_tpu/k8s/crds.py``;
reference deployer-api: ApplicationCustomResource, AgentCustomResource /
AgentSpec.java:33-60, helm/crds/*.yml).

Resources serialize to plain manifest dicts — the single currency shared by
the controllers, the resource factories, the fake API server, and a real
cluster client. The API group, kinds, labels and spec keys are the JAX
package's, so either package's operator reconciles the other's CRs, and
``config_checksum`` is the same digest byte for byte.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional

API_GROUP = "langstream.tpu"
API_VERSION = f"{API_GROUP}/v1alpha1"


def tenant_namespace(tenant: str, prefix: str = "langstream-") -> str:
    """Per-tenant namespace (reference TenantResources naming)."""
    return f"{prefix}{tenant}"


@dataclass
class ApplicationCustomResource:
    """Serialized application + deploy options + status
    (reference crds/ApplicationCustomResource + ApplicationSpec)."""

    name: str
    namespace: str
    tenant: str
    # the application source package (yaml name → text) plus env documents —
    # the spec carries the source of truth exactly as the reference carries
    # the serialized app in the CR
    package_files: dict[str, str] = field(default_factory=dict)
    instance_text: Optional[str] = None
    secrets_ref: Optional[str] = None  # name of the Secret holding secrets.yaml
    code_archive_id: Optional[str] = None
    status: dict[str, Any] = field(default_factory=dict)
    generation: int = 1

    KIND = "Application"
    PLURAL = "applications"

    def to_manifest(self) -> dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": self.KIND,
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "labels": {"app.langstream.tpu/tenant": self.tenant},
                "generation": self.generation,
            },
            "spec": {
                "tenant": self.tenant,
                "packageFiles": dict(self.package_files),
                "instance": self.instance_text,
                "secretsRef": self.secrets_ref,
                "codeArchiveId": self.code_archive_id,
            },
            "status": dict(self.status),
        }

    @staticmethod
    def from_manifest(m: dict[str, Any]) -> "ApplicationCustomResource":
        spec = m.get("spec", {})
        meta = m.get("metadata", {})
        return ApplicationCustomResource(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            tenant=spec.get("tenant", ""),
            package_files=dict(spec.get("packageFiles", {})),
            instance_text=spec.get("instance"),
            secrets_ref=spec.get("secretsRef"),
            code_archive_id=spec.get("codeArchiveId"),
            status=dict(m.get("status", {})),
            generation=int(meta.get("generation", 1)),
        )


@dataclass
class AgentCustomResource:
    """One physical agent of an execution plan (reference AgentSpec.java:33:
    agentId, applicationId, configuration secret ref + checksum,
    codeArchiveId, resources, options)."""

    name: str
    namespace: str
    tenant: str
    agent_id: str
    application_id: str
    agent_type: str
    component_type: str
    config_secret_ref: str
    config_checksum: str
    code_archive_id: Optional[str] = None
    parallelism: int = 1
    size: int = 1
    disk: Optional[dict[str, Any]] = None  # {enabled,type,size}
    tpu: Optional[dict[str, Any]] = None  # {type,topology,chips,mesh}
    # fleet autoscaling (serving/fleet.py, docs/SERVING.md §13):
    # {enabled, min-replicas, max-replicas}. The DESIRED count itself is
    # runtime state — the router's queue-wait-EMA hint, written to
    # status.fleet.desiredReplicas by the ops loop — so a scale decision
    # never touches the spec checksum (no pod rollout, just more pods).
    # min-replicas: 0 is legal (scale-to-zero, §23) — the router emits a
    # zero hint only when every replica checkpoints its sessions to the
    # durable tier, so scaling down loses nothing a resurrection can't
    # restore
    autoscale: Optional[dict[str, Any]] = None
    # multi-tenant overload control (serving/tenancy.py, docs/SERVING.md
    # §19): the declared tenants and their scheduling policy — list of
    # {name, weight, max-slots, queue-share, token-rate} blocks, passed
    # through to the tpu-serving `tenants:` config. Spec state (changing
    # a tenant's weight/quota IS a rollout — the engine builds its
    # registry at startup), unlike the autoscale hint above.
    tenants: Optional[list[dict[str, Any]]] = None
    status: dict[str, Any] = field(default_factory=dict)
    generation: int = 1

    KIND = "Agent"
    PLURAL = "agents"

    def to_manifest(self) -> dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": self.KIND,
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "labels": {
                    "app.langstream.tpu/tenant": self.tenant,
                    "app.langstream.tpu/application": self.application_id,
                    "app.langstream.tpu/agent": self.agent_id,
                },
                "generation": self.generation,
            },
            "spec": {
                "tenant": self.tenant,
                "agentId": self.agent_id,
                "applicationId": self.application_id,
                "agentType": self.agent_type,
                "componentType": self.component_type,
                "configSecretRef": self.config_secret_ref,
                "configChecksum": self.config_checksum,
                "codeArchiveId": self.code_archive_id,
                "resources": {
                    "parallelism": self.parallelism,
                    "size": self.size,
                    "disk": self.disk,
                    "tpu": self.tpu,
                    "autoscale": self.autoscale,
                    "tenants": self.tenants,
                },
            },
            "status": dict(self.status),
        }

    @staticmethod
    def from_manifest(m: dict[str, Any]) -> "AgentCustomResource":
        spec = m.get("spec", {})
        meta = m.get("metadata", {})
        resources = spec.get("resources", {})
        return AgentCustomResource(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            tenant=spec.get("tenant", ""),
            agent_id=spec.get("agentId", ""),
            application_id=spec.get("applicationId", ""),
            agent_type=spec.get("agentType", ""),
            component_type=spec.get("componentType", ""),
            config_secret_ref=spec.get("configSecretRef", ""),
            config_checksum=spec.get("configChecksum", ""),
            code_archive_id=spec.get("codeArchiveId"),
            parallelism=int(resources.get("parallelism", 1)),
            size=int(resources.get("size", 1)),
            disk=resources.get("disk"),
            tpu=resources.get("tpu"),
            autoscale=resources.get("autoscale"),
            tenants=resources.get("tenants"),
            status=dict(m.get("status", {})),
            generation=int(meta.get("generation", 1)),
        )


def config_checksum(configuration: dict[str, Any]) -> str:
    """Stable digest of an agent's runtime configuration; a changed checksum
    is what forces a pod rollout (reference AgentSpec checksum semantics)."""
    return hashlib.sha256(
        json.dumps(configuration, sort_keys=True, default=str).encode()
    ).hexdigest()[:32]
