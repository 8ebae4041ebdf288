"""Kubernetes runtime manager: the control plane's bridge to the operator
(the port's own copy of ``langstream_tpu/k8s/runtime_manager.py``).

Parity: reference ``KubernetesApplicationStore.java:138-195`` (apps become an
ApplicationCustomResource + secrets Secret in the tenant namespace) combined
with the AppController reconcile that follows.  Implements the webservice
``RuntimeManager`` protocol, so switching ``computeCluster.type`` from
``local`` to ``kubernetes`` swaps in-process agent runners for CRs reconciled
by the operator — the two planes share everything above this line.

``kube`` may be a blocking API client (``k8s/client.py``): the async
methods make their calls on a worker thread, never on the event loop.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from langstream_tpu_torch.api.storage import StoredApplication
from langstream_tpu_torch.k8s.crds import (
    AgentCustomResource,
    ApplicationCustomResource,
    tenant_namespace,
)
from langstream_tpu_torch.k8s.fake import FakeKubeServer
from langstream_tpu_torch.k8s.resources import AgentResourcesFactory


class KubernetesRuntimeManager:
    def __init__(self, kube: FakeKubeServer, store: Any) -> None:
        """``store`` must expose get_package_files/get_raw_documents
        (both webservice stores do)."""
        self.kube = kube
        self.store = store

    async def deploy_application(
        self, tenant: str, application_id: str, stored: StoredApplication
    ) -> None:
        await asyncio.to_thread(self._deploy, tenant, application_id, stored)

    def _deploy(self, tenant: str, application_id: str, stored: StoredApplication) -> None:
        from langstream_tpu_torch.core.parser import is_pipeline_document

        namespace = tenant_namespace(tenant)
        # the CR carries only the pipeline DOCUMENTS; user code (python/,
        # binaries) travels via code_archive_id + the code-download init
        # container (reference design) — inlining it would bloat etcd objects
        files = {
            rel: text
            for rel, text in self.store.get_package_files(tenant, application_id).items()
            if is_pipeline_document(rel)
        }
        instance_text, secrets_text = self.store.get_raw_documents(tenant, application_id)
        secrets_ref: Optional[str] = None
        if secrets_text is not None:
            secrets_ref = f"{application_id}-secrets"
            self.kube.apply(
                {
                    "apiVersion": "v1",
                    "kind": "Secret",
                    "metadata": {"name": secrets_ref, "namespace": namespace},
                    "stringData": {"secrets": secrets_text},
                }
            )
        existing = self.kube.get(ApplicationCustomResource.KIND, namespace, application_id)
        generation = 1
        if existing is not None:
            generation = int(existing["metadata"].get("generation", 1)) + 1
        app_cr = ApplicationCustomResource(
            name=application_id,
            namespace=namespace,
            tenant=tenant,
            package_files=files,
            instance_text=instance_text,
            secrets_ref=secrets_ref,
            code_archive_id=stored.code_archive_id,
            generation=generation,
        )
        self.kube.apply(app_cr.to_manifest())

    async def delete_application(self, tenant: str, application_id: str) -> None:
        from langstream_tpu_torch.k8s.controllers import delete_application_resources

        await asyncio.to_thread(
            delete_application_resources, self.kube, tenant_namespace(tenant), application_id
        )

    def application_status(self, tenant: str, application_id: str) -> dict[str, Any]:
        namespace = tenant_namespace(tenant)
        app = self.kube.get(ApplicationCustomResource.KIND, namespace, application_id)
        if app is None:
            return {"status": "UNKNOWN"}
        agent_manifests = [
            m
            for m in self.kube.list(AgentCustomResource.KIND, namespace)
            if m["spec"].get("applicationId") == application_id
        ]
        rolled = AgentResourcesFactory.aggregate_agents_status(agent_manifests)
        return {
            "status": app.get("status", {}).get("phase", "UNKNOWN"),
            "agents": rolled["agents"],
        }

    def application_logs(self, tenant: str, application_id: str) -> list[str]:
        status = self.application_status(tenant, application_id)
        return [f"{aid}: {s}" for aid, s in status.get("agents", {}).items()]
