"""Reconcilers (the port's own copy of ``langstream_tpu/k8s/controllers.py``;
reference JOSDK controllers).

``AppController`` (AppController.java:54,92-245): two-phase reconcile —
**setup job** (assets) then **deployer job** (planner writes Agent CRs);
inverse order on delete.  Job *execution* is pluggable: on a real cluster
the Jobs run in pods; in local/fake mode ``InProcessJobExecutor`` performs
the same work inline (the runtime-tester topology). The plan comes from the
port's ``core/parser.ModelBuilder``, ``core/planner.ClusterRuntime`` and
``core/resolver.resolve_placeholders``; the pod configuration it writes is
the JAX package's JSON for the same application.

``AgentController`` (AgentController.java:58,116-213): per-Agent dependents —
config Secret + headless Service + StatefulSet — applied only when the
generated spec differs (SpecDiffer), with pod→agent status aggregation.
Status is patched only when it changed (``_patch_status_if_changed``): an
unconditional patch would wake the operator's own watch.
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Protocol

from langstream_tpu_torch.k8s.crds import (
    AgentCustomResource,
    ApplicationCustomResource,
    config_checksum,
)
from langstream_tpu_torch.k8s.differ import specs_equal
from langstream_tpu_torch.k8s.fake import FakeKubeServer
from langstream_tpu_torch.k8s.resources import AgentResourcesFactory, AppResourcesFactory

log = logging.getLogger(__name__)


def delete_agent_and_dependents(
    kube: FakeKubeServer, namespace: str, manifest: dict[str, Any]
) -> None:
    """Remove an Agent CR and everything the AgentController materialized for
    it (StatefulSet, Service, config Secret) — pruning the CR alone would
    leave the workload running and holding its TPU slice."""
    name = manifest["metadata"]["name"]
    secret_ref = manifest.get("spec", {}).get("configSecretRef", f"{name}-config")
    kube.delete(AgentCustomResource.KIND, namespace, name)
    kube.delete("StatefulSet", namespace, name)
    kube.delete("Service", namespace, name)
    kube.delete("Secret", namespace, secret_ref)


def delete_application_resources(
    kube: FakeKubeServer, namespace: str, application_id: str
) -> None:
    """Full teardown of one application: agents + dependents, the setup and
    deployer Jobs, the app CR, and its secrets Secret. Single implementation
    shared by the operator cleanup and the control plane's delete path."""
    for manifest in kube.list(AgentCustomResource.KIND, namespace):
        if manifest["spec"].get("applicationId") == application_id:
            delete_agent_and_dependents(kube, namespace, manifest)
    for phase in ("deployer", "setup"):
        kube.delete(
            "Job", namespace, AppResourcesFactory.job_name_for(application_id, phase)
        )
    kube.delete(ApplicationCustomResource.KIND, namespace, application_id)
    kube.delete("Secret", namespace, f"{application_id}-secrets")


class JobExecutor(Protocol):
    """Runs the work a reconciler Job would run in-cluster."""

    def run_setup(self, app: ApplicationCustomResource) -> None: ...

    def run_deployer(self, app: ApplicationCustomResource) -> None: ...

    def run_cleanup(self, app: ApplicationCustomResource) -> None: ...


class InProcessJobExecutor:
    """Executes setup/deployer inline against the kube store: parses the app
    from the CR's package files, builds the execution plan, and writes one
    Agent CR per physical agent (the deployer job's work,
    KubernetesClusterRuntime.deploy:93)."""

    def __init__(self, kube: FakeKubeServer) -> None:
        self.kube = kube

    def _build_plan(self, app: ApplicationCustomResource):
        from langstream_tpu_torch.core.parser import ModelBuilder
        from langstream_tpu_torch.core.planner import ClusterRuntime
        from langstream_tpu_torch.core.resolver import resolve_placeholders

        from langstream_tpu_torch.core.parser import is_pipeline_document

        pkg = ModelBuilder.build_application_from_files(
            {k: v for k, v in app.package_files.items() if is_pipeline_document(k)},
            app.instance_text,
            self._secrets_text(app),
        )
        resolved = resolve_placeholders(pkg.application)
        return ClusterRuntime().build_execution_plan(app.name, resolved)

    def _secrets_text(self, app: ApplicationCustomResource) -> Optional[str]:
        if not app.secrets_ref:
            return None
        secret = self.kube.get("Secret", app.namespace, app.secrets_ref)
        if secret is None:
            return None
        return secret.get("stringData", {}).get("secrets")

    def run_setup(self, app: ApplicationCustomResource) -> None:
        # assets are provisioned by the agent runtime's asset managers in
        # local mode; the in-process setup validates they are declarable
        self._build_plan(app)

    @staticmethod
    def _serialize_node(node) -> dict[str, Any]:
        def conn(c):
            return {"topic": c.topic} if c is not None and c.topic else None

        out = {
            "agentId": node.id,
            "agentType": node.agent_type,
            "componentType": node.component_type,
            "module": node.module_id,
            "pipeline": node.pipeline_id,
            "configuration": dict(node.configuration),
            "errors": {
                "retries": node.errors.retries,
                "on-failure": node.errors.on_failure,
            },
            "input": conn(node.input),
            "output": conn(node.output),
            "disk": bool(node.disk),
        }
        if node.composite:
            out["composite"] = [
                InProcessJobExecutor._serialize_node(child) for child in node.composite
            ]
        return out

    def _pod_configuration(self, app: ApplicationCustomResource, plan, node) -> dict[str, Any]:
        """Full RuntimePodConfiguration — everything one agent pod needs to
        boot standalone (reference RuntimePodConfiguration in the agent
        Secret: agent node + streaming cluster + app resources)."""
        application = plan.application
        streaming = application.instance.streaming_cluster if application else None
        return {
            "tenant": app.tenant,
            "applicationId": app.name,
            "agent": self._serialize_node(node),
            "streamingCluster": {
                "type": streaming.type if streaming else "memory",
                "configuration": dict(streaming.configuration) if streaming else {},
            },
            "resources": {
                rid: {
                    "type": r.type,
                    "name": r.name,
                    "configuration": dict(r.configuration),
                }
                for rid, r in (application.resources.items() if application else ())
            },
        }

    def run_deployer(self, app: ApplicationCustomResource) -> None:
        plan = self._build_plan(app)
        desired: set[str] = set()
        for node in plan.agent_sequence():
            name = f"{app.name}-{node.id}".lower().replace("_", "-")
            desired.add(name)
            tpu = None
            if node.resources.tpu is not None:
                spec = node.resources.tpu
                tpu = {
                    "type": spec.type,
                    "topology": spec.topology,
                    "chips": spec.chips,
                    "mesh": dict(spec.mesh),
                    "hosts": spec.hosts,
                }
            agent = AgentCustomResource(
                name=name,
                namespace=app.namespace,
                tenant=app.tenant,
                agent_id=node.id,
                application_id=app.name,
                agent_type=node.agent_type,
                component_type=node.component_type,
                config_secret_ref=f"{name}-config",
                config_checksum=config_checksum(node.configuration),
                code_archive_id=app.code_archive_id,
                parallelism=node.resources.resolved_parallelism(),
                size=node.resources.resolved_size(),
                disk=(
                {
                    "enabled": True,
                    "type": node.resources.disk.type if node.resources.disk else "default",
                    "size": node.resources.disk.size if node.resources.disk else "256M",
                }
                if node.disk
                else None
            ),
                tpu=tpu,
            )
            # the deployer owns the pod-configuration Secret (reference: the
            # deployer job writes it; the AgentController only mounts it)
            self.kube.apply(
                AgentResourcesFactory().generate_config_secret(
                    agent, self._pod_configuration(app, plan, node)
                )
            )
            self.kube.apply(agent.to_manifest())
        # prune agents removed by an update (reference deployer delete path),
        # including their materialized dependents
        for manifest in self.kube.list(AgentCustomResource.KIND, app.namespace):
            if (
                manifest["spec"].get("applicationId") == app.name
                and manifest["metadata"]["name"] not in desired
            ):
                delete_agent_and_dependents(self.kube, app.namespace, manifest)

    def run_cleanup(self, app: ApplicationCustomResource) -> None:
        for manifest in self.kube.list(AgentCustomResource.KIND, app.namespace):
            if manifest["spec"].get("applicationId") == app.name:
                delete_agent_and_dependents(self.kube, app.namespace, manifest)



def _patch_status_if_changed(
    kube, kind: str, namespace: str, name: str,
    previous: dict[str, Any], status: dict[str, Any],
) -> None:
    """Skip the write when the status is already at the desired level: an
    unconditional patch bumps resourceVersion and emits a MODIFIED watch
    event, which would wake the operator's own watcher and busy-loop the
    reconcile pass against itself (the classic self-triggered storm)."""
    if previous == status:
        return
    kube.patch_status(kind, namespace, name, status)


class AppController:
    """Two-phase application reconciler."""

    def __init__(
        self,
        kube: FakeKubeServer,
        executor: JobExecutor,
        factory: Optional[AppResourcesFactory] = None,
    ) -> None:
        self.kube = kube
        self.executor = executor
        self.factory = factory or AppResourcesFactory()

    def reconcile(self, app_manifest: dict[str, Any]) -> dict[str, Any]:
        app = ApplicationCustomResource.from_manifest(app_manifest)
        previous = dict(app.status)
        status = dict(app.status)
        generation = str(app.generation)

        # phase 1: setup job (assets) — rerun when the generation moved
        if status.get("setupFor") != generation:
            job = self.factory.generate_setup_job(app)
            self.kube.apply(job)
            try:
                self.executor.run_setup(app)
            except Exception as e:  # noqa: BLE001
                status.update({"phase": "ERROR_SETUP", "reason": str(e)})
                _patch_status_if_changed(
                    self.kube, app.KIND, app.namespace, app.name, previous, status
                )
                return status
            status["setupFor"] = generation

        # phase 2: deployer job (planner → Agent CRs)
        if status.get("deployedFor") != generation:
            job = self.factory.generate_deployer_job(app)
            self.kube.apply(job)
            try:
                self.executor.run_deployer(app)
            except Exception as e:  # noqa: BLE001
                status.update({"phase": "ERROR_DEPLOY", "reason": str(e)})
                _patch_status_if_changed(
                    self.kube, app.KIND, app.namespace, app.name, previous, status
                )
                return status
            status["deployedFor"] = generation

        status["phase"] = "DEPLOYED"
        status.pop("reason", None)
        _patch_status_if_changed(
            self.kube, app.KIND, app.namespace, app.name, previous, status
        )
        return status

    def cleanup(self, app_manifest: dict[str, Any]) -> None:
        """Inverse-order delete (reference AppController delete flow)."""
        app = ApplicationCustomResource.from_manifest(app_manifest)
        self.executor.run_cleanup(app)
        delete_application_resources(self.kube, app.namespace, app.name)


class AgentController:
    """Agent CR → Secret + headless Service + StatefulSet dependents."""

    def __init__(
        self,
        kube: FakeKubeServer,
        factory: Optional[AgentResourcesFactory] = None,
    ) -> None:
        self.kube = kube
        self.factory = factory or AgentResourcesFactory()

    def reconcile(self, agent_manifest: dict[str, Any]) -> dict[str, Any]:
        agent = AgentCustomResource.from_manifest(agent_manifest)

        # the deployer job writes the full RuntimePodConfiguration Secret;
        # only create a stub if it is missing (standalone AgentController use)
        if self.kube.get("Secret", agent.namespace, agent.config_secret_ref) is None:
            secret = self.factory.generate_config_secret(
                agent,
                runtime_pod_configuration={
                    "agentId": agent.agent_id,
                    "applicationId": agent.application_id,
                    "agentType": agent.agent_type,
                    "configChecksum": agent.config_checksum,
                },
            )
            self._apply_if_changed(secret)
        self._apply_if_changed(self.factory.generate_headless_service(agent))
        statefulset = self.factory.generate_stateful_set(agent)
        self._apply_if_changed(statefulset)

        status = self._aggregate_status(agent)
        _patch_status_if_changed(
            self.kube, agent.KIND, agent.namespace, agent.name,
            dict(agent_manifest.get("status") or {}), status,
        )
        return status

    def _apply_if_changed(self, manifest: dict[str, Any]) -> bool:
        existing = self.kube.get(
            manifest["kind"],
            manifest["metadata"].get("namespace", "default"),
            manifest["metadata"]["name"],
        )
        if existing is not None and specs_equal(existing, manifest):
            return False
        self.kube.apply(manifest)
        return True

    def _aggregate_status(self, agent: AgentCustomResource) -> dict[str, Any]:
        sts = self.kube.get("StatefulSet", agent.namespace, agent.name)
        if sts is None:
            return {"phase": "DEPLOYING", "replicas": 0, "readyReplicas": 0}
        sts_status = sts.get("status", {})
        ready = int(sts_status.get("readyReplicas", 0))
        want = int(sts["spec"].get("replicas", 1))
        phase = "DEPLOYED" if ready >= want else "DEPLOYING"
        return {"phase": phase, "replicas": want, "readyReplicas": ready}

    def cleanup(self, agent_manifest: dict[str, Any]) -> None:
        agent = AgentCustomResource.from_manifest(agent_manifest)
        delete_agent_and_dependents(self.kube, agent.namespace, agent_manifest)


class Operator:
    """Watch-loop glue: hooks the fake API server's apply events to the
    controllers, so writing an Application CR reconciles everything the way
    the JOSDK operator does on a real cluster."""

    def __init__(self, kube: FakeKubeServer, executor: Optional[JobExecutor] = None) -> None:
        self.kube = kube
        self.app_controller = AppController(kube, executor or InProcessJobExecutor(kube))
        self.agent_controller = AgentController(kube)
        kube.on_apply(self._on_apply)

    def _on_apply(self, manifest: dict[str, Any]) -> None:
        kind = manifest.get("kind")
        try:
            if kind == ApplicationCustomResource.KIND:
                self.app_controller.reconcile(manifest)
            elif kind == AgentCustomResource.KIND:
                self.agent_controller.reconcile(manifest)
        except RecursionError:
            raise
        except Exception:  # noqa: BLE001 — operator keeps reconciling others
            log.exception("reconcile failed for %s", kind)
