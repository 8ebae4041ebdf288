"""Manifest factories (the port's own copy of
``langstream_tpu/k8s/resources.py``; reference
AgentResourcesFactory.java:91-591, AppResourcesFactory.java).

Every manifest is the JAX package's key for key, except where the port runs
on another card and from another command:

- ``resources.tpu`` (the app YAML key and ``api/model.py``'s ``TpuSpec``
  stay as they are) requests ``nvidia.com/gpu: str(chips // hosts)``, the
  NVIDIA device plugin's resource name, in place of ``google.com/tpu``;
- the node selector is ``cloud.google.com/gke-accelerator:
  nvidia-h100-80gb`` (GKE's public label for the H100) in place of
  ``cloud.google.com/gke-tpu-accelerator``; a ``type`` that already names an
  ``nvidia-…`` accelerator is taken as written, a TPU generation name
  (``v5e`` and so on) maps to the default;
- there is no topology label (``cloud.google.com/gke-tpu-topology``);
- every container's ``command`` is ``["python", "-m",
  "langstream_tpu_torch.entrypoint", <role>]`` (the JAX package writes
  ``["langstream-tpu-runtime", <role>]``, a name nothing installs);
- the default image is ``langstream-tpu-torch/runtime:latest``.

The multi-host pod affinity on ``cloud.google.com/gke-nodepool``, the
``LANGSTREAM_TPU_*`` env and the startup probe are as the JAX package writes
them (``parallel/multihost.py`` reads the same env).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Optional

from langstream_tpu_torch.k8s.crds import AgentCustomResource, ApplicationCustomResource
from langstream_tpu_torch.parallel.multihost import DEFAULT_COORDINATOR_PORT

# GKE's node label value for the card; a TPU generation name maps to it
DEFAULT_ACCELERATOR = "nvidia-h100-80gb"
# the NVIDIA device plugin's resource name
GPU_RESOURCE = "nvidia.com/gpu"


def runtime_command(role: str) -> list[str]:
    """A container's command: the port's entry point with its role."""
    return ["python", "-m", "langstream_tpu_torch.entrypoint", role]


@dataclass
class AgentResourceUnitConfiguration:
    """Per-unit sizing defaults (reference AgentResourceUnitConfiguration:
    cpuPerUnit=0.5, memPerUnit=512MB; max units per reference limits)."""

    cpu_per_unit: float = 0.5
    mem_per_unit_mb: int = 512
    max_units: int = 8
    storage_class: str = "default"
    runtime_image: str = "langstream-tpu-torch/runtime:latest"
    image_pull_policy: str = "IfNotPresent"


class AgentResourcesFactory:
    """AgentCustomResource → StatefulSet + headless Service + config Secret."""

    def __init__(
        self, config: Optional[AgentResourceUnitConfiguration] = None
    ) -> None:
        self.config = config or AgentResourceUnitConfiguration()

    # -- naming --------------------------------------------------------------

    @staticmethod
    def statefulset_name(agent: AgentCustomResource) -> str:
        return agent.name

    @staticmethod
    def labels(agent: AgentCustomResource) -> dict[str, str]:
        return {
            "app": "langstream-tpu-runtime",
            "langstream.tpu/tenant": agent.tenant,
            "langstream.tpu/application": agent.application_id,
            "langstream.tpu/agent": agent.agent_id,
        }

    # -- device scheduling ---------------------------------------------------

    @staticmethod
    def tpu_scheduling(tpu: dict[str, Any]) -> tuple[dict[str, str], dict[str, str]]:
        """(node_selector, container_resources) for the agent's
        ``resources.tpu`` block on this card: ``nvidia.com/gpu`` counts
        each POD's cards — on a multi-host replica (hosts > 1) that is
        chips/hosts per pod, as the JAX package counts TPU chips."""
        kind = str(tpu.get("type", "")).lower()
        accelerator = kind if kind.startswith("nvidia-") else DEFAULT_ACCELERATOR
        chips = int(tpu.get("chips", 1))
        hosts = max(int(tpu.get("hosts", 1)), 1)
        node_selector = {"cloud.google.com/gke-accelerator": accelerator}
        resources = {GPU_RESOURCE: str(chips // hosts)}
        return node_selector, resources

    # -- manifests -----------------------------------------------------------

    def generate_config_secret(
        self, agent: AgentCustomResource, runtime_pod_configuration: dict[str, Any]
    ) -> dict[str, Any]:
        """The agent Secret carrying RuntimePodConfiguration
        (reference AgentResourcesFactory.generateAgentSecret:501-521)."""
        return {
            "apiVersion": "v1",
            "kind": "Secret",
            "metadata": {
                "name": agent.config_secret_ref,
                "namespace": agent.namespace,
                "labels": self.labels(agent),
            },
            "stringData": {
                "pod-configuration": json.dumps(runtime_pod_configuration),
            },
        }

    def generate_headless_service(self, agent: AgentCustomResource) -> dict[str, Any]:
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": agent.name,
                "namespace": agent.namespace,
                "labels": self.labels(agent),
            },
            "spec": {
                "clusterIP": "None",
                # coordinator DNS must resolve BEFORE pods are Ready —
                # followers dial process 0 during the torch.distributed rendezvous,
                # which happens ahead of readiness (JobSet does the same)
                "publishNotReadyAddresses": True,
                "selector": self.labels(agent),
                "ports": [
                    {"name": "http", "port": 8080},  # /metrics + /info
                    {"name": "service", "port": 8000},  # service agents
                    {
                        "name": "coordinator",  # torch.distributed rendezvous
                        "port": DEFAULT_COORDINATOR_PORT,
                    },
                ],
            },
        }

    @staticmethod
    def fleet_consumers(agent: AgentCustomResource) -> int:
        """Broker-consumer replica count for the StatefulSet: spec
        parallelism, unless fleet autoscaling is enabled AND the ops loop
        has written the router's desired-replica hint into
        ``status.fleet.desiredReplicas`` — then the hint wins, clamped to
        the spec's ``min-replicas``/``max-replicas`` bounds so a runaway
        signal can never scale past what the operator budgeted
        (docs/SERVING.md §13).

        ``min-replicas: 0`` is LEGAL (scale-to-zero, §23): the router
        only emits a zero hint when demand has been quiet and every
        replica advertises durable checkpoints, and the drain hook
        hibernates each replica's sessions to the durable volume on the
        way down — so desired=0 is satisfiable without losing a single
        session. A later hint (the round-13 prefetch or any route)
        resurrects the StatefulSet and the replicas rehydrate from
        disk."""
        base = max(1, agent.parallelism)
        auto = agent.autoscale or {}
        if not auto.get("enabled"):
            return base
        hint = (agent.status.get("fleet") or {}).get("desiredReplicas")
        if hint is None:
            return base
        lo = max(0, int(auto.get("min-replicas", 1)))
        hi = max(lo, int(auto.get("max-replicas", max(base, 8))))
        return max(lo, min(int(hint), hi))

    def generate_stateful_set(self, agent: AgentCustomResource) -> dict[str, Any]:
        size = min(agent.size, self.config.max_units)
        cpu = self.config.cpu_per_unit * size
        mem_mb = self.config.mem_per_unit_mb * size
        resources: dict[str, Any] = {
            "requests": {"cpu": str(cpu), "memory": f"{mem_mb}M"},
            "limits": {"memory": f"{mem_mb}M"},
        }
        node_selector: dict[str, str] = {}
        if agent.tpu:
            node_selector, tpu_resources = self.tpu_scheduling(agent.tpu)
            resources["limits"] = {**resources["limits"], **tpu_resources}
            resources["requests"] = {**resources["requests"], **tpu_resources}

        volumes = [
            {"name": "app-code", "emptyDir": {}},
            {
                "name": "pod-config",
                "secret": {"secretName": agent.config_secret_ref},
            },
        ]
        volume_mounts = [
            {"name": "app-code", "mountPath": "/app-code-download"},
            {"name": "pod-config", "mountPath": "/app-config", "readOnly": True},
        ]
        init_containers = [
            {
                # reference init container pair: code-download-init writes the
                # downloader config, code-download pulls the archive
                "name": "code-download",
                "image": self.config.runtime_image,
                "imagePullPolicy": self.config.image_pull_policy,
                "command": runtime_command("agent-code-download"),
                "env": [
                    {"name": "CODE_ARCHIVE_ID", "value": agent.code_archive_id or ""},
                    {"name": "TENANT", "value": agent.tenant},
                    {"name": "APPLICATION_ID", "value": agent.application_id},
                ],
                "volumeMounts": list(volume_mounts),
            }
        ]
        hosts = max(int((agent.tpu or {}).get("hosts", 1)), 1)
        env = [
            {"name": "POD_CONFIGURATION", "value": "/app-config/pod-configuration"},
            {"name": "AGENT_ID", "value": agent.agent_id},
        ]
        if hosts > 1:
            # multi-host replica topology (parallel/multihost.py contract):
            # the entrypoint derives process_index + coordinator DNS from
            # the pod ordinal, the pods-per-replica count, and the headless
            # service that fronts this StatefulSet
            env += [
                {"name": "LANGSTREAM_TPU_HOSTS", "value": str(hosts)},
                {"name": "LANGSTREAM_TPU_SERVICE", "value": agent.name},
                {
                    "name": "LANGSTREAM_TPU_COORDINATOR_PORT",
                    "value": str(DEFAULT_COORDINATOR_PORT),
                },
                {
                    "name": "POD_NAME",
                    "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
                },
            ]
        container = {
            "name": "runtime",
            "image": self.config.runtime_image,
            "imagePullPolicy": self.config.image_pull_policy,
            "command": runtime_command("agent-runtime"),
            "env": env,
            "ports": [{"containerPort": 8080, "name": "http"}],
            "resources": resources,
            "volumeMounts": list(volume_mounts),
            "livenessProbe": {
                "httpGet": {"path": "/info", "port": 8080},
                "initialDelaySeconds": 10,
                "periodSeconds": 30,
            },
        }
        if hosts > 1:
            # group formation blocks in init_process_group (no HTTP
            # listener yet) until every peer's node exists — without a
            # startup probe the liveness probe would kill pods ~100s in and
            # the group could thrash forever while nodes provision
            container["startupProbe"] = {
                "httpGet": {"path": "/info", "port": 8080},
                "periodSeconds": 10,
                "failureThreshold": 60,  # up to 10 min of slice provisioning
            }
        pod_spec: dict[str, Any] = {
            "serviceAccountName": f"langstream-agent-{agent.tenant}",
            "terminationGracePeriodSeconds": 60,
            "initContainers": init_containers,
            "containers": [container],
            "volumes": volumes,
            # spread replicas across nodes (reference :591 anti-affinity)
            "affinity": {
                "podAntiAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "weight": 100,
                            "podAffinityTerm": {
                                "labelSelector": {"matchLabels": self.labels(agent)},
                                "topologyKey": "kubernetes.io/hostname",
                            },
                        }
                    ]
                }
            },
        }
        if node_selector:
            pod_spec["nodeSelector"] = node_selector
        if hosts > 1:
            # all pods of the (single — planner enforces parallelism=1)
            # process group MUST land on one node pool, so required
            # self-affinity on the node-pool topology key pins the group
            # together
            pod_spec["affinity"]["podAffinity"] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {
                        "labelSelector": {"matchLabels": self.labels(agent)},
                        "topologyKey": "cloud.google.com/gke-nodepool",
                    }
                ]
            }

        manifest: dict[str, Any] = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": self.statefulset_name(agent),
                "namespace": agent.namespace,
                "labels": self.labels(agent),
                "annotations": {
                    # rollout trigger: a changed config checksum restarts pods
                    # (reference configSecretRefChecksum semantics)
                    "langstream.tpu/config-checksum": agent.config_checksum,
                },
            },
            "spec": {
                # replicas = consumers × hosts (diverges from reference
                # :295,:526-556 by design): consumers multiply broker
                # consumers; hosts are the pods of ONE consumer's multi-host
                # process group (pods o..o+hosts-1 form replica o//hosts).
                # Consumers default to spec parallelism; with autoscale
                # enabled the fleet router's queue-wait-EMA hint
                # (status.fleet.desiredReplicas) overrides it within the
                # spec's min/max bounds (serving/fleet.py desired_replicas)
                "replicas": self.fleet_consumers(agent) * hosts,
                "podManagementPolicy": "Parallel",
                "serviceName": agent.name,
                "selector": {"matchLabels": self.labels(agent)},
                "template": {
                    "metadata": {
                        "labels": self.labels(agent),
                        "annotations": {
                            "langstream.tpu/config-checksum": agent.config_checksum,
                        },
                    },
                    "spec": pod_spec,
                },
            },
        }
        if agent.disk and agent.disk.get("enabled"):
            manifest["spec"]["volumeClaimTemplates"] = [
                {
                    "metadata": {"name": "state"},
                    "spec": {
                        "accessModes": ["ReadWriteOnce"],
                        "storageClassName": (
                            None
                            if agent.disk.get("type", "default") == "default"
                            else agent.disk.get("type")
                        ),
                        "resources": {
                            "requests": {"storage": agent.disk.get("size", "256M")}
                        },
                    },
                }
            ]
            container["volumeMounts"] = container["volumeMounts"] + [
                {"name": "state", "mountPath": "/persistent-state"}
            ]
        return manifest

    @staticmethod
    def aggregate_agents_status(
        agent_manifests: list[dict[str, Any]]
    ) -> dict[str, Any]:
        """Roll per-agent statuses up to the application
        (reference aggregateAgentsStatus:628)."""
        agents = {}
        worst = "DEPLOYED"
        for m in agent_manifests:
            status = m.get("status", {})
            phase = status.get("phase", "UNKNOWN")
            agents[m.get("spec", {}).get("agentId", m["metadata"]["name"])] = status
            if phase in ("ERROR",):
                worst = "ERROR"
            elif phase in ("DEPLOYING", "UNKNOWN") and worst != "ERROR":
                worst = "DEPLOYING"
        return {"phase": worst, "agents": agents}


class FleetAutoscaleReconciler:
    """The in-cluster ops loop for the fleet autoscale hint (ROADMAP 3c).

    ``fleet_consumers`` above already lets ``status.fleet.desiredReplicas``
    drive the StatefulSet's replica count — but until now NOTHING computed
    that field in-cluster: the router's ``desired_replicas()`` hint
    (serving/fleet.py — queue-wait-EMA scale-out capped at 4×/step,
    conservative scale-in) lived and died inside the serving process. This
    reconciler closes the loop: it reads the hint from ``desired_fn`` (the
    router's bound method, or any callable returning an int) and patches it
    into the Agent CR's status, where the AgentController's next reconcile
    turns it into pods.

    Design points:
    - Status-only writes (``patch_status``): a scale decision never touches
      the spec checksum, so scaling is "more pods", never a rollout.
    - No-op patches are SKIPPED: an unconditional patch bumps
      resourceVersion and emits a MODIFIED watch event every interval —
      the self-triggered reconcile storm ``_patch_status_if_changed``
      (k8s/controllers.py) exists to prevent.
    - Autoscale gating stays in ``fleet_consumers``: the reconciler writes
      the hint unconditionally (it is pure status), and the STS generation
      ignores it unless ``resources.autoscale.enabled`` — so flipping
      autoscale on/off needs no reconciler restart.
    - Crash-tolerant: a failed read/patch logs and retries next tick; the
      hint is advisory, so staleness degrades to "no scaling", never to a
      wrong spec.
    - Scale-to-zero passes through untouched (§23): a zero hint is only
      emitted by the router when the fleet is quiet AND fully durable
      (every replica hibernates its sessions to disk on drain), and
      ``fleet_consumers`` only honors it under ``min-replicas: 0`` — the
      reconciler itself never second-guesses either side.

    Works against any client with ``get(kind, ns, name)`` +
    ``patch_status(kind, ns, name, status)`` — the in-cluster HTTPS client
    (k8s/client.py) and the fake server (tests) share that surface."""

    def __init__(
        self,
        kube: Any,
        desired_fn: Any,  # Callable[[], int]
        namespace: str,
        name: str,
        kind: str = AgentCustomResource.KIND,
        interval_s: float = 15.0,
        desired_roles_fn: Any = None,  # Callable[[], dict[str, int]] | None
    ) -> None:
        import threading

        self.kube = kube
        self.desired_fn = desired_fn
        # disaggregated fleets (docs/SERVING.md §18): the per-role split
        # (router.desired_replicas_by_role — prefill pool on queue-wait
        # EMA, decode pool on occupancy/load) round-trips through
        # ``status.fleet.desiredReplicasByRole`` alongside the scalar
        # hint, so role-partitioned StatefulSets can each read their own
        # count. Empty dict / None = homogeneous fleet, field omitted.
        self.desired_roles_fn = desired_roles_fn
        self.namespace = namespace
        self.name = name
        self.kind = kind
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[Any] = None
        self.patches_total = 0
        self.skipped_total = 0

    def reconcile_once(self) -> Optional[int]:
        """One tick: read the hint, patch ``status.fleet.desiredReplicas``
        if it moved. Returns the hint written, or None when nothing was
        patched (CR missing, API unreachable, hint unavailable, or
        already current). Every external call is caught — the loop thread
        must survive any transient failure to the next tick."""
        import logging

        log = logging.getLogger(__name__)
        try:
            desired = int(self.desired_fn())
        except Exception:  # noqa: BLE001 — advisory signal; retry next tick
            log.exception("fleet autoscale hint unavailable")
            return None
        try:
            manifest = self.kube.get(self.kind, self.namespace, self.name)
        except Exception:  # noqa: BLE001 — API blip; retry next tick
            log.exception("autoscale CR read failed")
            return None
        if manifest is None:
            log.debug(
                "agent %s/%s not found; autoscale hint %d not written",
                self.namespace, self.name, desired,
            )
            return None
        by_role: Optional[dict] = None
        if self.desired_roles_fn is not None:
            try:
                raw = self.desired_roles_fn() or {}
                by_role = {str(k): int(v) for k, v in raw.items()} or None
            except Exception:  # noqa: BLE001 — advisory; scalar hint stands
                log.exception("fleet role-split hint unavailable")
        fleet = dict((manifest.get("status") or {}).get("fleet") or {})
        if (
            fleet.get("desiredReplicas") == desired
            and fleet.get("desiredReplicasByRole") == by_role
        ):
            self.skipped_total += 1
            return None
        fleet["desiredReplicas"] = desired
        if by_role is not None:
            fleet["desiredReplicasByRole"] = by_role
        elif self.desired_roles_fn is not None:
            # the fleet stopped advertising roles: retire the stale split
            fleet.pop("desiredReplicasByRole", None)
        try:
            # patch ONLY the fleet subtree: the real client's merge-patch
            # then cannot clobber status fields another controller wrote
            # between our read and this write (the AgentController owns
            # phase/agents and rewrites them every reconcile anyway)
            self.kube.patch_status(
                self.kind, self.namespace, self.name, {"fleet": fleet}
            )
        except Exception:  # noqa: BLE001 — transient API failure; next tick
            log.exception("autoscale status patch failed")
            return None
        self.patches_total += 1
        log.info(
            "fleet autoscale: %s/%s status.fleet.desiredReplicas ← %d",
            self.namespace, self.name, desired,
        )
        return desired

    def start(self) -> None:
        import threading

        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-autoscale", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.reconcile_once()


class AppResourcesFactory:
    """Application CR → setup Job + deployer Job + RBAC
    (reference AppResourcesFactory.java:590)."""

    def __init__(
        self, config: Optional[AgentResourceUnitConfiguration] = None
    ) -> None:
        self.config = config or AgentResourceUnitConfiguration()

    @staticmethod
    def job_name_for(application_id: str, phase: str) -> str:
        return f"langstream-runtime-{phase}-{application_id}"

    @classmethod
    def job_name(cls, app: ApplicationCustomResource, phase: str) -> str:
        return cls.job_name_for(app.name, phase)

    def _job(
        self, app: ApplicationCustomResource, phase: str, command: str
    ) -> dict[str, Any]:
        return {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {
                "name": self.job_name(app, phase),
                "namespace": app.namespace,
                "labels": {
                    "app": "langstream-tpu",
                    "langstream.tpu/application": app.name,
                    "langstream.tpu/phase": phase,
                },
                "annotations": {
                    "langstream.tpu/application-generation": str(app.generation),
                },
            },
            "spec": {
                "backoffLimit": 6,
                "template": {
                    "metadata": {"labels": {"langstream.tpu/application": app.name}},
                    "spec": {
                        "serviceAccountName": f"langstream-deployer-{app.tenant}",
                        "restartPolicy": "OnFailure",
                        "containers": [
                            {
                                "name": phase,
                                "image": self.config.runtime_image,
                                "imagePullPolicy": self.config.image_pull_policy,
                                "command": runtime_command(command),
                                "env": [
                                    {"name": "APPLICATION_ID", "value": app.name},
                                    {"name": "TENANT", "value": app.tenant},
                                ],
                            }
                        ],
                    },
                },
            },
        }

    def generate_setup_job(self, app: ApplicationCustomResource) -> dict[str, Any]:
        """Asset-provisioning job (reference Main application-setup)."""
        return self._job(app, "setup", "application-setup")

    def generate_deployer_job(self, app: ApplicationCustomResource) -> dict[str, Any]:
        """Planner job writing Agent CRs (reference Main deployer-runtime)."""
        return self._job(app, "deployer", "deployer-runtime")

    def generate_rbac(self, tenant: str, namespace: str) -> list[dict[str, Any]]:
        service_account = {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": f"langstream-deployer-{tenant}", "namespace": namespace},
        }
        role = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "Role",
            "metadata": {"name": f"langstream-deployer-{tenant}", "namespace": namespace},
            "rules": [
                {
                    "apiGroups": ["langstream.tpu"],
                    "resources": ["agents", "applications"],
                    "verbs": ["*"],
                },
                {"apiGroups": [""], "resources": ["secrets"], "verbs": ["*"]},
            ],
        }
        binding = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {"name": f"langstream-deployer-{tenant}", "namespace": namespace},
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": f"langstream-deployer-{tenant}",
                    "namespace": namespace,
                }
            ],
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "Role",
                "name": f"langstream-deployer-{tenant}",
            },
        }
        return [service_account, role, binding]
