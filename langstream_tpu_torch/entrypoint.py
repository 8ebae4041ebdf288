"""Pod entry point — role dispatch for the runtime image (the port's own
copy of ``langstream_tpu/entrypoint.py``, with its roles, env names and
defaults).

Parity: reference ``runtime/Main.java:42-45`` (``agent-runtime |
agent-code-download | deployer-runtime | application-setup``) plus the
control-plane/gateway roles the reference runs as separate Spring apps.

Roles that run standalone here:
- ``agent-runtime``: one physical agent replica driven by the
  RuntimePodConfiguration JSON the deployer wrote into the pod Secret
  (mounted at ``$POD_CONFIGURATION``); serves /metrics + /info on
  ``$HTTP_PORT`` (8080). Its ``tpu-serving`` resource serves on the card and
  raises without CUDA, unless the resource asks for ``device: cpu``.
- ``control-plane``: REST control plane over a disk-backed store
  (``$STORAGE_ROOT``), with the local runtime.
- ``gateway``: the standalone gateway over the control plane's disk store
  (``$STORAGE_ROOT``, ``$GATEWAY_PORT``); a memory-broker app is refused
  with HTTP 400.
- ``run-local``: whole platform in one process (the port's argparse CLI,
  ``run local <args>``).

Real-cluster roles (reference Main.java:42-45 + the JOSDK operator app),
all backed by the stdlib ``k8s/client.py`` API client (kubeconfig /
in-cluster / ``KUBE_API_SERVER`` auth):
- ``operator``: watch-driven, level-based reconcile loop over
  Application/Agent CRs.
- ``deployer-runtime`` / ``application-setup``: the two reconcile-phase
  Jobs, runnable as real cluster Jobs (``APPLICATION_NAME``, ``NAMESPACE``).
- ``agent-code-download``: init-container that unpacks the app archive
  from the control plane into the shared code volume.

A multi-host replica (``LANGSTREAM_TPU_HOSTS`` > 1, ``parallel/multihost.py``)
opens its broker consumer on process 0 only; a follower pod builds the
``tpu-serving`` engine unstarted and replays the leader's dispatches. The
provider joins the replica's process group when it builds its mesh (the
JAX package joins ``jax.distributed`` here, before any backend is touched).
No role installs a SIGTERM handler, as in the JAX package: a stopped pod
exits without closing its runner.

Usage: ``python -m langstream_tpu_torch.entrypoint <role> [args...]``
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import sys
from typing import Any

log = logging.getLogger(__name__)


def build_agent_node(pod: dict[str, Any]):
    """RuntimePodConfiguration ``agent`` section → AgentNode."""
    from langstream_tpu_torch.api.model import ErrorsSpec, ResourcesSpec
    from langstream_tpu_torch.api.planner import AgentNode, Connection

    def conn(section):
        if not section:
            return None
        return Connection.to_topic(section["topic"])

    def build(agent: dict[str, Any]) -> AgentNode:
        return AgentNode(
            id=agent["agentId"],
            agent_type=agent["agentType"],
            component_type=agent.get("componentType", "processor"),
            module_id=agent.get("module", "default"),
            pipeline_id=agent.get("pipeline", "default"),
            configuration=dict(agent.get("configuration", {})),
            resources=ResourcesSpec.from_dict(agent.get("resources")) or ResourcesSpec(),
            errors=ErrorsSpec.from_dict(agent.get("errors")) or ErrorsSpec(),
            input=conn(agent.get("input")),
            output=conn(agent.get("output")),
            disk=bool(agent.get("disk", False)),
            composite=[build(child) for child in agent.get("composite", [])],
        )

    return build(pod["agent"])


def _http_server(pod: dict[str, Any], metrics, agents_info):
    from langstream_tpu_torch.runtime.http_server import RuntimeHttpServer

    return RuntimeHttpServer(
        metrics_text=metrics.prometheus_text,
        agents_info=agents_info,
        host=os.environ.get("HTTP_HOST", "0.0.0.0"),
        port=int(pod.get("httpPort", os.environ.get("HTTP_PORT", "8080"))),
    )


async def _run_follower(pod: dict[str, Any], node, dist) -> None:
    """A follower host: a mesh worker of its replica's process group — it
    must NOT open a broker consumer or any agent machinery ("one logical
    consumer, N pods"). When the agent serves a tpu-serving model, the
    follower builds an IDENTICAL (unstarted) engine and replays the leader's
    device dispatches over the SPMD channel (parallel/spmd_serving.py);
    otherwise it parks serving /metrics."""
    from langstream_tpu_torch.api.metrics import MetricsReporter

    metrics = MetricsReporter()
    serving_resource = next(
        (r for r in (pod.get("resources") or {}).values() if r.get("type") == "tpu-serving"),
        None,
    )
    http = _http_server(pod, metrics, lambda: [
        {"agent-id": node.id, "replica": dist.replica_index,
         "role": "mesh-worker", "process-index": dist.process_index,
         "spmd-serving": serving_resource is not None}
    ])
    http.start()
    log.info("mesh worker up: %s process %d/%d", node.id, dist.process_index,
             dist.num_processes)
    try:
        if serving_resource is not None:
            from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
            from langstream_tpu_torch.parallel.spmd_serving import follower_loop

            holder = TorchCompletionsService(dict(serving_resource.get("configuration", {})))
            engine = await asyncio.to_thread(holder.build_engine, False)
            channel = holder.spmd_channel()
            if channel is None:
                raise RuntimeError("a multi-host follower's engine has no SPMD channel")
            # replay until the leader announces STOP (leader restart
            # restarts this pod via the crash-only StatefulSet policy)
            await asyncio.to_thread(follower_loop, engine, channel)
        else:
            await asyncio.Event().wait()  # crash-only: leader restarts us
    finally:
        http.stop()


async def run_agent_runtime(pod: dict[str, Any]) -> None:
    from pathlib import Path

    from langstream_tpu_torch.ai.provider import ServiceProviderRegistry
    from langstream_tpu_torch.api.metrics import MetricsReporter
    from langstream_tpu_torch.api.model import Application, Resource
    from langstream_tpu_torch.messaging.registry import get_topic_connections_runtime
    from langstream_tpu_torch.parallel.multihost import DistributedConfig
    from langstream_tpu_torch.runtime.runner import AgentRunner, SimpleAgentContext

    dist = DistributedConfig.from_env()
    node = build_agent_node(pod)

    if dist.is_multihost:
        serving_count = sum(
            1 for r in (pod.get("resources") or {}).values() if r.get("type") == "tpu-serving"
        )
        if serving_count > 1:
            # each engine would announce on the one broadcast transport with
            # no shared total order — reject rather than hang the replica
            raise RuntimeError(
                "a multi-host (tpu.hosts > 1) agent supports exactly one "
                f"tpu-serving resource, found {serving_count}"
            )
        if not dist.is_leader:
            await _run_follower(pod, node, dist)
            return

    streaming = pod.get("streamingCluster", {"type": "memory", "configuration": {}})
    topic_runtime = get_topic_connections_runtime(streaming.get("type", "memory"))
    await topic_runtime.init(streaming.get("configuration", {}))

    # resources (AI providers, datasources) declared by the application
    app = Application()
    for rid, resource in (pod.get("resources") or {}).items():
        app.resources[rid] = Resource(
            id=rid,
            name=resource.get("name", rid),
            type=resource["type"],
            configuration=dict(resource.get("configuration", {})),
        )
    # built when the agent asks: a pod that requests no card runs beside a
    # tpu-serving resource it never uses (the JAX package builds them all)
    registry = ServiceProviderRegistry(app, lazy=True)

    metrics = MetricsReporter()
    if dist.is_multihost:
        # the pod's ordinal covers hosts × replicas; the broker-facing
        # replica id is the process GROUP index
        replica = dist.replica_index
    else:
        # StatefulSet pods end in "-<ordinal>"; anything else (docker hex
        # ids, bare hostnames) falls back to replica 0
        try:
            replica = int(
                os.environ.get("REPLICA") or os.environ.get("HOSTNAME", "0").rsplit("-", 1)[-1]
            )
        except ValueError:
            replica = 0
    state_dir = os.environ.get("PERSISTENT_STATE_DIR", "/persistent-state")
    context = SimpleAgentContext(
        global_agent_id=f"{pod.get('applicationId', 'app')}-{node.id}-{replica}",
        tenant=pod.get("tenant", "default"),
        topic_runtime=topic_runtime,
        metrics=metrics,
        state_dir=Path(state_dir) if node.disk else None,
        service_registry=registry,
        on_critical_failure=lambda e: os._exit(1),  # crash-only (reference)
        code_directory=os.environ.get("APP_CODE_DIR"),
    )
    runner = AgentRunner(node, topic_runtime, context, replica)
    await runner.setup()
    await runner.start()

    http = _http_server(pod, metrics, lambda: [runner.info()])
    http.start()
    log.info("agent runtime up: %s", node.id)
    try:
        await runner.run()
    finally:
        http.stop()
        try:
            await runner.close()
        except Exception:  # noqa: BLE001 — shutdown best-effort
            log.exception("agent close failed")


async def run_control_plane() -> None:
    from langstream_tpu_torch.webservice.server import ControlPlaneServer
    from langstream_tpu_torch.webservice.service import make_local_service

    root = os.environ.get("STORAGE_ROOT", "/var/lib/langstream-tpu")
    code_storage = None
    if os.environ.get("CODE_STORAGE"):
        # JSON codeStorage block, e.g. {"type":"s3","configuration":{...}}
        from langstream_tpu_torch.webservice.stores import make_code_storage

        code_storage = make_code_storage(json.loads(os.environ["CODE_STORAGE"]))
    applications, tenants, runtime = make_local_service(root, code_storage)
    server = ControlPlaneServer(
        applications,
        tenants,
        host="0.0.0.0",
        port=int(os.environ.get("CONTROL_PLANE_PORT", "8090")),
        auth_token=os.environ.get("ADMIN_TOKEN") or None,
        archetypes_path=os.environ.get("ARCHETYPES_PATH") or None,
    )
    await server.start()
    log.info("control plane up on %s", server.url)
    try:
        await asyncio.Event().wait()
    finally:
        await runtime.close()
        await server.stop()


async def run_gateway() -> None:
    """Standalone gateway over the control plane's disk store (shared PVC)."""
    from langstream_tpu_torch.gateway.server import GatewayServer, StoreApplicationProvider
    from langstream_tpu_torch.webservice.stores import LocalDiskApplicationStore

    root = os.environ.get("STORAGE_ROOT", "/var/lib/langstream-tpu")
    store = LocalDiskApplicationStore(f"{root}/apps")
    server = GatewayServer(
        StoreApplicationProvider(store),
        host="0.0.0.0",
        port=int(os.environ.get("GATEWAY_PORT", "8091")),
    )
    await server.start()
    log.info("gateway up on %s", server.url)
    try:
        await asyncio.Event().wait()
    finally:
        await server.stop()


def run_operator(stop=None) -> None:
    """WATCH-driven, level-based reconcile loop against a live API server
    (or the HTTP fake). Watcher threads stream Application/Agent CR events
    and wake the reconcile pass immediately; every pass is still a full
    list+reconcile (the JOSDK operator's event loop collapsed to
    level-triggered form, which converges identically because the
    reconcilers are idempotent — AppController.java:92-245 two-phase
    flow). A fallback pass still runs every OPERATOR_POLL_SECONDS even
    with no events: unwatched state (StatefulSet readiness, Secrets)
    only surfaces through the periodic list, so the watch ACCELERATES
    convergence for CR edits without ever slowing anything else.

    OPERATOR_ONCE=true runs a single pass and exits 0 (tests / cron);
    ``stop`` (an optional threading.Event) ends the loop and its watcher
    threads — the in-process test harness's shutdown path."""
    import threading
    import time

    from langstream_tpu_torch.k8s.client import KubeApiClient, KubeWatchExpired
    from langstream_tpu_torch.k8s.controllers import (
        AgentController,
        AppController,
        InProcessJobExecutor,
    )
    from langstream_tpu_torch.k8s.crds import AgentCustomResource, ApplicationCustomResource

    kube = KubeApiClient.from_env()
    namespace = os.environ.get("OPERATOR_NAMESPACE")  # None = cluster-wide
    poll = float(os.environ.get("OPERATOR_POLL_SECONDS", "2"))
    once = os.environ.get("OPERATOR_ONCE") == "true"
    app_controller = AppController(kube, InProcessJobExecutor(kube))
    agent_controller = AgentController(kube)
    log.info("operator up against %s (namespace=%s)", kube.server, namespace or "*")

    dirty = threading.Event()
    dirty.set()  # first pass runs immediately
    stop = stop or threading.Event()

    def _watcher(kind: str) -> None:
        rv = None
        delay = poll
        while not stop.is_set():
            try:
                for _type, _obj in kube.watch(
                    kind, namespace, resource_version=rv, timeout_seconds=30
                ):
                    rv = _obj.get("metadata", {}).get("resourceVersion", rv)
                    dirty.set()
                    if stop.is_set():
                        return
                delay = poll  # clean stream end: reset backoff
            except KubeWatchExpired:
                rv = None  # horizon passed: next watch starts fresh; the
                dirty.set()  # full-list pass re-levels everything missed
            except Exception:  # noqa: BLE001 — reconnect with backoff
                log.warning(
                    "%s watch dropped; reconnecting in %.1fs", kind, delay, exc_info=True
                )
                if stop.wait(delay):
                    return
                delay = min(delay * 2, 60.0)

    if not once:
        for kind in (ApplicationCustomResource.KIND, AgentCustomResource.KIND):
            threading.Thread(
                target=_watcher, args=(kind,), daemon=True, name=f"watch-{kind.lower()}"
            ).start()

    backoff = poll
    while True:
        dirty.clear()  # events landing during the pass re-set it
        try:
            # apps first — their deployer phase writes the Agent CRs the
            # second list picks up, so one pass converges a fresh app
            for manifest in kube.list(ApplicationCustomResource.KIND, namespace):
                try:
                    app_controller.reconcile(manifest)
                except Exception:  # noqa: BLE001 — keep reconciling others
                    log.exception(
                        "application reconcile failed: %s",
                        manifest.get("metadata", {}).get("name"),
                    )
            for manifest in kube.list(AgentCustomResource.KIND, namespace):
                try:
                    agent_controller.reconcile(manifest)
                except Exception:  # noqa: BLE001
                    log.exception(
                        "agent reconcile failed: %s", manifest.get("metadata", {}).get("name")
                    )
            backoff = poll  # healthy pass: reset
        except Exception:  # noqa: BLE001 — API server blip: back off and retry
            log.exception("list from API server failed; retrying in %.1fs", backoff)
            if once:
                raise
            time.sleep(backoff)
            backoff = min(backoff * 2, 60.0)  # exponential, capped
            continue
        if once or stop.is_set():
            return
        # watch events wake us instantly; unwatched state (StatefulSet
        # readiness) still converges at the plain poll cadence
        dirty.wait(timeout=poll)


def _load_application_cr():
    """(kube, ApplicationCustomResource) for the job roles, from
    APPLICATION_NAME + NAMESPACE env (the operator stamps these into the
    Job pod spec; reference RuntimeDeployerConfiguration)."""
    from langstream_tpu_torch.k8s.client import KubeApiClient
    from langstream_tpu_torch.k8s.crds import ApplicationCustomResource

    kube = KubeApiClient.from_env()
    name = os.environ["APPLICATION_NAME"]
    namespace = os.environ.get("NAMESPACE", "default")
    manifest = kube.get(ApplicationCustomResource.KIND, namespace, name)
    if manifest is None:
        raise RuntimeError(f"Application CR {namespace}/{name} not found")
    return kube, ApplicationCustomResource.from_manifest(manifest)


def run_deployer_job() -> None:
    """The deployer Job's work: plan the app, write one Agent CR (+ pod
    config Secret) per physical agent (KubernetesClusterRuntime.deploy:93)."""
    from langstream_tpu_torch.k8s.controllers import InProcessJobExecutor

    kube, app = _load_application_cr()
    InProcessJobExecutor(kube).run_deployer(app)
    log.info("deployer job done for %s", app.name)


def run_setup_job() -> None:
    """The setup Job's work: validate the plan / provision declared assets
    before the deployer runs (AppController phase 1)."""
    from langstream_tpu_torch.k8s.controllers import InProcessJobExecutor

    kube, app = _load_application_cr()
    InProcessJobExecutor(kube).run_setup(app)
    log.info("setup job done for %s", app.name)


def run_code_download() -> None:
    """Init-container role: fetch the application's code archive from the
    control plane and unpack it into the shared volume the agent runtime
    mounts (reference agent-code-download + CodeStorage download path).

    Env: CONTROL_PLANE_URL, TENANT, APPLICATION_ID, TARGET_DIR
    (+ ADMIN_TOKEN when the control plane requires auth)."""
    import io
    import urllib.request
    import zipfile
    from pathlib import Path

    base = os.environ["CONTROL_PLANE_URL"].rstrip("/")
    tenant = os.environ.get("TENANT", "default")
    app_id = os.environ["APPLICATION_ID"]
    target = Path(os.environ.get("TARGET_DIR", "/app-code-download"))
    req = urllib.request.Request(f"{base}/api/applications/{tenant}/{app_id}/code")
    token = os.environ.get("ADMIN_TOKEN")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=60) as resp:
        archive = resp.read()
    target.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(archive)) as zf:
        root = target.resolve()
        for info in zf.infolist():
            # refuse path traversal from a hostile archive (proper ancestor
            # check — a raw str prefix passes sibling dirs like /target-evil)
            dest = (target / info.filename).resolve()
            if not dest.is_relative_to(root):
                raise RuntimeError(f"archive path escapes target: {info.filename}")
        zf.extractall(target)
    log.info("code archive for %s/%s unpacked to %s", tenant, app_id, target)


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    argv = argv if argv is not None else sys.argv[1:]
    role = argv[0] if argv else "agent-runtime"
    if role == "agent-runtime":
        config_path = os.environ.get("POD_CONFIGURATION", "/app-config/pod-configuration")
        with open(config_path) as f:
            pod = json.load(f)
        asyncio.run(run_agent_runtime(pod))
        return 0
    if role == "control-plane":
        asyncio.run(run_control_plane())
        return 0
    if role == "gateway":
        asyncio.run(run_gateway())
        return 0
    if role == "run-local":
        from langstream_tpu_torch.cli.main import main as cli_main

        return cli_main(["run", "local", *argv[1:]])
    if role == "operator":
        run_operator()
        return 0
    if role == "deployer-runtime":
        run_deployer_job()
        return 0
    if role == "application-setup":
        run_setup_job()
        return 0
    if role == "agent-code-download":
        run_code_download()
        return 0
    print(f"unknown role {role!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
