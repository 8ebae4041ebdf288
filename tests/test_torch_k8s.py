"""The port's Kubernetes layer (``langstream_tpu_torch/k8s/``) against the
JAX package's (``tests/test_k8s.py``, the k8s cases of ``test_fleet.py``,
``test_durable.py``, ``test_migration.py``, ``test_multihost.py`` and
``test_tenancy.py``), case for case: for the same application both
packages' operators on their own fakes write the same CRs, Secrets,
Services, StatefulSets and Jobs in the same order — equal key for key once
the device keys, command and image that ``k8s/resources.py`` lists are made
neutral — and the same pod-configuration JSON, byte for byte."""

import asyncio
import copy
import dataclasses
import importlib
import json
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _pkg(name: str) -> types.SimpleNamespace:
    mods = {m: importlib.import_module(f"{name}.k8s.{m}")
            for m in ("crds", "differ", "fake", "resources", "controllers")}
    return types.SimpleNamespace(name=name, **mods)


JAX = _pkg("langstream_tpu")
PORT = _pkg("langstream_tpu_torch")
PACKAGES = [JAX, PORT]

PIPELINE = """
module: default
id: p
name: chat
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: chat
    type: ai-chat-completions
    input: input-topic
    output: output-topic
    resources:
      parallelism: 2
      size: 2
      tpu:
        type: v5e
        topology: "8"
        mesh:
          model: 8
    configuration:
      model: llama-3-8b
      completion-field: value.answer
      messages:
        - role: user
          content: "{{ value }}"
"""

INSTANCE = """
instance:
  streamingCluster:
    type: memory
  computeCluster:
    type: kubernetes
"""

COMPUTE = """
module: default
id: p
name: echo
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: upper
    type: compute
    input: input-topic
    output: output-topic
    resources:
      parallelism: 3
      disk:
        enabled: true
        size: 1G
    configuration:
      fields:
        - name: value
          expression: "fn:uppercase(value)"
"""

MULTIHOST = PIPELINE.replace(
    '        topology: "8"\n', '        topology: v5e-16\n        hosts: 4\n'
).replace("      parallelism: 2\n", "      parallelism: 1\n").replace(
    "          model: 8\n", "          model: 16\n")


def _completions_files() -> dict:
    """tpu-completions with a one-card ``resources.tpu`` on its chat step."""
    app = ROOT / "examples" / "applications" / "tpu-completions"
    files = {p.name: p.read_text() for p in app.glob("*.yaml")}
    step = "  - name: chat\n    type: ai-chat-completions\n"
    assert step in files["pipeline.yaml"]
    files["pipeline.yaml"] = files["pipeline.yaml"].replace(
        step, step + '    resources:\n      tpu:\n        topology: "1"\n')
    return files


APPS = {
    "chat-tpu-8": ({"pipeline.yaml": PIPELINE}, INSTANCE),
    "compute-disk": ({"pipeline.yaml": COMPUTE}, INSTANCE),
    "multihost": ({"pipeline.yaml": MULTIHOST}, INSTANCE),
    "tpu-completions-kafka": (
        _completions_files(),
        (ROOT / "examples" / "instances" / "kubernetes.yaml").read_text(),
    ),
}

# the keys k8s/resources.py maps onto the card, and the JAX package's
DEVICE_RESOURCES = ("google.com/tpu", "nvidia.com/gpu")
SELECTORS = ("cloud.google.com/gke-tpu-accelerator", "cloud.google.com/gke-tpu-topology",
             "cloud.google.com/gke-accelerator")


def neutral(manifest: dict) -> dict:
    """A manifest with the package-specific values made neutral: each
    container's command reduced to its role, its image dropped, the device
    count under one key, the accelerator selector reduced to its presence."""
    m = copy.deepcopy(manifest)
    pod = (m.get("spec", {}).get("template") or {}).get("spec")
    if pod is None:
        return m
    for c in pod.get("containers", []) + pod.get("initContainers", []):
        c["command"] = c["command"][-1]
        c.pop("image")
        for section in c.get("resources", {}).values():
            for key in DEVICE_RESOURCES:
                if key in section:
                    section["device"] = section.pop(key)
    selector = pod.get("nodeSelector")
    if selector is not None:
        found = [selector.pop(k) for k in SELECTORS if k in selector]
        selector["accelerator"] = bool(found)
    return m


KINDS = ("Application", "Agent", "Secret", "Service", "StatefulSet", "Job")


def snapshot(kube) -> dict:
    return {kind: [neutral(m) for m in kube.list(kind)] for kind in KINDS}


def events(kube) -> list:
    return [(t, o["kind"], o["metadata"].get("namespace"), o["metadata"]["name"])
            for _, t, o in kube._events]


def app_cr(pkg, name="app1", app="chat-tpu-8", generation=1):
    files, instance = APPS[app]
    return pkg.crds.ApplicationCustomResource(
        name=name, namespace="langstream-default", tenant="default",
        package_files=dict(files), instance_text=instance, generation=generation)


def agent_cr(pkg, **overrides):
    defaults = dict(
        name="app1-chat", namespace="langstream-default", tenant="default", agent_id="chat",
        application_id="app1", agent_type="ai-chat-completions", component_type="processor",
        config_secret_ref="app1-chat-config",
        config_checksum=pkg.crds.config_checksum({"model": "llama"}), parallelism=2, size=2,
        tpu={"type": "v5e", "topology": "8", "chips": 8, "mesh": {"model": 8}},
    )
    defaults.update(overrides)
    return pkg.crds.AgentCustomResource(**defaults)


def operate(pkg, app: str) -> "object":
    kube = pkg.fake.FakeKubeServer()
    pkg.controllers.Operator(kube)
    kube.apply(app_cr(pkg, app=app).to_manifest())
    return kube


# -- manifests and the device mapping ----------------------------------------


def test_statefulset_device_scheduling():
    sts = PORT.resources.AgentResourcesFactory().generate_stateful_set(agent_cr(PORT))
    spec = sts["spec"]
    assert spec["replicas"] == 2
    pod = spec["template"]["spec"]
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    container = pod["containers"][0]
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "8"
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "8"
    assert container["resources"]["requests"]["cpu"] == "1.0"
    assert container["resources"]["requests"]["memory"] == "1024M"
    assert container["command"] == ["python", "-m", "langstream_tpu_torch.entrypoint",
                                    "agent-runtime"]
    assert pod["initContainers"][0]["command"][-1] == "agent-code-download"
    assert container["image"] == "langstream-tpu-torch/runtime:latest"
    assert "podAntiAffinity" in pod["affinity"]
    assert sts["metadata"]["annotations"]["langstream.tpu/config-checksum"] == \
        agent_cr(PORT).config_checksum


@pytest.mark.parametrize("tpu,selector,count", [
    ({"type": "v5e", "topology": "8", "chips": 8}, "nvidia-h100-80gb", "8"),
    ({"type": "v5p", "topology": "v5p-2x2", "chips": 4}, "nvidia-h100-80gb", "4"),
    ({"type": "nvidia-h100-mega-80gb", "chips": 1}, "nvidia-h100-mega-80gb", "1"),
    ({"type": "v5e", "topology": "4x4", "chips": 16, "hosts": 4}, "nvidia-h100-80gb", "4"),
    ({}, "nvidia-h100-80gb", "1"),
])
def test_device_scheduling(tpu, selector, count):
    """A TPU generation maps to the H100's label, an ``nvidia-…`` type is
    taken as written, no topology label; each pod counts chips / hosts, as
    the JAX package counts its chips."""
    sel, res = PORT.resources.AgentResourcesFactory.tpu_scheduling(tpu)
    assert sel == {"cloud.google.com/gke-accelerator": selector}
    assert res == {"nvidia.com/gpu": count}
    _, jax_res = JAX.resources.AgentResourcesFactory.tpu_scheduling(
        {"type": "v5e", **{k: v for k, v in tpu.items() if k != "type"}})
    assert jax_res == {"google.com/tpu": count}


@pytest.mark.parametrize("overrides", [
    {},
    {"disk": {"enabled": True, "size": "1G", "type": "default"}, "tpu": None},
    {"disk": {"enabled": True, "size": "2G", "type": "fast-ssd"}},
    {"tpu": {"type": "v5e", "topology": "4x4", "chips": 16, "hosts": 4, "mesh": {"model": 16}},
     "parallelism": 1},
    {"autoscale": {"enabled": True, "min-replicas": 1, "max-replicas": 4},
     "status": {"fleet": {"desiredReplicas": 3}}},
])
def test_manifests_match_jax(overrides):
    """Secret, headless Service and StatefulSet equal to the JAX package's
    but for the listed device keys, command and image."""
    jax_agent, port_agent = agent_cr(JAX, **overrides), agent_cr(PORT, **overrides)
    jf, pf = JAX.resources.AgentResourcesFactory(), PORT.resources.AgentResourcesFactory()
    assert pf.generate_headless_service(port_agent) == jf.generate_headless_service(jax_agent)
    pod = {"agentId": "chat"}
    assert pf.generate_config_secret(port_agent, pod) == jf.generate_config_secret(jax_agent, pod)
    assert neutral(pf.generate_stateful_set(port_agent)) == \
        neutral(jf.generate_stateful_set(jax_agent))
    jax_cr = JAX.crds.ApplicationCustomResource("a", "ns", "t")
    port_cr = PORT.crds.ApplicationCustomResource("a", "ns", "t")
    jaf, paf = JAX.resources.AppResourcesFactory(), PORT.resources.AppResourcesFactory()
    for phase in ("generate_setup_job", "generate_deployer_job"):
        assert neutral(getattr(paf, phase)(port_cr)) == neutral(getattr(jaf, phase)(jax_cr))
    assert paf.generate_rbac("t", "ns") == jaf.generate_rbac("t", "ns")


def test_statefulset_disk_pvc():
    sts = PORT.resources.AgentResourcesFactory().generate_stateful_set(
        agent_cr(PORT, disk={"enabled": True, "size": "1G", "type": "default"}, tpu=None))
    pvc = sts["spec"]["volumeClaimTemplates"][0]
    assert pvc["spec"]["resources"]["requests"]["storage"] == "1G"
    mounts = sts["spec"]["template"]["spec"]["containers"][0]["volumeMounts"]
    assert any(m["mountPath"] == "/persistent-state" for m in mounts)
    assert "nodeSelector" not in sts["spec"]["template"]["spec"]


def test_statefulset_multihost_topology():
    from langstream_tpu_torch.parallel.multihost import DEFAULT_COORDINATOR_PORT

    agent = agent_cr(PORT, parallelism=1, tpu={"type": "v5e", "topology": "4x4", "chips": 16,
                                               "hosts": 4, "mesh": {"model": 16}})
    factory = PORT.resources.AgentResourcesFactory()
    sts = factory.generate_stateful_set(agent)
    assert sts["spec"]["replicas"] == 4
    container = sts["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e for e in container["env"]}
    assert env["LANGSTREAM_TPU_HOSTS"]["value"] == "4"
    assert env["LANGSTREAM_TPU_SERVICE"]["value"] == "app1-chat"
    assert env["LANGSTREAM_TPU_COORDINATOR_PORT"]["value"] == str(DEFAULT_COORDINATOR_PORT)
    assert env["POD_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.name"
    affinity = sts["spec"]["template"]["spec"]["affinity"]["podAffinity"]
    required = affinity["requiredDuringSchedulingIgnoredDuringExecution"][0]
    assert required["topologyKey"] == "cloud.google.com/gke-nodepool"
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "4"
    assert "startupProbe" in container
    ports = {p["name"]: p["port"] for p in factory.generate_headless_service(agent)["spec"]["ports"]}
    assert ports["coordinator"] == 8476
    single = dataclasses.replace(agent, parallelism=2, tpu={"type": "v5e", "chips": 8})
    sts1 = factory.generate_stateful_set(single)
    assert sts1["spec"]["replicas"] == 2
    env1 = {e["name"] for e in sts1["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert "LANGSTREAM_TPU_HOSTS" not in env1
    assert "podAffinity" not in sts1["spec"]["template"]["spec"]["affinity"]


# -- checksums and the differ --------------------------------------------------


@pytest.mark.parametrize("config", [
    {}, {"model": "llama"}, {"b": 1, "a": [1, 2, {"z": None}]},
    {"messages": [{"role": "user", "content": "{{ value }} — ünïcode"}], "n": 1.5},
    {"when": Path("/x"), "nested": {"k": (1, 2)}},
])
def test_config_checksum_matches_jax(config):
    assert PORT.crds.config_checksum(config) == JAX.crds.config_checksum(config)


def _differ_pairs():
    jf = JAX.resources.AgentResourcesFactory()
    a = jf.generate_stateful_set(agent_cr(JAX))
    b = copy.deepcopy(a)
    b["metadata"]["resourceVersion"] = "42"
    b["status"] = {"readyReplicas": 1}
    c = jf.generate_stateful_set(agent_cr(JAX, parallelism=3))
    d = jf.generate_stateful_set(agent_cr(JAX, disk={"enabled": True, "size": "1G"}))
    e = copy.deepcopy(a)
    e["spec"]["template"]["spec"]["containers"].append({"name": "x"})
    return [(a, b), (a, c), (a, d), (a, e), ({}, {"spec": {"x": [1]}})]


@pytest.mark.parametrize("i", range(5))
def test_differ_matches_jax(i):
    a, b = _differ_pairs()[i]
    assert PORT.differ.specs_equal(a, b) == JAX.differ.specs_equal(a, b)
    assert PORT.differ.diff_paths(a, b) == JAX.differ.diff_paths(a, b)
    assert PORT.differ.diff_paths(a, b, prefix="root") == JAX.differ.diff_paths(a, b, "root")
    if i == 0:
        assert PORT.differ.specs_equal(a, b)
    if i == 1:
        assert any("replicas" in p for p in PORT.differ.diff_paths(a, b))


# -- reconcile flows, both packages ---------------------------------------------


@pytest.mark.parametrize("app", sorted(APPS))
def test_operator_matches_jax(app):
    """One Application CR through each package's operator on its own fake:
    the same objects (neutral), the same watch events in the same order,
    and the pod configuration byte for byte."""
    kubes = [operate(pkg, app) for pkg in PACKAGES]
    jax_kube, port_kube = kubes
    assert snapshot(port_kube) == snapshot(jax_kube)
    assert events(port_kube) == events(jax_kube)
    secrets = [[s["stringData"] for s in k.list("Secret")] for k in kubes]
    assert secrets[0] == secrets[1] and secrets[0]
    for pod in secrets[1]:
        json.loads(pod["pod-configuration"])
    stored = port_kube.get("Application", "langstream-default", "app1")
    assert stored["status"]["phase"] == "DEPLOYED"
    for sts in port_kube.list("StatefulSet"):
        agent = port_kube.get("Agent", "langstream-default", sts["metadata"]["name"])
        tpu = agent["spec"]["resources"]["tpu"]
        pod = sts["spec"]["template"]["spec"]
        limits = pod["containers"][0]["resources"]["limits"]
        if tpu:
            assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator":
                                           "nvidia-h100-80gb"}
            assert limits["nvidia.com/gpu"] == str(tpu["chips"] // tpu.get("hosts", 1))
        else:
            assert "nodeSelector" not in pod and "nvidia.com/gpu" not in limits


def test_tpu_completions_chat_requests_one_card():
    kube = operate(PORT, "tpu-completions-kafka")
    name = "app1-completions-ai-chat-completions-1"
    sts = kube.get("StatefulSet", "langstream-default", name)
    container = sts["spec"]["template"]["spec"]["containers"][0]
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "1"
    pod = json.loads(kube.get("Secret", "langstream-default", f"{name}-config")
                     ["stringData"]["pod-configuration"])
    assert pod["streamingCluster"]["type"] == "kafka"
    assert pod["resources"]["tpu"]["type"] == "tpu-serving"
    assert pod["resources"]["tpu"]["configuration"]["model"] == "llama-3-8b"
    assert pod["agent"]["agentType"] == "ai-chat-completions"


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
def test_app_controller_two_phase_and_agent_crs(pkg):
    kube = pkg.fake.FakeKubeServer()
    controller = pkg.controllers.AppController(kube, pkg.controllers.InProcessJobExecutor(kube))
    app = app_cr(pkg)
    kube.apply(app.to_manifest())
    status = controller.reconcile(app.to_manifest())
    assert status["phase"] == "DEPLOYED"
    assert kube.get("Job", app.namespace, "langstream-runtime-setup-app1") is not None
    assert kube.get("Job", app.namespace, "langstream-runtime-deployer-app1") is not None
    agents = kube.list(pkg.crds.AgentCustomResource.KIND, app.namespace)
    assert len(agents) == 1
    spec = agents[0]["spec"]
    assert spec["agentType"] == "ai-chat-completions"
    assert spec["resources"]["parallelism"] == 2
    assert spec["resources"]["tpu"]["chips"] == 8
    assert spec["resources"]["tpu"]["mesh"] == {"model": 8}


def test_app_controller_error_status_matches_jax():
    out = []
    for pkg in PACKAGES:
        kube = pkg.fake.FakeKubeServer()
        controller = pkg.controllers.AppController(kube, pkg.controllers.InProcessJobExecutor(kube))
        app = app_cr(pkg)
        app.package_files = {"pipeline.yaml": "pipeline:\n  - type: does-not-exist\n"}
        kube.apply(app.to_manifest())
        status = controller.reconcile(app.to_manifest())
        assert kube.get("Application", app.namespace, app.name)["status"] == status
        # the reason lists the agent types each package's registry holds
        # in this process (other tests register more): compare its head
        out.append({**status, "reason": status["reason"].split("; known:")[0]})
    assert out[1] == out[0]
    assert out[1] == {"phase": "ERROR_SETUP", "reason": "unknown agent type 'does-not-exist'"}


def _rollout(pkg) -> tuple[list, list]:
    """The agent controller's reconcile, a no-op reconcile, a config change
    (checksum rollout) and readiness: the StatefulSet's resourceVersion and
    the agent's status after each step."""
    kube = pkg.fake.FakeKubeServer()
    controller = pkg.controllers.AgentController(kube)
    agent = agent_cr(pkg)
    seen = []

    def step(manifest):
        status = controller.reconcile(manifest)
        sts = kube.get("StatefulSet", agent.namespace, agent.name)
        seen.append((status, sts["metadata"]["resourceVersion"],
                     sts["metadata"]["annotations"]["langstream.tpu/config-checksum"]))

    step(agent.to_manifest())
    step(agent.to_manifest())
    changed = agent_cr(pkg, config_checksum=pkg.crds.config_checksum({"model": "other"}))
    step(changed.to_manifest())
    kube.patch_status("StatefulSet", agent.namespace, agent.name, {"readyReplicas": 2})
    step(changed.to_manifest())
    return seen, events(kube)


def test_agent_controller_rollout_matches_jax():
    (port, port_events), (jax, jax_events) = _rollout(PORT), _rollout(JAX)
    assert port == jax and port_events == jax_events
    assert port[0][0]["phase"] == "DEPLOYING"
    assert port[1][1] == port[0][1]  # unchanged spec: no rewrite
    assert port[2][1] != port[1][1] and port[2][2] != port[1][2]  # checksum rollout
    assert port[3][0]["phase"] == "DEPLOYED"


def _update_and_delete(pkg) -> list:
    kube = pkg.fake.FakeKubeServer()
    operator = pkg.controllers.Operator(kube)
    kube.apply(app_cr(pkg).to_manifest())
    app2 = app_cr(pkg, generation=2)
    app2.package_files = {
        "pipeline.yaml": PIPELINE.replace("type: ai-chat-completions", "type: identity")}
    kube.apply(app2.to_manifest())
    after_update = snapshot(kube)
    mark = len(kube._events)
    operator.app_controller.cleanup(app2.to_manifest())
    return [after_update, events(kube)[mark:], snapshot(kube)]


def test_update_prune_and_inverse_order_delete_match_jax():
    port, jax = _update_and_delete(PORT), _update_and_delete(JAX)
    assert port == jax
    after_update, deleted, final = port
    agents = after_update["Agent"]
    assert len(agents) == 1 and agents[0]["spec"]["agentType"] == "identity"
    assert [s["metadata"]["name"] for s in after_update["StatefulSet"]] == \
        [agents[0]["metadata"]["name"]]
    # the agents and their dependents, then the jobs (deployer before
    # setup), the application and its secrets
    kinds = [kind for _, kind, _, _ in deleted]
    assert kinds == ["Agent", "StatefulSet", "Service", "Secret", "Job", "Job", "Application"]
    assert [name for *_, name in deleted if name.startswith("langstream-runtime")] == \
        ["langstream-runtime-deployer-app1", "langstream-runtime-setup-app1"]
    assert all(not final[kind] for kind in KINDS)


@pytest.mark.parametrize("phases", [
    [], ["DEPLOYED", "DEPLOYED"], ["DEPLOYED", "DEPLOYING"], ["ERROR", "DEPLOYING"],
    ["UNKNOWN"], [None, "DEPLOYED"],
])
def test_status_aggregation_matches_jax(phases):
    manifests = [{"metadata": {"name": f"a{i}"},
                  "spec": {"agentId": f"agent-{i}"} if i % 2 else {},
                  "status": {"phase": p} if p else {}} for i, p in enumerate(phases)]
    got = PORT.resources.AgentResourcesFactory.aggregate_agents_status(manifests)
    assert got == JAX.resources.AgentResourcesFactory.aggregate_agents_status(manifests)


# -- the control plane on the kubernetes runtime --------------------------------


def test_control_plane_on_kubernetes_runtime():
    """REST deploy → Application CR → operator reconcile → StatefulSets, then
    REST delete tears it down (the port's control plane, admin client and
    runtime manager over the port's fake store)."""
    import tempfile

    from langstream_tpu_torch.cli.client import AdminClient
    from langstream_tpu_torch.k8s.runtime_manager import KubernetesRuntimeManager
    from langstream_tpu_torch.webservice.server import ControlPlaneServer
    from langstream_tpu_torch.webservice.service import ApplicationService, TenantService
    from langstream_tpu_torch.webservice.stores import (
        InMemoryApplicationStore,
        InMemoryCodeStorage,
        InMemoryGlobalMetadataStore,
    )

    async def scenario(tmp: Path):
        kube = PORT.fake.FakeKubeServer()
        PORT.controllers.Operator(kube)
        store = InMemoryApplicationStore()
        runtime = KubernetesRuntimeManager(kube, store)
        applications = ApplicationService(store, InMemoryCodeStorage(), runtime)
        tenants = TenantService(InMemoryGlobalMetadataStore())
        tenants.put("default")
        server = ControlPlaneServer(applications, tenants, port=0)
        await server.start()
        try:
            app_dir, instance = tmp / "app", tmp / "instance.yaml"
            app_dir.mkdir()
            (app_dir / "pipeline.yaml").write_text(PIPELINE)
            instance.write_text(INSTANCE)
            client = AdminClient(server.url)
            await asyncio.to_thread(client.deploy, "k8sapp", app_dir, instance)
            desc = await asyncio.to_thread(client.get, "k8sapp")
            assert desc["status"]["status"] == "DEPLOYED"
            agents = kube.list("Agent", "langstream-default")
            assert len(agents) == 1
            sts = kube.get("StatefulSet", "langstream-default", agents[0]["metadata"]["name"])
            assert sts["spec"]["replicas"] == 2
            assert sts["spec"]["template"]["spec"]["nodeSelector"] == {
                "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
            app = kube.get("Application", "langstream-default", "k8sapp")
            assert app["spec"]["packageFiles"] == {"pipeline.yaml": PIPELINE}
            assert app["spec"]["codeArchiveId"]
            logs = await asyncio.to_thread(client.logs, "k8sapp")
            assert "chat" in logs
            await asyncio.to_thread(client.delete, "k8sapp")
            for kind in KINDS:
                assert kube.list(kind) == [], kind
        finally:
            await server.stop()

    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(scenario(Path(tmp)))


# -- autoscale and tenancy keys -----------------------------------------------


def _fleet_agent(pkg, autoscale=None, status=None, parallelism=2):
    return pkg.crds.AgentCustomResource(
        name="a", namespace="ns", tenant="t", agent_id="a", application_id="app",
        agent_type="ai-chat-completions", component_type="PROCESSOR", config_secret_ref="s",
        config_checksum="c", parallelism=parallelism, autoscale=autoscale, status=status or {})


AUTO = {"enabled": True, "min-replicas": 1, "max-replicas": 4}


@pytest.mark.parametrize("autoscale,status,want", [
    (None, None, 2),
    (None, {"fleet": {"desiredReplicas": 6}}, 2),
    (AUTO, {"fleet": {"desiredReplicas": 6}}, 4),
    (AUTO, {"fleet": {"desiredReplicas": 3}}, 3),
    (AUTO, {"fleet": {"desiredReplicas": 0}}, 1),
    (AUTO, None, 2),
    ({**AUTO, "min-replicas": 0}, {"fleet": {"desiredReplicas": 0}}, 0),
    ({**AUTO, "min-replicas": 0}, {"fleet": {"desiredReplicas": 3}}, 3),
    ({**AUTO, "min-replicas": 0}, {"fleet": {"desiredReplicas": 9}}, 4),
    ({"enabled": True}, {"fleet": {"desiredReplicas": 20}}, 8),
])
def test_fleet_consumers_match_jax(autoscale, status, want):
    got = PORT.resources.AgentResourcesFactory.fleet_consumers(
        _fleet_agent(PORT, autoscale, status))
    assert got == want == JAX.resources.AgentResourcesFactory.fleet_consumers(
        _fleet_agent(JAX, autoscale, status))
    sts = PORT.resources.AgentResourcesFactory().generate_stateful_set(
        _fleet_agent(PORT, autoscale, status))
    assert sts["spec"]["replicas"] == want
    rt = PORT.crds.AgentCustomResource.from_manifest(
        _fleet_agent(PORT, autoscale, status).to_manifest())
    assert rt.autoscale == autoscale


class _Replica:
    """A replica whose beacon the test scripts (the port's router reads it)."""

    is_local = False

    def __init__(self, fleet, rid: str, **beacon) -> None:
        self.fleet, self.replica_id, self.url = fleet, rid, f"fake:{rid}"
        self.beacon = beacon

    def fetch_beacon(self) -> dict:
        return {"schema": self.fleet.BEACON_SCHEMA, "id": self.replica_id, "url": self.url,
                "at": 0.0, "load_score": 0.0, "queue_wait_ema_s": 0.0, "active_slots": 0,
                "max_batch": 4, "queued": 0, "queue_depth": 16, "draining": False,
                "quarantined": False, "prefixes": [], **self.beacon}


def test_fleet_autoscale_reconciler_on_the_port_router():
    """The ops loop writes the port router's ``desired_replicas`` into
    ``status.fleet.desiredReplicas`` (only the fleet subtree, only when it
    moved), the StatefulSet follows it, and a failed read is a no-op tick."""
    from langstream_tpu_torch.serving import fleet

    kube = PORT.fake.FakeKubeServer()
    agent = _fleet_agent(PORT, {"enabled": True, "min-replicas": 1, "max-replicas": 8},
                         {"phase": "DEPLOYED"})
    kube.apply(agent.to_manifest())
    replicas = [_Replica(fleet, "r0", queue_wait_ema_s=2.0), _Replica(fleet, "r1")]
    router = fleet.FleetRouter(replicas, refresh_interval_s=3600.0)
    router.refresh_all()
    patches: list = []
    real_patch = kube.patch_status

    def recording_patch(kind, ns, name, status):
        patches.append(status)
        return real_patch(kind, ns, name, status)

    kube.patch_status = recording_patch
    rec = PORT.resources.FleetAutoscaleReconciler(
        kube, router.desired_replicas, namespace="ns", name="a")
    want = router.desired_replicas()
    assert want > 2
    assert rec.reconcile_once() == want
    assert patches == [{"fleet": {"desiredReplicas": want}}]
    manifest = kube.get("Agent", "ns", "a")
    rv = manifest["metadata"]["resourceVersion"]
    assert rec.reconcile_once() is None and rec.skipped_total == 1
    assert kube.get("Agent", "ns", "a")["metadata"]["resourceVersion"] == rv
    updated = PORT.crds.AgentCustomResource.from_manifest(manifest)
    assert PORT.resources.AgentResourcesFactory.fleet_consumers(updated) == min(want, 8)
    replicas[0].beacon["queue_wait_ema_s"] = 0.0
    router.refresh_all()
    assert rec.reconcile_once() == router.desired_replicas() != want
    real_get = kube.get
    kube.get = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("apiserver 503"))
    assert rec.reconcile_once() is None
    kube.get = real_get
    kube.delete("Agent", "ns", "a")
    assert rec.reconcile_once() is None
    assert rec.patches_total == 2
    rec.interval_s = 0.01
    rec.start()
    rec.stop()
    assert rec._thread is None


def _role_split(pkg) -> list:
    kube = pkg.fake.FakeKubeServer()
    kube.apply(_fleet_agent(pkg, {"enabled": True, "min-replicas": 1, "max-replicas": 8},
                            {"phase": "DEPLOYED"}).to_manifest())
    roles = {"v": {"prefill": 2, "decode": 4}}
    rec = pkg.resources.FleetAutoscaleReconciler(
        kube, lambda: 6, namespace="ns", name="a", desired_roles_fn=lambda: roles["v"])
    seen = []
    for split in ({"prefill": 2, "decode": 4}, {"prefill": 2, "decode": 4},
                  {"prefill": 3, "decode": 4}, {}):
        roles["v"] = split
        seen.append((rec.reconcile_once(), kube.get("Agent", "ns", "a")["status"]))
    return seen


def test_reconciler_role_split_matches_jax():
    port = _role_split(PORT)
    assert port == _role_split(JAX)
    assert port[0][1]["fleet"] == {"desiredReplicas": 6,
                                   "desiredReplicasByRole": {"prefill": 2, "decode": 4}}
    assert port[1][0] is None
    assert "desiredReplicasByRole" not in port[3][1]["fleet"]


def test_agent_cr_tenants_block_round_trips():
    tenants = [{"name": "acme", "weight": 4, "token-rate": 1000},
               {"name": "free", "queue-share": 0.25}]
    crs = [pkg.crds.AgentCustomResource(
        name="a", namespace="ns", tenant="t", agent_id="ag", application_id="app",
        agent_type="ai-chat-completions", component_type="PROCESSOR", config_secret_ref="s",
        config_checksum="c", tenants=tenants) for pkg in PACKAGES]
    manifests = [cr.to_manifest() for cr in crs]
    assert manifests[1] == manifests[0]
    assert manifests[1]["spec"]["resources"]["tenants"] == tenants
    back = PORT.crds.AgentCustomResource.from_manifest(manifests[0])
    assert back.tenants == tenants and back == crs[1]
    app = app_cr(PORT, app="tpu-completions-kafka")
    assert PORT.crds.ApplicationCustomResource.from_manifest(app.to_manifest()) == app
    assert app.to_manifest() == app_cr(JAX, app="tpu-completions-kafka").to_manifest()
    assert PORT.crds.tenant_namespace("acme") == JAX.crds.tenant_namespace("acme")
