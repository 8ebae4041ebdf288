"""The port's Kubernetes API client and its stdlib API-server fake against
the JAX package's (``tests/test_k8s_client.py``), case for case and across
packages: the port's client against the port's fake, the port's client
against the JAX package's aiohttp fake, and the JAX package's client against
the port's fake. Then the port's cluster roles: the ``operator`` as a
process of its own (one pass, and driven by its watch), the operator's
chaos convergence, the two Job roles and the code download (with its
refusal of a path that leaves the target)."""

import asyncio
import base64
import copy
import io
import json
import os
import subprocess
import sys
import threading
import time
import zipfile
from pathlib import Path

import pytest

import langstream_tpu.k8s.client as jax_client
import langstream_tpu.k8s.http_fake as jax_fake
import langstream_tpu_torch.k8s.client as port_client
import langstream_tpu_torch.k8s.http_fake as port_fake
from langstream_tpu_torch.k8s.crds import ApplicationCustomResource

ROOT = Path(__file__).resolve().parents[1]
CLIENTS = {"port": port_client, "jax": jax_client}
FAKES = {"port": port_fake, "jax": jax_fake}
# (client, fake): the port on its own fake and each package across
COMBOS = [("port", "port"), ("port", "jax"), ("jax", "port")]
COMBO_IDS = [f"{c}-client-{f}-fake" for c, f in COMBOS]

PIPELINE = """
module: default
id: app
topics:
  - name: input-topic
    creation-mode: create-if-not-exists
  - name: output-topic
    creation-mode: create-if-not-exists
pipeline:
  - name: step1
    type: identity
    input: input-topic
    output: output-topic
    resources:
      parallelism: 2
"""

INSTANCE = """
instance:
  streamingCluster:
    type: memory
  computeCluster:
    type: kubernetes
"""


def over_http(fake: str, drive, **kw) -> None:
    """Serve a fresh store on ``fake``'s HTTP fake and run ``drive(server)``
    on a worker thread (the JAX fake answers on the event loop)."""

    async def main():
        server = await FAKES[fake].HttpFakeKubeServer(**kw).start()
        try:
            await asyncio.to_thread(drive, server)
        finally:
            await server.stop()

    asyncio.run(main())


def app_cr(name: str, namespace: str = "langstream-default") -> ApplicationCustomResource:
    return ApplicationCustomResource(
        name=name, namespace=namespace, tenant="default",
        package_files={"pipeline.yaml": PIPELINE}, instance_text=INSTANCE)


@pytest.mark.parametrize("client,fake", COMBOS, ids=COMBO_IDS)
def test_client_verbs_over_http(client, fake):
    def drive(server):
        c = CLIENTS[client].KubeApiClient(server.url)
        out = c.apply({"apiVersion": "v1", "kind": "Secret",
                       "metadata": {"name": "s1", "namespace": "ns1"}, "stringData": {"k": "v"}})
        assert out["metadata"]["resourceVersion"]
        assert c.get("Secret", "ns1", "s1")["stringData"] == {"k": "v"}
        assert c.get("Secret", "ns1", "missing") is None
        out2 = c.apply({"apiVersion": "v1", "kind": "Secret",
                        "metadata": {"name": "s1", "namespace": "ns1"},
                        "stringData": {"k": "v2"}})
        assert out2["stringData"]["k"] == "v2"
        assert int(out2["metadata"]["resourceVersion"]) > int(out["metadata"]["resourceVersion"])
        c.apply({"apiVersion": "v1", "kind": "Secret",
                 "metadata": {"name": "s2", "namespace": "ns2"}})
        assert [m["metadata"]["name"] for m in c.list("Secret", "ns1")] == ["s1"]
        assert len(c.list("Secret")) == 2
        c.apply({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "ns9"}})
        assert [m["metadata"]["name"] for m in c.list("Namespace")] == ["ns9"]
        c.apply({"apiVersion": "langstream.tpu/v1alpha1", "kind": "Agent",
                 "metadata": {"name": "a1", "namespace": "ns1"}, "spec": {"agentId": "x"}})
        c.patch_status("Agent", "ns1", "a1", {"phase": "DEPLOYED"})
        assert c.get("Agent", "ns1", "a1")["status"]["phase"] == "DEPLOYED"
        assert c.patch_status("Agent", "ns1", "missing", {"phase": "X"}) is None
        assert c.delete("Secret", "ns1", "s1") is True
        assert c.delete("Secret", "ns1", "s1") is False
        with pytest.raises(CLIENTS[client].KubeApiError) as e:
            c.get("Widget", "ns1", "w")
        assert e.value.status == 400

    over_http(fake, drive)


@pytest.mark.parametrize("client,fake", COMBOS, ids=COMBO_IDS)
def test_client_bearer_auth(client, fake):
    secret = {"apiVersion": "v1", "kind": "Secret", "metadata": {"name": "s", "namespace": "d"}}

    def drive(server):
        mod = CLIENTS[client]
        with pytest.raises(mod.KubeApiError) as e:
            mod.KubeApiClient(server.url).apply(dict(secret))
        assert e.value.status == 401
        with pytest.raises(mod.KubeApiError) as e:
            mod.KubeApiClient(server.url, token="wrong").get("Secret", "d", "s")
        assert e.value.status == 401
        ok = mod.KubeApiClient(server.url, token="sekret")
        ok.apply(dict(secret))
        assert ok.get("Secret", "d", "s") is not None

    over_http(fake, drive, token="sekret")


@pytest.mark.parametrize("client,fake", COMBOS, ids=COMBO_IDS)
def test_patch_status_retries_injected_conflicts(client, fake):
    """A 409 then a 500 on PATCH /status are retried until the patch lands;
    a 404 is an answer, a 400 is raised."""

    def drive(server):
        c = CLIENTS[client].KubeApiClient(server.url)
        c.apply({"kind": "Application", "metadata": {"name": "a1", "namespace": "ns"},
                 "spec": {}})
        server.error_queue.extend([("PATCH", 409), ("PATCH", 500)])
        assert c.patch_status("Application", "ns", "a1", {"phase": "X"}) is not None
        assert not server.error_queue
        assert c.get("Application", "ns", "a1")["status"]["phase"] == "X"
        server.error_queue.append(("PATCH", 400))
        with pytest.raises(CLIENTS[client].KubeApiError) as e:
            c.patch_status("Application", "ns", "a1", {"phase": "Y"})
        assert e.value.status == 400
        c.max_conflict_retries = 2
        server.error_queue.extend([("PATCH", 503), ("PATCH", 503)])
        with pytest.raises(CLIENTS[client].KubeApiError) as e:
            c.patch_status("Application", "ns", "a1", {"phase": "Z"})
        assert e.value.status == 503
        assert c.get("Application", "ns", "a1")["status"]["phase"] == "X"

    over_http(fake, drive)


@pytest.mark.parametrize("client,fake", COMBOS, ids=COMBO_IDS)
def test_apply_retries_conflict_with_fresh_resource_version(client, fake):
    def drive(server):
        c = CLIENTS[client].KubeApiClient(server.url)
        c.apply({"kind": "ConfigMap", "metadata": {"name": "cm", "namespace": "ns"},
                 "data": {"v": "1"}})
        served = server.requests_served
        server.error_queue.append(("PUT", 409))
        out = c.apply({"kind": "ConfigMap", "metadata": {"name": "cm", "namespace": "ns"},
                       "data": {"v": "2"}})
        assert out["data"]["v"] == "2"
        # GET, PUT (409), GET, PUT
        assert server.requests_served - served == 4
        server.error_queue.append(("POST", 409))
        out = c.apply({"kind": "ConfigMap", "metadata": {"name": "new", "namespace": "ns"},
                       "data": {"v": "3"}})
        assert out["data"]["v"] == "3"

    over_http(fake, drive)


@pytest.mark.parametrize("client,fake", COMBOS, ids=COMBO_IDS)
def test_watch_streams_add_modify_delete(client, fake):
    """``watch`` yields the lifecycle as it happens (the apiserver's ?watch=1
    wire shape), and a resourceVersion past the bounded event horizon raises
    KubeWatchExpired for the re-list loop."""
    mod = CLIENTS[client]

    def drive(server):
        c = mod.KubeApiClient(server.url)
        seen: list = []

        def watch_thread():
            for type_, obj in c.watch("Secret", "ns1", resource_version="0", timeout_seconds=3):
                seen.append((type_, obj["metadata"]["name"]))
                if len(seen) >= 3:
                    return

        t = threading.Thread(target=watch_thread)
        t.start()
        time.sleep(0.2)
        c.apply({"apiVersion": "v1", "kind": "Secret",
                 "metadata": {"name": "w1", "namespace": "ns1"}})
        c.apply({"apiVersion": "v1", "kind": "Secret",
                 "metadata": {"name": "other", "namespace": "ns2"}})
        c.apply({"apiVersion": "v1", "kind": "Secret",
                 "metadata": {"name": "w1", "namespace": "ns1"}, "stringData": {"k": "v2"}})
        c.delete("Secret", "ns1", "w1")
        t.join(timeout=10)
        assert not t.is_alive()
        assert seen == [("ADDED", "w1"), ("MODIFIED", "w1"), ("DELETED", "w1")]
        # a watch that starts now sees nothing and ends at its timeout
        t0 = time.monotonic()
        assert list(c.watch("Secret", "ns1", timeout_seconds=1)) == []
        assert 0.9 < time.monotonic() - t0 < 5
        # every namespace: the cluster-wide form
        kinds = [(t, o["metadata"]["namespace"]) for t, o in
                 c.watch("Secret", resource_version="0", timeout_seconds=1)]
        assert kinds == [("ADDED", "ns1"), ("ADDED", "ns2"), ("MODIFIED", "ns1"),
                         ("DELETED", "ns1")]
        server.store.event_window = 2
        for i in range(6):
            c.apply({"apiVersion": "v1", "kind": "Secret",
                     "metadata": {"name": f"x{i}", "namespace": "ns1"}})
        with pytest.raises(mod.KubeWatchExpired):
            for _ in c.watch("Secret", "ns1", resource_version="1", timeout_seconds=2):
                pass

    over_http(fake, drive)


KUBECONFIG = """
apiVersion: v1
kind: Config
current-context: dev
contexts:
  - name: dev
    context:
      cluster: local
      user: admin
  - name: other
    context:
      cluster: remote
      user: robot
clusters:
  - name: local
    cluster:
      server: http://127.0.0.1:6443
      certificate-authority-data: {ca}
  - name: remote
    cluster:
      server: https://10.0.0.1:443
      insecure-skip-tls-verify: true
users:
  - name: admin
    user:
      token: tok-123
  - name: robot
    user:
      token: tok-456
"""


def test_kubeconfig_parsing(tmp_path, monkeypatch):
    """The port's client reads a kubeconfig with its own YAML reader to the
    JAX client's server and token, for the current context and another."""
    ca = base64.b64encode(b"fake-ca-pem").decode()
    path = tmp_path / "kubeconfig"
    path.write_text(KUBECONFIG.format(ca=ca))
    before = set(os.listdir(tempfile_dir()))
    for context in (None, "other"):
        port = port_client.KubeApiClient.from_kubeconfig(str(path), context)
        want = jax_client.KubeApiClient.from_kubeconfig(str(path), context)
        assert (port.server, port.token) == (want.server, want.token)
    assert port.server == "https://10.0.0.1:443" and port.token == "tok-456"
    assert port._context is not None
    # the decoded certificate authority was not left behind
    assert set(os.listdir(tempfile_dir())) <= before
    monkeypatch.setenv("KUBECONFIG", str(path))
    monkeypatch.delenv("KUBE_API_SERVER", raising=False)
    assert port_client.KubeApiClient.from_env().token == "tok-123"
    monkeypatch.setenv("KUBE_API_SERVER", "http://127.0.0.1:1/")
    monkeypatch.setenv("KUBE_API_TOKEN", "t")
    env = port_client.KubeApiClient.from_env()
    assert (env.server, env.token) == ("http://127.0.0.1:1", "t")
    monkeypatch.delenv("KUBE_API_SERVER")
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "missing"))
    monkeypatch.setattr(port_client, "SERVICE_ACCOUNT_DIR", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="no Kubernetes credentials"):
        port_client.KubeApiClient.from_env()


def tempfile_dir() -> str:
    import tempfile

    return tempfile.gettempdir()


# -- the cluster roles -----------------------------------------------------


def role_env(**env) -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p), **env}


def role(*args, **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "langstream_tpu_torch.entrypoint", *args],
                            cwd=ROOT, env=role_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_for(pred, timeout: float, what: str) -> float:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return time.monotonic() - t0
        time.sleep(0.05)
    raise AssertionError(f"{what} not within {timeout} s")


def test_operator_role_process_once():
    """``python -m langstream_tpu_torch.entrypoint operator`` with
    OPERATOR_ONCE against the port's HTTP fake: one pass turns an
    Application CR into Agent CRs, config Secrets, Services and StatefulSets,
    every write over the socket, and the process exits 0."""
    server = port_fake.HttpFakeKubeServer().serve()
    try:
        client = port_client.KubeApiClient(server.url)
        client.apply(app_cr("myapp").to_manifest())
        proc = role("operator", KUBE_API_SERVER=server.url, OPERATOR_ONCE="true",
                    OPERATOR_NAMESPACE="langstream-default")
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
        app = client.get("Application", "langstream-default", "myapp")
        assert app["status"]["phase"] == "DEPLOYED"
        agents = client.list("Agent", "langstream-default")
        assert len(agents) == 1
        name = agents[0]["metadata"]["name"]
        sts = client.get("StatefulSet", "langstream-default", name)
        assert sts["spec"]["replicas"] == 2
        assert sts["spec"]["template"]["spec"]["containers"][0]["command"][:3] == \
            ["python", "-m", "langstream_tpu_torch.entrypoint"]
        assert client.get("Secret", "langstream-default", f"{name}-config")
        assert client.get("Service", "langstream-default", name)
        assert client.get("Agent", "langstream-default", name)["status"]["phase"] == "DEPLOYING"
    finally:
        server.close()


def test_operator_role_process_driven_by_its_watch():
    """The operator as a process with a 12 s fallback poll: a CR created
    after its first pass reconciles within a few seconds (its watch woke
    it), and the process holds no reconcile loop against its own status
    patches."""
    server = port_fake.HttpFakeKubeServer().serve()
    proc = role("operator", KUBE_API_SERVER=server.url, OPERATOR_POLL_SECONDS="12")
    try:
        client = port_client.KubeApiClient(server.url)
        wait_for(lambda: server.requests_served >= 4, 60, "the operator's first pass")
        time.sleep(0.3)
        client.apply(app_cr("watched-app").to_manifest())

        def phase():
            live = client.get("Application", "langstream-default", "watched-app")
            return (live or {}).get("status", {}).get("phase") == "DEPLOYED"

        assert wait_for(phase, 8, "the watched CR's reconcile") < 8
        name = client.list("Agent", "langstream-default")[0]["metadata"]["name"]
        wait_for(lambda: client.get("StatefulSet", "langstream-default", name), 8,
                 "the agent's StatefulSet")

        def quiet_for_a_second() -> bool:
            version = server.store.version
            time.sleep(1.0)
            return server.store.version == version

        # the pass that applied the StatefulSet may still patch the Agent's
        # and the Application's status (a slow host); then the store
        # settles, and stays settled: no status patch storm
        wait_for(quiet_for_a_second, 15, "the store to settle")
        version = server.store.version
        time.sleep(1.0)
        assert server.store.version == version
        assert proc.poll() is None
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        server.close()
    assert "operator up against" in out


@pytest.mark.parametrize("fake", ["port", "jax"])
def test_operator_chaos_converges(fake, monkeypatch):
    """The operator dies after its setup phase; the CR is edited while it
    is down; the API server answers 409 and 500 to the restarted operator's
    writes. One pass of the restarted operator converges to DEPLOYED."""
    from langstream_tpu_torch.entrypoint import main as entrypoint_main
    from langstream_tpu_torch.k8s.controllers import AppController, InProcessJobExecutor

    def drive(server):
        client = port_client.KubeApiClient(server.url)
        monkeypatch.setenv("KUBE_API_SERVER", server.url)
        monkeypatch.setenv("OPERATOR_ONCE", "true")
        monkeypatch.setenv("OPERATOR_NAMESPACE", "langstream-default")
        client.apply(app_cr("chaos-app").to_manifest())

        class DyingExecutor(InProcessJobExecutor):
            def run_deployer(self, app):
                raise RuntimeError("operator killed mid-deploy")

        controller = AppController(client, DyingExecutor(client))
        manifest = client.get("Application", "langstream-default", "chaos-app")
        assert controller.reconcile(manifest)["phase"] == "ERROR_DEPLOY"
        live = client.get("Application", "langstream-default", "chaos-app")
        assert live["status"].get("setupFor") is not None
        assert live["status"].get("deployedFor") is None
        edited = copy.deepcopy(live)
        edited["metadata"].pop("resourceVersion")
        client.apply(edited)
        server.error_queue.extend([("PUT", 409), ("PATCH", 500)])
        assert entrypoint_main(["operator"]) == 0
        final = client.get("Application", "langstream-default", "chaos-app")
        assert final["status"]["phase"] == "DEPLOYED", final["status"]
        agents = client.list("Agent", "langstream-default")
        assert len(agents) == 1
        assert client.get("StatefulSet", "langstream-default", agents[0]["metadata"]["name"])
        assert not server.error_queue

    over_http(fake, drive)


def _stores(server) -> dict:
    kinds = ("Application", "Agent", "Secret", "Service", "StatefulSet", "Job")
    return {kind: server.store.list(kind) for kind in kinds}


def test_operator_roles_across_packages(monkeypatch):
    """Each package's operator role (one pass) over the OTHER package's
    fake and client: both stores end with the same objects, but for the
    command, image and device keys ``k8s/resources.py`` lists."""
    import langstream_tpu.entrypoint as jax_entrypoint
    import langstream_tpu_torch.entrypoint as port_entrypoint
    from test_torch_k8s import neutral

    monkeypatch.setenv("OPERATOR_ONCE", "true")
    got = {}
    for name, entrypoint, fake in (("port", port_entrypoint, "jax"),
                                   ("jax", jax_entrypoint, "port")):
        def drive(server, entrypoint=entrypoint, name=name):
            monkeypatch.setenv("KUBE_API_SERVER", server.url)
            CLIENTS[name].KubeApiClient(server.url).apply(app_cr("x").to_manifest())
            assert entrypoint.main(["operator"]) == 0
            got[name] = {kind: [neutral(m) for m in items]
                         for kind, items in _stores(server).items()}

        over_http(fake, drive)
    strip = ("resourceVersion",)
    for pkg in got.values():
        for items in pkg.values():
            for m in items:
                for key in strip:
                    m["metadata"].pop(key, None)
    assert got["port"] == got["jax"]
    assert got["port"]["Application"][0]["status"]["phase"] == "DEPLOYED"


@pytest.mark.parametrize("fake", ["port", "jax"])
def test_deployer_and_setup_job_roles(fake, monkeypatch):
    """The two Job roles do the operator's in-process work, addressed by
    APPLICATION_NAME / NAMESPACE; a missing CR is an error."""
    from langstream_tpu_torch.entrypoint import main as entrypoint_main

    def drive(server):
        client = port_client.KubeApiClient(server.url)
        client.apply(app_cr("jobs-app", "ns").to_manifest())
        monkeypatch.setenv("KUBE_API_SERVER", server.url)
        monkeypatch.setenv("APPLICATION_NAME", "jobs-app")
        monkeypatch.setenv("NAMESPACE", "ns")
        assert entrypoint_main(["application-setup"]) == 0
        assert client.list("Agent", "ns") == []
        assert entrypoint_main(["deployer-runtime"]) == 0
        agents = client.list("Agent", "ns")
        assert len(agents) == 1
        pod = json.loads(client.get("Secret", "ns", agents[0]["spec"]["configSecretRef"])
                         ["stringData"]["pod-configuration"])
        assert pod["applicationId"] == "jobs-app" and pod["agent"]["agentType"] == "identity"
        monkeypatch.setenv("APPLICATION_NAME", "missing")
        with pytest.raises(RuntimeError, match="ns/missing not found"):
            entrypoint_main(["deployer-runtime"])

    over_http(fake, drive)


def _zip(files: dict) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, text in files.items():
            zf.writestr(name, text)
    return buf.getvalue()


def test_code_download_role(tmp_path, monkeypatch):
    """agent-code-download fetches the archive from a live control plane
    (the port's) and unpacks it into the target dir."""
    from langstream_tpu_torch.cli.client import AdminClient
    from langstream_tpu_torch.entrypoint import main as entrypoint_main
    from torch_control_plane import Plane

    app = tmp_path / "app"
    (app / "python").mkdir(parents=True)
    (app / "pipeline.yaml").write_text(PIPELINE)
    (app / "python" / "agent.py").write_text("x = 1")
    instance = tmp_path / "instance.yaml"
    instance.write_text(INSTANCE.replace("kubernetes", "local"))
    with Plane("port", root=str(tmp_path / "store")) as plane:
        AdminClient(plane.url).deploy("dl-app", app, instance)
        target = tmp_path / "code"
        monkeypatch.setenv("CONTROL_PLANE_URL", plane.url)
        monkeypatch.setenv("TENANT", "default")
        monkeypatch.setenv("APPLICATION_ID", "dl-app")
        monkeypatch.setenv("TARGET_DIR", str(target))
        assert entrypoint_main(["agent-code-download"]) == 0
    assert (target / "pipeline.yaml").read_text().strip().startswith("module:")
    assert (target / "python" / "agent.py").read_text() == "x = 1"


@pytest.mark.parametrize("entry", ["../evil.py", "sub/../../evil.py", "/abs/evil.py"])
def test_code_download_refuses_path_traversal(tmp_path, monkeypatch, entry):
    """An archive entry that resolves outside the target is refused before
    anything is written, as the JAX role refuses it (a sibling directory
    whose name shares the target's prefix is outside too)."""
    from langstream_tpu_torch.entrypoint import main as entrypoint_main
    from torch_http_stub import Stub

    archive = _zip({"ok.txt": "fine", entry: "boom"})
    target = tmp_path / "code"
    with Stub([("GET", r"/api/applications/default/bad/code",
                lambda call: (200, {"Content-Type": "application/zip"}, archive))]) as stub:
        monkeypatch.setenv("CONTROL_PLANE_URL", stub.base)
        monkeypatch.setenv("APPLICATION_ID", "bad")
        monkeypatch.setenv("TARGET_DIR", str(target))
        results = {}
        for name, mod in (("port", "langstream_tpu_torch.entrypoint"),
                          ("jax", "langstream_tpu.entrypoint")):
            main = entrypoint_main if name == "port" else __import__(mod, fromlist=["main"]).main
            with pytest.raises(RuntimeError) as e:
                main(["agent-code-download"])
            results[name] = str(e.value)
    assert results["port"] == results["jax"] == f"archive path escapes target: {entry}"
    assert not (tmp_path / "evil.py").exists() and not (target / "ok.txt").exists()
