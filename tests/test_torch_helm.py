"""The port's chart renderer (``langstream_tpu_torch/k8s/helm_render.py``)
against the JAX package's (``tests/test_helm.py``): the chart under
``helm/langstream-tpu`` renders to the same manifests for the default values
and for overrides, other template constructs are refused, and the rendered
control-plane, gateway and operator containers boot as
``python -m langstream_tpu_torch.entrypoint <args>`` with their rendered env
(the operator against the port's HTTP fake)."""

import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from langstream_tpu.k8s.helm_render import render_chart as jax_render_chart
from langstream_tpu.k8s.helm_render import render_template as jax_render_template
from langstream_tpu_torch.k8s.helm_render import render_chart, render_template

REPO = Path(__file__).parent.parent
CHART = REPO / "helm" / "langstream-tpu"


def by_kind(docs, kind):
    return [d for d in docs if d.get("kind") == kind]


OVERRIDES = [
    {},
    {"image": {"repository": "gcr.io/x/runtime", "tag": "v9"},
     "controlPlane": {"adminToken": "sekret", "port": 9999},
     "operator": {"namespace": "tenant-ns"}},
    {"operator": {"pollSeconds": 7, "replicas": 2}, "gateway": {"port": 1234},
     "agentResources": {"cpuPerUnit": "2", "memPerUnitMb": 4096}},
    {"controlPlane": {"adminToken": 'with "quotes"', "storageSize": "5Gi"}},
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=range(len(OVERRIDES)))
@pytest.mark.parametrize("release,namespace", [("ls", "default"), ("prod", "ls-system")])
@pytest.mark.parametrize("crds", [True, False])
def test_render_matches_jax(overrides, release, namespace, crds):
    kw = dict(release_name=release, namespace=namespace, value_overrides=overrides,
              include_crds=crds)
    docs = render_chart(CHART, **kw)
    assert docs == jax_render_chart(CHART, **kw)
    assert bool(by_kind(docs, "CustomResourceDefinition")) == crds


def test_chart_renders_full_platform():
    docs = render_chart(CHART, release_name="ls", namespace="ls-system")
    deployments = {d["metadata"]["name"]: d for d in by_kind(docs, "Deployment")}
    assert set(deployments) == {"ls-control-plane", "ls-operator"}
    for doc in docs:
        assert doc.get("apiVersion") and doc.get("kind") and doc["metadata"]["name"]
    cp = deployments["ls-control-plane"]["spec"]["template"]["spec"]
    assert [c["name"] for c in cp["containers"]] == ["gateway", "control-plane"]
    op = deployments["ls-operator"]["spec"]["template"]["spec"]
    (op_container,) = op["containers"]
    assert op_container["args"] == ["operator"]
    env = {e["name"]: e["value"] for e in op_container["env"]}
    assert env["OPERATOR_POLL_SECONDS"] == "2" and "OPERATOR_NAMESPACE" not in env
    # the CRDs name the group and kinds the port's client routes to
    from langstream_tpu_torch.k8s.client import KIND_ROUTES

    for crd in by_kind(docs, "CustomResourceDefinition"):
        kind = crd["spec"]["names"]["kind"]
        prefix, plural, _ = KIND_ROUTES[kind]
        assert prefix == f"/apis/{crd['spec']['group']}/v1alpha1"
        assert plural == crd["spec"]["names"]["plural"]


@pytest.mark.parametrize("text", [
    'x: {{ include "helper" . }}',
    "x: {{ range .Values.items }}y{{ end }}",
    "x: {{ .Values.a | default \"b\" }}",
])
def test_renderer_rejects_unknown_constructs(text):
    with pytest.raises(ValueError, match="unrendered") as port:
        render_template(text, {"a": "v", "items": [1]}, {"Name": "r"})
    with pytest.raises(ValueError) as jax:
        jax_render_template(text, {"a": "v", "items": [1]}, {"Name": "r"})
    assert str(port.value) == str(jax.value)


def test_renderer_quotes_and_rejects_other_functions():
    """``| quote`` quotes (escaping ``"``) and a pipe into another function
    is refused. The JAX renderer keeps the ``|`` in its pipe group, so its
    ``quote`` never applies and any other function is dropped: it renders
    the bare value (ROADMAP §3). On the chart that shows only where a quoted
    value reads as another type: a numeric operator namespace."""
    assert render_template('x: {{ .Values.a | quote }}', {"a": 'q"t'}, {}) == 'x: "q\\"t"'
    assert render_template("x: {{ .Values.a|quote }}", {"a": "v"}, {}) == 'x: "v"'
    assert jax_render_template('x: {{ .Values.a | quote }}', {"a": 'q"t'}, {}) == 'x: q"t'
    for text in ("x: {{ .Values.a | upper }}", "x: {{- .Values.a | b64enc -}}"):
        with pytest.raises(ValueError, match="unsupported template function"):
            render_template(text, {"a": "v"}, {"Name": "r"})
        assert jax_render_template(text, {"a": "v"}, {"Name": "r"}) == "x: v"

    def namespace(render):
        docs = render(CHART, value_overrides={"operator": {"namespace": "123"}})
        (op,) = [d for d in by_kind(docs, "Deployment") if d["metadata"]["name"] == "ls-operator"]
        env = op["spec"]["template"]["spec"]["containers"][0]["env"]
        return next(e["value"] for e in env if e["name"] == "OPERATOR_NAMESPACE")

    assert namespace(render_chart) == "123" and namespace(jax_render_chart) == 123


def test_render_template_matches_jax():
    text = ('a: {{ .Release.Name }}\nb: {{ .Values.x.y }}\n'
            '{{- if .Values.flag }}\nc: yes\n{{- end }}\n{{- if .Values.off }}\nd: no\n'
            '{{- end }}\ne: "{{ .Values.missing }}"\n')
    for values in ({"x": {"y": 'q"t'}, "flag": True}, {"x": {}, "flag": {}, "off": ""}):
        assert render_template(text, values, {"Name": "r"}) == \
            jax_render_template(text, values, {"Name": "r"})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _role_env(container, overrides):
    env = {e["name"]: str(e["value"]) for e in container.get("env", [])}
    env.update(overrides)
    return env


def test_rendered_roles_boot_as_processes(tmp_path):
    """The rendered control-plane and gateway containers' args and env
    (ports remapped, storage on tmp) bring up a healthy control plane and
    gateway as the port's entry point, and the operator container passes
    once against the port's HTTP fake."""
    from langstream_tpu_torch.k8s.http_fake import HttpFakeKubeServer

    cp_port, gw_port = free_port(), free_port()
    docs = render_chart(CHART, value_overrides={"controlPlane": {"port": cp_port},
                                                "gateway": {"port": gw_port}})
    deployments = {d["metadata"]["name"]: d for d in by_kind(docs, "Deployment")}
    containers = {c["name"]: c for c in
                  deployments["ls-control-plane"]["spec"]["template"]["spec"]["containers"]}
    base_env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []

    def boot(container, extra_env):
        proc = subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.entrypoint", *container["args"]],
            env={**base_env, **_role_env(container, extra_env)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(proc)
        return proc

    def wait_healthy(proc, port, path):
        for _ in range(240):
            if proc.poll() is not None:
                raise AssertionError(f"role died: {proc.stdout.read()[-1500:]}")
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=1)
                return
            except OSError:
                time.sleep(0.25)
        raise AssertionError(f"port {port} never became healthy")

    server = HttpFakeKubeServer().serve()
    try:
        storage = {"STORAGE_ROOT": str(tmp_path / "store")}
        cp = boot(containers["control-plane"], storage)
        gw = boot(containers["gateway"], storage)
        op = deployments["ls-operator"]["spec"]["template"]["spec"]["containers"][0]
        once = subprocess.run(
            [sys.executable, "-m", "langstream_tpu_torch.entrypoint", *op["args"]],
            env={**base_env, **_role_env(op, {"KUBE_API_SERVER": server.url,
                                              "OPERATOR_ONCE": "true"})},
            capture_output=True, text=True, timeout=120)
        assert once.returncode == 0, once.stdout + once.stderr
        assert server.requests_served == 2  # the two lists of one pass
        wait_healthy(cp, cp_port, "/api/tenants")
        wait_healthy(gw, gw_port, "/healthz")
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        server.close()
