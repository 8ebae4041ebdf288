"""The port's command line (``cli/``) against the JAX package's: the port's
counterparts of ``tests/test_cli.py`` and ``tests/test_e2e_cli.py``, each
command's output compared with the JAX CLI's (click) on the same app and
the same kind of control plane, ``apps get -o mermaid`` equal to JAX's for
every example app the port plans, the gateway commands over the port's
websocket client, and the profile files either package writes."""

import asyncio
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
from click.testing import CliRunner

from langstream_tpu.cli.main import cli as jax_cli
from langstream_tpu_torch.cli.main import main as port_main
from langstream_tpu_torch.messaging import memory as port_memory
from torch_control_plane import INSTANCE, PIPELINE, Plane

ROOT = Path(__file__).resolve().parents[1]

GATEWAYS = """
gateways:
  - id: chat
    type: chat
    chat-options:
      questions-topic: input-topic
      answers-topic: output-topic
  - id: in
    type: produce
    topic: input-topic
  - id: out
    type: consume
    topic: output-topic
"""


@pytest.fixture(autouse=True)
def _reset_port_broker():
    port_memory.MemoryBroker.reset()
    yield
    port_memory.MemoryBroker.reset()


@pytest.fixture
def app_dir(tmp_path):
    d = tmp_path / "app"
    d.mkdir()
    (d / "pipeline.yaml").write_text(PIPELINE)
    (d / "gateways.yaml").write_text(GATEWAYS)
    (tmp_path / "instance.yaml").write_text(INSTANCE)
    return d


def untimed(answer):
    """An answer without the agents' ``last-processed-at`` stamps (the time
    of a source's last read, empty or not)."""
    code, out, err = answer
    return code, re.sub(r"""(["']last-processed-at["']): [0-9.e+-]+""", r"\1: 0", out), err


class Clis:
    """Both CLIs, each with its own profile file pointing at its own
    control plane: ``run(pkg, *args)`` → (exit code, stdout, stderr)."""

    def __init__(self, tmp_path, monkeypatch, capsys, **server_kw):
        from langstream_tpu.cli import config as jax_config
        from langstream_tpu_torch.cli import config as port_config

        self.planes = {pkg: Plane(pkg, **server_kw) for pkg in ("jax", "port")}
        self._configs = {pkg: tmp_path / f"{pkg}-cli.json" for pkg in ("jax", "port")}
        self._monkeypatch, self._capsys = monkeypatch, capsys
        for pkg, mod in (("jax", jax_config), ("port", port_config)):
            monkeypatch.setenv("LANGSTREAM_TPU_CONFIG", str(self._configs[pkg]))
            mod.save_config(mod.CliConfig(
                profiles={"default": mod.Profile(webServiceUrl=self.planes[pkg].url)}))

    def run(self, pkg, *args):
        self._monkeypatch.setenv("LANGSTREAM_TPU_CONFIG", str(self._configs[pkg]))
        if pkg == "jax":
            result = CliRunner().invoke(jax_cli, list(args))
            return result.exit_code, result.stdout, result.stderr
        self._capsys.readouterr()
        code = port_main(list(args))
        out = self._capsys.readouterr()
        return code, out.out, out.err

    def both(self, *args):
        """The same command through each CLI: the port's answer, checked
        equal to JAX's."""
        port, jax = self.run("port", *args), self.run("jax", *args)
        assert untimed(port) == untimed(jax), args
        return port

    def close(self):
        for plane in self.planes.values():
            plane.close()


@pytest.fixture
def clis(tmp_path, monkeypatch, capsys):
    from langstream_tpu.messaging.memory import MemoryBroker

    MemoryBroker.reset()
    c = Clis(tmp_path, monkeypatch, capsys)
    yield c
    c.close()


def test_apps_lifecycle(clis, app_dir, tmp_path):
    instance = str(tmp_path / "instance.yaml")
    code, out, _ = clis.both("apps", "deploy", "myapp", "--app", str(app_dir), "-i", instance)
    assert code == 0 and json.loads(out)["application-id"] == "myapp"
    code, out, _ = clis.both("apps", "list")
    assert "myapp" in out
    code, out, _ = clis.both("apps", "get", "myapp")
    assert json.loads(out)["status"]["status"] == "DEPLOYED"
    code, out, _ = clis.both("apps", "logs", "myapp")
    assert code == 0 and "identity" in out
    code, out, _ = clis.both("apps", "update", "myapp", "--app", str(app_dir))
    assert code == 0
    code, out, _ = clis.both("apps", "download", "myapp", "-o", str(tmp_path / "dl.zip"))
    assert out.startswith(f"wrote {tmp_path / 'dl.zip'} (")
    code, out, _ = clis.both("apps", "delete", "myapp")
    assert json.loads(out) == {"deleted": "myapp"}
    code, out, err = clis.both("apps", "get", "myapp")
    assert code == 1 and out == "" and err == (
        "Error: GET /api/applications/default/myapp → 404: application myapp not found\n")


def test_apps_dry_run(clis, app_dir, tmp_path):
    code, out, _ = clis.both("apps", "deploy", "dry", "--app", str(app_dir),
                             "-i", str(tmp_path / "instance.yaml"), "--dry-run")
    assert code == 0 and json.loads(out)["dry-run"] is True
    assert "dry" not in clis.both("apps", "list")[1]


def test_tenants_and_profiles(clis):
    assert clis.both("tenants", "put", "acme")[0] == 0
    assert "acme" in clis.both("tenants", "list")[1]
    assert clis.both("tenants", "get", "acme")[1] == '{\n  "name": "acme"\n}\n'
    assert clis.both("tenants", "delete", "acme")[0] == 0
    assert clis.both("tenants", "get", "acme")[0] == 1
    assert clis.both("profiles", "create", "prod", "--tenant", "acme")[0] == 0
    port_list, jax_list = clis.run("port", "profiles", "list"), clis.run("jax", "profiles", "list")
    # the default profiles point at different control planes; prod is the same
    assert port_list[1].splitlines()[1] == jax_list[1].splitlines()[1] == (
        "  prod: http://localhost:8090 (tenant=acme)")
    assert clis.both("profiles", "use", "prod") == (0, "using profile prod\n", "")
    assert clis.both("profiles", "use", "ghost") == (1, "", "Error: no profile named 'ghost'\n")
    assert clis.both("--tenant", "acme", "configure", "token", "t0k")[0] == 0
    assert clis.both("profiles", "delete", "prod") == (0, "deleted profile prod\n", "")


def test_archetypes_commands(tmp_path, monkeypatch, capsys):
    from langstream_tpu.messaging.memory import MemoryBroker

    arch = tmp_path / "archetypes" / "echo-arch"
    (arch / "application").mkdir(parents=True)
    (arch / "archetype.yaml").write_text("archetype:\n  title: Echo\n")
    (arch / "application" / "pipeline.yaml").write_text(PIPELINE)
    (arch / "instance.yaml").write_text(INSTANCE)
    MemoryBroker.reset()
    clis = Clis(tmp_path, monkeypatch, capsys, archetypes_path=str(tmp_path / "archetypes"))
    try:
        assert json.loads(clis.both("archetypes", "list")[1]) == [
            {"id": "echo-arch", "title": "Echo"}]
        assert clis.both("archetypes", "get", "echo-arch")[0] == 0
        code, out, _ = clis.both("archetypes", "deploy", "echo-arch", "from-arch",
                                 "-p", "a=1", "-p", "b=x: y")
        assert code == 0 and json.loads(out)["application-id"] == "from-arch"
        stored = clis.planes["port"].applications.store.get("default", "from-arch")
        assert stored.application.instance.globals_ == {"a": "1", "b": "x: y"}
        assert clis.both("archetypes", "get", "nope")[0] == 1
    finally:
        clis.close()


def test_profile_files_are_shared(tmp_path, monkeypatch):
    """The same file at the same place: what one package saves, the other
    loads; both write the same bytes."""
    from langstream_tpu.cli import config as jax_config
    from langstream_tpu_torch.cli import config as port_config

    monkeypatch.delenv("LANGSTREAM_TPU_CONFIG", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert port_config.config_path() == jax_config.config_path() == (
        tmp_path / ".langstream-tpu" / "config.json")
    port_config.save_config(port_config.CliConfig(current_profile="p", profiles={
        "p": port_config.Profile("http://cp", "http://gw", "t", "tok")}))
    written = port_config.config_path().read_bytes()
    loaded = jax_config.load_config()
    assert (loaded.current_profile, loaded.profile.token) == ("p", "tok")
    jax_config.save_config(loaded)
    assert port_config.config_path().read_bytes() == written


def test_mermaid_diagram(clis, app_dir, tmp_path):
    clis.both("apps", "deploy", "mmd", "--app", str(app_dir), "-i", str(tmp_path / "instance.yaml"))
    code, out, _ = clis.both("apps", "get", "mmd", "-o", "mermaid")
    assert code == 0 and out.startswith("flowchart LR")
    assert "topic_input_topic" in out and "agent_echo" in out and "gateway_chat" in out


def test_mermaid_equals_jax_for_every_planned_app():
    """``apps get -o mermaid`` renders the YAML files of the stored zip:
    the same text as JAX's for every example app the port plans."""
    import io
    import zipfile

    from langstream_tpu.cli.mermaid import generate_mermaid as jax_mermaid
    from langstream_tpu.core.parser import ModelBuilder as JaxModelBuilder
    from langstream_tpu_torch.cli.client import AdminClient
    from langstream_tpu_torch.cli.main import mermaid_from_zip
    from test_torch_app_plan import PLANNED

    for name in sorted(PLANNED):
        data = AdminClient.zip_app_dir(ROOT / "examples" / "applications" / name)
        zf = zipfile.ZipFile(io.BytesIO(data))
        files = {n: zf.read(n).decode() for n in zf.namelist() if n.endswith((".yaml", ".yml"))}
        want = jax_mermaid(JaxModelBuilder.build_application_from_files(files, None, None)
                           .application)
        assert mermaid_from_zip(data) == want, name


def test_run_local_once(app_dir, tmp_path, capsys):
    """With a control plane (JAX's run local) and without (the port's
    earlier one)."""
    instance = str(tmp_path / "instance.yaml")
    code = port_main(["run", "local", str(app_dir), "-i", instance, "--gateway-port", "0",
                      "--control-plane-port", "0", "--metrics-port", "0", "--once"])
    lines = capsys.readouterr().out.splitlines()
    assert code == 0
    assert [ln.split(":", 1)[0] for ln in lines] == [
        "control plane", "web ui", "gateway", "metrics", "application"]
    assert lines[-1] == "application:   local-app (tenant default)"
    port_memory.MemoryBroker.reset()
    code = port_main(["run", "local", str(app_dir), "-i", instance, "--gateway-port", "0",
                      "--metrics-port", "-1", "--once"])
    lines = capsys.readouterr().out.splitlines()
    assert code == 0 and [ln.split(":", 1)[0] for ln in lines] == ["gateway", "application"]


def test_usage_errors_exit_2(tmp_path, capsys):
    for args in (["apps", "deploy", "x", "--app", str(tmp_path / "missing")],
                 ["configure", "nope", "v"], ["apps"], ["run", "local", str(tmp_path),
                                                       "-i", str(tmp_path)]):
        with pytest.raises(SystemExit) as e:
            port_main(args)
        assert e.value.code == 2
        assert CliRunner().invoke(jax_cli, args).exit_code == 2


def test_logs_follow_through_the_cli(clis, app_dir, tmp_path):
    """``apps logs -f [--filter]``: the live lines as ``[replica] message``
    until the app is deleted, which ends the stream and the command."""
    clis.run("port", "apps", "deploy", "fol", "--app", str(app_dir),
             "-i", str(tmp_path / "instance.yaml"))
    plane = clis.planes["port"]
    hub = plane.runtime.get_runner("default", "fol").log_hub
    out = {}

    def follow():
        from contextlib import redirect_stdout
        import io

        buf = io.StringIO()
        with redirect_stdout(buf):
            out["code"] = port_main(["apps", "logs", "fol", "-f", "--filter", "echo-0"])
        out["text"] = buf.getvalue()

    clis._monkeypatch.setenv("LANGSTREAM_TPU_CONFIG", str(clis._configs["port"]))
    t = threading.Thread(target=follow)
    t.start()
    time.sleep(0.5)
    plane.loop.call_soon_threadsafe(hub.emit, "other-0", "INFO", "not this one")
    plane.loop.call_soon_threadsafe(hub.emit, "echo-0", "INFO", "this one")
    time.sleep(0.3)
    from langstream_tpu_torch.cli.client import AdminClient

    AdminClient(plane.url).delete("fol")
    t.join(20)
    assert not t.is_alive() and out["code"] == 0
    assert out["text"] == "[echo-0] this one\n"


def test_gateway_commands(app_dir, tmp_path, monkeypatch, capsys):
    """``gateway produce`` / ``consume`` / ``chat`` over the port's
    websocket client against the port's gateway."""
    from langstream_tpu_torch.cli import config as port_config
    from langstream_tpu_torch.cli.main import start_local

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    app = asyncio.run_coroutine_threadsafe(start_local(
        app_dir, tmp_path / "instance.yaml", gateway_port=0, metrics_port=-1), loop).result(30)
    try:
        monkeypatch.setenv("LANGSTREAM_TPU_CONFIG", str(tmp_path / "cli.json"))
        port_config.save_config(port_config.CliConfig(profiles={"default": port_config.Profile(
            apiGatewayUrl=app.gateway.url)}))
        assert port_main(["gateway", "produce", "local-app", "-g", "in", "-v", "hello"]) == 0
        assert json.loads(capsys.readouterr().out)["status"] == "OK"
        assert port_main(["gateway", "consume", "local-app", "-g", "out", "--position",
                          "earliest", "-n", "1"]) == 0
        assert json.loads(capsys.readouterr().out)["record"]["value"] == "hello"
        monkeypatch.setattr(sys, "stdin", __import__("io").StringIO("ping\n"))
        assert port_main(["gateway", "chat", "local-app", "-g", "chat"]) == 0
        assert capsys.readouterr().out.splitlines() == [
            "connected — type a message, Ctrl-D to exit", "< ping"]
    finally:
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)


def test_docs_equals_the_rest_route(capsys):
    from langstream_tpu_torch.webservice.docs import generate_documentation_model

    assert port_main(["docs"]) == 0
    docs = json.loads(capsys.readouterr().out)
    assert docs == json.loads(json.dumps(generate_documentation_model(), default=str))
    assert "ai-chat-completions" in docs["agents"] and "tpu-serving" in docs["resources"]


# -- `python` commands (reference BasePythonCmd sandbox) -----------------------


AGENT = '''
from langstream_tpu_torch.api.agent import AgentProcessor, ProcessorResult
from langstream_tpu_torch.api.record import SimpleRecord


class Upper(AgentProcessor):
    async def process(self, records):
        return [
            ProcessorResult(source_record=r, records=[SimpleRecord.of(str(r.value).upper())])
            for r in records
        ]
'''

TEST_OK = '''
import asyncio
import unittest

from my_agent import Upper
from langstream_tpu_torch.api.record import SimpleRecord


class UpperTest(unittest.TestCase):
    def test_upper(self):
        out = asyncio.run(Upper().process([SimpleRecord.of("hi")]))
        self.assertEqual(out[0].records[0].value, "HI")
'''

TEST_FAIL = '''
import unittest


class Broken(unittest.TestCase):
    def test_broken(self):
        self.assertTrue(False)
'''


def _python_app(tmp_path, agent_body: str, test_body: str):
    app = tmp_path / "py-app"
    (app / "python").mkdir(parents=True)
    (app / "python" / "my_agent.py").write_text(agent_body)
    (app / "python" / "test_my_agent.py").write_text(test_body)
    return app


def _python_cli(pkg, *args):
    """A python command in a child process (its test runner's output goes
    to the child's stderr): (exit code, stdout, stderr)."""
    module = "langstream_tpu_torch.cli" if pkg == "port" else "langstream_tpu.cli"
    done = subprocess.run([sys.executable, "-m", module, "python", *args],
                          capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return done.returncode, done.stdout, done.stderr


def test_python_run_tests_passes(tmp_path):
    app = _python_app(tmp_path, AGENT, TEST_OK)
    code, out, err = _python_cli("port", "run-tests", "-app", str(app))
    assert code == 0, err
    assert out.splitlines()[-1] == "Tests passed"
    assert out == _python_cli("jax", "run-tests", "-app", str(app))[1]


def test_python_run_tests_fails_on_red(tmp_path):
    app = _python_app(tmp_path, AGENT, TEST_FAIL)
    code, _, err = _python_cli("port", "run-tests", "--application", str(app))
    assert code == 1 and err.splitlines()[-1] == "Error: tests exited with 1"


def test_python_run_tests_sees_lib_dir(tmp_path, capsys):
    app = _python_app(
        tmp_path, AGENT,
        "import unittest\nimport vendored_dep\n\n"
        "class T(unittest.TestCase):\n"
        "    def test_dep(self):\n"
        "        self.assertEqual(vendored_dep.VALUE, 41)\n",
    )
    lib = app / "python" / "lib"
    lib.mkdir()
    (lib / "vendored_dep.py").write_text("VALUE = 41\n")
    assert port_main(["python", "run-tests", "-app", str(app)]) == 0


def test_python_load_pip_requirements(tmp_path, capsys):
    """The pip plumbing: validates requirements.txt, runs the (stubbed) pip
    with --target lib, surfaces its exit code."""
    app = _python_app(tmp_path, AGENT, TEST_OK)
    (app / "python" / "requirements.txt").write_text("left-pad==1.0\n")
    recorder = tmp_path / "pip-args.json"
    stub = tmp_path / "fake_pip.py"
    stub.write_text(
        "import json, sys, pathlib\n"
        f"pathlib.Path({str(recorder)!r}).write_text(json.dumps(sys.argv[1:]))\n"
        "pathlib.Path('lib').mkdir(exist_ok=True)\n"
    )
    args = ["python", "load-pip-requirements", "-app", str(app),
            "--pip-command", f"{sys.executable} {stub}"]
    assert port_main(args) == 0
    port_out = capsys.readouterr().out
    got = json.loads(recorder.read_text())
    assert got[:3] == ["install", "--target", "lib"]
    assert "-r" in got and "requirements.txt" in got
    result = CliRunner().invoke(jax_cli, args)
    assert result.exit_code == 0 and result.stdout == port_out
    assert json.loads(recorder.read_text()) == got


def test_python_load_pip_requirements_missing_file(tmp_path, capsys):
    app = _python_app(tmp_path, AGENT, TEST_OK)
    args = ["python", "load-pip-requirements", "-app", str(app)]
    assert port_main(args) == 1
    err = capsys.readouterr().err
    assert "requirements.txt" in err
    result = CliRunner().invoke(jax_cli, args)
    assert result.exit_code == 1 and result.stderr == err


# -- end to end over real processes (tests/test_e2e_cli.py) --------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def platform_proc(tmp_path):
    """``run local`` with its control plane in a child process, serving the
    tpu-completions example on the CPU."""
    app = tmp_path / "tpu-completions"
    shutil.copytree(ROOT / "examples" / "applications" / "tpu-completions", app)
    conf = app / "configuration.yaml"
    conf.write_text(conf.read_text().replace("tokenizer: byte", "tokenizer: byte\n"
                                             "        device: cpu"))
    cp_port, gw_port = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), LANGSTREAM_TPU_CONFIG=str(tmp_path / "cfg.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch.cli", "run", "local", str(app),
         "-i", str(ROOT / "examples" / "instances" / "local-memory.yaml"),
         "--name", "e2e-app", "--control-plane-port", str(cp_port),
         "--gateway-port", str(gw_port), "--metrics-port", "-1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
    )
    base = f"http://127.0.0.1:{cp_port}"
    for _ in range(240):
        if proc.poll() is not None:
            pytest.fail(f"platform died: {proc.stdout.read()[-2000:]}")
        try:
            urllib.request.urlopen(f"{base}/healthz", timeout=1)
            urllib.request.urlopen(f"http://127.0.0.1:{gw_port}/healthz", timeout=1)
            break
        except Exception:
            time.sleep(0.25)
    else:
        proc.terminate()
        pytest.fail(f"platform never became healthy: {proc.stdout.read()[-2000:]}")
    yield {"cp": cp_port, "gw": gw_port, "env": env}
    proc.terminate()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()


def _cli(env, *args, stdin=None, timeout=120):
    return subprocess.run([sys.executable, "-m", "langstream_tpu_torch.cli", *args],
                          env=dict(env), input=stdin, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)


def test_cli_end_to_end(platform_proc):
    env, cp, gw = platform_proc["env"], platform_proc["cp"], platform_proc["gw"]
    for key, value in (("webServiceUrl", f"http://127.0.0.1:{cp}"),
                       ("apiGatewayUrl", f"http://127.0.0.1:{gw}")):
        r = _cli(env, "configure", key, value)
        assert r.returncode == 0, r.stderr
    r = _cli(env, "apps", "list")
    assert r.returncode == 0 and "e2e-app" in r.stdout
    desc = json.loads(_cli(env, "apps", "get", "e2e-app").stdout)
    assert desc["status"]["status"] == "DEPLOYED"
    body = urllib.request.urlopen(f"http://127.0.0.1:{cp}/api/docs", timeout=5).read()
    assert "ai-chat-completions" in json.loads(body)["agents"]
    r = _cli(env, "gateway", "chat", "e2e-app", "-g", "chat", "-p", "sessionId=e2e",
             stdin="hello\n")
    assert r.returncode == 0, r.stderr[-1000:]
    assert r.stdout.splitlines()[1].startswith("< ")  # an answer chunk came back
