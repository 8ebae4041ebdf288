"""The port's command line (the port's own copy of
``langstream_tpu/cli/main.py``, on argparse: the card's machine has no
click). The same commands, options and output:

    python -m langstream_tpu_torch.cli [--tenant T] <command> ...

    configure webServiceUrl|apiGatewayUrl|tenant|token <value>
    profiles list | create <name> [--web-service-url U] [--api-gateway-url U]
             [--tenant T] [--token T] | use <name> | delete <name>
    apps deploy <name> --app <dir> [-i instance] [-s secrets] [--dry-run]
    apps update <name> --app <dir> [-i instance] [-s secrets]
    apps get <name> [-o json|mermaid] | list | delete <name>
    apps logs <name> [-f] [--filter <replica>] | download <name> [-o file]
    tenants put|get|delete <name> | list
    archetypes list | get <id> | deploy <id> <name> [-p key=value ...]
    docs
    gateway chat|produce|consume <application> -g <gateway> [-p key=value ...]
    python load-pip-requirements|run-tests -app <dir>
    run local <app-dir> -i <instance.yaml> [-s <secrets.yaml>] [--name local-app]
        [--gateway-port 8091] [--control-plane-port P] [--metrics-port 8080] [--once]

A command that fails prints ``Error: <text>`` on stderr and exits 1, as a
click command's ``ClickException`` does; a usage error exits 2.

``run local`` parses the application directory, deploys it on a local
runner over the in-memory broker, starts the chat / produce / consume
gateway and the ``/metrics`` + ``/info`` server, and serves until
interrupted (``--once``: start, print the addresses, stop). With
``--control-plane-port`` it first starts the control plane (REST,
``webservice/``) and deploys the application through it, as the JAX
package's ``run local`` always does; without it no control plane runs. A
``tpu-serving`` resource runs on the card unless its configuration says
``device: cpu``. The application's ``${secrets.*}`` / ``${globals.*}``
placeholders are resolved before the runner and the gateway take it, so a
gateway's authentication settings (say ``client-id:
"${secrets.google.client-id}"``) are the resolved values.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shlex
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from langstream_tpu_torch.cli.client import AdminClient, AdminClientError
from langstream_tpu_torch.cli.config import Profile, load_config, save_config

TENANT = "default"


class CliError(Exception):
    """A command's failure: ``Error: <text>`` on stderr, exit code 1
    (click's ``ClickException``)."""


def _client(args: argparse.Namespace) -> AdminClient:
    profile = load_config().profile
    tenant = args.tenant or profile.tenant
    return AdminClient(profile.webServiceUrl, tenant=tenant, token=profile.token)


def _echo_json(data: Any) -> None:
    print(json.dumps(data, indent=2, default=str), flush=True)


def _parse_params(params: Optional[list[str]]) -> dict[str, str]:
    out = {}
    for p in params or []:
        key, _, value = p.partition("=")
        out[key] = value
    return out


# -- configure / profiles ----------------------------------------------------


def configure(args: argparse.Namespace) -> None:
    config = load_config()
    profile = config.profiles.setdefault(config.current_profile, Profile())
    setattr(profile, args.key, args.value)
    save_config(config)
    print(f"profile {config.current_profile}: {args.key} = {args.value}")


def profiles_list(args: argparse.Namespace) -> None:
    config = load_config()
    for name, profile in config.profiles.items():
        marker = "*" if name == config.current_profile else " "
        print(f"{marker} {name}: {profile.webServiceUrl} (tenant={profile.tenant})")


def profiles_create(args: argparse.Namespace) -> None:
    config = load_config()
    config.profiles[args.name] = Profile(
        args.web_service_url, args.api_gateway_url, args.profile_tenant, args.token
    )
    save_config(config)
    print(f"created profile {args.name}")


def profiles_use(args: argparse.Namespace) -> None:
    config = load_config()
    if args.name not in config.profiles:
        raise CliError(f"no profile named {args.name!r}")
    config.current_profile = args.name
    save_config(config)
    print(f"using profile {args.name}")


def profiles_delete(args: argparse.Namespace) -> None:
    config = load_config()
    config.profiles.pop(args.name, None)
    if config.current_profile == args.name:
        config.current_profile = "default"
    save_config(config)
    print(f"deleted profile {args.name}")


# -- apps --------------------------------------------------------------------


def apps_deploy(args: argparse.Namespace) -> None:
    _echo_json(_client(args).deploy(args.name, args.app_dir, args.instance, args.secrets,
                                    dry_run=args.dry_run))


def apps_update(args: argparse.Namespace) -> None:
    _echo_json(_client(args).deploy(args.name, args.app_dir, args.instance, args.secrets,
                                    update=True))


def mermaid_from_zip(data: bytes) -> str:
    """The diagram of an application's code archive: its YAML files parsed
    without instance or secrets (``apps get -o mermaid``)."""
    import io
    import zipfile

    from langstream_tpu_torch.cli.mermaid import generate_mermaid
    from langstream_tpu_torch.core.parser import ModelBuilder

    zf = zipfile.ZipFile(io.BytesIO(data))
    files = {n: zf.read(n).decode() for n in zf.namelist() if n.endswith((".yaml", ".yml"))}
    return generate_mermaid(ModelBuilder.build_application_from_files(files, None, None)
                            .application)


def apps_get(args: argparse.Namespace) -> None:
    if args.output == "mermaid":
        print(mermaid_from_zip(_client(args).download(args.name)))
    else:
        _echo_json(_client(args).get(args.name))


def apps_list(args: argparse.Namespace) -> None:
    _echo_json(_client(args).list())


def apps_delete(args: argparse.Namespace) -> None:
    _echo_json(_client(args).delete(args.name))


def apps_logs(args: argparse.Namespace) -> None:
    if not args.follow:
        print(_client(args).logs(args.name, args.replica))
        return
    try:
        for entry in _client(args).follow_logs(args.name, args.replica):
            print(f"[{entry.get('replica', '?')}] {entry.get('message', '')}", flush=True)
    except KeyboardInterrupt:
        pass


def apps_download(args: argparse.Namespace) -> None:
    data = _client(args).download(args.name)
    target = Path(args.output or f"{args.name}.zip")
    target.write_bytes(data)
    print(f"wrote {target} ({len(data)} bytes)")


# -- tenants / archetypes / docs ---------------------------------------------


def tenants_put(args: argparse.Namespace) -> None:
    _echo_json(_client(args).tenant_put(args.name))


def tenants_get(args: argparse.Namespace) -> None:
    _echo_json(_client(args).tenant_get(args.name))


def tenants_delete(args: argparse.Namespace) -> None:
    _echo_json(_client(args).tenant_delete(args.name))


def tenants_list(args: argparse.Namespace) -> None:
    _echo_json(_client(args).tenant_list())


def archetypes_list(args: argparse.Namespace) -> None:
    _echo_json(_client(args).archetype_list())


def archetypes_get(args: argparse.Namespace) -> None:
    _echo_json(_client(args).archetype_get(args.archetype_id))


def archetypes_deploy(args: argparse.Namespace) -> None:
    _echo_json(_client(args).archetype_deploy(args.archetype_id, args.name,
                                              _parse_params(args.params)))


def docs(args: argparse.Namespace) -> None:
    """Dump the agent/resource/asset configuration catalog as JSON
    (reference DocumentationGeneratorStarter)."""
    from langstream_tpu_torch.webservice.docs import generate_documentation_model

    _echo_json(generate_documentation_model())


# -- gateway -----------------------------------------------------------------


def _gateway_ws_url(args: argparse.Namespace, kind: str) -> str:
    from urllib.parse import quote

    profile = load_config().profile
    tenant = args.tenant or profile.tenant
    base = profile.apiGatewayUrl.replace("http://", "ws://").replace("https://", "wss://")
    url = f"{base}/v1/{kind}/{tenant}/{args.application}/{args.gateway_id}"
    query = [f"param:{quote(k)}={quote(v, safe='')}"
             for k, v in _parse_params(args.params).items()]
    if args.credentials:
        query.append(f"credentials={quote(args.credentials, safe='')}")
    if query:
        url += "?" + "&".join(query)
    return url


def gateway_chat(args: argparse.Namespace) -> None:
    """Interactive chat REPL over the chat gateway (ChatGatewayCmd)."""
    from langstream_tpu_torch.gateway.websocket import connect

    url = _gateway_ws_url(args, "chat")

    async def repl() -> None:
        ws = await connect(url)
        try:
            print("connected — type a message, Ctrl-D to exit", flush=True)
            loop = asyncio.get_running_loop()
            while True:
                try:
                    line = await loop.run_in_executor(None, sys.stdin.readline)
                except (EOFError, KeyboardInterrupt):
                    break
                if not line:
                    break
                await ws.send_str(json.dumps({"value": line.strip()}))
                msg = await ws.receive()
                if msg.kind != "text":
                    break
                record = json.loads(msg.data).get("record", {})
                print(f"< {record.get('value')}", flush=True)
        finally:
            await ws.close()

    asyncio.run(repl())


def gateway_produce(args: argparse.Namespace) -> None:
    from langstream_tpu_torch.gateway.websocket import connect

    url = _gateway_ws_url(args, "produce")

    async def produce() -> None:
        ws = await connect(url)
        try:
            await ws.send_str(json.dumps({"value": args.value, "key": args.key}))
            msg = await ws.receive()
            print(msg.data)
        finally:
            await ws.close()

    asyncio.run(produce())


def gateway_consume(args: argparse.Namespace) -> None:
    from langstream_tpu_torch.gateway.websocket import connect

    url = _gateway_ws_url(args, "consume")
    url += ("&" if "?" in url else "?") + f"option:position={args.position}"

    async def consume() -> None:
        seen = 0
        ws = await connect(url)
        try:
            async for msg in ws:
                if msg.kind != "text":
                    break
                print(msg.data, flush=True)
                seen += 1
                if args.count and seen >= args.count:
                    break
        finally:
            await ws.close()

    asyncio.run(consume())


# -- python ------------------------------------------------------------------


def _python_dir(app_path: str) -> Path:
    python_dir = Path(app_path) / "python"
    if not python_dir.is_dir():
        raise CliError(f"{python_dir} not found — not an application with python agents")
    return python_dir


def load_pip_requirements(args: argparse.Namespace) -> None:
    """Install python/requirements.txt into python/lib — the directory the
    runtime puts on the agent's path (reference
    LoadPythonDependenciesCmd.java: pip install --target ./lib)."""
    python_dir = _python_dir(args.app_path)
    requirements = python_dir / "requirements.txt"
    if not requirements.is_file():
        raise CliError(f"{requirements} not found")
    cmd = [*shlex.split(args.pip_command), "install", "--target", "lib", "--upgrade",
           "--prefer-binary", "-r", "requirements.txt"]
    print(f"Running: {' '.join(cmd)} (in {python_dir})", flush=True)
    proc = subprocess.run(cmd, cwd=python_dir)
    if proc.returncode != 0:
        raise CliError(f"pip exited with {proc.returncode}")
    print(f"Dependencies installed in {python_dir / 'lib'}")


def python_run_tests(args: argparse.Namespace) -> None:
    """Run the application's python agent tests with the sandbox path
    layout: python/ + python/lib + the platform SDK on PYTHONPATH."""
    python_dir = _python_dir(args.app_path)
    sdk_root = str(Path(__file__).resolve().parents[2])  # langstream_tpu_torch's parent
    env = dict(os.environ)
    entries = [str(python_dir), str(python_dir / "lib"), sdk_root]
    if env.get("PYTHONPATH"):
        entries.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(entries)
    print(f"Running: {args.test_command} (in {python_dir})", flush=True)
    proc = subprocess.run(shlex.split(args.test_command), cwd=python_dir, env=env)
    if proc.returncode != 0:
        raise CliError(f"tests exited with {proc.returncode}")
    print("Tests passed")


# -- run local ---------------------------------------------------------------


@dataclass
class LocalApp:
    """One application running in this process: its runner, its gateway,
    its metrics server (None when disabled) and, when one was asked for,
    the control plane that deployed it and its runtime manager."""

    name: str
    runner: Any
    gateway: Any
    metrics: Any
    control_plane: Any = None
    runtime: Any = None

    async def stop(self) -> None:
        if self.metrics is not None:
            self.metrics.stop()
        await self.gateway.stop()
        if self.runtime is not None:
            await self.runtime.close()
            await self.control_plane.stop()
        else:
            await self.runner.stop()


async def start_local(
    app_dir: str | Path,
    instance: Optional[str | Path] = None,
    secrets: Optional[str | Path] = None,
    name: str = "local-app",
    gateway_port: int = 8091,
    metrics_port: int = 8080,
    host: str = "127.0.0.1",
    control_plane_port: Optional[int] = None,
) -> LocalApp:
    """Parse, deploy and start the application and its servers, in the
    order of ``run local``; port 0 binds a free port (read back from the
    servers' ``port``), a metrics port below 0 disables that server. With
    ``control_plane_port`` the control plane starts first and deploys the
    application (``ApplicationService.deploy``); the gateway then serves
    the runner its runtime manager holds (JAX's ``run local``: an update
    through the control plane replaces that runner, and this gateway keeps
    the first deploy's application and topics)."""
    from langstream_tpu_torch.gateway.server import DictApplicationProvider, GatewayServer

    if control_plane_port is not None:
        from langstream_tpu_torch.webservice.server import ControlPlaneServer
        from langstream_tpu_torch.webservice.service import make_local_service

        applications, tenant_service, runtime = make_local_service(None)
        control_plane = ControlPlaneServer(applications, tenant_service, host=host,
                                           port=control_plane_port)
        await control_plane.start()
        try:
            await applications.deploy(
                TENANT, name, AdminClient.zip_app_dir(app_dir),
                Path(instance).read_text() if instance else None,
                Path(secrets).read_text() if secrets else None,
            )
            runner = runtime.get_runner(TENANT, name)
            provider = DictApplicationProvider()
            provider.put(TENANT, name, runner.application, runner.topic_runtime)
            gateway = GatewayServer(provider, host=host, port=gateway_port)
            await gateway.start()
        except BaseException:
            await runtime.close()
            await control_plane.stop()
            raise
        metrics = runner.serve_metrics(host=host, port=metrics_port) if metrics_port >= 0 else None
        return LocalApp(name, runner, gateway, metrics, control_plane, runtime)

    from langstream_tpu_torch.core.parser import ModelBuilder
    from langstream_tpu_torch.core.resolver import resolve_placeholders
    from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner

    package = ModelBuilder.build_application_from_path(
        app_dir, instance_path=instance, secrets_path=secrets
    )
    application = resolve_placeholders(package.application)
    runner = LocalApplicationRunner(name, application, tenant=TENANT)
    try:
        await runner.deploy()
        await runner.start()
        gateway = await runner.serve_gateway(host=host, port=gateway_port)
    except BaseException:
        await runner.stop(drain=False)
        raise
    metrics = runner.serve_metrics(host=host, port=metrics_port) if metrics_port >= 0 else None
    return LocalApp(name, runner, gateway, metrics)


async def _run_local(args: argparse.Namespace) -> None:
    app = await start_local(
        args.app_dir, args.instance, args.secrets, args.name, args.gateway_port,
        args.metrics_port, control_plane_port=args.control_plane_port,
    )
    if app.control_plane is not None:
        url = app.control_plane.url
        print(f"control plane: {url}", flush=True)
        print(f"web ui:        {url}/ui?gateway={app.gateway.url}", flush=True)
    print(f"gateway:       {app.gateway.url}", flush=True)
    if app.metrics is not None:
        print(f"metrics:       {app.metrics.url}/metrics", flush=True)
    print(f"application:   {app.name} (tenant {TENANT})", flush=True)
    try:
        if not args.once:
            while True:  # serve until interrupted
                await asyncio.sleep(3600)
    except asyncio.CancelledError:
        pass
    finally:
        await app.stop()


def run_local(args: argparse.Namespace) -> None:
    """Whole platform in one process: runtime + gateway (+ control plane)
    (reference `langstream docker run` / runtime-tester)."""
    try:
        asyncio.run(_run_local(args))
    except KeyboardInterrupt:
        pass


# -- the parser --------------------------------------------------------------


def _existing(kind: str, is_dir: bool):
    """An argparse type: a path that exists, as a directory or a file."""

    def check(value: str) -> str:
        p = Path(value)
        if not p.exists():
            raise argparse.ArgumentTypeError(f"{kind} {value!r} does not exist.")
        if p.is_dir() != is_dir:
            raise argparse.ArgumentTypeError(
                f"{kind} {value!r} is a {'file' if is_dir else 'directory'}.")
        return value

    return check


def parser() -> argparse.ArgumentParser:
    directory, file = _existing("Directory", True), _existing("File", False)
    top = argparse.ArgumentParser(prog="python -m langstream_tpu_torch.cli",
                                  description="TPU-native streaming Gen-AI platform CLI.")
    top.add_argument("--tenant", default=None, help="override the profile tenant")
    commands = top.add_subparsers(dest="command", required=True)

    def group(name: str, help_: str) -> argparse._SubParsersAction:
        sub = commands.add_parser(name, help=help_)
        return sub.add_subparsers(dest="subcommand", required=True)

    def command(where, name: str, fn, help_: Optional[str] = None) -> argparse.ArgumentParser:
        p = where.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        return p

    p = command(commands, "configure", configure, "set a value on the current profile")
    p.add_argument("key", choices=["webServiceUrl", "apiGatewayUrl", "tenant", "token"])
    p.add_argument("value")

    profiles = group("profiles", "manage named connection profiles")
    command(profiles, "list", profiles_list)
    p = command(profiles, "create", profiles_create)
    p.add_argument("name")
    p.add_argument("--web-service-url", default="http://localhost:8090")
    p.add_argument("--api-gateway-url", default="http://localhost:8091")
    p.add_argument("--tenant", dest="profile_tenant", default="default")
    p.add_argument("--token", default=None)
    for name, fn in (("use", profiles_use), ("delete", profiles_delete)):
        command(profiles, name, fn).add_argument("name")

    apps = group("apps", "deploy and manage applications")
    for name, fn in (("deploy", apps_deploy), ("update", apps_update)):
        p = command(apps, name, fn)
        p.add_argument("name")
        p.add_argument("--app", dest="app_dir", required=True, type=directory)
        p.add_argument("--instance", "-i", type=file)
        p.add_argument("--secrets", "-s", type=file)
        if name == "deploy":
            p.add_argument("--dry-run", action="store_true")
    p = command(apps, "get", apps_get)
    p.add_argument("name")
    p.add_argument("-o", dest="output", choices=["json", "mermaid"], default="json")
    command(apps, "list", apps_list)
    command(apps, "delete", apps_delete).add_argument("name")
    p = command(apps, "logs", apps_logs)
    p.add_argument("name")
    p.add_argument("-f", "--follow", action="store_true", help="stream logs live (NDJSON follow)")
    p.add_argument("--filter", dest="replica", default="", help="only this agent replica")
    p = command(apps, "download", apps_download)
    p.add_argument("name")
    p.add_argument("-o", dest="output", default=None)

    tenants = group("tenants", "manage tenants")
    for name, fn in (("put", tenants_put), ("get", tenants_get), ("delete", tenants_delete)):
        command(tenants, name, fn).add_argument("name")
    command(tenants, "list", tenants_list)

    archetypes = group("archetypes", "browse and instantiate application archetypes")
    command(archetypes, "list", archetypes_list)
    command(archetypes, "get", archetypes_get).add_argument("archetype_id")
    p = command(archetypes, "deploy", archetypes_deploy)
    p.add_argument("archetype_id")
    p.add_argument("name")
    p.add_argument("--param", "-p", dest="params", action="append", help="key=value")

    command(commands, "docs", docs, "dump the configuration catalog as JSON")

    gateway = group("gateway", "interact with application gateways")
    for name, fn in (("chat", gateway_chat), ("produce", gateway_produce),
                     ("consume", gateway_consume)):
        p = command(gateway, name, fn)
        p.add_argument("application")
        p.add_argument("--gateway", "-g", dest="gateway_id", required=True)
        p.add_argument("--param", "-p", dest="params", action="append", help="key=value")
        p.add_argument("--credentials", default=None)
        if name == "produce":
            p.add_argument("--value", "-v", required=True)
            p.add_argument("--key", "-k", default=None)
        if name == "consume":
            p.add_argument("--position", default="latest")
            p.add_argument("-n", dest="count", type=int, default=0,
                           help="stop after N messages (0 = forever)")

    python = group("python", "work with an application's python agents")
    p = command(python, "load-pip-requirements", load_pip_requirements)
    p.add_argument("--application", "-app", dest="app_path", required=True, type=directory)
    p.add_argument("--pip-command", default=f"{shlex.quote(sys.executable)} -m pip",
                   help="override the pip invocation")
    p = command(python, "run-tests", python_run_tests)
    p.add_argument("--application", "-app", dest="app_path", required=True, type=directory)
    p.add_argument("--command", "-c", dest="test_command",
                   default=f"{shlex.quote(sys.executable)} -m unittest",
                   help="test runner to execute (reference PythonRunTests.java)")

    run = group("run", "run applications locally")
    p = command(run, "local", run_local, "the whole application in one process")
    p.add_argument("app_dir", type=directory, help="the application directory")
    p.add_argument("-i", "--instance", type=file, help="instance.yaml")
    p.add_argument("-s", "--secrets", type=file, help="secrets.yaml")
    p.add_argument("--name", default="local-app")
    p.add_argument("--gateway-port", type=int, default=8091)
    p.add_argument("--control-plane-port", type=int, default=None,
                   help="start the control plane on this port and deploy through it")
    p.add_argument("--metrics-port", type=int, default=8080,
                   help="/metrics + /info port (-1 disables)")
    p.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    return top


def main(argv: Optional[list[str]] = None) -> int:
    args = parser().parse_args(argv)
    try:
        args.fn(args)
    except (CliError, AdminClientError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
