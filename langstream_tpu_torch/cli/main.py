"""The port's command line: ``run local``, the counterpart of the JAX
package's ``langstream_tpu/cli/main.py`` ``run local`` without the control
plane (argparse: the card's machine has no click).

    python -m langstream_tpu_torch.cli run local <app-dir> -i <instance.yaml>
        [-s <secrets.yaml>] [--name local-app] [--gateway-port 8091]
        [--metrics-port 8080] [--once]

It parses the application directory, deploys it on a local runner over the
in-memory broker, starts the chat / produce / consume gateway and the
``/metrics`` + ``/info`` server, and serves until interrupted (``--once``:
start, print the addresses, stop). A ``tpu-serving`` resource runs on the
card unless its configuration says ``device: cpu``. The application's
``${secrets.*}`` / ``${globals.*}`` placeholders are resolved before the
runner and the gateway take it, so a gateway's authentication settings
(say ``client-id: "${secrets.google.client-id}"``) are the resolved values
(JAX's ``run local`` hands its gateway the stored, unresolved application).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

TENANT = "default"


@dataclass
class LocalApp:
    """One application running in this process: its runner, its gateway
    and its metrics server (None when disabled)."""

    name: str
    runner: Any
    gateway: Any
    metrics: Any

    async def stop(self) -> None:
        if self.metrics is not None:
            self.metrics.stop()
        await self.gateway.stop()
        await self.runner.stop()


async def start_local(
    app_dir: str | Path,
    instance: Optional[str | Path] = None,
    secrets: Optional[str | Path] = None,
    name: str = "local-app",
    gateway_port: int = 8091,
    metrics_port: int = 8080,
    host: str = "127.0.0.1",
) -> LocalApp:
    """Parse, deploy and start the application and its servers, in the
    order of ``run local``; port 0 binds a free port (read back from the
    servers' ``port``), a metrics port below 0 disables that server."""
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


async def run_local(args: argparse.Namespace) -> None:
    app = await start_local(
        args.app_dir, args.instance, args.secrets, args.name, args.gateway_port,
        args.metrics_port,
    )
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


def parser() -> argparse.ArgumentParser:
    top = argparse.ArgumentParser(prog="python -m langstream_tpu_torch.cli")
    commands = top.add_subparsers(dest="command", required=True)
    run = commands.add_parser("run", help="run applications")
    modes = run.add_subparsers(dest="mode", required=True)
    local = modes.add_parser("local", help="the whole application in one process")
    local.add_argument("app_dir", help="the application directory")
    local.add_argument("-i", "--instance", help="instance.yaml")
    local.add_argument("-s", "--secrets", help="secrets.yaml")
    local.add_argument("--name", default="local-app")
    local.add_argument("--gateway-port", type=int, default=8091)
    local.add_argument("--metrics-port", type=int, default=8080,
                       help="/metrics + /info port (-1 disables)")
    local.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    return top


def main(argv: Optional[list[str]] = None) -> int:
    args = parser().parse_args(argv)
    app_dir = Path(args.app_dir)
    if not app_dir.is_dir():
        print(f"error: {app_dir} is not a directory", file=sys.stderr)
        return 2
    for path in (args.instance, args.secrets):
        if path is not None and not Path(path).is_file():
            print(f"error: {path} is not a file", file=sys.stderr)
            return 2
    try:
        asyncio.run(run_local(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
