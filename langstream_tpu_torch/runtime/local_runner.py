"""LocalApplicationRunner: the whole platform in one process (the port's
own copy of ``langstream_tpu/runtime/local_runner.py``, with its log hub:
``runtime/log_stream.py``).

Parity: reference `langstream-runtime-tester/LocalApplicationRunner.java:58,
125,175` — in-memory store, same planner path as production, one runner task
per agent replica, embedded gateway support. This is the testbed for every
tier-1/2 test and the engine behind `langstream-tpu run` local mode.
"""

from __future__ import annotations

import asyncio
import logging
import tempfile
from pathlib import Path
from typing import Any, Optional

from langstream_tpu_torch.api.metrics import MetricsReporter
from langstream_tpu_torch.api.model import Application
from langstream_tpu_torch.api.planner import ExecutionPlan
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.api.topics import TopicOffsetPosition
from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.core.planner import ClusterRuntime
from langstream_tpu_torch.messaging.registry import get_topic_connections_runtime
from langstream_tpu_torch.runtime.runner import AgentRunner, SimpleAgentContext

log = logging.getLogger(__name__)


class LocalApplicationRunner:
    def __init__(
        self,
        application_id: str,
        application: Application,
        tenant: str = "default",
        state_root: Optional[Path] = None,
    ) -> None:
        self.application_id = application_id
        self.application = application
        self.tenant = tenant
        self.metrics = MetricsReporter()
        self.plan: Optional[ExecutionPlan] = None
        self.runners: list[AgentRunner] = []
        self._tasks: list[asyncio.Task] = []
        self._state_root = state_root or Path(tempfile.mkdtemp(prefix="langstream-tpu-"))
        self._topic_runtime = None
        self._service_registry = None
        self._failed: Optional[BaseException] = None
        from langstream_tpu_torch.runtime.log_stream import LogHub

        self.log_hub = LogHub(application_id)
        self._log_handler = None

    # -- lifecycle ----------------------------------------------------------

    async def deploy(self) -> ExecutionPlan:
        """Plan + create topics + instantiate agent runners (deploy path of
        reference deployApplicationWithSecrets:125)."""
        streaming = self.application.instance.streaming_cluster
        self._topic_runtime = get_topic_connections_runtime(streaming.type)
        await self._topic_runtime.init(streaming.configuration)

        deployer = ApplicationDeployer(
            ClusterRuntime(),
            topic_admin_factory=self._topic_runtime.create_topic_admin,
        )
        self.plan = deployer.create_implementation(self.application_id, self.application)
        await deployer.setup(self.plan)
        await deployer.deploy_topics(self.plan)

        from langstream_tpu_torch.ai.provider import ServiceProviderRegistry

        assert self.plan.application is not None
        self._service_registry = ServiceProviderRegistry(self.plan.application)

        for node in self.plan.agent_sequence():
            replicas = node.resources.resolved_parallelism()
            for replica in range(replicas):
                context = SimpleAgentContext(
                    global_agent_id=f"{self.application_id}-{node.id}-{replica}",
                    tenant=self.tenant,
                    topic_runtime=self._topic_runtime,
                    metrics=self.metrics,
                    state_dir=self._state_root / node.id / str(replica)
                    if node.disk
                    else None,
                    service_registry=self._service_registry,
                    on_critical_failure=self._on_critical_failure,
                    code_directory=self.application.code_directory,
                )
                runner = AgentRunner(node, self._topic_runtime, context, replica)
                await runner.setup()
                self.runners.append(runner)
        return self.plan

    @property
    def topic_runtime(self):
        """The app's topic-connections runtime (available after deploy())."""
        return self._topic_runtime

    def serve_metrics(self, host: str = "127.0.0.1", port: int = 0):
        """Start the /metrics + /info observability server (reference
        AgentRunner.java:96-110 Jetty on :8080): the port's stdlib runtime
        HTTP server, serving on its own thread; ``stop()`` it when done."""
        from langstream_tpu_torch.runtime.http_server import RuntimeHttpServer

        server = RuntimeHttpServer(
            metrics_text=self.metrics.prometheus_text,
            agents_info=self.agents_info,
            host=host,
            port=port,
        )
        server.start()
        return server

    async def serve_gateway(self, host: str = "127.0.0.1", port: int = 0):
        """Start an API gateway bound to this application (the embedded
        gateway of reference LocalApplicationRunner / `langstream docker run`)."""
        from langstream_tpu_torch.gateway.server import DictApplicationProvider, GatewayServer

        assert self._topic_runtime is not None, "deploy() first"
        provider = DictApplicationProvider()
        provider.put(self.tenant, self.application_id, self.application, self._topic_runtime)
        server = GatewayServer(provider, host=host, port=port)
        await server.start()
        return server

    def _on_critical_failure(self, error: BaseException) -> None:
        self._failed = error
        for r in self.runners:
            r.stop()

    async def start(self) -> None:
        from langstream_tpu_torch.runtime.log_stream import install_hub

        self.log_hub.attach_loop(asyncio.get_running_loop())
        self._log_handler = install_hub(self.log_hub)
        self.log_hub.emit("app", "INFO", f"application {self.application_id} starting")
        for runner in self.runners:
            await runner.start()
        for runner in self.runners:
            self._tasks.append(asyncio.create_task(self._run_guarded(runner)))

    async def _run_guarded(self, runner: AgentRunner) -> None:
        from langstream_tpu_torch.runtime.log_stream import current_app_replica

        # tag this task's log records with (app, replica) — what makes the
        # control plane's /logs?filter=<replica> work without OS-level pods,
        # and what keeps one app's records out of another app's hub
        current_app_replica.set(
            (self.application_id, f"{runner.node.id}-{runner.replica}")
        )
        try:
            await runner.run()
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 — crash-only: stop everything
            log.error("agent %s crashed: %s", runner.node.id, e)
            self._failed = e
            for r in self.runners:
                r.stop()

    async def run(self) -> None:
        await self.deploy()
        await self.start()

    async def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        if drain:
            for runner in self.runners:
                try:
                    await runner.wait_for_no_pending_records(timeout)
                except TimeoutError as e:
                    log.warning("%s", e)
        for runner in self.runners:
            runner.stop()
        for task in self._tasks:
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        for runner in self.runners:
            await runner.close()
        if self._log_handler is not None:
            from langstream_tpu_torch.runtime.log_stream import remove_hub

            remove_hub(self._log_handler)
            self._log_handler = None
        self.log_hub.close()  # every follow stream of this run ends
        if self._service_registry is not None:
            await self._service_registry.close()
        if self._topic_runtime is not None:
            await self._topic_runtime.close()
        if self._failed is not None:
            raise RuntimeError(f"application failed: {self._failed}") from self._failed

    # -- test/gateway helpers ----------------------------------------------

    async def produce(
        self, topic: str, value: Any, key: Any = None, headers: Any = None
    ) -> None:
        assert self._topic_runtime is not None, "deploy() first"
        producer = self._topic_runtime.create_producer("local-runner", topic)
        await producer.start()
        await producer.write(SimpleRecord.of(value, key=key, headers=headers))
        await producer.close()

    async def consume(
        self, topic: str, n: int = 1, timeout: float = 5.0
    ) -> list[Record]:
        """Read n records from a topic (earliest), for tests and demos."""
        assert self._topic_runtime is not None, "deploy() first"
        reader = self._topic_runtime.create_reader(
            topic, TopicOffsetPosition(position="earliest")
        )
        await reader.start()
        out: list[Record] = []
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while len(out) < n:
            if loop.time() > deadline:
                raise TimeoutError(
                    f"got {len(out)}/{n} records from {topic} within {timeout}s"
                )
            result = await reader.read()
            out.extend(result.records)
        return out

    def agents_info(self) -> list[dict[str, Any]]:
        return [r.info() for r in self.runners]

    async def wait_for_records_out(
        self, agent_id: str, n: int, timeout: float = 5.0
    ) -> None:
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while True:
            total = sum(
                r._records_out for r in self.runners if r.node.id == agent_id
            )
            if total >= n:
                return
            if loop.time() > deadline:
                raise TimeoutError(f"agent {agent_id}: {total}/{n} records out")
            await asyncio.sleep(0.01)
