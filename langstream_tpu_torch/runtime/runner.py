"""AgentRunner — the hot loop: read → process → write → ordered commit.

Parity: reference `runtime/agent/AgentRunner.java:85` (main loop :651-730,
error routing :627-649,856-943, service bypass :416-421, graceful drain
waitForNoPendingRecords:562). Single logical consumer, async fan-out on
completions, ordering enforced only at commit time via SourceRecordTracker +
the consumer's contiguous-prefix offsets.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Optional

from langstream_tpu_torch.api.agent import (
    AgentCode,
    AgentContext,
    AgentProcessor,
    AgentService,
    AgentSink,
    AgentSource,
    ProcessorResult,
)
from langstream_tpu_torch.api.metrics import MetricsReporter
from langstream_tpu_torch.api.planner import AgentNode, Connection
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.tracing import TRACE_HEADER, TRACER, record_trace_id
from langstream_tpu_torch.api.topics import TopicConnectionsRuntime
from langstream_tpu_torch.core.registry import REGISTRY
from langstream_tpu_torch.runtime.composite import CompositeAgentProcessor
from langstream_tpu_torch.runtime.errors import (
    ErrorsProcessingOutcome,
    PermanentFailureError,
    StandardErrorsHandler,
)
from langstream_tpu_torch.runtime.topic_adapters import TopicConsumerSource, TopicProducerSink
from langstream_tpu_torch.runtime.tracker import SourceRecordTracker

log = logging.getLogger(__name__)


class IdentityProcessor(AgentProcessor):
    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        return [ProcessorResult.ok(r, [r]) for r in records]


class _LazyStartProducer:
    """Starts the wrapped producer on first write; closed by the context.

    Lets agents grab side-channel producers synchronously from AgentContext
    while honoring the TopicProducer start/close lifecycle contract.
    """

    def __init__(self, producer) -> None:
        self._producer = producer
        self._started = False

    async def start(self) -> None:
        if not self._started:
            await self._producer.start()
            self._started = True

    async def write(self, record: Record) -> None:
        if not self._started:
            await self.start()
        # stream-to-topic writes happen inside the agent's process span
        # (contextvars flow through the asyncio task), so side-channel
        # records — e.g. completion chunks — join the record's trace too
        trace_id = TRACER.current_trace_id()
        if trace_id is not None and record_trace_id(record) is None:
            record = SimpleRecord.copy_from(record).with_headers(
                [(TRACE_HEADER, trace_id)]
            )
        await self._producer.write(record)

    async def close(self) -> None:
        if self._started:
            await self._producer.close()
            self._started = False

    @property
    def total_in(self) -> int:
        return self._producer.total_in


class SimpleAgentContext(AgentContext):
    """Runtime context handed to agents (reference SimpleAgentContext)."""

    def __init__(
        self,
        global_agent_id: str,
        tenant: str,
        topic_runtime: TopicConnectionsRuntime,
        metrics: MetricsReporter,
        state_dir: Optional[Path] = None,
        service_registry: Any = None,
        on_critical_failure: Optional[Callable[[BaseException], None]] = None,
        code_directory: Optional[str] = None,
    ) -> None:
        self._global_agent_id = global_agent_id
        self._tenant = tenant
        self._topic_runtime = topic_runtime
        self._metrics = metrics
        self._state_dir = state_dir
        self._service_registry = service_registry
        self._on_critical_failure = on_critical_failure
        self._producers: dict[str, Any] = {}
        self._code_directory = code_directory

    def get_code_directory(self) -> Optional[str]:
        return self._code_directory

    def get_global_agent_id(self) -> str:
        return self._global_agent_id

    def get_tenant(self) -> str:
        return self._tenant

    def get_persistent_state_directory(self) -> Optional[Path]:
        if self._state_dir is not None:
            self._state_dir.mkdir(parents=True, exist_ok=True)
        return self._state_dir

    def get_topic_producer(self, topic: str):
        if topic not in self._producers:
            self._producers[topic] = _LazyStartProducer(
                self._topic_runtime.create_producer(self._global_agent_id, topic)
            )
        return self._producers[topic]

    async def close(self) -> None:
        for producer in self._producers.values():
            await producer.close()
        self._producers.clear()

    def get_topic_consumer(self, topic: str):
        return self._topic_runtime.create_consumer(self._global_agent_id, topic)

    def get_topic_admin(self):
        return self._topic_runtime.create_topic_admin()

    def get_metrics_reporter(self) -> MetricsReporter:
        return self._metrics

    def get_service_provider_registry(self) -> Any:
        return self._service_registry

    def critical_failure(self, error: BaseException) -> None:
        log.error("critical agent failure: %s", error)
        if self._on_critical_failure is not None:
            self._on_critical_failure(error)


class AgentRunner:
    """Runs one physical agent node (one replica)."""

    def __init__(
        self,
        node: AgentNode,
        topic_runtime: TopicConnectionsRuntime,
        context: SimpleAgentContext,
        replica: int = 0,
    ) -> None:
        self.node = node
        self.topic_runtime = topic_runtime
        self.context = context
        self.replica = replica
        self.source: Optional[AgentSource] = None
        self.processor: AgentProcessor = IdentityProcessor()
        self.sink: Optional[AgentSink] = None
        self.service: Optional[AgentService] = None
        self.errors_handler = StandardErrorsHandler(node.errors)
        self.tracker: Optional[SourceRecordTracker] = None
        self._stop = asyncio.Event()
        self._started = False
        self._records_in = 0
        self._records_out = 0
        self._last_error: Optional[BaseException] = None
        metrics = context.get_metrics_reporter().with_prefix(f"agent_{node.id}")
        self._m_in = metrics.counter("source_out_total", "records read from source")
        self._m_out = metrics.counter("sink_in_total", "records written to sink")
        self._m_err = metrics.counter("errors_total", "record processing failures")

    # -- wiring -------------------------------------------------------------

    async def setup(self) -> None:
        """Instantiate agent code and wire source/processor/sink
        (reference AgentRunner.java:319-358)."""
        sources: list[AgentSource] = []
        processors: list[AgentProcessor] = []
        sinks: list[AgentSink] = []
        for logical in self.node.logical_agents():
            info = REGISTRY.agent(logical.agent_type)
            code: AgentCode = info.factory()
            code.agent_id = logical.id
            code.agent_type = logical.agent_type
            code.set_context(self.context)
            await code.init(logical.configuration)
            if isinstance(code, AgentSource):
                sources.append(code)
            elif isinstance(code, AgentSink):
                sinks.append(code)
            elif isinstance(code, AgentService):
                self.service = code
            elif isinstance(code, AgentProcessor):
                processors.append(code)
            else:
                raise TypeError(f"agent {logical.id} is not a valid AgentCode")

        if len(sources) > 1 or len(sinks) > 1:
            raise ValueError(f"agent node {self.node.id} has multiple sources or sinks")

        if sources:
            self.source = sources[0]
        elif self.node.input is not None and self.node.input.kind == Connection.TOPIC:
            topic = self.node.input.topic
            consumer = self.topic_runtime.create_consumer(
                self.node.id, topic, {"group": self.node.id}
            )
            dead_letter = None
            if self.node.errors.resolved_on_failure() == "dead-letter":
                dead_letter = self.topic_runtime.create_producer(
                    self.node.id, f"{topic}-deadletter"
                )
            self.source = TopicConsumerSource(consumer, dead_letter)

        if len(processors) == 1:
            self.processor = processors[0]
        elif processors:
            self.processor = CompositeAgentProcessor(processors)
            self.processor.set_context(self.context)

        if sinks:
            self.sink = sinks[0]
        elif self.node.output is not None and self.node.output.kind == Connection.TOPIC:
            producer = self.topic_runtime.create_producer(self.node.id, self.node.output.topic)
            self.sink = TopicProducerSink(producer, self.context.get_topic_producer)

        self.tracker = SourceRecordTracker(self.source)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self.source is not None:
            await self.source.start()
        await self.processor.start()
        if self.sink is not None:
            await self.sink.start()
        if self.service is not None:
            await self.service.start()
        self._started = True

    async def close(self) -> None:
        if self.service is not None:
            await self.service.close()
        if self.sink is not None:
            await self.sink.close()
        await self.processor.close()
        if self.source is not None:
            await self.source.close()
        await self.context.close()
        self._started = False

    def stop(self) -> None:
        self._stop.set()

    # -- main loop ----------------------------------------------------------

    async def run(self, max_loops: Optional[int] = None) -> None:
        """The hot loop (reference runMainLoop:651-730)."""
        if self.service is not None:
            service_task = asyncio.create_task(self.service.join())
            stop_task = asyncio.create_task(self._stop.wait())
            done, _ = await asyncio.wait(
                [service_task, stop_task], return_when=asyncio.FIRST_COMPLETED
            )
            stop_task.cancel()
            if service_task in done:
                service_task.result()
            else:
                service_task.cancel()
                try:
                    await service_task  # let join()'s cleanup unwind before close()
                except asyncio.CancelledError:
                    pass
            return

        if self.source is None:
            raise RuntimeError(f"agent {self.node.id} has no source and is not a service")

        # Pipelined read/process (reference AgentRunner.java:669-729: the
        # poll loop keeps reading while processing completes via ordered
        # callbacks). Up to ``max-inflight-batches`` batches process
        # concurrently; RESULTS are handled strictly in source order (the
        # writer drains a FIFO of batch tasks), so sink writes and commits
        # keep the reference's ordering guarantees while a slow record in
        # batch k no longer stalls batch k+1's processing — the round-2 e2e
        # TTFT bottleneck: records arriving mid-generation waited out the
        # whole previous batch before the engine even saw them.
        loops = 0
        depth = max(1, int(self.node.configuration.get("max-inflight-batches", 4)))
        pending: asyncio.Queue = asyncio.Queue(maxsize=depth)

        async def process_batch(records: list[Record], trace_id: str):
            # a batch-level span joins the FIRST record's trace (per-record
            # spans would serialize the batch); records without a trace id
            # get this one stamped on their outputs so the path stitches
            with TRACER.span(
                f"agent.{self.node.id}.process",
                trace_id=trace_id,
                agent_type=self.node.agent_type,
                records=len(records),
            ):
                return await self.processor.process(records)

        async def writer() -> None:
            while True:
                item = await pending.get()
                if item is None:
                    return
                task, trace_id = item
                results = await task
                await self._handle_results(results, trace_id)

        writer_task = asyncio.create_task(writer())
        try:
            while not self._stop.is_set():
                if max_loops is not None and loops >= max_loops:
                    break
                if writer_task.done():
                    break  # writer hit a permanent failure; surfaced below
                loops += 1
                # race the read against the writer so a sink/handler failure
                # surfaces immediately instead of hanging behind a quiet topic
                read_task = asyncio.create_task(self.source.read())
                await asyncio.wait(
                    {read_task, writer_task}, return_when=asyncio.FIRST_COMPLETED
                )
                if not read_task.done():
                    read_task.cancel()
                    break  # writer failed; propagated below
                records = read_task.result()
                if not records:
                    continue
                self._records_in += len(records)
                self._m_in.count(len(records))
                trace_id = record_trace_id(records[0]) or uuid.uuid4().hex[:16]
                task = asyncio.create_task(process_batch(records, trace_id))
                put = asyncio.create_task(pending.put((task, trace_id)))
                # the put blocks at pipeline depth (backpressure toward the
                # broker); racing it against the writer avoids a deadlock if
                # the writer dies while the queue is full
                await asyncio.wait({put, writer_task}, return_when=asyncio.FIRST_COMPLETED)
                if not put.done():
                    put.cancel()
                    task.cancel()
                    break
            if not writer_task.done():
                await pending.put(None)
            await writer_task  # drain in-flight batches; propagate failures
        finally:
            if not writer_task.done():
                writer_task.cancel()
            cancelled = [writer_task]
            while not pending.empty():
                item = pending.get_nowait()
                if item is not None:
                    item[0].cancel()
                    cancelled.append(item[0])
            # retrieve cancellations/exceptions so failed in-flight batches
            # don't surface as "Task exception was never retrieved"
            await asyncio.gather(*cancelled, return_exceptions=True)

    async def _handle_results(
        self, results: list[ProcessorResult], trace_id: Optional[str] = None
    ) -> None:
        for result in results:
            await self._handle_result(result, trace_id)

    async def _handle_result(
        self, result: ProcessorResult, trace_id: Optional[str] = None
    ) -> None:
        """Per-record outcome routing (reference :703-718, :750-768, :856-943)."""
        record = result.source_record
        while result.error is not None:
            self._m_err.count()
            outcome = self.errors_handler.handle_error(record, result.error)
            if outcome is ErrorsProcessingOutcome.RETRY:
                retried = await self.processor.process([record])
                result = retried[0]
                continue
            if outcome is ErrorsProcessingOutcome.SKIP:
                if self.tracker is not None:
                    await self.tracker.commit_empty(record)
                return
            if outcome is ErrorsProcessingOutcome.DEAD_LETTER:
                assert self.source is not None
                await self.source.permanent_failure(record, result.error)
                if self.tracker is not None:
                    await self.tracker.commit_empty(record)
                return
            self._last_error = result.error
            raise PermanentFailureError(record, result.error)
        self.errors_handler.forget(record)
        await self._write_result(result, trace_id)

    @staticmethod
    def _with_trace_header(out, trace_id: str):
        """Propagate the trace id downstream (no-op when already traced)."""
        if record_trace_id(out) is not None:
            return out
        return SimpleRecord.copy_from(out).with_headers([(TRACE_HEADER, trace_id)])

    async def _write_result(
        self, result: ProcessorResult, trace_id: Optional[str] = None
    ) -> None:
        record = result.source_record
        assert self.tracker is not None
        if not result.records or self.sink is None:
            await self.tracker.commit_empty(record)
            return
        # the id minted before the process span (or carried by the source
        # record) stamps every output, so the downstream path stitches
        trace_id = record_trace_id(record) or trace_id or uuid.uuid4().hex[:16]
        result = ProcessorResult(
            source_record=record,
            records=[self._with_trace_header(o, trace_id) for o in result.records],
            error=result.error,
        )
        self.tracker.track(record, len(result.records))
        for out in result.records:
            written = False
            while True:
                try:
                    await self.sink.write(out)
                    written = True
                    break
                except BaseException as e:  # noqa: BLE001 — routed to errors policy
                    self._m_err.count()
                    outcome = self.errors_handler.handle_error(out, e)
                    if outcome is ErrorsProcessingOutcome.RETRY:
                        continue
                    if outcome is ErrorsProcessingOutcome.SKIP:
                        break
                    if outcome is ErrorsProcessingOutcome.DEAD_LETTER:
                        assert self.source is not None
                        await self.source.permanent_failure(out, e)
                        break
                    self.tracker.forget(record)
                    raise PermanentFailureError(out, e) from e
            self.errors_handler.forget(out)
            if written:
                self._records_out += 1
                self._m_out.count()
            await self.tracker.commit_if_complete(record)

    async def wait_for_no_pending_records(self, timeout: float = 10.0) -> None:
        """Graceful drain (reference waitForNoPendingRecords:562)."""
        deadline = time.monotonic() + timeout
        while self.tracker is not None and self.tracker.pending > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"agent {self.node.id}: {self.tracker.pending} records still pending"
                )
            await asyncio.sleep(0.01)

    # -- introspection ------------------------------------------------------

    def info(self) -> dict[str, Any]:
        """/info payload (reference AgentAPIController / AgentInfoServlet)."""
        components = []
        if self.source is not None:
            components.append(self.source.agent_info())
        components.append(self.processor.agent_info())
        if self.sink is not None:
            components.append(self.sink.agent_info())
        if self.service is not None:
            components.append(self.service.agent_info())
        return {
            "agent-id": self.node.id,
            "replica": self.replica,
            "records-in": self._records_in,
            "records-out": self._records_out,
            "failures": self.errors_handler.total_failures,
            "components": components,
        }
