"""Agent SPI — the contract every agent implements. asyncio-native.

Parity: reference `api/runner/code/AgentCode.java:25` (init/start/close/
setContext), `AgentSource.java:22` (read/commit/permanentFailure),
`AgentProcessor.java:23` (async process → per-source-record results),
`AgentSink.java:22` (write → future), `AgentService.java:21` (join).

Design shift vs the reference: the Java SPI is callback-based
(`process(List<Record>, RecordSink)`); here ``process`` is a coroutine
returning ``list[ProcessorResult]`` — one per source record, each carrying
either output records or an error. Streaming side-effects (chunk records
emitted before the final result, e.g. completion token chunks) go through
``AgentContext.get_topic_producer`` exactly like the reference's
``StreamingChunksConsumer`` path (ChatCompletionsStep.java:137).
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional, TYPE_CHECKING

from langstream_tpu_torch.api.record import Record

if TYPE_CHECKING:
    from langstream_tpu_torch.api.metrics import MetricsReporter
    from langstream_tpu_torch.api.topics import TopicAdmin, TopicConsumer, TopicProducer


class ComponentType(enum.Enum):
    SOURCE = "source"
    PROCESSOR = "processor"
    SINK = "sink"
    SERVICE = "service"


@dataclass
class ProcessorResult:
    """Outcome of processing one source record (reference SourceRecordAndResult:42)."""

    source_record: Record
    records: list[Record] = field(default_factory=list)
    error: Optional[BaseException] = None

    @staticmethod
    def ok(source: Record, records: list[Record]) -> "ProcessorResult":
        return ProcessorResult(source_record=source, records=records)

    @staticmethod
    def failed(source: Record, error: BaseException) -> "ProcessorResult":
        return ProcessorResult(source_record=source, error=error)


# Callback used by push-style processors (streaming emit before completion).
RecordSink = Callable[[ProcessorResult], None]


class BadRecordError(Exception):
    """Non-retryable record failure — routes straight to the errors policy."""


class AgentContext(abc.ABC):
    """Runtime services available to an agent (reference AgentContext)."""

    @abc.abstractmethod
    def get_global_agent_id(self) -> str: ...

    @abc.abstractmethod
    def get_tenant(self) -> str: ...

    @abc.abstractmethod
    def get_persistent_state_directory(self) -> Optional[Path]:
        """Per-agent durable dir backed by resources.disk (AgentRunner.java:1130)."""

    @abc.abstractmethod
    def get_topic_producer(self, topic: str) -> "TopicProducer":
        """Producer for side-channel topics (streaming chunks, signals)."""

    @abc.abstractmethod
    def get_topic_consumer(self, topic: str) -> "TopicConsumer": ...

    @abc.abstractmethod
    def get_topic_admin(self) -> "TopicAdmin": ...

    @abc.abstractmethod
    def get_metrics_reporter(self) -> "MetricsReporter": ...

    @abc.abstractmethod
    def get_service_provider_registry(self) -> Any:
        """AI ServiceProvider registry (completions/embeddings backends)."""

    def get_code_directory(self) -> Optional[str]:
        """Source-package directory when known; ``<dir>/python`` goes on the
        path of python-agent subprocesses (reference PYTHONPATH injection)."""
        return None

    @abc.abstractmethod
    def critical_failure(self, error: BaseException) -> None:
        """Crash-only escape hatch (reference SimpleAgentContext.criticalFailure:1115)."""


class AgentCode(abc.ABC):
    """Base lifecycle (reference AgentCode.java:25)."""

    agent_id: str = ""
    agent_type: str = ""

    def __init__(self) -> None:
        self.context: Optional[AgentContext] = None
        self._processed = 0
        self._last_processed_at = 0.0

    @abc.abstractmethod
    def component_type(self) -> ComponentType: ...

    async def init(self, configuration: dict[str, Any]) -> None:  # noqa: B027
        pass

    async def start(self) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass

    def set_context(self, context: AgentContext) -> None:
        self.context = context

    def processed(self, n: int) -> None:
        import time

        self._processed += n
        self._last_processed_at = time.time()

    def agent_info(self) -> dict[str, Any]:
        """Status for /info (reference AbstractAgentCode.buildAdditionalInfo)."""
        return {
            "agent-id": self.agent_id,
            "agent-type": self.agent_type,
            "component-type": self.component_type().value,
            "metrics": {
                "total-in": self._processed,
                "last-processed-at": self._last_processed_at,
            },
        }


class AgentSource(AgentCode):
    """Pulls records in (reference AgentSource.java:22)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SOURCE

    @abc.abstractmethod
    async def read(self) -> list[Record]:
        """Return next batch; may be empty. Must not block the loop forever."""

    async def commit(self, records: list[Record]) -> None:  # noqa: B027
        """Called when every downstream write for these records has landed."""

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        """Dead-letter hook; default re-raises to crash (reference behavior)."""
        raise error


class AgentProcessor(AgentCode):
    """Transforms records (reference AgentProcessor.java:23)."""

    def component_type(self) -> ComponentType:
        return ComponentType.PROCESSOR

    @abc.abstractmethod
    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        """One ProcessorResult per input record, order-preserving."""


class SingleRecordProcessor(AgentProcessor):
    """Convenience base: per-record transform (reference SingleRecordAgentProcessor)."""

    @abc.abstractmethod
    async def process_record(self, record: Record) -> list[Record]: ...

    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        out: list[ProcessorResult] = []
        for r in records:
            try:
                out.append(ProcessorResult.ok(r, await self.process_record(r)))
            except BaseException as e:  # noqa: BLE001 — routed to errors policy
                out.append(ProcessorResult.failed(r, e))
        return out


class AgentSink(AgentCode):
    """Writes records out (reference AgentSink.java:22)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SINK

    @abc.abstractmethod
    async def write(self, record: Record) -> None:
        """Completes when durably written. Raise to trigger errors policy."""

    def handles_commit(self) -> bool:
        """True if the sink owns source offset commits (Kafka Connect parity)."""
        return False

    def set_commit_callback(self, cb: Callable[[list[Record]], None]) -> None:  # noqa: B027
        pass


class AgentService(AgentCode):
    """Long-running service bypassing the record loop (reference AgentService.java:21)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SERVICE

    @abc.abstractmethod
    async def join(self) -> None:
        """Run until shutdown; the runner awaits this instead of the poll loop."""
