"""Topic SPI — broker-agnostic consume / produce / admin.

Parity: reference `api/runner/topics/` (TopicConsumer, TopicProducer,
TopicAdmin, TopicReader, TopicOffsetPosition, OffsetPerPartition) and the
registry `TopicConnectionsRuntimeRegistry`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.api.record import Record


@dataclass(frozen=True)
class TopicOffsetPosition:
    """Where a reader starts (reference TopicOffsetPosition).

    position ∈ {latest, earliest, absolute}; ``offsets`` is an opaque
    per-partition offset map serialized by the broker runtime.
    """

    position: str = "latest"
    offsets: dict[int, int] = field(default_factory=dict)

    LATEST = "latest"
    EARLIEST = "earliest"

    @staticmethod
    def absolute(offsets: dict[int, int]) -> "TopicOffsetPosition":
        return TopicOffsetPosition(position="absolute", offsets=dict(offsets))


class TopicConsumer(abc.ABC):
    """Group-based consumer with explicit, possibly out-of-order ack.

    Implementations must commit only contiguous prefixes per partition
    (reference KafkaConsumerWrapper.java:41-115 manual offset bookkeeping).
    """

    async def start(self) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def read(self) -> list[Record]: ...

    @abc.abstractmethod
    async def commit(self, records: list[Record]) -> None: ...

    def get_native_consumer(self) -> Any:
        return None

    def get_info(self) -> dict[str, Any]:
        return {}

    @property
    def total_out(self) -> int:
        return 0


class TopicProducer(abc.ABC):
    async def start(self) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def write(self, record: Record) -> None: ...

    @property
    def total_in(self) -> int:
        return 0


class TopicReader(abc.ABC):
    """Offset-addressed reader for gateway consume (no consumer group)."""

    async def start(self) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def read(self) -> "TopicReadResult": ...


@dataclass
class TopicReadResult:
    records: list[Record]
    offset: dict[int, int]
    # per-record resume positions: record_offsets[i] is the offset map to
    # restart AFTER records[i]; resuming from the batch-level ``offset`` for a
    # mid-batch record would skip the rest of the batch
    record_offsets: Optional[list[dict[int, int]]] = None


class TopicAdmin(abc.ABC):
    async def start(self) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def create_topic(self, name: str, partitions: int = 1, options: Optional[dict] = None) -> None: ...

    @abc.abstractmethod
    async def delete_topic(self, name: str) -> None: ...

    @abc.abstractmethod
    async def topic_exists(self, name: str) -> bool: ...


class TopicConnectionsRuntime(abc.ABC):
    """Factory for consumers/producers/readers/admin on one streaming cluster
    (reference TopicConnectionsRuntime / KafkaTopicConnectionsRuntime)."""

    async def init(self, streaming_cluster_config: dict[str, Any]) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    def create_consumer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicConsumer: ...

    @abc.abstractmethod
    def create_producer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicProducer: ...

    @abc.abstractmethod
    def create_reader(
        self,
        topic: str,
        initial_position: TopicOffsetPosition = TopicOffsetPosition(),
        config: Optional[dict[str, Any]] = None,
    ) -> TopicReader: ...

    @abc.abstractmethod
    def create_topic_admin(self) -> TopicAdmin: ...
