"""In-memory broker: partitioned topics, consumer groups, ordered offset commit.

This is the reference implementation of the Topic SPI, mirroring the Kafka
semantics the framework depends on (reference `langstream-kafka-runtime/`):

- partitioned topics, records keyed → partition by hash (KafkaProducerWrapper);
- consumer groups with partition assignment + rebalance redelivery
  (KafkaConsumerWrapper.java:82-115);
- **manual ordered commit**: consumers track acked offsets out of order but the
  committed offset only advances over the contiguous prefix
  (KafkaConsumerWrapper.java:41-115,159-190 — `uncommittedOffsets` TreeSet);
- dead-letter convention: `<topic>-deadletter` (AgentRunner.java:282-284).
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.api.record import Header, Record
from langstream_tpu_torch.native import OffsetTracker, key_partition
from langstream_tpu_torch.api.topics import (
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConsumer,
    TopicOffsetPosition,
    TopicProducer,
    TopicReader,
    TopicReadResult,
)


@dataclass(frozen=True)
class ConsumedRecord:
    """A record as read from a topic — carries its provenance for commit."""

    value: Any
    key: Any
    headers: tuple[Header, ...]
    origin: str  # topic name
    timestamp: Optional[float]
    partition: int
    offset: int


@dataclass
class _Partition:
    records: list[ConsumedRecord] = field(default_factory=list)

    def append(self, topic: str, partition: int, record: Record) -> ConsumedRecord:
        stored = ConsumedRecord(
            value=record.value,
            key=record.key,
            headers=tuple(record.headers),
            origin=topic,
            timestamp=record.timestamp if record.timestamp is not None else time.time(),
            partition=partition,
            offset=len(self.records),
        )
        self.records.append(stored)
        return stored


@dataclass
class _Topic:
    name: str
    partitions: list[_Partition]
    # committed offset per (group, partition): next offset to deliver on restart
    committed: dict[tuple[str, int], int] = field(default_factory=dict)


class MemoryBroker:
    """One broker instance ≈ one streaming cluster. Async-safe within a loop."""

    _instances: dict[str, "MemoryBroker"] = {}

    def __init__(self) -> None:
        self.topics: dict[str, _Topic] = {}
        self._consumers: dict[str, list["MemoryTopicConsumer"]] = {}
        self._waiters: list[asyncio.Event] = []

    @classmethod
    def instance(cls, name: str = "default") -> "MemoryBroker":
        broker = cls._instances.get(name)
        if broker is None:
            broker = cls()
            cls._instances[name] = broker
        return broker

    @classmethod
    def reset(cls, name: Optional[str] = None) -> None:
        if name is None:
            cls._instances.clear()
        else:
            cls._instances.pop(name, None)

    # -- admin --------------------------------------------------------------

    def create_topic(self, name: str, partitions: int = 1) -> _Topic:
        if name not in self.topics:
            self.topics[name] = _Topic(
                name=name, partitions=[_Partition() for _ in range(max(partitions, 1))]
            )
        return self.topics[name]

    def delete_topic(self, name: str) -> None:
        self.topics.pop(name, None)

    def topic_exists(self, name: str) -> bool:
        return name in self.topics

    def _get_or_create(self, name: str) -> _Topic:
        return self.create_topic(name)

    # -- produce ------------------------------------------------------------

    def publish(self, topic_name: str, record: Record) -> ConsumedRecord:
        topic = self._get_or_create(topic_name)
        n = len(topic.partitions)
        if record.key is not None:
            part = key_partition(record.key, n)
        else:
            part = getattr(self, "_rr", 0) % n
            self._rr = part + 1
        stored = topic.partitions[part].append(topic_name, part, record)
        self._notify()
        return stored

    def _notify(self) -> None:
        for ev in self._waiters:
            ev.set()

    async def wait_for_data(self, timeout: float) -> None:
        ev = asyncio.Event()
        self._waiters.append(ev)
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            self._waiters.remove(ev)

    # -- consumer group management ------------------------------------------

    def join_group(self, group: str, consumer: "MemoryTopicConsumer") -> None:
        members = self._consumers.setdefault(group, [])
        members.append(consumer)
        self._rebalance(group)

    def leave_group(self, group: str, consumer: "MemoryTopicConsumer") -> None:
        members = self._consumers.get(group, [])
        if consumer in members:
            members.remove(consumer)
        self._rebalance(group)

    def _rebalance(self, group: str) -> None:
        """Round-robin partition assignment; reassigned consumers restart from
        the committed offset (rebalance redelivery, KafkaConsumerWrapper:82)."""
        members = self._consumers.get(group, [])
        if not members:
            return
        by_topic: dict[str, list[MemoryTopicConsumer]] = {}
        for c in members:
            by_topic.setdefault(c.topic_name, []).append(c)
        for topic_name, consumers in by_topic.items():
            topic = self._get_or_create(topic_name)
            for c in consumers:
                c._assigned.clear()
            for part, consumer in zip(
                range(len(topic.partitions)), itertools.cycle(consumers)
            ):
                consumer._assigned.append(part)
            for c in consumers:
                c._reset_to_committed()


class MemoryTopicConsumer(TopicConsumer):
    def __init__(
        self,
        broker: MemoryBroker,
        topic: str,
        group: str,
        poll_timeout: float = 0.1,
        max_records: int = 100,
    ) -> None:
        self.broker = broker
        self.topic_name = topic
        self.group = group
        self.poll_timeout = poll_timeout
        self.max_records = max_records
        self._assigned: list[int] = []
        self._fetch_pos: dict[int, int] = {}
        # contiguous-prefix commit bookkeeping per partition (C++ fast path
        # when the native extension is built; langstream_tpu_torch.native)
        self._trackers: dict[int, OffsetTracker] = {}
        self._total_out = 0
        self._started = False

    async def start(self) -> None:
        self.broker._get_or_create(self.topic_name)
        self.broker.join_group(self.group, self)
        self._started = True

    async def close(self) -> None:
        if self._started:
            self.broker.leave_group(self.group, self)
            self._started = False

    def _reset_to_committed(self) -> None:
        topic = self.broker._get_or_create(self.topic_name)
        self._fetch_pos = {
            p: topic.committed.get((self.group, p), 0) for p in self._assigned
        }
        self._trackers = {
            p: OffsetTracker(topic.committed.get((self.group, p), 0))
            for p in self._assigned
        }

    async def read(self) -> list[Record]:
        out = self._poll()
        if not out:
            await self.broker.wait_for_data(self.poll_timeout)
            out = self._poll()
        self._total_out += len(out)
        return out

    def _poll(self) -> list[Record]:
        topic = self.broker._get_or_create(self.topic_name)
        out: list[Record] = []
        for p in self._assigned:
            pos = self._fetch_pos.get(p, 0)
            records = topic.partitions[p].records
            while pos < len(records) and len(out) < self.max_records:
                out.append(records[pos])
                pos += 1
            self._fetch_pos[p] = pos
        return out

    async def commit(self, records: list[Record]) -> None:
        """Ack records; advance the committed offset over contiguous prefixes
        only (the TreeSet logic of KafkaConsumerWrapper.commit:159-190)."""
        topic = self.broker._get_or_create(self.topic_name)
        for r in records:
            if not isinstance(r, ConsumedRecord):
                continue
            tracker = self._trackers.get(r.partition)
            if tracker is None:
                tracker = OffsetTracker(topic.committed.get((self.group, r.partition), 0))
                self._trackers[r.partition] = tracker
            topic.committed[(self.group, r.partition)] = tracker.ack(r.offset)

    def get_info(self) -> dict[str, Any]:
        topic = self.broker._get_or_create(self.topic_name)
        return {
            "topic": self.topic_name,
            "group": self.group,
            "assigned-partitions": list(self._assigned),
            "committed": {
                str(p): topic.committed.get((self.group, p), 0) for p in self._assigned
            },
        }

    @property
    def total_out(self) -> int:
        return self._total_out


class MemoryTopicProducer(TopicProducer):
    def __init__(self, broker: MemoryBroker, topic: str) -> None:
        self.broker = broker
        self.topic_name = topic
        self._total_in = 0

    async def start(self) -> None:
        self.broker._get_or_create(self.topic_name)

    async def write(self, record: Record) -> None:
        self.broker.publish(self.topic_name, record)
        self._total_in += 1

    @property
    def total_in(self) -> int:
        return self._total_in


class MemoryTopicReader(TopicReader):
    """Offset-addressed reader (gateway consume path — no group)."""

    def __init__(
        self,
        broker: MemoryBroker,
        topic: str,
        initial: TopicOffsetPosition,
        poll_timeout: float = 0.1,
    ) -> None:
        self.broker = broker
        self.topic_name = topic
        self.initial = initial
        self.poll_timeout = poll_timeout
        self._pos: dict[int, int] = {}

    async def start(self) -> None:
        topic = self.broker._get_or_create(self.topic_name)
        for p, part in enumerate(topic.partitions):
            if self.initial.position == TopicOffsetPosition.EARLIEST:
                self._pos[p] = 0
            elif self.initial.position == "absolute":
                self._pos[p] = self.initial.offsets.get(p, 0)
            else:  # latest
                self._pos[p] = len(part.records)

    def _poll(self) -> tuple[list[Record], list[dict[int, int]]]:
        topic = self.broker._get_or_create(self.topic_name)
        out: list[Record] = []
        offsets: list[dict[int, int]] = []
        for p, part in enumerate(topic.partitions):
            pos = self._pos.get(p, 0)
            while pos < len(part.records):
                out.append(part.records[pos])
                pos += 1
                resume = dict(self._pos)
                resume[p] = pos
                offsets.append(resume)
            self._pos[p] = pos
        return out, offsets

    async def read(self) -> TopicReadResult:
        out, offsets = self._poll()
        if not out:
            await self.broker.wait_for_data(self.poll_timeout)
            out, offsets = self._poll()
        return TopicReadResult(out, dict(self._pos), record_offsets=offsets)


class MemoryTopicAdmin(TopicAdmin):
    def __init__(self, broker: MemoryBroker) -> None:
        self.broker = broker

    async def create_topic(self, name: str, partitions: int = 1, options: Optional[dict] = None) -> None:
        self.broker.create_topic(name, partitions)

    async def delete_topic(self, name: str) -> None:
        self.broker.delete_topic(name)

    async def topic_exists(self, name: str) -> bool:
        return self.broker.topic_exists(name)


class MemoryTopicConnectionsRuntime(TopicConnectionsRuntime):
    def __init__(self, broker: Optional[MemoryBroker] = None) -> None:
        self.broker = broker if broker is not None else MemoryBroker.instance()

    async def init(self, streaming_cluster_config: dict[str, Any]) -> None:
        name = streaming_cluster_config.get("broker", "default")
        self.broker = MemoryBroker.instance(name)

    def create_consumer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicConsumer:
        config = config or {}
        return MemoryTopicConsumer(
            self.broker,
            topic,
            group=config.get("group", agent_id),
            poll_timeout=float(config.get("poll-timeout", 0.1)),
            max_records=int(config.get("max-records", 100)),
        )

    def create_producer(
        self, agent_id: str, topic: str, config: Optional[dict[str, Any]] = None
    ) -> TopicProducer:
        return MemoryTopicProducer(self.broker, topic)

    def create_reader(
        self,
        topic: str,
        initial_position: TopicOffsetPosition = TopicOffsetPosition(),
        config: Optional[dict[str, Any]] = None,
    ) -> TopicReader:
        return MemoryTopicReader(self.broker, topic, initial_position)

    def create_topic_admin(self) -> TopicAdmin:
        return MemoryTopicAdmin(self.broker)
