"""Default source/sink adapters: topic consumer as source, producer as sink.

Parity: reference `TopicConsumerSource.java`, `TopicProducerSink.java` — the
halves the runner plugs in when an agent node has no explicit source/sink.
The source also owns the dead-letter producer (`<topic>-deadletter`,
AgentRunner.java:282-284).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from langstream_tpu_torch.api.agent import AgentSink, AgentSource
from langstream_tpu_torch.api.record import Record, header_value
from langstream_tpu_torch.api.topics import TopicConsumer, TopicProducer

# Well-known header carrying a per-record destination override (the rebuild's
# equivalent of the reference MutableRecord.destinationTopic / dispatch agent
# routing, flow/DispatchAgent.java). The default sink honors it.
DESTINATION_HEADER = "langstream-destination-topic"


class TopicConsumerSource(AgentSource):
    def __init__(
        self, consumer: TopicConsumer, dead_letter_producer: Optional[TopicProducer] = None
    ) -> None:
        super().__init__()
        self.agent_type = "topic-source"
        self.consumer = consumer
        self.dead_letter_producer = dead_letter_producer

    async def start(self) -> None:
        await self.consumer.start()
        if self.dead_letter_producer is not None:
            await self.dead_letter_producer.start()

    async def close(self) -> None:
        await self.consumer.close()
        if self.dead_letter_producer is not None:
            await self.dead_letter_producer.close()

    async def read(self) -> list[Record]:
        records = await self.consumer.read()
        self.processed(len(records))
        return records

    async def commit(self, records: list[Record]) -> None:
        await self.consumer.commit(records)

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        if self.dead_letter_producer is not None:
            from langstream_tpu_torch.api.record import SimpleRecord

            dl = SimpleRecord.copy_from(record).with_headers(
                [("error-msg", str(error)), ("error-class", type(error).__name__)]
            )
            await self.dead_letter_producer.write(dl)
        else:
            raise error

    def agent_info(self) -> dict[str, Any]:
        info = super().agent_info()
        info["consumer"] = self.consumer.get_info()
        return info


class TopicProducerSink(AgentSink):
    """Default sink; honors per-record DESTINATION_HEADER routing overrides
    via ``producer_factory`` (usually AgentContext.get_topic_producer, so
    side-channel producers are cached and closed with the context)."""

    def __init__(
        self,
        producer: TopicProducer,
        producer_factory: Optional[Callable[[str], TopicProducer]] = None,
    ) -> None:
        super().__init__()
        self.agent_type = "topic-sink"
        self.producer = producer
        self.producer_factory = producer_factory

    async def start(self) -> None:
        await self.producer.start()

    async def close(self) -> None:
        await self.producer.close()

    async def write(self, record: Record) -> None:
        destination = header_value(record, DESTINATION_HEADER)
        if destination is not None:
            # The override is per-hop: strip it so downstream stages route
            # to their own outputs (reference resets destinationTopic per step).
            from langstream_tpu_torch.api.record import SimpleRecord

            record = SimpleRecord.copy_from(
                record,
                headers=tuple(h for h in record.headers if h.key != DESTINATION_HEADER),
            )
        if destination and self.producer_factory is not None:
            await self.producer_factory(str(destination)).write(record)
        else:
            await self.producer.write(record)
        self.processed(1)
