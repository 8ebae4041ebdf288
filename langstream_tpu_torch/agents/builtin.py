"""Core structural agents: identity, topic passthrough, mock/test agents.

Parity: the reference's implicit identity processor (AgentRunner.java:319-358
wraps a bare source/sink with an identity processor) and the `mockagents`
test providers (SURVEY §4 tier-1).
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.api.agent import (
    AgentProcessor,
    AgentSink,
    AgentSource,
    ComponentType,
    ProcessorResult,
    SingleRecordProcessor,
)
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo


class IdentityAgent(AgentProcessor):
    """Pass-through processor."""

    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        self.processed(len(records))
        return [ProcessorResult.ok(r, [r]) for r in records]


class ListSource(AgentSource):
    """Emits a configured list of values once — test/demo source."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self._items = list(configuration.get("items", []))
        self._emitted = False
        self.committed: list[Record] = []

    async def read(self) -> list[Record]:
        if self._emitted:
            import asyncio

            await asyncio.sleep(0.01)
            return []
        self._emitted = True
        self.processed(len(self._items))
        return [SimpleRecord.of(v, origin="list-source") for v in self._items]

    async def commit(self, records: list[Record]) -> None:
        self.committed.extend(records)


class CollectSink(AgentSink):
    """Collects records in memory — test/demo sink."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.collected: list[Record] = []

    async def write(self, record: Record) -> None:
        self.collected.append(record)
        self.processed(1)


class NoopProcessor(SingleRecordProcessor):
    async def process_record(self, record: Record) -> list[Record]:
        return [record]


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="identity",
            component_type=ComponentType.PROCESSOR,
            factory=IdentityAgent,
            composable=True,
            description="Pass records through unchanged.",
            config_model=ConfigModel(type="identity", allow_unknown=True),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="list-source",
            component_type=ComponentType.SOURCE,
            factory=ListSource,
            description="Emit a fixed list of values (testing).",
            config_model=ConfigModel(
                type="list-source",
                properties=props(
                    ConfigProperty("items", "values to emit", type="array"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="collect-sink",
            component_type=ComponentType.SINK,
            factory=CollectSink,
            description="Collect records in memory (testing).",
            config_model=ConfigModel(type="collect-sink", allow_unknown=True),
        )
    )


_register()
