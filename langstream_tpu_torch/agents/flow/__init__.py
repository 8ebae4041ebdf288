"""Flow-control agents (the port's own copy of
``langstream_tpu/agents/flow/__init__.py``).

Parity: reference `langstream-agents-flow-control` (SURVEY §2.5):
`dispatch` (EL-routed fan-out, flow/DispatchAgent.java), `timer-source`
(TimerSource.java), `trigger-event` (TriggerEventProcessor.java),
`log-event` (LogEventProcessor.java). Conditions and field expressions use
the same whitelisted EL as the GenAI toolkit.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.api.agent import (
    AgentSource,
    ComponentType,
    SingleRecordProcessor,
)
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Header, Record, SimpleRecord
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo
from langstream_tpu_torch.runtime.topic_adapters import DESTINATION_HEADER

log = logging.getLogger(__name__)


class DispatchAgent(SingleRecordProcessor):
    """`dispatch`: route each record to the first matching route's
    destination topic; `action: drop` routes discard; non-matching records
    pass through to the default output (reference DispatchAgent)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.routes = list(configuration.get("routes", []))

    async def process_record(self, record: Record) -> list[Record]:
        ctx = MutableRecord.from_record(record)
        self.processed(1)
        for route in self.routes:
            when = route.get("when")
            if when and not el.evaluate_bool(when, ctx):
                continue
            action = route.get("action", "dispatch")
            if action == "drop":
                return []
            destination = route.get("destination")
            if destination:
                headers = tuple(
                    h for h in record.headers if h.key != DESTINATION_HEADER
                ) + (Header(DESTINATION_HEADER, destination),)
                return [SimpleRecord.copy_from(record, headers=headers)]
            return [record]
        return [record]


class TimerSource(AgentSource):
    """`timer-source`: emit one record every `period-seconds`, with fields
    computed by EL expressions (reference TimerSource.java)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.period = float(configuration.get("period-seconds", 60))
        self.fields = list(configuration.get("fields", []))
        self._next_fire = time.monotonic()

    async def read(self) -> list[Record]:
        now = time.monotonic()
        if now < self._next_fire:
            await asyncio.sleep(min(self.period / 20.0, self._next_fire - now))
            return []
        self._next_fire = now + self.period
        ctx = MutableRecord(value={}, timestamp=time.time())
        for f in self.fields:
            ctx.set_field(f.get("name", "value.field"), el.evaluate(f.get("expression", "None"), ctx))
        if not ctx.value:
            ctx.value = {"fired-at": time.time()}
        self.processed(1)
        out = ctx.to_record()
        return [SimpleRecord.copy_from(out, origin="timer-source")]


class TriggerEventProcessor(SingleRecordProcessor):
    """`trigger-event`: when `when` matches, emit a synthetic event record to
    `destination`; `continue-processing` controls whether the original record
    also flows on (reference TriggerEventProcessor.java)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.when = configuration.get("when")
        self.destination = configuration.get("destination", "")
        self.fields = list(configuration.get("fields", []))
        self.continue_processing = bool(configuration.get("continue-processing", True))

    async def process_record(self, record: Record) -> list[Record]:
        ctx = MutableRecord.from_record(record)
        self.processed(1)
        if self.when and not el.evaluate_bool(self.when, ctx):
            return [record]
        event = MutableRecord(value={}, timestamp=time.time())
        for f in self.fields:
            event.set_field(f.get("name", "value.event"), el.evaluate(f.get("expression", "None"), ctx))
        out = event.to_record()
        if self.destination:
            out = SimpleRecord.copy_from(
                out,
                headers=tuple(h for h in out.headers if h.key != DESTINATION_HEADER)
                + (Header(DESTINATION_HEADER, self.destination),),
            )
        return [out, record] if self.continue_processing else [out]


class LogEventProcessor(SingleRecordProcessor):
    """`log-event`: log matching records (with EL-computed fields), pass all
    records through unchanged (reference LogEventProcessor.java)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.when = configuration.get("when")
        self.message = configuration.get("message", "")
        self.fields = list(configuration.get("fields", []))

    async def process_record(self, record: Record) -> list[Record]:
        ctx = MutableRecord.from_record(record)
        self.processed(1)
        if self.when is None or el.evaluate_bool(self.when, ctx):
            extra = {
                f.get("name", f"field{i}"): el.evaluate(f.get("expression", "None"), ctx)
                for i, f in enumerate(self.fields)
            }
            log.info("log-event %s: value=%r %s", self.message, record.value, extra)
        return [record]


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="dispatch",
            component_type=ComponentType.PROCESSOR,
            factory=DispatchAgent,
            composable=False,  # routing must reach the real sink, not a fused peer
            description="Route records to topics by EL conditions.",
            config_model=ConfigModel(
                type="dispatch",
                properties=props(
                    ConfigProperty("routes", "list of {when, destination, action}", type="array"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="timer-source",
            component_type=ComponentType.SOURCE,
            factory=TimerSource,
            description="Emit a record on a fixed period.",
            config_model=ConfigModel(
                type="timer-source",
                properties=props(
                    ConfigProperty("period-seconds", "emission period", type="number", default=60),
                    ConfigProperty("fields", "list of {name, expression}", type="array"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="trigger-event",
            component_type=ComponentType.PROCESSOR,
            factory=TriggerEventProcessor,
            composable=False,
            description="Emit a synthetic event record when a condition matches.",
            config_model=ConfigModel(
                type="trigger-event",
                properties=props(
                    ConfigProperty("when", "EL condition"),
                    ConfigProperty("destination", "topic for the event record"),
                    ConfigProperty("fields", "list of {name, expression}", type="array"),
                    ConfigProperty("continue-processing", "forward the original record", type="boolean", default=True),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="log-event",
            component_type=ComponentType.PROCESSOR,
            factory=LogEventProcessor,
            composable=True,
            description="Log matching records; pass-through.",
            config_model=ConfigModel(
                type="log-event",
                properties=props(
                    ConfigProperty("when", "EL condition"),
                    ConfigProperty("message", "log message prefix"),
                    ConfigProperty("fields", "list of {name, expression}", type="array"),
                ),
            ),
        )
    )


_register()
