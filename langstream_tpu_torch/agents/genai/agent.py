"""GenAI toolkit agent: a processor that runs a chain of steps per record.

Parity: reference `GenAIToolKitAgent.java:53` (AgentProcessor wrapping a step
list). The planner registers each step type as its own agent type (the
reference planner does the same via GenAIToolKitFunctionAgentProvider, then
fuses adjacent composable agents); one agent instance may carry several steps
when configured with a `steps` list.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.agents.genai.completions import ChatCompletionsStep, TextCompletionsStep
from langstream_tpu_torch.agents.genai.embeddings import ComputeAIEmbeddingsStep
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.genai.query import QueryStep
from langstream_tpu_torch.agents.genai.steps import TRANSFORM_STEPS, Step
from langstream_tpu_torch.api.agent import AgentProcessor, ProcessorResult
from langstream_tpu_torch.api.record import Record

STEP_TYPES: dict[str, type[Step]] = {
    **TRANSFORM_STEPS,
    "ai-chat-completions": ChatCompletionsStep,
    "ai-text-completions": TextCompletionsStep,
    "compute-ai-embeddings": ComputeAIEmbeddingsStep,
    "query": QueryStep,
}


def make_step(step_type: str, config: dict[str, Any]) -> Step:
    if step_type not in STEP_TYPES:
        raise ValueError(f"unknown GenAI step type {step_type!r}")
    return STEP_TYPES[step_type](config)


class GenAIToolKitAgent(AgentProcessor):
    """Runs one or more GenAI steps over each record.

    Configuration is either a single step's config (agent `type:` selects the
    step) or `{"steps": [{"type": ..., ...}, ...]}` for a pre-fused chain.
    """

    def __init__(self, step_type: str | None = None) -> None:
        super().__init__()
        self._declared_type = step_type
        self.steps: list[Step] = []

    async def init(self, configuration: dict[str, Any]) -> None:
        if "steps" in configuration and isinstance(configuration["steps"], list):
            self.steps = [
                make_step(s["type"], {k: v for k, v in s.items() if k != "type"})
                for s in configuration["steps"]
            ]
        else:
            assert self._declared_type is not None, "agent type missing"
            self.steps = [make_step(self._declared_type, configuration)]

    async def start(self) -> None:
        for step in self.steps:
            await step.start(self.context)

    async def close(self) -> None:
        for step in self.steps:
            await step.close()

    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        # records fan out CONCURRENTLY (reference GenAIToolKitAgent processes
        # each record on its own CompletableFuture chain): with an
        # engine-backed completions step this is what fills the continuous
        # batcher's slots — a sequential await would serialize the whole
        # batch through one KV-cache slot. gather preserves input order;
        # ordering is enforced at COMMIT time by the tracker, not here.
        import asyncio

        return list(
            await asyncio.gather(*(self._process_one(r) for r in records))
        )

    async def _process_one(self, record: Record) -> ProcessorResult:
        try:
            mutable = MutableRecord.from_record(record)
            for step in self.steps:
                await step.apply(mutable, self.context)
                if mutable.dropped:
                    break
            out = [] if mutable.dropped else [mutable.to_record()]
            self.processed(1)
            return ProcessorResult.ok(record, out)
        except Exception as e:  # noqa: BLE001 — per-record error routing
            return ProcessorResult.failed(record, e)


def _make_factory(step_type: str):
    def factory() -> GenAIToolKitAgent:
        return GenAIToolKitAgent(step_type)

    return factory


def register_genai_agents() -> None:
    from langstream_tpu_torch.api.agent import ComponentType
    from langstream_tpu_torch.api.doc import ConfigModel
    from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo

    for step_type in STEP_TYPES:
        REGISTRY.register_agent(
            AgentTypeInfo(
                type=step_type,
                component_type=ComponentType.PROCESSOR,
                factory=_make_factory(step_type),
                composable=True,
                description=f"GenAI toolkit step: {step_type}",
                config_model=ConfigModel(type=step_type, allow_unknown=True),
            )
        )
