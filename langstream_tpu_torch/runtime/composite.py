"""CompositeAgentProcessor: N fused agents chained in one process.

Parity: reference `runtime/agent/CompositeAgentProcessor.java` — the runtime
half of pipeline fusion. Records flow stage→stage in-process with no
intermediate topic; lineage back to the original source record is preserved so
ordered commit still works per source record.
"""

from __future__ import annotations

from langstream_tpu_torch.api.agent import AgentContext, AgentProcessor, ProcessorResult
from langstream_tpu_torch.api.record import Record


class CompositeAgentProcessor(AgentProcessor):
    def __init__(self, processors: list[AgentProcessor]) -> None:
        super().__init__()
        self.processors = processors
        self.agent_type = "composite-agent"

    def set_context(self, context: AgentContext) -> None:
        super().set_context(context)
        for p in self.processors:
            p.set_context(context)

    async def init(self, configuration: dict) -> None:
        # children are initialised individually by the runner with their own configs
        pass

    async def start(self) -> None:
        for p in self.processors:
            await p.start()

    async def close(self) -> None:
        for p in self.processors:
            await p.close()

    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        # lineage: source record -> current frontier of records
        frontiers: list[ProcessorResult] = [ProcessorResult.ok(r, [r]) for r in records]
        for processor in self.processors:
            # collect the records still alive, remembering which source they came from
            batch: list[Record] = []
            owner: list[int] = []
            for idx, fr in enumerate(frontiers):
                if fr.error is not None:
                    continue
                for rec in fr.records:
                    batch.append(rec)
                    owner.append(idx)
            if not batch:
                break
            stage_results = await processor.process(batch)
            if len(stage_results) != len(batch):
                raise RuntimeError(
                    f"processor {processor.agent_type} returned {len(stage_results)} "
                    f"results for {len(batch)} records"
                )
            new_records: dict[int, list[Record]] = {i: [] for i in range(len(frontiers))}
            for res, owner_idx in zip(stage_results, owner):
                fr = frontiers[owner_idx]
                if fr.error is not None:
                    continue
                if res.error is not None:
                    frontiers[owner_idx] = ProcessorResult.failed(fr.source_record, res.error)
                else:
                    new_records[owner_idx].extend(res.records)
            for idx, fr in enumerate(frontiers):
                if fr.error is None:
                    frontiers[idx] = ProcessorResult.ok(fr.source_record, new_records[idx])
        self.processed(len(records))
        return frontiers

    def agent_info(self) -> dict:
        info = super().agent_info()
        info["agents"] = [p.agent_info() for p in self.processors]
        return info
