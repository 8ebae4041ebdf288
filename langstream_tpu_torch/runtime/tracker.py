"""SourceRecordTracker: maps each source record to its outstanding sink
writes and commits to the source only when every downstream write landed.

Parity: reference `runtime/agent/SourceRecordTracker.java:32,45-99`. Ordering
across records is NOT enforced here — the topic consumer's contiguous-prefix
offset bookkeeping (messaging.memory.MemoryTopicConsumer.commit) provides it,
exactly as KafkaConsumerWrapper does for the reference. This matters for the
TPU engine: continuous batching completes generations out of order, and the
commit path must tolerate that without losing at-least-once (SURVEY §7 hard
parts).
"""

from __future__ import annotations

from typing import Optional

from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.record import Record


class SourceRecordTracker:
    def __init__(self, source: Optional[AgentSource]) -> None:
        self.source = source
        self._outstanding: dict[int, int] = {}  # id(source_record) -> writes left
        self._records: dict[int, Record] = {}

    def track(self, source_record: Record, num_sink_records: int) -> None:
        key = id(source_record)
        self._records[key] = source_record
        self._outstanding[key] = self._outstanding.get(key, 0) + num_sink_records

    async def commit_if_complete(self, source_record: Record) -> None:
        """Called once per completed sink write (or once with 0 writes)."""
        key = id(source_record)
        if key not in self._outstanding:
            return
        self._outstanding[key] -= 1
        if self._outstanding[key] <= 0:
            await self._commit(key)

    async def commit_empty(self, source_record: Record) -> None:
        """Source record produced no sink records — committable immediately."""
        key = id(source_record)
        self._records[key] = source_record
        self._outstanding.pop(key, None)
        if self.source is not None:
            await self.source.commit([source_record])
        self._records.pop(key, None)

    async def _commit(self, key: int) -> None:
        record = self._records.pop(key)
        self._outstanding.pop(key, None)
        if self.source is not None:
            await self.source.commit([record])

    def forget(self, source_record: Record) -> None:
        """Drop tracking without committing (errors policy took over)."""
        key = id(source_record)
        self._outstanding.pop(key, None)
        self._records.pop(key, None)

    @property
    def pending(self) -> int:
        return len(self._outstanding)
