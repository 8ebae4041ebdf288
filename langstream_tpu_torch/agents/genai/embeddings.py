"""`compute-ai-embeddings` step.

Parity: reference `ComputeAIEmbeddingsStep.java:46,70-102` — renders the
`text` template per record, computes embeddings via the resolved
EmbeddingsService, writes the vector into `embeddings-field`. The reference
batches via OrderedAsyncBatchExecutor (`batch-size`/`flush-interval`); here
the whole `process()` batch goes to the service in one call (the TPU provider
does its own device-side batching), with `loop-over` support for embedding a
list of sub-documents in one record.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.genai.steps import Step


class ComputeAIEmbeddingsStep(Step):
    def __init__(self, config: dict[str, Any]) -> None:
        super().__init__(config)
        self.text_template = config.get("text", "{{ value }}")
        self.embeddings_field = config.get("embeddings-field", "embeddings")
        self.loop_over = config.get("loop-over")
        self.ai_service = config.get("ai-service")
        self._service = None

    async def start(self, context: Any) -> None:
        registry = context.get_service_provider_registry()
        provider = registry.get_provider(self.ai_service)
        self._service = provider.get_embeddings_service(dict(self.config))

    async def process(self, record: MutableRecord, context: Any) -> None:
        assert self._service is not None, "step not started"
        if self.loop_over:
            items = el.evaluate(self.loop_over, record) or []
            texts = [
                el.render_template(self.text_template, record, extra={"record": item})
                for item in items
            ]
            if not texts:
                return
            vectors = await self._service.compute_embeddings(texts)
            # embeddings-field is relative to each item ("record.embeddings")
            field = self.embeddings_field
            if field.startswith("record."):
                field = field[len("record."):]
            for item, vec in zip(items, vectors):
                if isinstance(item, dict):
                    item[field] = vec
        else:
            text = el.render_template(self.text_template, record)
            vectors = await self._service.compute_embeddings([text])
            record.set_field(self.embeddings_field, vectors[0])
