"""Mock AI provider for tests (the port's own copy of
``langstream_tpu/ai/mock_provider.py``) — the WireMock-stub tier of the reference's
test strategy (SURVEY §4: remote services tested against HTTP stubs, never
live APIs). Resource type ``mock-ai-configuration``.

Configuration:
  response: static completion text (default echoes the last user message)
  chunk-size: streaming chunk size in characters (default 4)
  embedding-dim: dimension of deterministic hash embeddings (default 8)
"""

from __future__ import annotations

import hashlib
import uuid
from typing import Any, Optional

import numpy as np

from langstream_tpu_torch.ai.provider import (
    ChatChunk,
    ChatCompletionsResult,
    ChatMessage,
    CompletionsService,
    EmbeddingsService,
    ServiceProvider,
    StreamingChunksConsumer,
)


class MockCompletionsService(CompletionsService):
    def __init__(self, resource_config: dict[str, Any]) -> None:
        self.response: Optional[str] = resource_config.get("response")
        self.chunk_size = int(resource_config.get("chunk-size", 4))
        self.calls: list[dict[str, Any]] = []

    async def get_chat_completions(
        self,
        messages: list[ChatMessage],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        self.calls.append({"messages": messages, "options": options})
        content = (
            self.response
            if self.response is not None
            else f"echo: {messages[-1].content if messages else ''}"
        )
        if chunks_consumer is not None:
            answer_id = str(uuid.uuid4())
            pieces = [
                content[i : i + self.chunk_size]
                for i in range(0, len(content), self.chunk_size)
            ] or [""]
            for i, piece in enumerate(pieces):
                chunks_consumer(
                    ChatChunk(
                        content=piece,
                        index=i,
                        last=i == len(pieces) - 1,
                        answer_id=answer_id,
                    )
                )
        return ChatCompletionsResult(
            content=content,
            prompt_tokens=sum(len(m.content.split()) for m in messages),
            completion_tokens=len(content.split()),
        )


class MockEmbeddingsService(EmbeddingsService):
    def __init__(self, resource_config: dict[str, Any]) -> None:
        self.dim = int(resource_config.get("embedding-dim", 8))
        self.calls: list[list[str]] = []

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        self.calls.append(list(texts))
        out = []
        for t in texts:
            seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:8], "big")
            v = np.random.default_rng(seed).normal(size=self.dim)
            out.append((v / np.linalg.norm(v)).tolist())
        return out


class MockAIProvider(ServiceProvider):
    def __init__(self, resource_config: dict[str, Any]) -> None:
        self.resource_config = resource_config
        self.completions = MockCompletionsService(resource_config)
        self.embeddings = MockEmbeddingsService(resource_config)

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return self.completions

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return self.embeddings


def register() -> None:
    from langstream_tpu_torch.api.doc import ConfigModel
    from langstream_tpu_torch.core.registry import REGISTRY, ResourceTypeInfo

    REGISTRY.register_resource(
        ResourceTypeInfo(
            type="mock-ai-configuration",
            description="Canned-response AI provider for tests.",
            config_model=ConfigModel(type="mock-ai-configuration", allow_unknown=True),
            factory=MockAIProvider,
        )
    )
