"""The AI service SPI types the port needs (own copy of
``langstream_tpu/ai/provider.py``'s): ``CompletionsService`` (reference
``CompletionsService.java:22-33``, with a streaming chunks consumer),
``EmbeddingsService`` (``EmbeddingsService.java:24-36``) and the
``ServiceProvider`` that hands out both. The provider registry waits for
the slice that ports the pipeline runtime."""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class ChatMessage:
    role: str
    content: str

    @staticmethod
    def from_dict(d: dict) -> "ChatMessage":
        return ChatMessage(role=str(d.get("role", "user")), content=str(d.get("content", "")))


@dataclass
class ChatChunk:
    """One streamed delta (reference Chunk/StreamingChunksConsumer contract)."""

    content: str
    index: int
    last: bool
    answer_id: str = ""


# consume_chunk(chunk) — called for every streamed delta, including the last
StreamingChunksConsumer = Callable[[ChatChunk], None]


@dataclass
class ChatCompletionsResult:
    content: str
    role: str = "assistant"
    finish_reason: str = "stop"
    prompt_tokens: int = 0
    completion_tokens: int = 0
    ttft_ms: float = 0.0
    total_ms: float = 0.0
    extra: dict[str, Any] = field(default_factory=dict)


class CompletionsService(abc.ABC):
    """Reference CompletionsService.java:22-33."""

    @abc.abstractmethod
    async def get_chat_completions(
        self,
        messages: list[ChatMessage],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult: ...

    async def get_text_completions(
        self,
        prompt: list[str],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        messages = [ChatMessage(role="user", content=p) for p in prompt]
        return await self.get_chat_completions(messages, options, chunks_consumer)


class EmbeddingsService(abc.ABC):
    """Reference EmbeddingsService.java:24-36."""

    @abc.abstractmethod
    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]: ...


class ServiceProvider(abc.ABC):
    """Reference ServiceProvider.java:24."""

    @abc.abstractmethod
    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService: ...

    @abc.abstractmethod
    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService: ...

    async def close(self) -> None:  # noqa: B027
        pass
