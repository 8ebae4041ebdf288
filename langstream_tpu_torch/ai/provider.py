"""The AI service SPI types the port needs (own copy of
``langstream_tpu/ai/provider.py``'s): ``CompletionsService`` (reference
``CompletionsService.java:22-33``, with a streaming chunks consumer),
``EmbeddingsService`` (``EmbeddingsService.java:24-36``) and the
``ServiceProvider`` that hands out both, and ``ServiceProviderRegistry``,
which resolves providers and datasources from an application's
``configuration.resources`` through the port's ``core.registry.REGISTRY``
(an application is duck-typed: a ``.resources`` mapping of id to objects
with ``.type`` and ``.configuration``, as the JAX package's
``Application``)."""

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


class ServiceProviderRegistry:
    """Resolves providers from the app's ``configuration.resources`` entries
    (the JAX package's ``ServiceProviderRegistry``): every resource whose
    type the registry knows is built by its factory — a ``ServiceProvider``
    is a provider, anything else a datasource. Agents ask by resource id,
    or take the first one declared.

    ``lazy``: build each resource when an agent first asks for it (or for
    the first one declared), not all at once. A pod runs one agent of the
    application but carries every resource, and the ``tpu-serving``
    provider resolves its card when it is built: a pod that asks for no card
    must not build it (the JAX provider touches no device until its engine
    is built)."""

    def __init__(self, application: Optional[Any] = None, lazy: bool = False) -> None:
        self._providers: dict[str, ServiceProvider] = {}
        self._datasources: dict[str, Any] = {}
        self._resources: dict[str, Any] = {}
        # resource id → (factory, resource) not built yet, in declaration order
        self._pending: dict[str, tuple[Callable[[dict], Any], Any]] = {}
        self._order: list[str] = []
        if application is not None:
            from langstream_tpu_torch.core.registry import REGISTRY

            for rid, resource in application.resources.items():
                info = REGISTRY.resource(resource.type)
                if info is not None and info.factory is not None:
                    self._pending[rid] = (info.factory, resource)
                    self._order.append(rid)
            if not lazy:
                for rid in self._order:
                    self._build(rid)

    def _build(self, rid: str) -> None:
        entry = self._pending.pop(rid, None)
        if entry is None:
            return
        factory, resource = entry
        provider = factory(resource.configuration)
        if isinstance(provider, ServiceProvider):
            self._providers[rid] = provider
        else:
            self._datasources[rid] = provider
        self._resources[rid] = resource

    def _first(self, built: dict) -> Any:
        """The first resource declared among ``built``'s kind, building the
        pending ones before it in declaration order."""
        for rid in self._order:
            self._build(rid)
            if rid in built:
                return built[rid]
        return next(iter(built.values())) if built else None

    def register(self, resource_id: str, provider: ServiceProvider) -> None:
        self._providers[resource_id] = provider

    def register_datasource(self, resource_id: str, datasource: Any) -> None:
        self._datasources[resource_id] = datasource

    def get_datasource(self, resource_id: Optional[str] = None) -> Any:
        if resource_id is not None:
            self._build(resource_id)
            if resource_id not in self._datasources:
                raise ValueError(
                    f"no datasource for resource {resource_id!r}; "
                    f"known: {sorted(self._datasources)}"
                )
            return self._datasources[resource_id]
        first = self._first(self._datasources)
        if first is None:
            raise ValueError(
                "no datasource configured; declare a configuration.resources "
                "entry of type datasource/vector-database"
            )
        return first

    def get_provider(self, resource_id: Optional[str] = None) -> ServiceProvider:
        if resource_id is not None:
            self._build(resource_id)
            if resource_id not in self._providers:
                raise ValueError(
                    f"no AI service provider for resource {resource_id!r}; "
                    f"known: {sorted(self._providers)}"
                )
            return self._providers[resource_id]
        first = self._first(self._providers)
        if first is None:
            raise ValueError(
                "no AI service provider configured; declare a configuration.resources "
                "entry (e.g. type tpu-serving)"
            )
        return first

    async def close(self) -> None:
        import logging

        for target in (*self._providers.values(), *self._datasources.values()):
            try:
                await target.close()
            except Exception:  # noqa: BLE001 — close the rest regardless
                logging.getLogger(__name__).exception("error closing AI provider/datasource")
