"""OpenAI-compatible remote AI provider (HTTP + SSE streaming): the port's
own copy of ``langstream_tpu/ai/openai_compat.py``.

Parity: reference `langstream-ai-agents/.../impl/OpenAICompletionService.java`
(+ the `open-ai-configuration` resource in AIProvidersResourceProvider) — the
capability it restores is MIXING models in one app: TPU-local serving for the
models you host, remote OpenAI-compatible endpoints (OpenAI, vLLM, Ollama,
llama.cpp server, text-generation-inference...) for the ones you don't.

The surface is the CompletionsService/EmbeddingsService SPI; streaming uses
the `/chat/completions` SSE protocol (`data: {...}` lines, `data: [DONE]`
terminator) and feeds the same StreamingChunksConsumer contract the TPU
provider does, so `ai-chat-completions`'s stream-to-topic path works
unchanged against either provider.

The port's requests go out on ``urllib`` in worker threads
(``runtime/http_client.py``; JAX's on aiohttp): a blocking POST is one
thread's call, and a stream is read line by line by a worker thread that
hands each line to the event loop, so the consumer is called on the loop's
thread, in order. No proxy is taken from the environment.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Optional

from langstream_tpu_torch.ai.provider import (
    ChatChunk,
    ChatCompletionsResult,
    ChatMessage,
    CompletionsService,
    EmbeddingsService,
    ServiceProvider,
    StreamingChunksConsumer,
)
from langstream_tpu_torch.runtime import http_client


class OpenAICompatCompletions(CompletionsService):
    def __init__(self, provider: "OpenAICompatProvider", config: dict[str, Any]) -> None:
        self.provider = provider
        self.config = config

    async def get_chat_completions(
        self,
        messages: list[ChatMessage],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        body: dict[str, Any] = {
            "model": options.get("model") or self.provider.model,
            "messages": [{"role": m.role, "content": m.content} for m in messages],
        }
        for key, wire_key in (
            ("max-tokens", "max_tokens"),
            ("max-new-tokens", "max_tokens"),
            ("temperature", "temperature"),
            ("top-p", "top_p"),
            ("stop", "stop"),
        ):
            if options.get(key) is not None:
                body[wire_key] = options[key]
        start = time.monotonic()
        if chunks_consumer is not None:
            body["stream"] = True
            return await self._stream(body, chunks_consumer, start)
        status, payload = await self.provider.post("/chat/completions", body)
        if status != 200:
            raise RuntimeError(
                f"chat completions failed ({status}): {payload[:300]!r}"
            )
        data = json.loads(payload)
        choice = data["choices"][0]
        usage = data.get("usage", {})
        total_ms = (time.monotonic() - start) * 1e3
        return ChatCompletionsResult(
            content=choice["message"].get("content") or "",
            role=choice["message"].get("role", "assistant"),
            finish_reason=choice.get("finish_reason") or "stop",
            prompt_tokens=int(usage.get("prompt_tokens", 0)),
            completion_tokens=int(usage.get("completion_tokens", 0)),
            ttft_ms=total_ms,
            total_ms=total_ms,
        )

    async def _stream(
        self, body: dict, chunks_consumer: StreamingChunksConsumer, start: float
    ) -> ChatCompletionsResult:
        answer_id = uuid.uuid4().hex
        parts: list[str] = []
        finish_reason = "stop"
        ttft_ms = 0.0
        index = 0
        async for event in self.provider.post_sse("/chat/completions", body):
            if event == "[DONE]":
                break
            data = json.loads(event)
            choice = (data.get("choices") or [{}])[0]
            delta = choice.get("delta", {})
            content = delta.get("content") or ""
            if choice.get("finish_reason"):
                finish_reason = choice["finish_reason"]
            if not content:
                continue
            if not parts:
                ttft_ms = (time.monotonic() - start) * 1e3
            parts.append(content)
            chunks_consumer(
                ChatChunk(content=content, index=index, last=False, answer_id=answer_id)
            )
            index += 1
        chunks_consumer(
            ChatChunk(content="", index=index, last=True, answer_id=answer_id)
        )
        total_ms = (time.monotonic() - start) * 1e3
        return ChatCompletionsResult(
            content="".join(parts),
            finish_reason=finish_reason,
            completion_tokens=index,
            ttft_ms=ttft_ms,
            total_ms=total_ms,
        )


class OpenAICompatEmbeddings(EmbeddingsService):
    def __init__(self, provider: "OpenAICompatProvider", config: dict[str, Any]) -> None:
        self.provider = provider
        self.config = config

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        body = {
            "model": self.config.get("model") or self.provider.embeddings_model,
            "input": texts,
        }
        status, payload = await self.provider.post("/embeddings", body)
        if status != 200:
            raise RuntimeError(f"embeddings failed ({status}): {payload[:300]!r}")
        data = json.loads(payload)
        rows = sorted(data["data"], key=lambda d: d.get("index", 0))
        return [list(map(float, row["embedding"])) for row in rows]


class OpenAICompatProvider(ServiceProvider):
    """`open-ai-configuration` resource → OpenAI-compatible HTTP backend.

    config keys: ``url`` (base, e.g. http://host:8000/v1), ``access-key``
    (bearer token, optional), ``model`` / ``embeddings-model`` defaults."""

    def __init__(self, config: dict[str, Any]) -> None:
        self.url = str(config.get("url", "https://api.openai.com/v1")).rstrip("/")
        self.access_key = config.get("access-key") or config.get("api-key") or ""
        self.model = config.get("model", "")
        self.embeddings_model = config.get("embeddings-model", self.model)

    def _headers(self) -> dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self.access_key:
            headers["Authorization"] = f"Bearer {self.access_key}"
        return headers

    async def post(self, path: str, body: dict) -> tuple[int, bytes]:
        data, headers = http_client.json_body(body, self._headers())
        resp = await http_client.request("POST", f"{self.url}{path}", data, headers)
        return resp.status, resp.body

    async def post_sse(self, path: str, body: dict):
        """POST and yield SSE `data:` payload strings (a line counts once its
        newline arrived, as JAX's reader splits its buffer)."""
        data, headers = http_client.json_body(body, self._headers())
        resp = await http_client.stream("POST", f"{self.url}{path}", data, headers)
        try:
            if resp.status != 200:
                raise RuntimeError(
                    f"streaming request failed ({resp.status}): "
                    f"{(await resp.read())[:300]!r}"
                )
            async for line in resp.lines():
                if not line.endswith(b"\n"):
                    break  # the unterminated tail JAX's buffer never reads
                line = line.strip()
                if line.startswith(b"data:"):
                    payload = line[len(b"data:"):].strip()
                    if payload:
                        yield payload.decode("utf-8", "replace")
        finally:
            resp.close()

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return OpenAICompatCompletions(self, config)

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return OpenAICompatEmbeddings(self, config)


def register() -> None:
    from langstream_tpu_torch.api.doc import ConfigModel
    from langstream_tpu_torch.core.registry import REGISTRY, ResourceTypeInfo

    for type_ in ("open-ai-configuration", "openai-compatible"):
        REGISTRY.register_resource(
            ResourceTypeInfo(
                type=type_,
                description=(
                    "Remote OpenAI-compatible completions/embeddings endpoint "
                    "(OpenAI, vLLM, Ollama, TGI...)."
                ),
                config_model=ConfigModel(type=type_, allow_unknown=True),
                factory=OpenAICompatProvider,
            )
        )
