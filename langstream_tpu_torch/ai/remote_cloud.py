"""Bedrock + Vertex AI remote providers (SDK-free HTTP): the port's own
copy of ``langstream_tpu/ai/remote_cloud.py``.

Parity: reference `langstream-ai-agents/.../services/impl/BedrockService...`
(SigV4-signed `POST /model/{id}/invoke` on bedrock-runtime) and
`VertexAIProvider` (`POST .../publishers/google/models/{model}:predict` with
a bearer token). Rebuilt on the same stdlib SigV4 signer the s3-source agent
uses (`agents/storage/_sigv4_headers`, service="bedrock") and
``urllib`` in worker threads (``runtime/http_client.py``; JAX's use
aiohttp) — no boto3, no google-cloud SDK.

These restore the reference's "mix remote models into the app" capability
class alongside the TPU-local provider and the OpenAI-compatible provider
(openai_compat.py): one app can route some steps to the local chip and
others to Bedrock/Vertex."""

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


def _consume_whole(
    content: str, chunks_consumer: Optional[StreamingChunksConsumer]
) -> None:
    """Non-streaming backends still honor the chunk contract: one content
    chunk + the last marker."""
    if chunks_consumer is None:
        return
    answer_id = uuid.uuid4().hex
    chunks_consumer(ChatChunk(content=content, index=0, last=False, answer_id=answer_id))
    chunks_consumer(ChatChunk(content="", index=1, last=True, answer_id=answer_id))


class BedrockCompletions(CompletionsService):
    def __init__(self, provider: "BedrockProvider", config: dict[str, Any]) -> None:
        self.provider = provider
        self.config = config

    async def get_chat_completions(
        self,
        messages: list[ChatMessage],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        model = options.get("model") or self.provider.model
        # anthropic-messages request shape (the common bedrock chat schema);
        # parameters-by-name pass through via options["parameters"]
        system = "\n".join(m.content for m in messages if m.role == "system")
        body: dict[str, Any] = {
            "anthropic_version": "bedrock-2023-05-31",
            "max_tokens": int(
                options.get("max-tokens") or options.get("max-new-tokens") or 256
            ),
            "messages": [
                {"role": m.role, "content": m.content}
                for m in messages
                if m.role != "system"
            ],
            **dict(options.get("parameters") or {}),
        }
        if system:
            body["system"] = system
        start = time.monotonic()
        payload = await self.provider.invoke(model, body)
        content = ""
        for block in payload.get("content", []):
            if block.get("type") == "text":
                content += block.get("text", "")
        if not content and "completion" in payload:  # titan/claude-v1 shapes
            content = payload["completion"]
        total_ms = (time.monotonic() - start) * 1e3
        _consume_whole(content, chunks_consumer)
        usage = payload.get("usage", {})
        return ChatCompletionsResult(
            content=content,
            finish_reason=payload.get("stop_reason") or "stop",
            prompt_tokens=int(usage.get("input_tokens", 0)),
            completion_tokens=int(usage.get("output_tokens", 0)),
            ttft_ms=total_ms,
            total_ms=total_ms,
        )


class BedrockEmbeddings(EmbeddingsService):
    def __init__(self, provider: "BedrockProvider", config: dict[str, Any]) -> None:
        self.provider = provider
        self.config = config

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        model = self.config.get("model") or self.provider.embeddings_model
        out: list[list[float]] = []
        for text in texts:  # titan embeddings: one text per invoke
            payload = await self.provider.invoke(model, {"inputText": text})
            out.append([float(x) for x in payload.get("embedding", [])])
        return out


class BedrockProvider(ServiceProvider):
    """`bedrock-configuration` resource: ``region``, ``access-key``,
    ``secret-key``, default ``model`` / ``embeddings-model``; ``endpoint``
    overrides the bedrock-runtime URL for tests."""

    def __init__(self, config: dict[str, Any]) -> None:
        self.region = config.get("region", "us-east-1")
        self.endpoint = str(
            config.get("endpoint")
            or f"https://bedrock-runtime.{self.region}.amazonaws.com"
        ).rstrip("/")
        self.access_key = config.get("access-key", "")
        self.secret_key = config.get("secret-key", "")
        self.model = config.get("model", "")
        self.embeddings_model = config.get("embeddings-model", "")

    async def invoke(self, model: str, body: dict[str, Any]) -> dict[str, Any]:
        from urllib.parse import quote

        from langstream_tpu_torch.agents.storage import _sigv4_headers

        url = f"{self.endpoint}/model/{quote(model, safe='')}/invoke"
        payload = json.dumps(body).encode()
        headers = _sigv4_headers(
            "POST", url, self.region, self.access_key, self.secret_key,
            payload, service="bedrock",
        )
        headers["Content-Type"] = "application/json"
        resp = await http_client.request("POST", url, payload, headers)
        if resp.status != 200:
            raise RuntimeError(
                f"bedrock invoke {model} failed ({resp.status}): {resp.body[:300]!r}"
            )
        return json.loads(resp.body)

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return BedrockCompletions(self, config)

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return BedrockEmbeddings(self, config)


class VertexCompletions(CompletionsService):
    def __init__(self, provider: "VertexProvider", config: dict[str, Any]) -> None:
        self.provider = provider
        self.config = config

    async def get_chat_completions(
        self,
        messages: list[ChatMessage],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        model = options.get("model") or self.provider.model
        contents = []
        system: Optional[dict] = None
        for m in messages:
            if m.role == "system":
                system = {"parts": [{"text": m.content}]}
                continue
            role = "model" if m.role == "assistant" else "user"
            contents.append({"role": role, "parts": [{"text": m.content}]})
        body: dict[str, Any] = {"contents": contents}
        if system is not None:
            body["systemInstruction"] = system
        generation: dict[str, Any] = {}
        if options.get("max-tokens") or options.get("max-new-tokens"):
            generation["maxOutputTokens"] = int(
                options.get("max-tokens") or options["max-new-tokens"]
            )
        if options.get("temperature") is not None:
            generation["temperature"] = options["temperature"]
        if generation:
            body["generationConfig"] = generation
        start = time.monotonic()
        payload = await self.provider.post(f"{model}:generateContent", body)
        content = ""
        for candidate in payload.get("candidates", [])[:1]:
            for part in candidate.get("content", {}).get("parts", []):
                content += part.get("text", "")
        total_ms = (time.monotonic() - start) * 1e3
        _consume_whole(content, chunks_consumer)
        usage = payload.get("usageMetadata", {})
        return ChatCompletionsResult(
            content=content,
            prompt_tokens=int(usage.get("promptTokenCount", 0)),
            completion_tokens=int(usage.get("candidatesTokenCount", 0)),
            ttft_ms=total_ms,
            total_ms=total_ms,
        )


class VertexEmbeddings(EmbeddingsService):
    def __init__(self, provider: "VertexProvider", config: dict[str, Any]) -> None:
        self.provider = provider
        self.config = config

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        model = self.config.get("model") or self.provider.embeddings_model
        payload = await self.provider.post(
            f"{model}:predict", {"instances": [{"content": t} for t in texts]}
        )
        return [
            [float(x) for x in p.get("embeddings", {}).get("values", [])]
            for p in payload.get("predictions", [])
        ]


class VertexProvider(ServiceProvider):
    """`vertex-configuration` resource: ``url`` (regional endpoint),
    ``project``, ``region``, ``token`` (bearer — the reference takes a
    service-account json OR a token; only the token path is SDK-free),
    default ``model`` / ``embeddings-model``."""

    def __init__(self, config: dict[str, Any]) -> None:
        self.region = config.get("region", "us-central1")
        self.project = config.get("project", "")
        base = config.get("url") or f"https://{self.region}-aiplatform.googleapis.com"
        self.base = str(base).rstrip("/")
        self.token = config.get("token", "")
        self.model = config.get("model", "")
        self.embeddings_model = config.get("embeddings-model", "")

    async def post(self, model_verb: str, body: dict[str, Any]) -> dict[str, Any]:
        url = (
            f"{self.base}/v1/projects/{self.project}/locations/{self.region}"
            f"/publishers/google/models/{model_verb}"
        )
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        data, headers = http_client.json_body(body, headers)
        resp = await http_client.request("POST", url, data, headers)
        if resp.status != 200:
            raise RuntimeError(
                f"vertex {model_verb} failed ({resp.status}): {resp.body[:300]!r}"
            )
        return json.loads(resp.body)

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return VertexCompletions(self, config)

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return VertexEmbeddings(self, config)


def register() -> None:
    from langstream_tpu_torch.api.doc import ConfigModel
    from langstream_tpu_torch.core.registry import REGISTRY, ResourceTypeInfo

    REGISTRY.register_resource(
        ResourceTypeInfo(
            type="bedrock-configuration",
            description="AWS Bedrock remote models (SigV4, SDK-free).",
            config_model=ConfigModel(type="bedrock-configuration", allow_unknown=True),
            factory=BedrockProvider,
        )
    )
    REGISTRY.register_resource(
        ResourceTypeInfo(
            type="vertex-configuration",
            description="Google Vertex AI remote models (bearer token).",
            config_model=ConfigModel(type="vertex-configuration", allow_unknown=True),
            factory=VertexProvider,
        )
    )
