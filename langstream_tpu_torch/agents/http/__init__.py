"""HTTP client agents (the port's own copy of
``langstream_tpu/agents/http/__init__.py``).

Parity: reference `langstream-agent-http-request` (SURVEY §2.5):
`http-request` (HttpRequestAgent.java — per-record templated HTTP calls)
and `langserve-invoke` (LangServeClient.java — LangServe /invoke and
/stream endpoints, incl. SSE streaming to an intermediate topic, matching
the completions chunk-streaming contract).

The calls run ``urllib`` in worker threads (``runtime/http_client.py``;
JAX's agents use aiohttp), held to aiohttp's reading: a 4xx / 5xx answer
raises ``ClientResponseError``'s text, a string body goes as
``text/plain; charset=utf-8`` and a mapping as a form, ``json()`` refuses a
content type that is not JSON's. The SSE stream is read line by line by a
worker thread and handed to the event loop, so the chunks are written to
the side topic on the loop's thread, in order.
"""

from __future__ import annotations

import json
import re
from typing import Any
from urllib.parse import urlencode

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.api.agent import ComponentType, SingleRecordProcessor
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo
from langstream_tpu_torch.runtime import http_client

# the media types aiohttp's ``json()`` accepts by default
_JSON_TYPE = re.compile(r"^(?:application/|[\w.-]+/[\w.+-]+?\+)json$", re.IGNORECASE)


def _json_of(resp: http_client.Response) -> Any:
    """aiohttp's ``ClientResponse.json()``: a JSON media type or an error."""
    if not _JSON_TYPE.match(resp.content_type):
        raise RuntimeError(
            f"{resp.status}, message='Attempt to decode JSON with unexpected mimetype: "
            f"{resp.content_type}', url={resp.url!r}"
        )
    return resp.json()


def _request_body(body: Any, headers: dict[str, str]) -> tuple:
    """The bytes aiohttp's ``data=`` sends for ``body``, with its default
    content type where the headers name none."""
    if body is None:
        return None, headers
    if isinstance(body, str):
        data, ctype = body.encode(), "text/plain; charset=utf-8"
    elif isinstance(body, (dict, list)):
        pairs = body.items() if isinstance(body, dict) else body
        data, ctype = urlencode(list(pairs), doseq=True).encode(), \
            "application/x-www-form-urlencoded"
    elif isinstance(body, bytes):
        data, ctype = body, "application/octet-stream"
    else:
        raise TypeError(f"http-request body of type {type(body).__name__} cannot be sent")
    if not any(k.lower() == "content-type" for k in headers):
        headers = {**headers, "Content-Type": ctype}
    return data, headers


class HttpRequestAgent(SingleRecordProcessor):
    """`http-request`: per-record HTTP call; url/headers/query/body values are
    EL-templated against the record; the response lands in `output-field`
    (JSON-decoded when the content type says so)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.url = configuration.get("url", "")
        self.method = configuration.get("method", "GET").upper()
        self.output_field = configuration.get("output-field", "value")
        self.headers = dict(configuration.get("headers", {}))
        self.query_string = dict(configuration.get("query-string", {}))
        self.body = configuration.get("body")
        self.allow_redirects = bool(configuration.get("allow-redirects", True))
        self.handle_cookies = bool(configuration.get("handle-cookies", True))
        self._opener = None

    async def start(self) -> None:
        # one session's opener: its cookie jar lives as long as the agent
        self._opener = http_client.build_opener(self.allow_redirects, self.handle_cookies)

    def _render(self, template: str, ctx: MutableRecord) -> str:
        return el.render_template(template, ctx)

    async def process_record(self, record: Record) -> list[Record]:
        assert self._opener is not None, "agent not started"
        ctx = MutableRecord.from_record(record)
        url = self._render(self.url, ctx)
        if self.query_string:
            qs = urlencode({k: self._render(str(v), ctx) for k, v in self.query_string.items()})
            url = f"{url}{'&' if '?' in url else '?'}{qs}"
        headers = {k: self._render(str(v), ctx) for k, v in self.headers.items()}
        body = self._render(self.body, ctx) if isinstance(self.body, str) else self.body
        data, headers = _request_body(body, headers)
        resp = await http_client.request(self.method, url, data, headers, opener=self._opener)
        resp.raise_for_status()
        if "json" in resp.content_type:
            payload: Any = _json_of(resp)
        else:
            payload = resp.text()
        ctx.set_field(self.output_field, payload)
        self.processed(1)
        return [ctx.to_record()]


class LangServeInvokeAgent(SingleRecordProcessor):
    """`langserve-invoke`: call a LangServe runnable. `/invoke` returns the
    final output; `/stream` consumes server-sent events and forwards each
    content delta to `stream-to-topic` before emitting the final record —
    the same chunk contract as ai-chat-completions."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.url = configuration.get("url", "")
        self.output_field = configuration.get("output-field", "value.answer")
        self.content_field = configuration.get("content-field", "content")
        self.fields = list(configuration.get("fields", []))
        self.stream_to_topic = configuration.get("stream-to-topic", "")
        self.min_chunks_per_message = int(configuration.get("min-chunks-per-message", 10))
        self.debug = bool(configuration.get("debug", False))

    def _input(self, ctx: MutableRecord) -> dict[str, Any]:
        return {
            f.get("name", f"field{i}"): el.evaluate(f.get("expression", "value"), ctx)
            for i, f in enumerate(self.fields)
        }

    @staticmethod
    def _content_of(payload: Any, content_field: str) -> str:
        if isinstance(payload, dict):
            if content_field in payload:
                return str(payload[content_field])
            output = payload.get("output")
            if isinstance(output, dict) and content_field in output:
                return str(output[content_field])
            if isinstance(output, str):
                return output
            return json.dumps(payload)
        return str(payload)

    async def process_record(self, record: Record) -> list[Record]:
        ctx = MutableRecord.from_record(record)
        body = {"input": self._input(ctx)}
        streaming = bool(self.stream_to_topic) and self.url.rstrip("/").endswith("/stream")
        if streaming:
            answer = await self._stream(body, record)
        else:
            data, headers = http_client.json_body(body)
            resp = await http_client.request("POST", self.url, data, headers)
            resp.raise_for_status()
            payload = _json_of(resp)
            answer = self._content_of(payload.get("output", payload), self.content_field)
        ctx.set_field(self.output_field, answer)
        self.processed(1)
        return [ctx.to_record()]

    async def _stream(self, body: dict[str, Any], record: Record) -> str:
        """SSE consumption with min-chunks growth batching (reference
        LangServeClient + StreamingChunksConsumer semantics)."""
        assert self.context is not None
        producer = self.context.get_topic_producer(self.stream_to_topic)
        parts: list[str] = []
        batch: list[str] = []
        batch_target = 1
        index = 0
        data, headers = http_client.json_body(body)
        resp = await http_client.stream("POST", self.url, data, headers)
        try:
            resp.raise_for_status()
            event = ""
            async for raw in resp.lines():
                line = raw.decode("utf-8").rstrip("\n")
                if line.startswith("event:"):
                    event = line[len("event:") :].strip()
                elif line.startswith("data:"):
                    data_line = line[len("data:") :].strip()
                    if event in ("", "data"):
                        try:
                            payload = json.loads(data_line)
                        except json.JSONDecodeError:
                            payload = data_line
                        delta = self._content_of(payload, self.content_field)
                        parts.append(delta)
                        batch.append(delta)
                        if len(batch) >= batch_target:
                            await self._emit_chunk(producer, record, "".join(batch), index, False)
                            index += 1
                            batch = []
                            # growth batching: later chunks batch more
                            batch_target = min(batch_target * 2, self.min_chunks_per_message)
                elif line == "" and event == "end":
                    break
        finally:
            resp.close()
        await self._emit_chunk(producer, record, "".join(batch), index, True)
        return "".join(parts)

    async def _emit_chunk(
        self, producer: Any, record: Record, content: str, index: int, last: bool
    ) -> None:
        chunk = SimpleRecord.of(
            content,
            key=record.key,
            headers=[
                ("stream-index", str(index)),
                ("stream-last-message", str(last).lower()),
            ],
            origin=record.origin,
        )
        await producer.write(chunk)


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="http-request",
            component_type=ComponentType.PROCESSOR,
            factory=HttpRequestAgent,
            composable=True,
            description="Per-record templated HTTP request.",
            config_model=ConfigModel(
                type="http-request",
                properties=props(
                    ConfigProperty("url", "target url (EL-templated)", required=True),
                    ConfigProperty("method", "HTTP method", default="GET"),
                    ConfigProperty("output-field", "where the response lands", default="value"),
                    ConfigProperty("headers", "request headers (EL-templated values)", type="object"),
                    ConfigProperty("query-string", "query params (EL-templated values)", type="object"),
                    ConfigProperty("body", "request body (EL-templated string)"),
                    ConfigProperty("allow-redirects", "follow redirects", type="boolean", default=True),
                    ConfigProperty("handle-cookies", "keep a cookie jar", type="boolean", default=True),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="langserve-invoke",
            component_type=ComponentType.PROCESSOR,
            factory=LangServeInvokeAgent,
            composable=False,  # may stream to a side topic
            description="Invoke a LangServe runnable (/invoke or /stream + SSE).",
            config_model=ConfigModel(
                type="langserve-invoke",
                properties=props(
                    ConfigProperty("url", "runnable endpoint", required=True),
                    ConfigProperty("output-field", "where the answer lands", default="value.answer"),
                    ConfigProperty("content-field", "delta content field", default="content"),
                    ConfigProperty("fields", "list of {name, expression} inputs", type="array"),
                    ConfigProperty("stream-to-topic", "topic for streamed chunks"),
                    ConfigProperty("min-chunks-per-message", "growth batching cap", type="integer", default=10),
                    ConfigProperty("debug", "log requests", type="boolean", default=False),
                ),
            ),
        )
    )


_register()
