"""Local serving on an NVIDIA card: the port's counterpart of the
``tpu-serving`` resource (``langstream_tpu/ai/tpu_serving.py``).

``TorchCompletionsService`` takes a ``tpu-serving`` resource config and
honours the keys this slice serves:

  model: preset name (models.configs.MODEL_PRESETS), default tiny-test;
    Llama-family and Mixtral (MoE) presets
  weights: "random" (the only value yet; checkpoint loading waits for the
    loader slice) — drawn on the device from ``seed`` (default 0)
  quantization: "int8" → weight-only int8 (per-output-channel scales; the
    random int8 tree is drawn straight on the device, so a model whose
    bf16 tree would not fit — mixtral-8x7b — never exists in bf16);
    "" / "none" → model dtype. Any other value raises ValueError
  max-batch / decode-chunk / page-size: engine knobs (8 / 16 / 64)
  max-seq-len: the engine's sequence limit (default min(2048, the preset's
    max_seq_len), as in the JAX provider)
  prefill-buckets: admit-group prompt widths (default 32, 64, …, 2048);
    the widest is also the chunked-prefill segment width
  kv-layout: "paged" (default) → one page pool; "dense" → a per-slot big
    cache, decode reads it with the dense decode kernels. On both, prompts
    wider than the widest bucket (up to max-seq-len - 1) prefill in
    segments of that width (the segment kernels; paged: straight into the
    request's pages). Any other value raises ValueError.
  kv-cache-quantization: "int8" → int8 KV with per-token per-head scales
    (the int8 decode / segment kernels); "" / "none" → model dtype
  tokenizer: "byte" (the only value yet)
  device: "cuda" (default) or "cpu"
  queue-depth / shed-policy: the bounded admission queue (default
    max-batch x 4); "block" (default) backpressures the caller, "reject"
    sheds with ShedError and a retry-after
  engine-restart-backoff / engine-max-restarts: loop-crash recovery —
    quarantine the slots in flight, rebuild the device state (the decode
    graphs are captured again), restart under bounded exponential backoff
    (0.1 s doubling to 30 s; 5 restarts)
  fault-injection / fault-seed / fault-stall-s: deterministic fault drills
    (serving/faultinject.py; also through the LSTPU_FAULTS environment)

Per request, the options' ``deadline`` (``deadline-s``) and
``max-queue-wait`` (``max-queue-wait-s``) bound the wall time from submit
and the wait for a slot (``GenerationOptions.from_dict``). On the card
every decode chunk is a CUDA-graph replay; no key turns that off.

A config the CUDA kernels cannot take on the device (a model dtype other
than bfloat16 on the card, unless ``attention_impl`` is "jnp") raises
ValueError when the service is built, before any request.

Completions stream text through the tokenizer with the reference
provider's growth batching (1, 2, 4, … tokens per chunk). Wiring into the
pipeline runtime and the gateway waits until those modules exist in the
port.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import uuid
from typing import Any, Optional

import torch

from langstream_tpu_torch.ai.provider import (
    ChatChunk,
    ChatCompletionsResult,
    ChatMessage,
    CompletionsService,
    StreamingChunksConsumer,
)
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.models.bridge import init_params
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions, ModelConfig
from langstream_tpu_torch.models.quant import init_random_quantized_params
from langstream_tpu_torch.ops.attention import kernel_path_ok
from langstream_tpu_torch.serving.engine import PREFILL_BUCKETS, GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.tokenizer import get_tokenizer


def model_config_from(resource: dict[str, Any]) -> ModelConfig:
    """The preset named by ``model``, with ``kv-cache-quantization`` applied."""
    name = resource.get("model", "tiny-test")
    if name not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset {name!r}; known: {sorted(MODEL_PRESETS)}")
    mc = MODEL_PRESETS[name]
    kv_mode = str(resource.get("kv-cache-quantization", "") or "").lower()
    if kv_mode not in ("", "none", "int8"):
        raise ValueError(f"unknown kv-cache-quantization {kv_mode!r}; supported: int8, none")
    if kv_mode == "int8":
        mc = dataclasses.replace(mc, kv_cache_dtype="int8")
    return mc


class _StreamState:
    """Growth batching: flush after 1 raw token, then 2, 4, … capped at
    ``min_chunks`` — the reference provider's schedule."""

    def __init__(self, tokenizer, consumer: StreamingChunksConsumer, min_chunks: int):
        self.tokenizer = tokenizer
        self.consumer = consumer
        self.min_chunks = max(1, min_chunks)
        self.threshold = 1
        self.pending = 0
        self.tokens: list[int] = []
        self.emitted_text = ""
        self.index = 0
        self.answer_id = str(uuid.uuid4())

    def on_token(self, token: int) -> None:
        self.tokens.append(token)
        self.pending += 1
        if self.pending >= self.threshold:
            self._flush(last=False)
            self.threshold = min(self.threshold * 2, self.min_chunks)

    def _flush(self, last: bool) -> None:
        if last:
            text = self.tokenizer.decode(self.tokens)
        else:
            # a token boundary may split a multibyte char: hold back the
            # undecodable tail so the next flush re-emits it whole
            text = self.tokenizer.decode_stream_prefix(self.tokens)
            if not text.startswith(self.emitted_text):
                self.pending = 0
                return
        delta = text[len(self.emitted_text):]
        if delta or last:
            self.consumer(
                ChatChunk(content=delta, index=self.index, last=last, answer_id=self.answer_id)
            )
            self.index += 1
            self.emitted_text = text
        self.pending = 0

    def finish(self) -> None:
        self._flush(last=True)


class TorchCompletionsService(CompletionsService):
    """Completions from a local ``ServingEngine``, built lazily on first use."""

    def __init__(self, resource: dict[str, Any]) -> None:
        self.resource = dict(resource)
        weights = self.resource.get("weights", "random")
        if weights != "random":
            raise NotImplementedError(
                f"weights {weights!r}: the PyTorch port serves random weights only "
                "(checkpoint loading waits for the loader slice)"
            )
        layout = str(self.resource.get("kv-layout", "paged")).lower()
        if layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv-layout {layout!r}; supported: paged, dense")
        self.kv_layout = layout
        quant = str(self.resource.get("quantization", "") or "").lower()
        if quant not in ("", "none", "int8"):
            raise ValueError(f"unknown quantization {quant!r}; supported: int8, none")
        self.quantize = quant == "int8"
        self.model_config = model_config_from(self.resource)
        self.max_seq_len = int(
            self.resource.get("max-seq-len", min(2048, self.model_config.max_seq_len))
        )
        self.prefill_buckets = tuple(
            int(b) for b in self.resource.get("prefill-buckets", PREFILL_BUCKETS)
        )
        self.device = resolve_device(self.resource.get("device", "cuda"))
        kernel_path_ok(self.model_config, self.device)  # raises for what the kernels refuse
        depth = self.resource.get("queue-depth")
        self.queue_depth = int(depth) if depth is not None else None
        self.shed_policy = str(self.resource.get("shed-policy", "block"))
        if self.shed_policy not in ("block", "reject"):
            raise ValueError(f"unknown shed-policy {self.shed_policy!r}; supported: block, reject")
        self.restart_backoff_s = float(self.resource.get("engine-restart-backoff", 0.1))
        self.max_restarts = int(self.resource.get("engine-max-restarts", 5))
        self.tokenizer = get_tokenizer(self.resource.get("tokenizer", "byte"))
        self._lock = threading.Lock()
        self._engine: Optional[ServingEngine] = None

    def engine(self) -> ServingEngine:
        with self._lock:
            if self._engine is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(self.resource.get("seed", 0)))
                init = init_random_quantized_params if self.quantize else init_params
                params = init(self.model_config, gen, device=self.device)
                engine = ServingEngine(
                    self.model_config,
                    params,
                    max_batch=int(self.resource.get("max-batch", 8)),
                    max_seq_len=self.max_seq_len,
                    eos_token_id=self.tokenizer.eos_token_id,
                    prefill_buckets=self.prefill_buckets,
                    decode_chunk=int(self.resource.get("decode-chunk", 16)),
                    page_size=int(self.resource.get("page-size", 64)),
                    kv_layout=self.kv_layout,
                    device=self.device,
                    queue_depth=self.queue_depth,
                    shed_policy=self.shed_policy,
                    restart_backoff_s=self.restart_backoff_s,
                    max_restarts=self.max_restarts,
                    fault_injector=self._fault_injector(),
                )
                engine.start()
                self._engine = engine
            return self._engine

    def _fault_injector(self) -> Optional[FaultInjector]:
        """``fault-injection`` (with ``fault-seed`` / ``fault-stall-s``), else
        the LSTPU_FAULTS environment, else none."""
        spec = str(self.resource.get("fault-injection", "") or "").strip()
        if not spec:
            return FaultInjector.from_env()
        return FaultInjector(
            spec,
            seed=int(self.resource.get("fault-seed", 0)),
            stall_s=float(self.resource.get("fault-stall-s", 0.05)),
        )

    def engine_stats(self) -> dict[str, Any]:
        return self._engine.stats() if self._engine is not None else {}

    def close(self) -> None:
        with self._lock:
            if self._engine is not None:
                self._engine.stop()
                self._engine = None

    def _render_prompt(self, messages: list[ChatMessage]) -> str:
        lines = [f"{m.role}: {m.content}" for m in messages]
        lines.append("assistant:")
        return "\n".join(lines)

    async def get_chat_completions(
        self,
        messages: list[ChatMessage],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        return await self._generate(self._render_prompt(messages), options, chunks_consumer)

    async def get_text_completions(
        self,
        prompt: list[str],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer] = None,
    ) -> ChatCompletionsResult:
        return await self._generate("\n".join(prompt), options, chunks_consumer)

    async def _generate(
        self,
        prompt: str,
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer],
    ) -> ChatCompletionsResult:
        loop = asyncio.get_running_loop()
        engine = await loop.run_in_executor(None, self.engine)
        stream = None
        if chunks_consumer is not None:
            stream = _StreamState(
                self.tokenizer, chunks_consumer, int(options.get("min-chunks-per-message", 20))
            )
        done: asyncio.Future = loop.create_future()

        def on_done(res) -> None:  # engine thread → event loop
            loop.call_soon_threadsafe(lambda: done.done() or done.set_result(res))

        request = GenerationRequest(
            prompt_tokens=self.tokenizer.encode(prompt),
            options=GenerationOptions.from_dict(options),
            on_token=stream.on_token if stream is not None else None,
            on_done=on_done,
        )
        await loop.run_in_executor(None, engine.submit, request)
        try:
            result = await asyncio.wait_for(done, 600.0)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            request.cancel()
            raise
        if result.error is not None:
            raise result.error
        if stream is not None:
            stream.finish()
        content = self.tokenizer.decode(result.tokens)
        # string-level stop sequences (token-level stops are in-engine)
        for stop in options.get("stop") or []:
            cut = content.find(stop)
            if cut >= 0:
                content = content[:cut]
        return ChatCompletionsResult(
            content=content,
            finish_reason=result.finish_reason,
            prompt_tokens=result.prompt_tokens,
            completion_tokens=len(result.tokens),
            ttft_ms=result.ttft_s * 1000.0,
            total_ms=result.total_s * 1000.0,
        )
