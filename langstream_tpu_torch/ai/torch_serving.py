"""Local serving on an NVIDIA card: the port's counterpart of the
``tpu-serving`` resource (``langstream_tpu/ai/tpu_serving.py``).

``TorchServingProvider`` takes a ``tpu-serving`` resource config and hands
out a completions service (``TorchCompletionsService``, which holds the
weights and the engine and can be built on its own) and an embeddings
service (``TorchEmbeddingsService``: ``encode`` over the same weight tree,
step key ``max-text-tokens``). The resource keys served:

  model: preset name (models.configs.MODEL_PRESETS), default tiny-test;
    Llama-family and Mixtral (MoE) presets
  weights: "random" (default) — drawn on the device from ``seed`` (default
    0) — or a local Hugging Face safetensors checkpoint (a directory of
    ``*.safetensors`` shards, or one file; a path with none raises
    FileNotFoundError when the service is built). Loaded when the engine
    is first built; a failed load leaves no engine and no params
  weight-streaming: auto (default) → the streamed load
    (models/streamload.py): header-indexed shards, positioned reads by a
    reader pool into a pinned ring of ``weight-load-workers + 1`` layers,
    asynchronous copies on a load stream and the transpose / cast on the
    card; the engine's build and graph capture wait on the load's last
    event. "off" raises NotImplementedError: the provider always streams
    (``models.loader.load_params`` stays the eager loader as a library
    function)
  weight-load-workers: reader threads of the streamed load (default 4,
    at least 1); also sizes its readahead window
  quantize-on-load: auto (default) → with ``quantization: int8``, each
    layer is quantized on the card as it streams in, so the model-dtype
    tree never exists. "off" raises NotImplementedError
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
  prefix-cache: auto | off (default off) → prefix KV reuse. Paged: every
    prefill publishes its prompt's deepest bucket boundary into a radix
    index as an alias of the slot's pages, and a later prompt sharing that
    prefix (a chat's earlier turns, a RAG or agent preamble) aliases those
    pages and prefills only its suffix (a prefix ending mid-page costs one
    page copy); `prefix-cache-fraction` (default 0.25) adds that share of
    the pool as headroom for the shared pages; `prefix-cache-entries`
    (default 512) caps the index (0 disables reuse). Dense: a pool of rows
    of the widest bucket's columns (as many as `prefix-cache-fraction` of
    the cache's tokens, or `prefix-cache-entries`); every prefill copies its
    prompt's deepest boundary into a row, and a later prompt sharing it
    starts from a copy of that row and prefills only its suffix (a long
    prompt reuses a full segment width)
  host-kv-fraction: the host KV tier (kv-layout paged with prefix-cache
    auto only) — sizes a host-RAM page arena (pinned on the card) relative
    to the page pool (2.0 = twice the pool's pages; 0, the default, turns
    it off). Idle published prefixes spill into it off the hot loop
    (`spill-idle-s`, default 0: as soon as published), and under pool
    pressure the LRU eviction demotes an entry to its host copy instead of
    dropping it, so a hibernated session's next turn restores its KV (every
    page checksum-verified, then uploaded) instead of re-prefilling.
    `spill: auto | off` (default auto) turns it off; a restore that blocks
    an admission past `restore-stall-dump-s` (default 1.0) leaves a
    `spill-stall` flight dump
  durable: auto | on | off (default auto: on iff `durable-dir` is set) →
    the durable session tier (paged with prefix-cache auto): hibernated
    arenas checkpoint crash-safe into `durable-dir` (temp + fsync + rename,
    the JAX package's format), a new engine on that directory rehydrates
    them before its first admission, and an admission nothing live covers
    restores the deepest checkpointed prefix (verified against the
    manifest's checksums; any failure prefills cold).
    `durable-max-bytes` caps the directory (0, the default: no cap; LRU
    eviction past it), `durable-timeout-s` (default 5.0) bounds a restore.
    ``close()`` hibernates every live session after the drain
  speculation: auto | off (default off) → self-speculative decoding on
    both layouts: a per-slot n-gram index over prompt and emitted tokens
    proposes drafts, and each decode iteration verifies them in one
    dispatch (one graph replay on the card; the paged or the dense decode
    kernel reads the k + 1 queries of a row as single-query rows), so one
    read of the weights emits up to k + 1 tokens a slot on repetitive
    text. Greedy output is the same as without it; sampled output keeps
    its distribution (rejection sampling). `speculation-tokens` (default
    4, at least 1) is k, one value engine-wide
  kv-cache-quantization: "int8" → int8 KV with per-token per-head scales
    (the int8 decode / segment kernels); "" / "none" → model dtype
  tokenizer: "byte" (default) or "hf:<local path>" (a Hugging Face
    tokenizer directory; needs the ``transformers`` package)
  device: "cuda" (default) or "cpu"
  queue-depth / shed-policy: the bounded admission queue (default
    max-batch x 4); "block" (default) backpressures the caller, "reject"
    sheds with ShedError and a retry-after
  kv-pages: the paged pool's page count (default: every slot can reach
    max-seq-len, plus the prefix fraction's headroom)
  prefill-token-budget: prompt tokens admitted an iteration (default the
    widest bucket, floored at one full admit group); max-prefill-streams:
    chunked-prefill streams at once (default 2); prefill-batch: rows of an
    admit group (default 8; an MoE model's groups are padded to it, as the
    JAX engine pads every group)
  tenants: a list of tenant specs (name, weight, max-slots, queue-share,
    token-rate, burst-s; serving/tenancy.TenantSpec): weighted fair share
    of the prefill budget and the slots, hard slot caps, queue shares and
    token-rate quotas; a request names its tenant in its ``tenant`` option
    (none: the shared "default" tenant)
  brownout: auto (default) | off → the degradation ladder under sustained
    load (speculative drafts halved, speculation off, low priority shed,
    over-quota tenants shed), one step per ``brownout-dwell-s`` (0.5) at a
    load score at or above ``brownout-enter-load`` (2.0), released at or
    below ``brownout-exit-load`` (1.0). With speculation on and brownout
    auto the engine captures the decode graphs beside the verify graphs
  observability: true (default) | false → the engine's histograms,
    request spans and flight recorder; flight-recorder-iterations (256)
    sizes the recorder's ring, flight-dir (or LSTPU_FLIGHT_DIR) also
    writes each flight dump there as JSON
  adapters: LoRA adapters registered at start — each entry {name, rank
    (8), scale (1.0), path (a peft safetensors dir) | seed (random
    factors)}. One engine then serves base and every adapter mixed in one
    decode dispatch (serving/adapters.py); a request picks one with its
    ``adapter`` option. `adapter-pool-fraction` (default 0.1) sizes the
    device pool as a fraction of the weights' bytes (more adapters than
    rows swap in LRU: ``adapter-swaps-total``); `adapter-rank` pads every
    adapter to one pool rank; `adapter-pool-rows` sets the row count
  constrained-decoding: auto (default) | off → grammar-constrained
    decoding (serving/constrain.py): a request's ``response-format``
    ({type: json_schema | regex, ...}) compiles against the provider's
    tokenizer to a token DFA and every sampled token is masked by it on the
    card, the speculative verify included. `grammar-slots` (default 64; 0
    turns the tier off), `grammar-states` (128) and `grammar-exceptions`
    (65536) size the device pool (the memory plan logs it)
  drain-grace-s: how long ``close()`` lets the work in flight finish
    (default 10) before it stops the engine
  engine-restart-backoff / engine-max-restarts: loop-crash recovery —
    quarantine the slots in flight, rebuild the device state (the decode
    graphs are captured again), restart under bounded exponential backoff
    (0.1 s doubling to 30 s; 5 restarts)
  fault-injection / fault-seed / fault-stall-s: deterministic fault drills
    (serving/faultinject.py; also through the LSTPU_FAULTS environment)
  fleet: auto | off (default off) → resolve each completion through the
    fleet router (serving/fleet.py): prefix affinity first, load second,
    across this engine (an ``InProcessReplica``: a local route pays no hop)
    and the replicas in `fleet-replicas` (base URLs, or {id, url} dicts;
    ``HttpReplica``s over their runtime HTTP servers). `fleet-lambda` (256)
    trades warm-prefix tokens against load; `fleet-policy` (affinity |
    round-robin | least-loaded); `fleet-replica-id` / `fleet-self-url` name
    THIS replica in its beacon; `fleet-beacon-ttl-s` (10),
    `fleet-refresh-interval-s` (0.5) and `fleet-sticky-ttl-s` (600) tune
    health and session stickiness. The engine's beacon and dispatch
    functions are registered in this process whatever this key says (a
    runtime HTTP server serves them to routers in other processes).
  fleet-role: prefill | decode | mixed (default mixed) → disaggregated
    prefill/decode: the role rides the beacon; routers send admissions whose
    estimated prefill reaches `fleet-prefill-threshold` (2048 tokens) to a
    prefill replica, which prefills and samples the first token, then
    MIGRATE the prompt's KV pages to a decode replica (``POST
    /fleet/migrate``, v2 binary frames where the receiver advertises them,
    per-page blake2b checksums), where the stream decodes warm. A role
    other than mixed also builds the engine's migration staging arena.
    `fleet-migrate: auto | off` turns the transfer off (roles still steer;
    streams decode in place); `fleet-migrate-timeout-s` (30) bounds each
    transfer — on any failure the stream decodes in place, token-exact.
    `fleet-p2p: auto | off` with `fleet-p2p-threshold` (256) and
    `fleet-p2p-min-gap` (0) copy a prefix a peer holds before dispatch
    instead of re-prefilling it.

A request's ``cancel-key`` option registers it for cancellation by that
key (``serving/lifecycle.py``); a fleet route to another process carries
the key to the peer and records the peer, so ``lifecycle.cancel(key)``
forwards ``POST /fleet/cancel`` there. ``begin_drain()`` is the graceful
half of ``close()``: stop routing, unregister the beacon, drain the engine
and hibernate, while a runtime HTTP server still serves.

  mesh: {data: D, expert: E, seq: S, model: M} → one rank a card (the SPMD
    plane, ``parallel/``): the weights split over expert x model
    (``parallel.sharding``; collectives inside the captured chunks), data
    and seq ranks hold the whole model (of their model-axis slice). With
    ``seq`` > 1 and ``kv-layout: dense`` a long prompt is admitted by ONE
    ring prefill over the seq ranks (``parallel/sp.py``: each rank
    prefills its block, ring attention rotates K/V between them, the
    blocks are gathered into every rank's cache); on the paged layout long
    prompts keep the segment loop, as the JAX engine does. One host: the provider is rank 0 and
    starts the other N − 1 ranks as follower processes (``python -m
    langstream_tpu_torch.parallel.spmd_serving``), rank r on ``cuda:(r %
    device_count)`` (or the CPU with ``device: cpu``, gloo for the
    collectives); with ``LANGSTREAM_TPU_HOSTS`` > 1 each pod is one rank
    (``parallel/multihost.py``) and the mesh product must equal the hosts.
    The leader announces every device dispatch and the followers replay it
    (``parallel/spmd_serving.py``); ``close()`` announces OP_STOP and
    waits for every follower to exit. A model, expert or seq axis above 1
    where two ranks would share one card is refused (NCCL cannot put two
    ranks of a communicator on one device; on one card a seq ring runs
    only as an in-process loopback pair, ``spmd_serving.LoopbackRing``,
    which the provider never builds). A mesh on the card at world 1
    ({model: 1}) runs the TP collectives over a world-1 NCCL group. A
    multi-rank mesh turns the host KV tier, the durable tier, adapters and
    constrained decoding off, as the JAX engine does under SPMD (the JAX
    provider serves them on a single-process mesh; ROADMAP §3), and the
    embeddings service is refused under tensor parallelism
  spmd-parity-echo: false (default) → every processed decode / verify
    chunk's tokens ride back out and the followers hold them against their
    own (one extra broadcast a chunk)
  spmd-watchdog-s: 30 (0 = off) → the followers' receive deadline (2x),
    the leader's idle heartbeat (1/4 x) and its per-fetch bound (1x)
  spmd-resync-window-s: 60 → a second divergence within this window of a
    granted resync stays fatal

Keys of the JAX provider with no meaning here, which the port ignores:

  precompile: XLA's ahead-of-time compile of the decode ladder (the port
    captures its graphs in ``start()`` instead)
  compile-cache-dir: XLA's persistent compile cache (nothing is compiled)
  overlap: the JAX engine's fused prefill / decode iteration switch (the
    port always fuses them)
  pipeline-depth: the JAX engine's chunks in flight (the port keeps one)

Per request, the options' ``deadline`` (``deadline-s``) and
``max-queue-wait`` (``max-queue-wait-s``) bound the wall time from submit
and the wait for a slot, ``tenant`` / ``priority`` (low | normal | high) /
``max-cost-tokens`` schedule and budget it, ``adapter`` names the adapter
serving it, ``response-format`` constrains its output and
``grammar-resume-state`` continues a cut constrained stream from its DFA
state (``GenerationOptions.from_dict``). On the card every decode chunk is
a CUDA-graph replay; no key turns that off.

A config the CUDA kernels cannot take on the device (a model dtype other
than bfloat16 on the card, unless ``attention_impl`` is "jnp") raises
ValueError when the service is built, before any request.

Completions stream text through the tokenizer with the reference
provider's growth batching (1, 2, 4, … tokens per chunk); a fleet route to
another process streams the peer's frames into the same chunk writer.
Wiring into the pipeline runtime and the gateway waits until those modules
exist in the port.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Optional

import torch
import torch.distributed as dist

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
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.models.bridge import init_params
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions, ModelConfig
from langstream_tpu_torch.models.loader import _iter_safetensor_files
from langstream_tpu_torch.models.quant import init_random_quantized_params
from langstream_tpu_torch.models.streamload import load_params_streamed
from langstream_tpu_torch.models.transformer import encode
from langstream_tpu_torch.ops.attention import kernel_path_ok
from langstream_tpu_torch.parallel.mesh import axis_sizes, build_mesh
from langstream_tpu_torch.parallel.ring_attention import seq_ring
from langstream_tpu_torch.parallel.multihost import DistributedConfig, bootstrap
from langstream_tpu_torch.parallel.sharding import shard_params
from langstream_tpu_torch.parallel.spmd_serving import SpmdChannel
from langstream_tpu_torch.serving import fleet as fleet_mod
from langstream_tpu_torch.serving import lifecycle
from langstream_tpu_torch.serving.engine import (
    PREFILL_BUCKETS,
    GenerationRequest,
    ServingEngine,
    ShedError,
)
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.pagepool import table_len_for
from langstream_tpu_torch.serving.tokenizer import get_tokenizer
from langstream_tpu_torch.tracing import TRACER

log = logging.getLogger(__name__)

def _asks_for(value: Any) -> bool:
    """A refused key set to something other than off."""
    if value is None or value is False or value == 0 or value in ([], {}):
        return False
    return str(value).strip().lower() not in ("", "off", "false", "none", "0")


def _off(value: Any) -> bool:
    return str(value).lower() in ("off", "false", "0", "none")


def _int_or_none(value: Any) -> Optional[int]:
    return int(value) if value is not None else None


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


def mesh_axes(resource: dict[str, Any]) -> Optional[dict[str, int]]:
    """The resource's ``mesh`` as axis sizes (None when off)."""
    value = resource.get("mesh")
    if not _asks_for(value):
        return None
    if not isinstance(value, dict):
        raise ValueError(f"mesh must be a mapping of axis sizes, got {value!r}")
    axes = {str(k): int(v) for k, v in value.items()}
    axis_sizes(axes)  # unknown axes / sizes below 1 raise
    return axes


def _exit_line(path: str) -> Optional[dict]:
    """The exit line a follower process's log ends with (its ``main``
    prints one JSON object with a ``follower`` key on a clean stop), or
    None when the log has none."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "follower" in obj:
                return obj
    return None


class TorchCompletionsService(CompletionsService):
    """Completions from a local ``ServingEngine``, built lazily on first use.
    ``rank`` / ``world`` / ``init_method``: a follower rank's service
    (``parallel.spmd_serving.main``); the provider itself is rank 0."""

    def __init__(self, resource: dict[str, Any], rank: int = 0, world: Optional[int] = None,
                 init_method: Optional[str] = None) -> None:
        self.resource = dict(resource)
        self.weights = str(self.resource.get("weights", "random") or "random")
        if self.weights != "random":
            next(_iter_safetensor_files(self.weights))  # FileNotFoundError without shards
        for key in ("weight-streaming", "quantize-on-load"):
            value = self.resource.get(key, "auto")
            if not isinstance(value, bool) and str(value).lower() not in ("auto", "off"):
                raise ValueError(f"unknown {key} {value!r}; supported: auto, off")
            if value is False or str(value).lower() == "off":
                raise NotImplementedError(
                    f"{key}: off is not served: the provider always streams the "
                    "checkpoint, quantizing on load with quantization int8"
                )
        self.load_workers = int(self.resource.get("weight-load-workers", 4))
        if self.load_workers < 1:
            raise ValueError(f"weight-load-workers must be >= 1, got {self.load_workers}")
        layout = str(self.resource.get("kv-layout", "paged")).lower()
        if layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv-layout {layout!r}; supported: paged, dense")
        self.kv_layout = layout
        px = self.resource.get("prefix-cache", "off")
        if not isinstance(px, bool) and str(px).lower() not in ("auto", "off"):
            raise ValueError(f"unknown prefix-cache {px!r}; supported: auto, off")
        self.prefix_cache = "auto" if px is True or str(px).lower() == "auto" else "off"
        spec = self.resource.get("speculation", "off")
        if not isinstance(spec, bool) and str(spec).lower() not in ("auto", "off"):
            raise ValueError(f"unknown speculation {spec!r}; supported: auto, off")
        self.speculation = "auto" if spec is True or str(spec).lower() == "auto" else "off"
        self.speculation_tokens = int(self.resource.get("speculation-tokens", 4))
        if self.speculation_tokens < 1:
            raise ValueError(
                f"speculation-tokens must be >= 1, got {self.speculation_tokens}"
            )
        spill = self.resource.get("spill", "auto")
        if not isinstance(spill, bool) and str(spill).lower() not in ("auto", "off"):
            raise ValueError(f"unknown spill {spill!r}; supported: auto, off")
        self.spill = "off" if spill is False or str(spill).lower() == "off" else "auto"
        self.host_kv_fraction = float(self.resource.get("host-kv-fraction", 0.0))
        if self.host_kv_fraction < 0:
            raise ValueError(f"host-kv-fraction must be >= 0, got {self.host_kv_fraction}")
        durable = self.resource.get("durable", "auto")
        if not isinstance(durable, bool) and str(durable).lower() not in (
            "auto", "on", "true", "1", "off", "false", "0"
        ):
            raise ValueError(f"unknown durable {durable!r}; supported: auto, on, off")
        self.durable = {True: "on", False: "off"}.get(durable, str(durable).lower())
        self.durable_dir = (
            str(self.resource["durable-dir"]) if self.resource.get("durable-dir") else None
        )
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
        # the mesh: its axes, this process's rank and the world (one rank a
        # pod under LANGSTREAM_TPU_HOSTS, else rank 0 of the axis product)
        self.mesh_axes = mesh_axes(self.resource)
        self.dist_config = DistributedConfig.from_env()
        size = int(np.prod(list(self.mesh_axes.values()))) if self.mesh_axes else 1
        if self.dist_config.is_multihost:
            rank, world = self.dist_config.process_index, self.dist_config.num_processes
            if size != world:
                raise ValueError(
                    f"mesh {self.mesh_axes} has {size} ranks but LANGSTREAM_TPU_HOSTS is {world}"
                )
        self.rank = int(rank)
        self.world = int(world) if world is not None else size
        self.init_method = init_method
        device = resolve_device(self.resource.get("device", "cuda"))
        if device.type == "cuda" and self.mesh_axes is not None:
            # one rank a card: rank r on cuda:(r % device_count)
            count = torch.cuda.device_count()
            if self._device_groups() and not self.dist_config.is_multihost and self.world > count:
                raise ValueError(
                    f"mesh {self.mesh_axes}: {self.world} ranks on {count} card(s) would put two "
                    "ranks of one model / expert / seq group on one card, which NCCL cannot "
                    "do; only a data axis may share a card"
                )
            device = torch.device("cuda", self.rank % count)
        self.device = device
        kernel_path_ok(self.model_config, self.device)  # raises for what the kernels refuse
        depth = self.resource.get("queue-depth")
        self.queue_depth = int(depth) if depth is not None else None
        self.shed_policy = str(self.resource.get("shed-policy", "block"))
        if self.shed_policy not in ("block", "reject"):
            raise ValueError(f"unknown shed-policy {self.shed_policy!r}; supported: block, reject")
        self.restart_backoff_s = float(self.resource.get("engine-restart-backoff", 0.1))
        self.max_restarts = int(self.resource.get("engine-max-restarts", 5))
        batch = self.resource.get("prefill-batch")
        self.prefill_batch = int(batch) if batch is not None else ServingEngine.PREFILL_BATCH
        if self.prefill_batch < 1:
            raise ValueError(f"prefill-batch must be >= 1, got {self.prefill_batch}")
        bo = self.resource.get("brownout", "auto")
        if not isinstance(bo, bool) and str(bo).lower() not in ("auto", "off"):
            raise ValueError(f"unknown brownout {bo!r}; supported: auto, off")
        self.brownout = "off" if bo is False or str(bo).lower() == "off" else "auto"
        self.drain_grace_s = float(self.resource.get("drain-grace-s", 10.0))
        constrained = self.resource.get("constrained-decoding", "auto")
        if not isinstance(constrained, bool) and str(constrained).lower() not in ("auto", "off"):
            raise ValueError(
                f"unknown constrained-decoding {constrained!r}; supported: auto, off"
            )
        off = constrained is False or str(constrained).lower() == "off"
        self.constrained = "off" if off else "auto"
        self.tokenizer = get_tokenizer(self.resource.get("tokenizer", "byte"))
        # disaggregated serving: the role is validated here, so a bad knob
        # fails before the engine builds
        self.fleet_role = str(self.resource.get("fleet-role") or "mixed")
        if self.fleet_role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"unknown fleet-role {self.fleet_role!r}; supported: prefill, decode, mixed"
            )
        mode = self.resource.get("fleet", "off")
        if mode is True or str(mode).lower() == "auto":
            self.fleet = True
        elif mode is False or str(mode).lower() in ("off", "false", "none", ""):
            self.fleet = False
        else:
            raise ValueError(f"unknown fleet mode {mode!r}; supported: auto, off")
        self._fleet_router: Any = None
        self._fleet_replica_id: Optional[str] = None
        self._drain_begun = False
        # the engine's build and the params' load, from any thread (the
        # engine's build loads the params under it)
        self._lock = threading.RLock()
        # one embedding call at a time on the card (``TorchEmbeddingsService``)
        self.embed_lock = threading.Lock()
        self._engine: Optional[ServingEngine] = None
        self._params: Optional[dict] = None
        # the checkpoint load's WeightLoadReport, whose event the engine
        # waits on; None for random weights
        self._weight_load_report: Any = None
        # one injector for the load and the engine: the weight-load site and
        # the engine's sites share its seeded schedule and counters
        self._injector: Optional[FaultInjector] = None
        self._injector_built = False
        # the SPMD plane: the mesh, the channel, the follower processes (the
        # provider's own, rank 0 on one host), each one's log (its stdout
        # and stderr), their exit codes and exit lines
        self._mesh: Any = None
        self._channel: Any = None
        self._followers: list[subprocess.Popen] = []
        self.follower_logs: list[str] = []
        self.follower_exit_codes: list[Optional[int]] = []
        self.follower_exit_lines: list[Optional[dict]] = []
        self._joined = False

    def mesh(self) -> Any:
        """This rank's mesh (None without ``mesh``), joining the process
        group first when the mesh needs one: more than one rank, or a mesh
        on the card at world 1 (the world-1 NCCL group). Every rank calls
        this at the same point of its build, so the groups are made in the
        same order everywhere."""
        if self.mesh_axes is None:
            return None
        if self._mesh is None:
            cuda = self.device.type == "cuda"
            if self._device_groups():
                backend = "nccl" if cuda else "gloo"
            else:
                backend = "nccl" if cuda and self.world == 1 else None
            if (self.world > 1 or backend is not None) and not dist.is_initialized():
                if cuda:
                    torch.cuda.set_device(self.device)
                if self.dist_config.is_multihost:
                    bootstrap(self.dist_config, self.init_method)
                else:
                    if self.init_method is None:
                        self.init_method = "file://" + os.path.join(
                            tempfile.mkdtemp(prefix="lstpu-spmd-"), "store"
                        )
                    dist.init_process_group(
                        "gloo", init_method=self.init_method, world_size=self.world,
                        rank=self.rank,
                    )
                self._joined = True
            self._mesh = build_mesh(self.mesh_axes, backend)
            if backend is not None and cuda:
                # a communicator initialises at its first collective: run
                # one eagerly, before any capture
                for group in {id(g): g for g in self._mesh.groups.values()}.values():
                    dist.all_reduce(torch.zeros(1, device=self.device), group=group)
                # the ring's send / receive may make a communicator of its
                # own at its first use: warm it the same way
                ring = seq_ring(self._mesh)
                if ring is not None:
                    ring.warm(self.device)
                torch.cuda.synchronize(self.device)
        return self._mesh

    def _device_groups(self) -> bool:
        """Whether the mesh's axes need device process groups: the weights
        split (expert x model above 1) or a seq ring."""
        axes = self.mesh_axes or {}
        return axes.get("model", 1) * axes.get("expert", 1) > 1 or axes.get("seq", 1) > 1

    def spmd_channel(self) -> Any:
        """The SPMD channel (None at world 1), built with the engine."""
        return self._channel

    def _start_followers(self) -> None:
        """On one host, start ranks 1..N-1 as processes of their own: each
        builds the same engine and replays this rank's announcements."""
        if self.rank != 0 or self.world <= 1 or self.dist_config.is_multihost or self._followers:
            return
        if self.init_method is None:
            self.init_method = "file://" + os.path.join(
                tempfile.mkdtemp(prefix="lstpu-spmd-"), "store"
            )
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        log_dir = tempfile.mkdtemp(prefix="lstpu-spmd-logs-")
        self.follower_logs = []
        for r in range(1, self.world):
            path = os.path.join(log_dir, f"spmd-follower-{r}.log")
            with open(path, "w") as out:
                self._followers.append(subprocess.Popen(
                    [sys.executable, "-m", "langstream_tpu_torch.parallel.spmd_serving",
                     "--config", json.dumps(self.resource), "--rank", str(r),
                     "--world", str(self.world), "--init-method", self.init_method],
                    cwd=root, env=env, stdin=subprocess.DEVNULL, stdout=out,
                    stderr=subprocess.STDOUT,
                ))
            self.follower_logs.append(path)

    def _reap_followers(self, timeout_s: float = 120.0) -> None:
        """Wait for every follower to exit (after OP_STOP); one that does
        not within ``timeout_s`` is killed. Exit codes land in
        ``follower_exit_codes``, each one's exit line (the JSON object its
        ``main`` prints last, None when it printed none) in
        ``follower_exit_lines``."""
        deadline = time.monotonic() + timeout_s
        codes = []
        for proc in self._followers:
            try:
                codes.append(proc.wait(timeout=max(0.1, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                log.error("SPMD follower pid %d did not exit after OP_STOP; killing it", proc.pid)
                proc.kill()
                codes.append(proc.wait())
        self._followers = []
        self.follower_exit_codes = codes
        self.follower_exit_lines = [_exit_line(path) for path in self.follower_logs]
        if any(c != 0 for c in codes):
            log.error("SPMD follower exit codes: %s (logs %s)", codes, self.follower_logs)

    def release_follower(self) -> None:
        """Leave the process group (a follower rank's, or the leader's,
        last step)."""
        self._channel = None
        self._mesh = None
        if self._joined and dist.is_initialized():
            dist.destroy_process_group()
        self._joined = False

    def params(self) -> dict:
        """The served params, loaded (or drawn) once — the one tree every
        service of the provider reads (completions and embeddings); a load
        that raises caches nothing. Random weights drawn on the card are
        complete when this returns (their stream is synchronized), so any
        stream may read them; a streamed load's copies may still be in
        flight (``wait_for_weights``). Once loaded it is read without the
        lock, which the engine's build holds through its graph capture."""
        params = self._params
        if params is not None:
            return params
        with self._lock:
            if self._params is None:
                params, report = self._load_params()
                if report is None and self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                self._weight_load_report = report
                self._params = params
            return self._params

    def wait_for_weights(self, stream: Any) -> None:
        """Make ``stream`` wait for a streamed load's last copy (a no-op
        for drawn weights or on the CPU)."""
        report = self._weight_load_report
        if report is not None and self.device.type == "cuda":
            report.wait(stream)

    def _load_params(self) -> tuple[dict, Any]:
        mc, dev = self.model_config, self.device
        if self.weights == "random":
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(self.resource.get("seed", 0)))
            init = init_random_quantized_params if self.quantize else init_params
            params, report = init(mc, gen, device=dev), None
        else:
            params, report = load_params_streamed(
                self.weights, mc, workers=self.load_workers, quantize=self.quantize,
                fault_injector=self._fault_injector(), block=False, device=dev,
            )
        mesh = self.mesh()
        if mesh is not None and mesh.tensor_parallel > 1:
            # this rank's slices; the whole tree goes with the return
            if report is not None and dev.type == "cuda":
                report.wait(torch.cuda.current_stream(dev))
            params = shard_params(params, mesh, mc)
        return params, report

    def engine(self) -> ServingEngine:
        with self._lock:
            if self._engine is None:
                self._start_followers()
                engine = self.build_engine(start=True)
                self._register_replica(engine)
                self._engine = engine
            return self._engine

    def build_engine(self, start: bool = True) -> ServingEngine:
        """Construct this rank's engine (with its mesh and, at world > 1,
        its SPMD channel). ``start=False`` is the follower path: the caller
        runs ``follower_loop`` over ``spmd_channel()`` instead."""
        with self._lock:
            mesh = self.mesh()
            params = self.params()
            if mesh is not None and self.world > 1:
                self._channel = SpmdChannel(
                    prefill_batch=self.prefill_batch,
                    max_width=max(self.prefill_buckets),
                    max_batch=int(self.resource.get("max-batch", 8)),
                    table_len=(
                        table_len_for(self.max_seq_len, int(self.resource.get("page-size", 64)))
                        if self.kv_layout == "paged" else 0
                    ),
                    spec_tokens=self.speculation_tokens,
                    echo=bool(self.resource.get("spmd-parity-echo", False)),
                    decode_chunk=int(self.resource.get("decode-chunk", 16)),
                    watchdog_s=float(self.resource.get("spmd-watchdog-s", 30.0)),
                    resync_window_s=float(self.resource.get("spmd-resync-window-s", 60.0)),
                    group=mesh.control_group,
                    src=0,
                )
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
                prefix_cache=self.prefix_cache,
                prefix_cache_fraction=float(self.resource.get("prefix-cache-fraction", 0.25)),
                prefix_cache_entries=(
                    int(self.resource["prefix-cache-entries"])
                    if self.resource.get("prefix-cache-entries") is not None
                    else None
                ),
                speculation=self.speculation,
                speculation_tokens=self.speculation_tokens,
                weight_load_report=self._weight_load_report,
                kv_pages=_int_or_none(self.resource.get("kv-pages")),
                prefill_token_budget=_int_or_none(self.resource.get("prefill-token-budget")),
                max_prefill_streams=_int_or_none(self.resource.get("max-prefill-streams")),
                tenants=list(self.resource.get("tenants") or []),
                brownout=self.brownout,
                brownout_enter_load=float(self.resource.get("brownout-enter-load", 2.0)),
                brownout_exit_load=float(self.resource.get("brownout-exit-load", 1.0)),
                brownout_dwell_s=float(self.resource.get("brownout-dwell-s", 0.5)),
                observability=bool(self.resource.get("observability", True)),
                flight_iterations=int(self.resource.get("flight-recorder-iterations", 256)),
                flight_dir=(
                    str(self.resource["flight-dir"]) if self.resource.get("flight-dir")
                    else None
                ),
                adapters=list(self.resource.get("adapters") or []),
                adapter_pool_fraction=float(
                    self.resource.get("adapter-pool-fraction", 0.1)
                ),
                adapter_rank=_int_or_none(self.resource.get("adapter-rank")),
                adapter_pool_rows=_int_or_none(self.resource.get("adapter-pool-rows")),
                constrained_decoding=self.constrained,
                grammar_slots=int(self.resource.get("grammar-slots", 64)),
                grammar_states=int(self.resource.get("grammar-states", 128)),
                grammar_exceptions=int(self.resource.get("grammar-exceptions", 65536)),
                grammar_tokenizer=self.tokenizer,
                host_kv_fraction=self.host_kv_fraction,
                spill=self.spill,
                spill_idle_s=float(self.resource.get("spill-idle-s", 0.0)),
                restore_stall_dump_s=float(self.resource.get("restore-stall-dump-s", 1.0)),
                durable=self.durable,
                durable_dir=self.durable_dir,
                durable_max_bytes=int(self.resource.get("durable-max-bytes", 0)),
                durable_timeout_s=float(self.resource.get("durable-timeout-s", 5.0)),
                migrate_staging=self.fleet_role != "mixed",
                prefill_batch=self.prefill_batch,
                mesh=mesh,
                spmd=self._channel,
            )
            if start:
                engine.start()
            return engine

    def _register_replica(self, engine: ServingEngine) -> None:
        """Publish the engine's beacon and fleet functions in this process's
        registry (what a runtime HTTP server serves as ``/state`` and
        ``/fleet/*``), whatever the ``fleet`` key says: a router in ANOTHER
        process reads them."""
        rid = str(self.resource.get("fleet-replica-id") or "local")
        url = str(self.resource.get("fleet-self-url") or "")
        role = self.fleet_role
        self._fleet_replica_id = rid
        fleet_mod.register_local(
            rid,
            beacon_fn=lambda: fleet_mod.beacon_from_engine(rid, engine, url=url, role=role),
            generate_fn=lambda payload: fleet_mod.engine_generate(engine, payload),
            generate_stream_fn=lambda payload: fleet_mod.engine_generate_stream(engine, payload),
            migrate_bind_fn=lambda frames, timeout_s=30.0: fleet_mod.engine_migrate_bind(
                engine, frames, timeout_s
            ),
            migrate_out_fn=lambda payload: fleet_mod.engine_migrate_out(engine, payload),
            migrate_pages_fn=lambda payload: fleet_mod.engine_migrate_pages(engine, payload),
            p2p_fetch_fn=lambda payload: fleet_mod.engine_p2p_fetch(engine, payload),
            migrate_limits_fn=engine.migrate_limits,
            reset_fn=engine.reset_histograms,
            recovering_fn=lambda: engine.recovering,
            restoring_fn=lambda: engine.restoring,
        )

    def fleet_router(self) -> Optional[fleet_mod.FleetRouter]:
        """The fleet router with ``fleet: auto``, else None: this engine (an
        ``InProcessReplica``) and every peer of ``fleet-replicas`` (an
        ``HttpReplica``), its beacon refresher started with it."""
        if not self.fleet:
            return None
        engine = self.engine()  # outside the lock: engine() takes it
        with self._lock:
            if self._fleet_router is None:
                r = self.resource
                replicas: list[Any] = [fleet_mod.InProcessReplica(
                    self._fleet_replica_id or "local", engine,
                    url=str(r.get("fleet-self-url") or ""), role=self.fleet_role,
                )]
                for peer in r.get("fleet-replicas") or []:
                    if isinstance(peer, dict):
                        replicas.append(fleet_mod.HttpReplica(
                            str(peer.get("id") or peer["url"]), str(peer["url"])
                        ))
                    else:
                        replicas.append(fleet_mod.HttpReplica(str(peer), str(peer)))
                router = fleet_mod.FleetRouter(
                    replicas,
                    lam=float(r.get("fleet-lambda", 256.0)),
                    policy=str(r.get("fleet-policy", "affinity")),
                    beacon_ttl_s=float(r.get("fleet-beacon-ttl-s", 10.0)),
                    refresh_interval_s=float(r.get("fleet-refresh-interval-s", 0.5)),
                    sticky_ttl_s=float(r.get("fleet-sticky-ttl-s", 600.0)),
                    prefill_route_threshold=int(r.get("fleet-prefill-threshold", 2048)),
                    migrate=not _off(r.get("fleet-migrate", "auto")),
                    migrate_timeout_s=float(r.get("fleet-migrate-timeout-s", 30.0)),
                    p2p=not _off(r.get("fleet-p2p", "auto")),
                    p2p_threshold=int(r.get("fleet-p2p-threshold", 256)),
                    p2p_min_gap=int(r.get("fleet-p2p-min-gap", 0)),
                )
                router.start()
                # the HTTP prefetch surface (POST /fleet/prefetch) reaches
                # this router through the process registry
                fleet_mod.register_local_router(router)
                self._fleet_router = router
            return self._fleet_router

    def fleet_stats(self) -> dict[str, Any]:
        """The router's counters (empty with ``fleet: off`` or before the
        router is built — never builds one to report zeros)."""
        router = self._fleet_router
        return router.stats() if router is not None else {}

    def _fault_injector(self) -> Optional[FaultInjector]:
        """``fault-injection`` (with ``fault-seed`` / ``fault-stall-s``), else
        the LSTPU_FAULTS environment, else none — built once per service."""
        if not self._injector_built:
            spec = str(self.resource.get("fault-injection", "") or "").strip()
            self._injector = FaultInjector.from_env() if not spec else FaultInjector(
                spec,
                seed=int(self.resource.get("fault-seed", 0)),
                stall_s=float(self.resource.get("fault-stall-s", 0.05)),
            )
            self._injector_built = True
        return self._injector

    def engine_stats(self) -> dict[str, Any]:
        return self._engine.stats() if self._engine is not None else {}

    def begin_drain(self) -> None:
        """The graceful half of ``close()``, callable while a runtime HTTP
        server still serves: stop routing, unregister the fleet beacon
        (peers see ``/state`` empty within one refresh instead of routing
        into the drain), then drain the engine — new requests shed while
        the work in flight finishes for up to ``drain-grace-s`` — and, with
        the durable tier on, hibernate every live session (while the engine
        thread still serves it). Idempotent: a second call returns at once
        instead of waiting out the grace period again."""
        with self._lock:
            if self._drain_begun:
                return
            self._drain_begun = True
            router, self._fleet_router = self._fleet_router, None
            rid, self._fleet_replica_id = self._fleet_replica_id, None
            engine = self._engine
        if router is not None:
            fleet_mod.unregister_local_router()
            router.stop()
        if rid is not None:
            fleet_mod.unregister_local(rid)
        if engine is not None:
            engine.drain(self.drain_grace_s)
            ledger = engine.hibernate(rid or "")
            if ledger:
                log.info("replica %s hibernated: %s session prefix(es), %s bytes, %s failure(s)",
                         rid or "local", ledger.get("entries"), ledger.get("bytes"),
                         ledger.get("failures"))

    def close(self) -> None:
        """``begin_drain()``, then stop: what is still running fails with
        the stop. Under SPMD the stop announces OP_STOP; every follower
        process is then waited for (``follower_exit_codes``,
        ``follower_exit_lines``) and the process group left. The weight
        tree is released with the engine: a control plane's update frees
        the old tree before the new provider draws its own (a later
        ``params()`` loads it again)."""
        self.begin_drain()
        with self._lock:
            engine, self._engine = self._engine, None
            self._params, self._weight_load_report = None, None
        if engine is not None:
            engine.stop()
        if self._followers:
            self._reap_followers()
        if self._joined:
            self.release_follower()

    def _render_prompt(self, messages: list[ChatMessage]) -> str:
        """The tokenizer's chat template when it has one (an HF tokenizer
        of an instruct checkpoint), as the JAX provider renders it; else
        ``role: content`` lines and an ``assistant:`` cue."""
        hf = getattr(self.tokenizer, "_tok", None)
        if hf is not None and getattr(hf, "chat_template", None):
            return hf.apply_chat_template(
                [{"role": m.role, "content": m.content} for m in messages],
                tokenize=False,
                add_generation_prompt=True,
            )
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

    def _finish_result(
        self, tokens: list[int], finish_reason: str, prompt_tokens: int, ttft_s: float,
        total_s: float, options: dict[str, Any], stream: Optional[_StreamState],
    ) -> ChatCompletionsResult:
        if stream is not None:
            stream.finish()
        content = self.tokenizer.decode(tokens)
        # string-level stop sequences (token-level stops are in-engine)
        for stop in options.get("stop") or []:
            cut = content.find(stop)
            if cut >= 0:
                content = content[:cut]
        return ChatCompletionsResult(
            content=content,
            finish_reason=finish_reason,
            prompt_tokens=prompt_tokens,
            completion_tokens=len(tokens),
            ttft_ms=ttft_s * 1000.0,
            total_ms=total_s * 1000.0,
        )

    async def _fleet_dispatch(
        self,
        router: fleet_mod.FleetRouter,
        prompt_tokens: list[int],
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer],
    ) -> Optional[ChatCompletionsResult]:
        """Resolve one request through the fleet router: None when the first
        route lands on THIS replica (the caller then runs the native path),
        else the completed result of a dispatch elsewhere. The router's
        frames stream into the chunk writer as the peer delivers them, so a
        remote route keeps local TTFT; a peer dying mid-stream fails over
        inside the router (prompt + delivered tokens re-dispatched to a
        survivor). The ``cancel-key`` rides to the peer, and the replica that
        owns the stream is recorded under it (following the stream across
        failovers), so ``lifecycle.cancel`` forwards there. A fleet shed
        surfaces as the engine's ShedError."""
        session_id = str(options.get("cancel-key") or "") or None
        loop = asyncio.get_running_loop()
        frames = router.stream_generate(
            prompt_tokens, dict(options), session_id=session_id,
            timeout_s=fleet_mod.hop_timeout_s(options),
        )

        def _next():
            try:
                return next(frames)
            except StopIteration:
                return None

        delivered: list[int] = []
        end: Optional[dict] = None
        owner_url: Optional[str] = None
        stream = None

        def _point_cancel_at(url: str, is_local: bool) -> None:
            # exactly one remote-owner registration, following the stream
            nonlocal owner_url
            if owner_url is not None and session_id:
                lifecycle.unregister_remote(session_id, owner_url)
            owner_url = None
            if session_id and url and not is_local and not url.startswith("local:"):
                lifecycle.register_remote(session_id, url)
                owner_url = url

        # ONE try/finally owns the stream: a cancellation at any await below
        # closes the router's generator, which cancels the serving replica's
        # request
        try:
            try:
                first = await loop.run_in_executor(None, _next)
            except fleet_mod.FleetShedError as e:
                raise ShedError(str(e), retry_after_s=e.retry_after_s) from e
            if first is None:
                return None
            if first.get("kind") == "route" and first.get("local") and not first.get("disagg"):
                # the route landed HERE: the native path serves it. Not a
                # disaggregated prefill handoff — the router owns that one
                # (prefill here, migrate, decode elsewhere)
                return None
            if chunks_consumer is not None:
                stream = _StreamState(
                    self.tokenizer, chunks_consumer, int(options.get("min-chunks-per-message", 20))
                )
            frame: Optional[dict] = first
            while frame is not None:
                kind = frame.get("kind")
                if kind == "route":
                    _point_cancel_at(str(frame.get("url") or ""), bool(frame.get("local")))
                elif kind == "tokens":
                    for t in frame.get("tokens") or []:
                        delivered.append(int(t))
                        if stream is not None:
                            stream.on_token(int(t))
                elif kind == "end":
                    end = frame
                    break
                try:
                    frame = await loop.run_in_executor(None, _next)
                except fleet_mod.FleetShedError as e:
                    raise ShedError(str(e), retry_after_s=e.retry_after_s) from e
        except fleet_mod.ReplicaError:
            if delivered:
                raise  # tokens already streamed: a local restart would repeat them
            # every replica died before the first token (sheds raised
            # above): serve locally, cold — this process's engine may be
            # healthy even when the router has it quarantined
            return None
        finally:
            if owner_url is not None and session_id:
                lifecycle.unregister_remote(session_id, owner_url)
            # an executor thread may still be inside next()
            fleet_mod.close_frames(frames)
        if end is None:
            raise fleet_mod.ReplicaError("fleet stream ended without a terminal frame")
        return self._finish_result(
            delivered, str(end.get("finish_reason", "stop")),
            int(end.get("prompt_tokens", len(prompt_tokens))), float(end.get("ttft_s", 0.0)),
            float(end.get("total_s", 0.0)), options, stream,
        )

    async def _generate(
        self,
        prompt: str,
        options: dict[str, Any],
        chunks_consumer: Optional[StreamingChunksConsumer],
    ) -> ChatCompletionsResult:
        loop = asyncio.get_running_loop()
        engine = await loop.run_in_executor(None, self.engine)
        prompt_tokens = self.tokenizer.encode(prompt)
        gen_options = GenerationOptions.from_dict(options)
        router = await loop.run_in_executor(None, self.fleet_router)
        if router is not None:
            remote = await self._fleet_dispatch(router, prompt_tokens, options, chunks_consumer)
            if remote is not None:
                return remote
        stream = None
        if chunks_consumer is not None:
            stream = _StreamState(
                self.tokenizer, chunks_consumer, int(options.get("min-chunks-per-message", 20))
            )
        done: asyncio.Future = loop.create_future()

        def on_done(res) -> None:  # engine thread → event loop
            loop.call_soon_threadsafe(lambda: done.done() or done.set_result(res))

        # trace correlation: the record's propagated ls-trace-id (forwarded
        # by the completions step) wins; else join whatever agent span is
        # active so the engine's request spans stitch into the pipeline
        # trace on /traces either way
        trace_id = str(options.get("trace-id") or "") or TRACER.current_trace_id()
        request = GenerationRequest(
            prompt_tokens=prompt_tokens,
            options=gen_options,
            on_token=stream.on_token if stream is not None else None,
            on_done=on_done,
            trace_id=trace_id,
        )
        # a disconnect cancels every request registered under the key
        # (serving/lifecycle.py): the slot frees within one chunk
        cancel_key = str(options.get("cancel-key") or "")
        if cancel_key:
            lifecycle.register(cancel_key, request)
        try:
            await loop.run_in_executor(None, engine.submit, request)
            try:
                result = await asyncio.wait_for(done, 600.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                request.cancel()
                raise
        finally:
            if cancel_key:
                lifecycle.unregister(cancel_key, request)
        if result.error is not None:
            raise result.error
        return self._finish_result(
            result.tokens, result.finish_reason, result.prompt_tokens, result.ttft_s,
            result.total_s, options, stream,
        )


class TorchEmbeddingsService(EmbeddingsService):
    """Embeddings from the provider's model: the port's counterpart of the
    JAX provider's ``TpuEmbeddingsService`` (and ``embed_fn``). Each text is
    tokenized and cut at ``max-text-tokens`` (default 512), the batch
    padded to a power of two from 16 (a row's length ``max(1, len)``: an
    empty text pools its one pad token), and ``models/transformer.encode``
    gives one L2-normalised f32 vector a text. The call runs off the event
    loop, in an executor. On the card the calls take the provider's
    ``embed_lock`` for their device work, one at a time: an eager
    ``encode`` is some 1,700 kernel launches of host work under the GIL
    (the JAX package's, one jitted dispatch), and a pipeline embeds its
    records concurrently, where threads launching at once slow every call
    (``chip_smoke.py``'s ``rag`` phase times both ways).

    It reads the weight tree of the completions service it was given (one
    load for both services). On the card it runs on a stream of its own —
    never the legacy default stream — waits on that stream only (no
    device-wide synchronize) and calls no ``gc.collect()``, so it may run
    while the engine captures its graphs (a thread-local capture on
    another thread) or replays them. The JAX provider refuses embeddings on
    a multi-host replica; the port refuses them on any multi-rank or
    tensor-parallel mesh (``get_embeddings_service``)."""

    def __init__(self, holder: TorchCompletionsService, step_config: dict[str, Any]) -> None:
        self.holder = holder
        self.max_len = int(step_config.get("max-text-tokens", 512))
        self._stream: Optional[Any] = None

    def batch(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(tokens [n, width] int64, lengths [n] int64): each text cut at
        ``max-text-tokens``, right-padded with 0 to the power of two from 16
        that holds the longest."""
        token_lists = [self.holder.tokenizer.encode(t)[: self.max_len] for t in texts]
        width = 16
        longest = max((len(t) for t in token_lists), default=1)
        while width < longest:
            width *= 2
        tokens = np.zeros((len(texts), width), np.int64)
        lengths = np.zeros(len(texts), np.int64)
        for i, toks in enumerate(token_lists):
            tokens[i, : len(toks)] = toks
            lengths[i] = max(1, len(toks))
        return tokens, lengths

    def embed(self, texts: list[str]) -> np.ndarray:
        """[n, d_model] f32 embeddings of ``texts``, computed on the calling
        thread (on the card: on the service's own stream)."""
        holder = self.holder
        if holder.mesh_axes is not None and (
            holder.world > 1
            or holder.mesh_axes.get("model", 1) * holder.mesh_axes.get("expert", 1) > 1
        ):
            raise NotImplementedError(
                "embeddings are not served on a multi-rank or tensor-parallel mesh "
                "(the JAX provider refuses them on a multi-host replica)"
            )
        tokens, lengths = self.batch(texts)
        params = holder.params()
        dev = holder.device
        if dev.type != "cuda":
            return encode(params, torch.from_numpy(tokens), torch.from_numpy(lengths),
                          holder.model_config).numpy()
        with holder.embed_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            stream = self._stream
            with torch.cuda.stream(stream):
                holder.wait_for_weights(stream)
                out = encode(params, torch.from_numpy(tokens).to(dev),
                             torch.from_numpy(lengths).to(dev), holder.model_config)
                host = out.cpu()  # synchronizes this stream only
        return host.numpy()

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        loop = asyncio.get_running_loop()
        vectors = await loop.run_in_executor(None, self.embed, list(texts))
        return [v.tolist() for v in vectors]


class TorchServingProvider(ServiceProvider):
    """The ``tpu-serving`` resource as a provider (the JAX package's
    ``TpuServingProvider``): one ``TorchCompletionsService`` holds the
    weight tree and the engine, and both services read it — a replica that
    serves completions and embeddings loads its model once."""

    def __init__(self, resource_config: dict[str, Any]) -> None:
        self.holder = TorchCompletionsService(resource_config)

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return self.holder

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return TorchEmbeddingsService(self.holder, config)

    async def close(self) -> None:
        # close() drains for up to drain-grace-s: off the event loop
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.holder.close)


def register() -> None:
    """Register the ``tpu-serving`` resource type with
    ``TorchServingProvider`` as its factory (the JAX package's
    ``tpu_serving.register``)."""
    from langstream_tpu_torch.api.doc import ConfigModel
    from langstream_tpu_torch.core.registry import REGISTRY, ResourceTypeInfo

    REGISTRY.register_resource(
        ResourceTypeInfo(
            type="tpu-serving",
            description="Local PyTorch / CUDA completions+embeddings serving engine.",
            config_model=ConfigModel(type="tpu-serving", allow_unknown=True),
            factory=TorchServingProvider,
        )
    )
