"""Continuous-batching serving engine — the paged and dense KV layouts of
``langstream_tpu/serving/engine.py``'s ``ServingEngine``, under its request
lifecycle.

One engine thread owns the device. Each iteration (``_iterate``) first
zeroes what a quarantine left behind and resolves queued requests that
died waiting (cancelled, past their deadline), then drives the
chunked-prefill streams, then admits a token-budgeted slice of queued
requests — batched per prompt bucket into admit groups: a prefill into a
local cache, the first sample, and the insert of that cache into each row's
reserved pages (paged) or into the slot's row of the big cache (dense) —
then dispatches one decode chunk of ``decode_chunk`` fused decode+sample
steps. Sampled tokens stay on the device and feed the next step.

**The decode chunk is one CUDA-graph replay.** ``_decode_chunk`` runs the
whole chunk over static buffers — the decode chain (last token, next
position), the per-slot sampling parameters, the dispatch page table and
the ``[steps, B]`` output — and writes only into them. ``start()`` captures
it before any request, once per sampling branch (greedy; sampled; sampled
with top-k / top-p filters: the host predicates ``sample`` takes), after a
warm-up call of each on a side stream (cuBLAS handles, the kernels' shared
memory attributes and the rope table are set up outside the capture). All
graphs of an engine share one memory pool. Between replays the host writes
into the static buffers in place: freed slots' temperatures are zeroed, and
the masked page table is copied up (pinned, asynchronous) when it changed.
On the card every decode chunk is a replay; a capture that fails raises
from ``start()``. On the CPU the same function is called directly, the
dense layout with its exact ``kv_bound``; a stand-in graph object can be
set as ``_graph_factory`` to drive the replay bookkeeping there. Kernel
launch counts survive replay: each graph's per-kernel launches are taken at
capture and added back on every replay (``ops.attention.add_counts``).

Tokens reach the host through a fetch thread (``_TokenFetcher``): every
dispatch queues a pinned copy of its device output fenced by a CUDA event
right after it on the stream (so replay k+1 cannot overwrite chunk k's
output before it is copied), and the thread waits for those copies in
submission order while the engine thread dispatches the next chunk — the
JAX engine's depth-1 pipeline. A fetch whose thread is not running is
read inline.

Request lifecycle, as the JAX engine runs it: a bounded admission queue
(``queue_depth``; ``shed_policy`` "block" or "reject" with
``ShedError.retry_after_s``), hopeless deadlines shed at submit against an
EMA of the observed queue wait, ``deadline_s`` / ``max_queue_wait_s``
swept every iteration across the queue, the long backlog and the held-back
request and checked mid-decode (partial tokens, ``finish_reason``
"deadline"), cancellation within one chunk, ``drain(grace_s)``, and the
NaN guard's per-slot quarantine (dense rows zeroed, paged pages zeroed
before they return to the pool, the page-table integrity check before
every decode dispatch). A crash of the loop restarts it under bounded
exponential backoff: the slots in flight are quarantined, queued
admissions stay queued, every device buffer is rebuilt and the graphs are
captured again; once ``max_restarts`` is spent every request fails. A
sticky CUDA error (an illegal address, a device-side trap) leaves the
context unusable for the whole process, so it is not restarted in-process:
it fails everything (``_fail_all``). The fault sites of
``serving/faultinject.py`` drive these paths on demand.

On both layouts a prompt wider than the largest bucket (up to
``max_seq_len - 1`` tokens) goes to a long queue and prefills in segments
of that width, at most ``MAX_PREFILL_STREAMS`` streams at once, one
segment per stream per iteration, with decode chunks interleaving; the
final segment samples the first token and seeds the slot's decode chain.

``kv_layout="paged"`` (default): one page pool; pages are reserved in full
(prompt plus ``max_new_tokens``) at admission, or when a long prompt's
stream starts, and released when a request finishes or is cancelled; a
reservation the pool cannot cover now waits, one it can never cover ends
with ``ShedError``. A long prompt's segments write straight into the
slot's pages (``paged_prefill_segment_inplace``). ``kv_layout="dense"``: a
big cache ``[L, max_batch, Hkv, max_seq_len + 1, D]`` (the extra column is
the write sink of slots that ran past ``max_seq_len``); decode kernels
read each row to its length through the whole cache, the reference path
through a ``[..., :kv_bound]`` view; a long prompt's segments go into a
batch-1 local cache (``prefill_segment``), inserted into the slot's row
after the final one.

An MoE model's logits depend on the other rows of its batch (the experts'
capacity is shared), so its admit groups are padded to ``PREFILL_BATCH``
rows with the JAX engine's pad rows (token 0, length 1): the same groups
give the same tokens.

Not ported yet (later slices): tenancy, brownout, priorities,
``max_cost_tokens``, observability spans and flight dumps, the SPMD
watchdog, prefix reuse, speculation, adapters and grammars.
"""

from __future__ import annotations

import gc
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.models.configs import GenerationOptions, ModelConfig
from langstream_tpu_torch.models.transformer import (
    KVCache,
    decode_step_inplace,
    dense_insert_cache,
    make_kv_cache,
    paged_decode_step_inplace,
    paged_insert_cache,
    paged_prefill_segment_inplace,
    prefill,
    prefill_segment,
)
from langstream_tpu_torch.ops.attention import (
    add_counts,
    count_delta,
    count_snapshot,
    kernel_counts,
    kernel_path_ok,
)
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.pagepool import PagePool, default_num_pages
from langstream_tpu_torch.serving.sampling import sample

log = logging.getLogger(__name__)

# default prompt buckets (token widths of the admit-group prefills); the
# widest is also the chunked-prefill segment width
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
# the sampling branches a decode chunk is captured for, in capture order:
# (some row samples, some sampling row filters with top-k / top-p)
DECODE_BRANCHES = ((False, False), (True, False), (True, True))
# CUDA errors after which the context is unusable for the whole process
_STICKY_CUDA = (
    "illegal memory access", "illegal instruction", "misaligned address",
    "unspecified launch failure", "device-side assert", "hardware stack error",
    "invalid program counter",
)


class ShedError(RuntimeError):
    """Admission refused: a full queue (``shed_policy="reject"``), a
    hopeless deadline, a draining engine, or a request that needs more KV
    pages than the whole pool holds. ``retry_after_s`` is the engine's
    estimate of when capacity frees (an HTTP 429's Retry-After)."""

    def __init__(self, reason: str, retry_after_s: float = 1.0) -> None:
        super().__init__(reason)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(TimeoutError):
    """The request's deadline or max-queue-wait expired while it was still
    queued: nothing was generated."""


class LogitsNaNError(RuntimeError):
    """A slot's logits went non-finite (the sampling NaN guard): its request
    fails and its KV rows or pages are zeroed; other slots are untouched."""


def _is_sticky(error: BaseException) -> bool:
    """A CUDA error the process cannot recover from (every later call fails
    too): the restart path would only crash again."""
    if getattr(error, "sticky", False):
        return True
    text = str(error)
    return "CUDA" in text and any(p in text for p in _STICKY_CUDA)


def _rows(entry, n: int):
    """The first ``n`` batch rows of a cache [L, B, ...] (or its int8 dict)."""
    if isinstance(entry, dict):
        return {k: v[:, :n] for k, v in entry.items()}
    return entry[:, :n]


def _leaves(tree: KVCache) -> list[torch.Tensor]:
    return [
        leaf for entry in tree.values()
        for leaf in (entry.values() if isinstance(entry, dict) else (entry,))
    ]


@dataclass
class GenerationRequest:
    prompt_tokens: list[int]
    options: GenerationOptions
    # called from the engine thread with each new token id (stream path)
    on_token: Optional[Callable[[int], None]] = None
    # called from the engine thread once, with the final GenerationResult
    on_done: Optional[Callable[["GenerationResult"], None]] = None
    submitted_at: float = field(default_factory=time.monotonic)
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Optional["GenerationResult"] = None
    _cancelled: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Cancel from any thread: an active slot frees at the next chunk
        boundary (partial tokens, finish_reason "cancelled"), a queued
        request resolves at the next iteration's sweep."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def deadline_at(self) -> Optional[float]:
        """Absolute monotonic deadline, or None when the request has none."""
        if self.options.deadline_s is None:
            return None
        return self.submitted_at + self.options.deadline_s

    def result(self, timeout: Optional[float] = None) -> "GenerationResult":
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        assert self._result is not None
        if self._result.error is not None:
            raise self._result.error
        return self._result

    def _finish(self, result: "GenerationResult") -> None:
        if self._done.is_set():
            return  # the first resolution wins (sweep vs admission races)
        self._result = result
        self._done.set()
        if self.on_done is not None:
            try:
                self.on_done(result)
            except Exception:  # noqa: BLE001 — a callback must not kill the loop
                log.exception("on_done callback failed")


@dataclass
class GenerationResult:
    tokens: list[int]
    # stop | length | cancelled | deadline | error — cancelled and deadline
    # carry the tokens generated so far
    finish_reason: str
    prompt_tokens: int
    ttft_s: float
    total_s: float
    error: Optional[BaseException] = None


@dataclass
class _Slot:
    request: Optional[GenerationRequest] = None
    position: int = 0  # next write position (= prompt len + generated so far)
    generated: list[int] = field(default_factory=list)
    started_at: float = 0.0
    first_token_at: float = 0.0

    @property
    def active(self) -> bool:
        return self.request is not None


class _Fetch:
    """A device tensor on its way to the host: a pinned copy queued on the
    current stream and fenced by a CUDA event when it is made (a CPU tensor
    is cloned). The fetch thread fills ``_value`` in submission order;
    ``result`` reads the copy inline when no fetch thread is running."""

    __slots__ = ("_host", "_event", "_fetcher", "_landed", "_value")

    def __init__(self, tensor: torch.Tensor, fetcher: "_TokenFetcher") -> None:
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event: Optional[torch.cuda.Event] = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor.clone()
            self._event = None
        self._fetcher = fetcher
        self._landed = threading.Event()
        self._value: Any = None

    @property
    def done(self) -> bool:
        return self._landed.is_set()

    def ready(self) -> bool:
        """The bytes are on the host (reading them would not block)."""
        return self._landed.is_set() or self._event is None or self._event.query()

    def _materialize(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def result(self) -> np.ndarray:
        while not self._landed.wait(0.5 if self._fetcher.alive() else 0):
            if not self._fetcher.alive():
                return self._materialize()
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value


class _TokenFetcher:
    """The device-to-host fetch thread: one FIFO queue and one worker keep
    results in submission (= dispatch) order while the engine thread
    dispatches the next chunk. Consults the ``fetch`` fault site."""

    def __init__(self, injector: Optional[FaultInjector] = None) -> None:
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._injector = injector

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.alive():
            return
        self._thread = threading.Thread(target=self._run, name="serving-fetch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=30)
            self._thread = None

    def submit(self, tensor: torch.Tensor) -> _Fetch:
        handle = _Fetch(tensor, self)
        if self.alive():
            self._queue.put(handle)
        return handle

    def _run(self) -> None:
        while True:
            handle = self._queue.get()
            if handle is None:
                return
            try:
                if self._injector is not None:
                    self._injector.stall("fetch")
                handle._value = handle._materialize()
            except BaseException as e:  # noqa: BLE001 — surfaces at result()
                handle._value = e
            handle._landed.set()


class _CudaGraph:
    """One captured decode chunk on the card: a ``torch.cuda.CUDAGraph`` in
    the engine's shared pool, captured on a side stream with the engine's
    generator registered, so every replay advances its Philox offset (a
    draw is never repeated)."""

    def __init__(self, pool, stream: torch.cuda.Stream, generator: torch.Generator) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.stream = stream
        self.generator = generator

    def capture(self, fn: Callable[[], None]) -> None:
        register = getattr(self.graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                "this torch cannot capture a draw from an explicit generator "
                "(torch.cuda.CUDAGraph.register_generator_state is missing)"
            )
        register(self.generator)
        with torch.cuda.graph(
            self.graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"
        ):
            fn()

    def replay(self) -> None:
        self.graph.replay()


class ServingEngine:
    """One engine per model; owns the device loop (paged or dense KV layout)."""

    # rows per admit group (one prefill call; an MoE model's groups are
    # padded to it)
    PREFILL_BATCH = 8
    # long prompts waiting for a chunked-prefill stream before the next one
    # is held back (so submit's queue bound still engages), and streams
    # prefilling at once (dense: each holds one long local cache)
    LONG_QUEUE_CAP = 8
    MAX_PREFILL_STREAMS = 2
    # a stand-in for the decode chunk's CUDA graph (an object with
    # ``capture(fn)`` and ``replay()``, made with no arguments): set on an
    # engine before ``start()`` to drive the replay path off the card
    _graph_factory: Optional[Callable[[], Any]] = None

    def __init__(
        self,
        config: ModelConfig,
        params: Any,
        max_batch: int = 8,
        max_seq_len: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        prefill_buckets: tuple[int, ...] = PREFILL_BUCKETS,
        rng_seed: int = 0,
        decode_chunk: int = 16,
        page_size: int = 64,
        kv_pages: Optional[int] = None,
        kv_layout: str = "paged",
        device: DeviceLike = "cuda",
        queue_depth: Optional[int] = None,
        shed_policy: str = "block",
        restart_backoff_s: float = 0.1,
        max_restarts: int = 5,
        fault_injector: Optional[FaultInjector] = None,
    ) -> None:
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; supported: paged, dense")
        if queue_depth is not None and int(queue_depth) <= 0:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if shed_policy not in ("block", "reject"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}; supported: block, reject")
        self.device = resolve_device(device)
        # a config the kernels cannot take on this device (a non-bf16 model
        # on the card) raises here, before anything is allocated
        kernel_path_ok(config, self.device)
        self.config = config
        self.params = params
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len or config.max_seq_len)
        self.eos_token_id = eos_token_id
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= self.max_seq_len
        ) or (self.max_seq_len,)
        self.decode_chunk = max(1, int(decode_chunk))
        # each iteration admits at most one widest bucket of prompt tokens
        # (floored at one full admit group) before its decode chunk, so a
        # burst of admissions overlaps the running batch's decode
        self.prefill_token_budget = self.prefill_buckets[-1]
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self.page_size = max(1, int(page_size))
        self._pagepool: Optional[PagePool] = None
        self._cache: Optional[KVCache] = None
        if self._paged:
            num_pages = (
                int(kv_pages)
                if kv_pages is not None
                else default_num_pages(self.max_batch, self.max_seq_len, self.page_size)
            )
            self._pagepool = PagePool(
                config, num_pages, self.page_size, self.max_batch, self.max_seq_len,
                device=self.device,
            )
        else:
            # + one sink column: a slot that finished mid-chunk keeps
            # advancing on the device, and its writes past max_seq_len land
            # there (JAX drops them)
            self._cache = make_kv_cache(
                config, self.max_batch, self.max_seq_len + 1, device=self.device
            )
        # chunked-prefill streams: queued long requests, one held back when
        # that queue is full, and the active streams by slot (request, next
        # segment; dense: its local cache)
        self._long_queue: list[GenerationRequest] = []
        self._held_back: Optional[GenerationRequest] = None
        self._longs: dict[int, dict] = {}
        self._long_rr = -1
        # decode steps dispatched but not yet processed on the host: device
        # positions lead host positions by this much
        self._inflight_steps = 0
        self._slots = [_Slot() for _ in range(self.max_batch)]
        self.shed_policy = shed_policy
        self._queue: queue.Queue = queue.Queue(
            maxsize=int(queue_depth) if queue_depth is not None else self.max_batch * 4
        )
        # admissions popped from the queue but waiting for pool pages;
        # retried ahead of the queue every iteration
        self._page_deferred: deque[GenerationRequest] = deque()
        # queued-but-unadmitted requests (queue.Queue cannot be walked): the
        # expiry sweep resolves them without waiting for a slot
        self._waiting: dict[int, GenerationRequest] = {}
        self._waiting_lock = threading.Lock()
        # EMA of the observed queue wait: submit's hopeless-deadline shed
        # and ShedError.retry_after_s read it
        self._queue_wait_ema_s = 0.0
        self._draining = False
        # drain()'s blind spot: a request popped from the queue but not yet
        # visible in a slot exists only inside an iteration's admission
        self._mid_iteration = False
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(rng_seed))
        # the device-resident decode state the graphs read and write
        # (_alloc_decode_state): chain, sampling params, table, output
        self._alloc_decode_state()
        # slots freed since the last dispatch: their device temperature is
        # zeroed so a dead slot never keeps the sampling path on
        self._freed_slots: list[int] = []
        # quarantine: dense rows and physical pages to zero at the top of
        # the next iteration
        self._pending_row_resets: list[int] = []
        self._pending_page_zero: list[int] = []
        # the captured decode chunks: sampling branch → (graph, per-kernel
        # launches of one replay)
        self._graphs: dict[tuple[bool, bool], tuple[Any, dict]] = {}
        self.restart_backoff_s = max(0.01, float(restart_backoff_s))
        self.max_restarts = max(0, int(max_restarts))
        self._injector = (
            fault_injector if fault_injector is not None else FaultInjector.from_env()
        )
        self._fetcher = _TokenFetcher(self._injector)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead: Optional[BaseException] = None
        self._recovering = False
        self._last_crash_t = 0.0
        self._stats_lock = threading.Lock()
        self.total_requests = 0
        self.total_generated = 0
        self.admit_groups_total = 0
        self.prefill_tokens_total = 0
        self.prefill_segments_total = 0
        self.decode_chunks_total = 0
        self.decode_steps_total = 0
        self.nan_guard_total = 0
        self.cancelled_total = 0
        self.shed_total = 0
        self.deadline_queue_total = 0
        self.deadline_decode_total = 0
        self.quarantined_slots_total = 0
        self.engine_restarts_total = 0
        self.graph_captures_total = 0
        self.graph_replays_total = 0
        self.graph_capture_s = 0.0
        self.graph_pool_bytes = 0

    def _alloc_decode_state(self) -> None:
        """Fresh static buffers of the decode chunk: the chain (last sampled
        token and next write position per slot), the per-slot sampling
        params, the dispatch page table (paged; every row the sentinel) and
        the ``[steps, B]`` output. The graphs hold raw pointers to these:
        they are only ever written in place."""
        dev = self.device
        b = self.max_batch
        self._tokens_dev = torch.zeros(b, dtype=torch.long, device=dev)
        self._positions_dev = torch.zeros(b, dtype=torch.long, device=dev)
        self._temp_dev = torch.zeros(b, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros(b, dtype=torch.long, device=dev)
        self._top_p_dev = torch.ones(b, dtype=torch.float32, device=dev)
        self._chunk_out = torch.zeros((self.decode_chunk, b), dtype=torch.long, device=dev)
        self._table_dev: Optional[torch.Tensor] = None
        self._table_uploaded: Optional[np.ndarray] = None
        if self._paged:
            pool = self._pagepool
            self._table_dev = torch.full(
                pool.tables.shape, pool.oob, dtype=torch.int32, device=dev
            )
            self._table_uploaded = np.full(pool.tables.shape, pool.oob, np.int32)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without a host sync: staged in pinned
        memory and copied asynchronously on the card (the caching host
        allocator keeps the staging block until the copy ran)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        """Capture the decode graphs (on the card, or with a stand-in
        ``_graph_factory``) — a failed capture raises here, before any
        request — then start the fetch thread and the engine thread."""
        if self._thread is not None:
            return
        if not self._graphs:
            self._capture_graphs()
        self._dead = None
        self._stop.clear()
        self._fetcher.start()
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fetcher.stop()
        # resolve everything still in flight so blocked callers return now
        self._fail_all(RuntimeError("serving engine stopped"))

    def drain(self, grace_s: float = 30.0) -> bool:
        """Graceful quiescence, distinct from stop(): reject new submissions
        (ShedError) but let everything already accepted run to completion.
        True when the engine went quiet within ``grace_s``; False when work
        was still in flight at the end of the grace. Does not stop the
        engine thread; call stop() after."""
        self._draining = True
        deadline = time.monotonic() + max(0.0, grace_s)
        while time.monotonic() < deadline:
            if self._quiesced():
                return True
            if self._thread is None or not self._thread.is_alive():
                return self._quiesced()
            time.sleep(0.01)
        return self._quiesced()

    def _quiesced(self) -> bool:
        return (
            not self._mid_iteration
            and not any(s.active for s in self._slots)
            and self._queue.qsize() == 0
            and not self._longs
            and not self._long_queue
            and not self._page_deferred
            and self._held_back is None
        )

    # -- the captured decode chunk ---------------------------------------------

    def _capture_graphs(self) -> None:
        """Capture ``_decode_chunk`` once per sampling branch, in
        ``DECODE_BRANCHES`` order, into one shared pool — on the card with
        ``torch.cuda.CUDAGraph`` after one warm-up call of each branch on the
        side stream, off the card only with a stand-in ``_graph_factory``.
        Each graph's kernel launches are counted at capture and removed
        from the totals (the capture launched nothing); each replay adds
        them back. Raises when a capture fails."""
        factory = self._graph_factory
        cuda = self.device.type == "cuda"
        if factory is None and not cuda:
            return  # the CPU calls the chunk function directly
        t0 = time.monotonic()
        reserved0 = 0
        with torch.no_grad():
            if factory is None:
                stream = torch.cuda.Stream(self.device)
                pool = torch.cuda.graph_pool_handle()
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    for branch in DECODE_BRANCHES:
                        self._decode_chunk(*branch)
                torch.cuda.current_stream(self.device).wait_stream(stream)
                torch.cuda.synchronize(self.device)
                # the graph pool's bytes: what stays reserved past the
                # captures once every releasable block went back
                torch.cuda.empty_cache()
                reserved0 = torch.cuda.memory_reserved(self.device)

                def factory() -> _CudaGraph:
                    return _CudaGraph(pool, stream, self._generator)

            graphs = {}
            # a garbage collection inside a capture could destroy another
            # engine's unreachable graphs (and free their pool), which a
            # capturing stream refuses: collect first, none during
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                for branch in DECODE_BRANCHES:
                    graph = factory()
                    before = count_snapshot()
                    graph.capture(lambda b=branch: self._decode_chunk(*b))
                    delta = count_delta(before, count_snapshot())
                    add_counts(delta, -1)
                    graphs[branch] = (graph, delta)
            finally:
                if collecting:
                    gc.enable()
            if cuda:
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
        self._graphs = graphs
        with self._stats_lock:
            self.graph_captures_total += len(graphs)
            self.graph_capture_s += time.monotonic() - t0
            if cuda:
                self.graph_pool_bytes = torch.cuda.memory_reserved(self.device) - reserved0
        log.info("captured %d decode graphs in %.2fs", len(graphs), time.monotonic() - t0)

    def _decode_chunk(self, samples: bool, filters: bool, kv_bound: Optional[int] = None) -> None:
        """One decode chunk over the static buffers: ``decode_chunk`` x
        (decode step + sample) from the device chain, each step's tokens
        written into the chain and into ``_chunk_out[step]``, positions
        advanced in place — nothing rebound, no host sync, so this is the
        function the graphs capture. Paged: rows of the dispatch table that
        are not active are the sentinel, so their (discarded) steps write
        only into the sink page. Dense: inactive rows write into their own
        rows (past max_seq_len, into the sink column); the kernels read
        each row to its length, ``kv_bound`` (the CPU's reference path)
        narrows the masked read."""
        for step in range(self.decode_chunk):
            if self._paged:
                logits, _ = paged_decode_step_inplace(
                    self.params, self._tokens_dev, self._positions_dev, self._pagepool.dev,
                    self._table_dev, self.config, self.page_size,
                )
            else:
                logits, _ = decode_step_inplace(
                    self.params, self._tokens_dev, self._positions_dev, self._cache,
                    self.config, kv_bound,
                )
            tokens = sample(
                logits, self._generator, self._temp_dev, self._top_k_dev, self._top_p_dev,
                samples, filters,
            )
            self._tokens_dev.copy_(tokens)
            self._positions_dev.add_(1)
            self._chunk_out[step].copy_(tokens)

    def _branch(self) -> tuple[bool, bool]:
        """The sampling branch the active slots need (host predicates)."""
        opts = [s.request.options for s in self._slots if s.active]
        samples = any(o.temperature > 0 for o in opts)
        filters = any(o.temperature > 0 and (o.top_k > 0 or o.top_p < 1.0) for o in opts)
        return samples, filters

    def _prepare_chunk(self) -> None:
        """Host writes into the static buffers before a chunk: zero the
        temperature of slots freed since the last dispatch (and not
        re-admitted), and copy up the masked page table when it changed."""
        stale = [i for i in set(self._freed_slots) if not self._slots[i].active]
        self._freed_slots.clear()
        for i in stale:
            self._temp_dev[i] = 0.0
        if self._paged:
            self._refresh_table(self._dispatch_tables())

    def _refresh_table(self, tables: np.ndarray) -> None:
        """Copy the dispatch table into the static ``[B, Tp]`` buffer when it
        differs from the one the device holds."""
        if np.array_equal(tables, self._table_uploaded):
            return
        self._table_dev.copy_(self._upload(tables), non_blocking=True)
        self._table_uploaded = tables.copy()

    def _run_chunk(self, branch: tuple[bool, bool]) -> None:
        """Run one decode chunk: replay its captured graph and add the
        graph's launches to the kernel counts — or, on the CPU without a
        stand-in graph, call the chunk function (dense: with the exact
        bound)."""
        captured = self._graphs.get(branch)
        if captured is None:
            if self.device.type == "cuda" or self._graph_factory is not None:
                raise RuntimeError("no captured decode graph: start() captures them")
            kv_bound = None if self._paged else self._decode_kv_bound(self.decode_chunk)
            self._decode_chunk(*branch, kv_bound=kv_bound)
            return
        graph, delta = captured
        graph.replay()
        add_counts(delta)
        with self._stats_lock:
            self.graph_replays_total += 1

    # -- public API ------------------------------------------------------------

    def submit(self, request: GenerationRequest) -> GenerationRequest:
        """Thread-safe enqueue. A full queue blocks (``shed_policy``
        "block") or sheds with ShedError and a retry-after estimate
        ("reject"). A request whose deadline cannot survive the observed
        queue wait is shed at once either way, as is every request once the
        engine drains."""
        if self._dead is not None:
            raise RuntimeError("serving engine is stopped") from self._dead
        # stamped on every submit attempt: a retry after ShedError reuses
        # the request, and its sleep is not queue wait
        request.submitted_at = time.monotonic()
        if self._draining:
            self._count_shed()
            raise ShedError("serving engine is draining", retry_after_s=5.0)
        n = len(request.prompt_tokens)
        limit = self.max_seq_len - 1
        if n > limit:
            raise ValueError(
                f"prompt of {n} tokens exceeds the engine limit of {limit} (max_seq_len - 1)"
            )
        deadline_s = request.options.deadline_s
        if deadline_s is not None:
            est_wait = self._queue_wait_ema_s
            if deadline_s <= 0 or (self._queue.qsize() > 0 and est_wait >= deadline_s):
                self._count_shed()
                raise ShedError(
                    f"deadline of {deadline_s:.2f}s cannot survive the current "
                    f"~{est_wait:.2f}s queue wait",
                    retry_after_s=max(est_wait, 0.1),
                )
        with self._waiting_lock:
            self._waiting[id(request)] = request
        try:
            if self.shed_policy == "reject":
                self._queue.put_nowait(request)
            else:
                self._queue.put(request)
        except queue.Full:
            with self._waiting_lock:
                self._waiting.pop(id(request), None)
            self._count_shed()
            raise ShedError(
                f"admission queue full ({self._queue.maxsize} deep)",
                retry_after_s=max(self._queue_wait_ema_s, 0.1),
            ) from None
        except BaseException:
            with self._waiting_lock:
                self._waiting.pop(id(request), None)
            raise
        return request

    def generate(
        self,
        prompt_tokens: list[int],
        options: Optional[GenerationOptions] = None,
        on_token: Optional[Callable[[int], None]] = None,
        timeout: float = 300.0,
    ) -> GenerationResult:
        """Blocking submit + wait; a wait timeout cancels the request, so
        the engine does not keep decoding an orphan nobody reads."""
        req = GenerationRequest(
            prompt_tokens=list(prompt_tokens),
            options=options or GenerationOptions(),
            on_token=on_token,
        )
        self.submit(req)
        try:
            return req.result(timeout)
        except TimeoutError:
            req.cancel()
            raise

    def _count_shed(self) -> None:
        with self._stats_lock:
            self.shed_total += 1

    def stats(self) -> dict[str, Any]:
        pool = self._pagepool
        with self._stats_lock:
            out = {
                "device": str(self.device),
                "max-batch": self.max_batch,
                "active-slots": sum(1 for s in self._slots if s.active),
                "queued": self._queue.qsize() + len(self._page_deferred),
                "total-requests": self.total_requests,
                "total-generated-tokens": self.total_generated,
                "admit-groups-total": self.admit_groups_total,
                "prefill-tokens-total": self.prefill_tokens_total,
                "prefill-segments-total": self.prefill_segments_total,
                "decode-chunks-total": self.decode_chunks_total,
                "decode-steps-total": self.decode_steps_total,
                "kv-layout": self.kv_layout,
                "long-prefill-queued": len(self._long_queue) + (self._held_back is not None),
                "long-prefill-streams": len(self._longs),
                # request lifecycle (the JAX engine's names)
                "draining": self._draining,
                "recovering": self._recovering,
                "shed-total": self.shed_total,
                "cancelled-total": self.cancelled_total,
                "deadline-exceeded-total": self.deadline_queue_total + self.deadline_decode_total,
                "deadline-queue-total": self.deadline_queue_total,
                "deadline-decode-total": self.deadline_decode_total,
                "quarantined-slots-total": self.quarantined_slots_total,
                "nan-guard-total": self.nan_guard_total,
                "engine-restarts-total": self.engine_restarts_total,
                "queue-wait-ema-s": round(self._queue_wait_ema_s, 4),
                "fault-injection": (
                    self._injector.stats() if self._injector is not None else None
                ),
                # the decode graphs: live captures (the counterpart of the
                # JAX engine's compiled programs), all captures so far
                # (restarts capture again), replays, capture wall time and
                # the shared pool's bytes
                "compiled_programs": len(self._graphs),
                "graph-captures-total": self.graph_captures_total,
                "graph-replays-total": self.graph_replays_total,
                "graph-capture-s": self.graph_capture_s,
                "graph-pool-bytes": self.graph_pool_bytes,
                # launches of each attention kernel in this process (CUDA,
                # replays included) and calls of its plain version (CPU)
                "kernels": kernel_counts(),
            }
        if pool is not None:
            out.update({
                "kv-page-size": self.page_size,
                "kv-pages-total": pool.num_pages,
                "kv-pages-in-use": pool.pages_in_use,
                "kv-pages-free": pool.free_pages,
                "kv-pool-bytes": pool.bytes_total,
            })
        else:
            out["kv-cache-bytes"] = sum(
                t.numel() * t.element_size() for t in _leaves(self._cache)
            )
        return out

    # -- the loop --------------------------------------------------------------

    def _run(self) -> None:
        """Engine-thread supervisor: run the loop; on a crash, quarantine the
        slots in flight, rebuild the device state (graphs captured again)
        and restart under bounded exponential backoff. A crash that is not
        an Exception, a sticky CUDA error, or one past ``max_restarts``
        fails everything instead."""
        backoff = self.restart_backoff_s
        restarts = 0
        try:
            while True:
                try:
                    self._recovering = False
                    self._run_once()
                    return  # clean stop
                except BaseException as e:  # noqa: BLE001 — classified below
                    now = time.monotonic()
                    if self._last_crash_t and now - self._last_crash_t > 60.0:
                        # a crash long after the last one is a new incident
                        restarts = 0
                        backoff = self.restart_backoff_s
                    self._last_crash_t = now
                    recoverable = (
                        isinstance(e, Exception)
                        and not _is_sticky(e)
                        and restarts < self.max_restarts
                        and not self._stop.is_set()
                    )
                    if not recoverable:
                        log.exception("serving engine loop crashed (unrecoverable)")
                        self._fail_all(e)
                        return
                    restarts += 1
                    self._recovering = True
                    with self._stats_lock:
                        self.engine_restarts_total += 1
                    log.exception(
                        "serving engine loop crashed; quarantining %d in-flight slot(s), "
                        "restarting in %.2fs (restart %d/%d)",
                        sum(1 for s in self._slots if s.active) + len(self._longs),
                        backoff, restarts, self.max_restarts,
                    )
                    try:
                        self._recover(e)
                    except BaseException as e2:  # noqa: BLE001 — recovery itself failed
                        log.exception("crash recovery failed; engine is dead")
                        self._fail_all(e2)
                        return
                    if self._stop.wait(backoff):
                        return  # stop() raced the backoff; it fails the rest
                    backoff = min(backoff * 2, 30.0)
        finally:
            self._recovering = False

    def _run_once(self) -> None:
        # batches of deferred fetch entries, one per iteration, newest last
        pending: deque[list[tuple]] = deque()
        with torch.no_grad():
            while not self._stop.is_set():
                self._iterate(pending)
            while pending:
                for entry in pending.popleft():
                    self._process_entry(entry)

    def _recover(self, error: BaseException) -> None:
        """Quarantine and rebuild after a loop crash, without failing
        untouched work: slots in flight and long-prefill streams fail with
        the error (teardown strictly before their waiters wake); queued and
        page-deferred admissions were never dispatched, so they stay queued
        and are served after the restart. Every device buffer is rebuilt
        and the graphs are captured again."""
        finished: list[tuple[GenerationRequest, GenerationResult]] = []
        for slot in self._slots:
            request = slot.request
            if request is not None:
                finished.append((request, self._result(
                    request, slot.generated, "error", slot.first_token_at, error
                )))
                slot.request = None
                slot.generated = []
                slot.position = 0
        for idx in list(self._longs):
            st = self._longs.pop(idx)
            finished.append((st["request"], self._result(st["request"], [], "error", error=error)))
        with self._stats_lock:
            self.quarantined_slots_total += len(finished)
        for request, result in finished:
            request._finish(result)
        self._inflight_steps = 0
        self._rebuild_device_state()
        if not self._fetcher.alive():
            self._fetcher.start()

    def _rebuild_device_state(self) -> None:
        """Fresh device state after a crash: the graphs are dropped first
        (they hold raw pointers into the buffers below), the pool's pages
        and tables or the dense cache are remade from scratch (the old
        ones released before the new ones are allocated), the decode
        buffers too, and the graphs are captured again. The generator
        keeps its live state."""
        self._freed_slots.clear()
        self._pending_row_resets.clear()
        self._pending_page_zero.clear()
        self._graphs = {}
        if self._paged:
            self._pagepool.reset()
        else:
            self._cache = None
            self._cache = make_kv_cache(
                self.config, self.max_batch, self.max_seq_len + 1, device=self.device
            )
        self._alloc_decode_state()
        self._capture_graphs()

    def _iterate(self, pending: deque) -> None:
        """One fused iteration: the quarantine's zeroing and the expiry
        sweep, then a token-budgeted slice of prefill work (chunked-prefill
        segments first, so a long prompt cannot starve under short
        traffic, then admissions), then the decode chunk — back-to-back on
        the in-order stream — then host processing of whatever batch of
        earlier dispatches has landed."""
        if self._pending_row_resets:
            self._flush_row_resets()
        if self._pending_page_zero:
            self._flush_page_zeros()
        self._sweep_waiting()
        self._inflight_steps = sum(e[3] for batch in pending for e in batch if e[0] == "chunk")
        had_active = any(s.active for s in self._slots)
        self._mid_iteration = True
        try:
            new_pending, spent = self._long_step(self.prefill_token_budget)
            new_pending.extend(self._admit(max(0, self.prefill_token_budget - spent)))
        finally:
            self._mid_iteration = False
        if new_pending and not had_active:
            # cold start: nothing to overlap the first-token fetch with
            for entry in new_pending:
                self._process_entry(entry)
            new_pending = []
        if any(s.active for s in self._slots):
            chunk = self._dispatch_chunk()
            if chunk is not None:
                new_pending.append(chunk)
        elif not new_pending and not pending and not spent:
            time.sleep(0.001)
        pending.append(new_pending)
        # depth-1 pipeline: at most one dispatched batch waits unprocessed
        while pending and (
            len(pending) > 1
            or not new_pending
            or all(e[1].ready() for e in pending[0])
        ):
            for entry in pending.popleft():
                self._process_entry(entry)

    def _sweep_waiting(self) -> None:
        """Resolve queued-but-unadmitted requests that died waiting
        (cancelled, past deadline or max-queue-wait) without waiting for a
        slot: the shadow ``_waiting`` dict, the page-deferred admissions,
        the long backlog and the held-back request. A swept request's queue
        entry is skipped when it is popped (already done)."""
        now = time.monotonic()
        with self._waiting_lock:
            waiting = list(self._waiting.values())
        for request in waiting:
            if request._done.is_set() or self._resolve_if_dead(request, now):
                with self._waiting_lock:
                    self._waiting.pop(id(request), None)
        self._long_queue = [
            r for r in self._long_queue
            if not (r._done.is_set() or self._resolve_if_dead(r, now))
        ]
        self._page_deferred = deque(
            r for r in self._page_deferred
            if not (r._done.is_set() or self._resolve_if_dead(r, now))
        )
        if self._held_back is not None and (
            self._held_back._done.is_set() or self._resolve_if_dead(self._held_back, now)
        ):
            self._held_back = None

    @staticmethod
    def _expired(request: GenerationRequest, now: float) -> bool:
        opts = request.options
        wait = now - request.submitted_at
        return (opts.deadline_s is not None and wait >= opts.deadline_s) or (
            opts.max_queue_wait_s is not None and wait > opts.max_queue_wait_s
        )

    def _resolve_if_dead(self, request: GenerationRequest, now: float) -> bool:
        """Resolve a queued request that was cancelled or expired while
        waiting, without a slot or prefill work. True when resolved (or
        already done)."""
        if request._done.is_set():
            return True
        wait = now - request.submitted_at
        if request.cancelled:
            with self._stats_lock:
                self.cancelled_total += 1
            request._finish(GenerationResult(
                tokens=[], finish_reason="cancelled",
                prompt_tokens=len(request.prompt_tokens), ttft_s=0, total_s=wait,
            ))
            return True
        if self._expired(request, now):
            opts = request.options
            with self._stats_lock:
                self.deadline_queue_total += 1
            request._finish(GenerationResult(
                tokens=[], finish_reason="deadline",
                prompt_tokens=len(request.prompt_tokens), ttft_s=0, total_s=wait,
                error=DeadlineExceededError(
                    f"request waited {wait:.2f}s in queue against deadline={opts.deadline_s} "
                    f"max-queue-wait={opts.max_queue_wait_s}"
                ),
            ))
            return True
        return False

    def _prequalify(self, request: GenerationRequest) -> bool:
        """The queue-exit gate: False when the request died waiting; a live
        request feeds the queue-wait EMA that submit's shed reads."""
        now = time.monotonic()
        if self._resolve_if_dead(request, now):
            return False
        wait = now - request.submitted_at
        with self._stats_lock:
            self._queue_wait_ema_s = (
                wait if self._queue_wait_ema_s == 0 else 0.8 * self._queue_wait_ema_s + 0.2 * wait
            )
        return True

    def _flush_row_resets(self) -> None:
        """Zero the big-cache rows of NaN-quarantined slots (dense), so a
        poisoned row never reaches a later request of that slot."""
        stale = sorted(set(self._pending_row_resets))
        self._pending_row_resets.clear()
        for leaf in _leaves(self._cache):
            for idx in stale:
                leaf[:, idx].zero_()

    def _flush_page_zeros(self) -> None:
        """Zero the physical pages a quarantine freed, at the top of the
        iteration: on the in-order stream this lands after the chunks that
        still held them and before any admission that reuses them."""
        pages = self._upload(np.asarray(sorted(set(self._pending_page_zero)), np.int64))
        self._pending_page_zero = []
        for leaf in _leaves(self._pagepool.dev):
            leaf.index_fill_(1, pages, 0)

    # -- admission -------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _pop_admission(self, allow_new: bool) -> GenerationRequest:
        if self._page_deferred:
            return self._page_deferred.popleft()
        if not allow_new:
            raise queue.Empty
        return self._queue.get_nowait()

    def _admit(self, budget: int) -> list[tuple]:
        """Move queued requests into free slots, batched per prompt bucket
        into admit groups; returns the deferred first-token fetch entries.
        ``budget`` caps this iteration's prefill tokens, floored at one
        full admission group. A group whose prefill fails (the ``prefill``
        fault site) fails its own requests only."""
        free = [
            i for i, slot in enumerate(self._slots) if not slot.active and i not in self._longs
        ]
        pairs: list[tuple[int, GenerationRequest]] = []
        admitted_tokens = 0
        # while deferred admissions wait for pages, only they retry
        allow_new = not self._page_deferred
        widest = self.prefill_buckets[-1]
        # a held-back long request gets first claim on freed long-queue room
        if self._held_back is not None and len(self._long_queue) < self.LONG_QUEUE_CAP:
            self._long_queue.append(self._held_back)
            self._held_back = None
        for idx in free:
            got = False
            while not got and self._held_back is None:
                if admitted_tokens >= budget and len(pairs) >= self.PREFILL_BATCH:
                    break
                try:
                    request = self._pop_admission(allow_new)
                except queue.Empty:
                    break
                with self._waiting_lock:
                    self._waiting.pop(id(request), None)
                if request._done.is_set() or not self._prequalify(request):
                    continue  # resolved by the sweep, or dead on its way out
                n = len(request.prompt_tokens)
                if n > widest:
                    # the chunked-prefill path, its queue bounded so
                    # submit's backpressure still engages under long traffic
                    if len(self._long_queue) >= self.LONG_QUEUE_CAP:
                        self._held_back = request
                        break
                    self._long_queue.append(request)
                    continue
                if not self._paged:
                    pairs.append((idx, request))
                    admitted_tokens += self._bucket(n)
                    got = True
                    continue
                reserved = self._reserve_pages(idx, request)
                if reserved is None:
                    continue  # can never fit: resolved with ShedError
                if not reserved:
                    # pool exhausted: defer (retried first next iteration)
                    self._page_deferred.appendleft(request)
                    allow_new = False
                    break
                pairs.append((idx, request))
                admitted_tokens += self._bucket(n)
                got = True
            if not got:
                break
        groups: dict[int, list[tuple[int, GenerationRequest]]] = {}
        for idx, request in pairs:
            groups.setdefault(self._bucket(len(request.prompt_tokens)), []).append(
                (idx, request)
            )
        entries: list[tuple] = []
        for width, group in sorted(groups.items()):
            for start in range(0, len(group), self.PREFILL_BATCH):
                sub = group[start:start + self.PREFILL_BATCH]
                try:
                    entries.extend(self._prefill_group(width, sub))
                except Exception as e:  # noqa: BLE001 — fail the group, not the engine
                    if _is_sticky(e):
                        raise
                    log.exception("prefill failed for a group of %d requests", len(sub))
                    for idx, request in sub:
                        if self._paged:
                            self._pagepool.free_slot(idx)  # reserved above
                        request._finish(self._result(request, [], "error", error=e))
        return entries

    def _reserve_pages(self, idx: int, request: GenerationRequest) -> Optional[bool]:
        """Reserve slot ``idx``'s worst-case pages (prompt plus
        max_new_tokens): True when bound, False when the pool cannot cover
        them now (slot untouched), None when it never can — the request is
        then resolved with ``ShedError``."""
        pool = self._pagepool
        need = pool.pages_needed(
            len(request.prompt_tokens), max(1, request.options.max_new_tokens)
        )
        if need > pool.num_pages:
            request._finish(self._result(
                request, [], "error",
                error=ShedError(
                    f"request needs {need} KV pages but the pool has only "
                    f"{pool.num_pages}; raise kv-pages (or lower max-new-tokens)"
                ),
            ))
            return None
        return pool.reserve(idx, need)

    def _prefill_group(self, width: int, group: list[tuple[int, GenerationRequest]]) -> list[tuple]:
        """One admit group: every (slot, request) pair of one prompt bucket,
        prompts right-padded with zeros to the bucket width. An MoE model's
        group also gets pad rows (token 0, length 1) up to PREFILL_BATCH,
        as the JAX engine pads every group: the rows share the experts'
        capacity, so the same rows give the same logits."""
        n = self.PREFILL_BATCH if self.config.is_moe else len(group)
        tokens = np.zeros((n, width), np.int64)
        lengths = np.ones(n, np.int64)
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int64)
        top_ps = np.ones(n, np.float32)
        slots = np.zeros(n, np.int64)
        started = time.monotonic()
        for j, (idx, request) in enumerate(group):
            prompt = request.prompt_tokens
            tokens[j, : len(prompt)] = prompt
            lengths[j] = len(prompt)
            temps[j] = request.options.temperature
            top_ks[j] = request.options.top_k
            top_ps[j] = request.options.top_p
            slots[j] = idx
        first = self._dev_prefill(tokens, lengths, temps, top_ks, top_ps, slots, len(group))
        for idx, request in group:
            slot = self._slots[idx]
            slot.request = request
            slot.position = len(request.prompt_tokens)
            slot.generated = []
            slot.started_at = started
            slot.first_token_at = 0.0
        with self._stats_lock:
            self.total_requests += len(group)
            self.admit_groups_total += 1
            self.prefill_tokens_total += sum(len(r.prompt_tokens) for _, r in group)
        return [("prefill", self._fetcher.submit(first), list(group), 0)]

    def _dev_prefill(self, tokens, lengths, temps, top_ks, top_ps, slots, rows: int):
        """Device layer of an admit group: local-cache prefill, the insert of
        that cache into each real row's pages (paged) or its slot's row of
        the big cache (dense), then the first sample and the chain seeding.
        Rows from ``rows`` on are padding: they prefill and are dropped.
        The ``prefill`` fault site fires before any state changes."""
        if self._injector is not None:
            self._injector.fire("prefill")
        dev = self.device
        n, width = tokens.shape
        local = make_kv_cache(self.config, n, width, device=dev)
        logits, local = prefill(self.params, self._upload(tokens), self._upload(lengths), local,
                                self.config)
        if rows < n:
            local = {name: _rows(entry, rows) for name, entry in local.items()}
            logits = logits[:rows]
            slots, lengths, temps = slots[:rows], lengths[:rows], temps[:rows]
            top_ks, top_ps = top_ks[:rows], top_ps[:rows]
        if self._paged:
            tables = self._upload(self._pagepool.tables[slots])
            paged_insert_cache(self._pagepool.dev, local, tables, self.page_size)
        else:
            dense_insert_cache(self._cache, local, self._upload(slots))
        return self._seed_chain(logits, slots, lengths, temps, top_ks, top_ps)

    def _seed_chain(self, logits, slots, lengths, temps, top_ks, top_ps) -> torch.Tensor:
        """Sample the first token of each admitted row and seed its slot's
        device decode chain in place: token, next position, sampling
        params."""
        temp_t, topk_t, topp_t = self._upload(temps), self._upload(top_ks), self._upload(top_ps)
        samples = bool((temps > 0).any())
        filters = bool(((temps > 0) & ((top_ks > 0) | (top_ps < 1.0))).any())
        first = sample(logits, self._generator, temp_t, topk_t, topp_t, samples, filters)
        slots_t = self._upload(slots)
        self._tokens_dev[slots_t] = first
        self._positions_dev[slots_t] = self._upload(lengths)
        self._temp_dev[slots_t] = temp_t
        self._top_k_dev[slots_t] = topk_t
        self._top_p_dev[slots_t] = topp_t
        return first

    # -- chunked prefill -------------------------------------------------------

    def _long_width(self, prompt_len: int) -> int:
        """Local-cache width of a long prompt: the whole segments that hold
        it, clamped to max_seq_len (the JAX engine doubles the widest
        bucket instead, to bound the programs XLA compiles)."""
        width = self.prefill_buckets[-1]
        return min(-(-prompt_len // width) * width, self.max_seq_len)

    def _long_step(self, budget: int) -> tuple[list[tuple], int]:
        """Drive the chunked-prefill streams: start streams for queued long
        requests while free slots and stream capacity allow (paged: once
        the request's whole reservation is bound — a pool that cannot cover
        it yet leaves the request at the front of the long queue), then
        dispatch ONE segment per stream, round-robin, under the iteration's
        token ``budget`` (at least one segment rides when a stream is
        active). Returns (first-token fetch entries of finished prompts,
        prefill tokens dispatched — a segment counts its full width)."""
        entries: list[tuple] = []
        spent = 0
        while self._long_queue and len(self._longs) < self.MAX_PREFILL_STREAMS:
            free = next(
                (i for i, s in enumerate(self._slots) if not s.active and i not in self._longs),
                None,
            )
            if free is None:
                break
            request = self._long_queue.pop(0)
            if self._paged:
                reserved = self._reserve_pages(free, request)
                if reserved is None:
                    continue  # can never fit: resolved with ShedError
                if not reserved:
                    self._long_queue.insert(0, request)  # waits for pages
                    break
            self._longs[free] = {"idx": free, "request": request, "seg": 0}
        # round-robin, so two streams alternate when the budget covers one
        order = sorted(self._longs)
        start_at = next((j for j, i in enumerate(order) if i > self._long_rr), 0)
        for idx in order[start_at:] + order[:start_at]:
            if spent and spent >= budget:
                break
            self._long_rr = idx
            entries.extend(self._segment_step(self._longs[idx]))
            spent += self.prefill_buckets[-1]
        return entries, spent

    def _end_stream(self, st: dict, reason: str, error: Optional[BaseException] = None) -> None:
        """End a chunked-prefill stream before its slot activates: the
        stream and its pages go first, then its request resolves."""
        request: GenerationRequest = st["request"]
        idx = st["idx"]
        del self._longs[idx]
        if self._paged:
            self._pagepool.free_slot(idx)
        with self._stats_lock:
            if reason == "cancelled":
                self.cancelled_total += 1
            elif reason == "deadline":
                # zero tokens generated: the waiting bucket, not mid-decode
                self.deadline_queue_total += 1
        request._finish(self._result(request, [], reason, error=error))

    def _segment_step(self, st: dict) -> list[tuple]:
        """Dispatch one segment of one stream. Paged: the segment forward
        writes into the slot's reserved pages and reads its prefix through
        them. Dense: a fresh batch-1 local cache of ``_long_width`` columns
        plus a sink column on the first segment (the last, padded segment
        may run past that width), then the segment forward; the final
        segment inserts the local cache into the slot's row of the big
        cache. The final segment samples the first token (only it samples:
        its logits are the prompt's last token's), seeds the decode chain
        and activates the slot host-side. A stream cancelled or past its
        deadline ends here, before another segment is spent on it, and
        frees its pages; one whose segment fails (the ``segment`` fault
        site) fails its own request only."""
        request: GenerationRequest = st["request"]
        idx = st["idx"]
        deadline = request.deadline_at()
        if request.cancelled:
            self._end_stream(st, "cancelled")
            return []
        if deadline is not None and time.monotonic() >= deadline:
            self._end_stream(st, "deadline")
            return []
        dev = self.device
        prompt = request.prompt_tokens
        width = self.prefill_buckets[-1]
        s0 = st["seg"] * width
        seg = prompt[s0 : s0 + width]
        tokens = np.zeros((1, width), np.int64)
        tokens[0, : len(seg)] = seg
        try:
            if self._injector is not None:
                self._injector.fire("segment")
            offsets = self._upload(np.array([s0], np.int64))
            seg_len = self._upload(np.array([len(seg)], np.int64))
            # readable columns: segment i never attends past s0 + width (the
            # exact bound, as for decode chunks)
            if self._paged:
                table = self._upload(self._pagepool.tables[idx : idx + 1])
                logits, _ = paged_prefill_segment_inplace(
                    self.params, self._upload(tokens), offsets, seg_len, self._pagepool.dev,
                    table, self.config, self.page_size, kv_bound=s0 + width,
                )
            else:
                t_long = self._long_width(len(prompt))
                if st["seg"] == 0:
                    st["cache"] = make_kv_cache(self.config, 1, t_long + 1, device=dev)
                logits, _ = prefill_segment(
                    self.params, self._upload(tokens), offsets, seg_len, st["cache"],
                    self.config, kv_bound=min(s0 + width, t_long),
                )
        except Exception as e:  # noqa: BLE001 — fail the stream, not the engine
            if _is_sticky(e):
                raise
            log.exception("chunked prefill failed at segment %d", st["seg"])
            self._end_stream(st, "error", error=e)
            return []
        st["seg"] += 1
        with self._stats_lock:
            self.prefill_tokens_total += len(seg)
            self.prefill_segments_total += 1
        if s0 + width < len(prompt):
            return []  # more segments to go
        del self._longs[idx]
        slots = np.array([idx], np.int64)
        if not self._paged:
            dense_insert_cache(self._cache, st["cache"], self._upload(slots))
        opts = request.options
        first = self._seed_chain(
            logits, slots, np.array([len(prompt)], np.int64),
            np.array([opts.temperature], np.float32), np.array([opts.top_k], np.int64),
            np.array([opts.top_p], np.float32),
        )
        slot = self._slots[idx]
        slot.request = request
        slot.position = len(prompt)
        slot.generated = []
        slot.started_at = time.monotonic()
        slot.first_token_at = 0.0
        with self._stats_lock:
            self.total_requests += 1
        return [("prefill", self._fetcher.submit(first), [(idx, request)], 0)]

    # -- decode dispatch -------------------------------------------------------

    def _decode_kv_bound(self, steps: int) -> int:
        """Readable columns of the big cache for a chunk on the reference
        path (the CPU): the highest host position, plus the steps in
        flight, plus this chunk (the JAX engine's rule, without its pow2
        ladder). The kernels read each row to its length, so the card's
        graphs read the whole cache and need no bound."""
        highest = max((s.position for s in self._slots if s.active), default=0)
        return min(self.max_seq_len, highest + self._inflight_steps + steps)

    def _dispatch_tables(self) -> np.ndarray:
        """The page tables of a decode dispatch: every slot that is not
        active gets the sentinel row, so a decode step never writes into a
        stream's pages mid-prefill (or into pages a quarantine freed)."""
        pool = self._pagepool
        tables = pool.tables.copy()
        inactive = [i for i, s in enumerate(self._slots) if not s.active]
        if inactive:
            tables[inactive] = pool.oob
        return tables

    def _page_integrity_check(self) -> None:
        """Validate every active slot's table row against the allocator's
        owned list before a decode dispatch; a mismatch (the ``page`` fault
        site, or a bookkeeping bug) quarantines only that slot: its request
        fails, its pages free through the owned list and are zeroed."""
        pool = self._pagepool
        if self._injector is not None:
            snapshot = [(i, s.request) for i, s in enumerate(self._slots) if s.active]
            self._injector.corrupt_page_table(pool, snapshot)
        for i, slot in enumerate(self._slots):
            if not slot.active or pool.validate(i):
                continue
            with self._stats_lock:
                self.quarantined_slots_total += 1
            self._quarantine_pages(i)
            self._finish_slot(
                i, "error",
                error=RuntimeError(
                    f"page-table corruption detected for slot {i}; slot quarantined, "
                    "pages freed and zeroed"
                ),
            )

    def _quarantine_pages(self, idx: int) -> None:
        """Free the slot's pages through the owned list and queue the freed
        ones for zeroing at the top of the next iteration."""
        self._pending_page_zero.extend(self._pagepool.free_slot(idx))

    def _dispatch_chunk(self) -> Optional[tuple]:
        """Queue one decode chunk: the page-table integrity check (paged),
        the ``decode`` fault site (a raise crashes the loop into the restart
        path), the host writes into the static buffers, then the replay;
        the chunk's output goes to the fetch thread right behind it. None
        when the integrity check quarantined every active slot."""
        if self._paged:
            self._page_integrity_check()
            if not any(s.active for s in self._slots):
                return None
        if self._injector is not None:
            self._injector.fire("decode")
        steps = self.decode_chunk
        branch = self._branch()
        self._prepare_chunk()
        self._run_chunk(branch)
        snapshot = [(i, s.request) for i, s in enumerate(self._slots) if s.active]
        with self._stats_lock:
            self.decode_chunks_total += 1
            self.decode_steps_total += steps
        return ("chunk", self._fetcher.submit(self._chunk_out), snapshot, steps)

    # -- host processing -------------------------------------------------------

    def _process_entry(self, entry: tuple) -> None:
        if entry[0] == "prefill":
            _, fetch, group, _ = entry
            first = fetch.result()
            now = time.monotonic()
            for j, (idx, request) in enumerate(group):
                slot = self._slots[idx]
                if slot.request is not request:
                    continue
                slot.first_token_at = now
                self._deliver_token(idx, int(first[j]))
            return
        _, fetch, snapshot, steps = entry
        host = fetch.result()  # [steps, B]
        if self._injector is not None:
            host, _ = self._injector.corrupt_tokens(host, snapshot)
        for idx, request in snapshot:
            slot = self._slots[idx]
            if slot.request is not request:  # freed / reassigned meanwhile
                continue
            for s in range(steps):
                slot.position += 1
                self._deliver_token(idx, int(host[s, idx]))
                if slot.request is not request:  # finished mid-chunk
                    break

    def _deliver_token(self, idx: int, token: int) -> None:
        slot = self._slots[idx]
        request = slot.request
        assert request is not None
        opts = request.options
        if token < 0:
            # sampling's NaN-guard sentinel: quarantine only this slot —
            # its request fails, its rows or pages are zeroed next iteration
            with self._stats_lock:
                self.nan_guard_total += 1
                self.quarantined_slots_total += 1
            if self._paged:
                self._quarantine_pages(idx)
            else:
                self._pending_row_resets.append(idx)
            self._finish_slot(
                idx, "error",
                error=LogitsNaNError(
                    f"non-finite logits for slot {idx}; slot quarantined and its KV reset"
                ),
            )
            return
        if request.cancelled:
            # chunk-boundary cancellation: the rest of this and any chunk in
            # flight is dropped by the snapshot identity check
            with self._stats_lock:
                self.cancelled_total += 1
            self._finish_slot(idx, "cancelled")
            return
        deadline = request.deadline_at()
        if deadline is not None and time.monotonic() >= deadline:
            with self._stats_lock:
                self.deadline_decode_total += 1
            self._finish_slot(idx, "deadline")
            return
        if self._injector is not None:
            self._injector.stall("client")  # slow-client drill
        if (self.eos_token_id is not None and token == self.eos_token_id) or (
            token in opts.stop_tokens
        ):
            self._finish_slot(idx, "stop")
            return
        slot.generated.append(token)
        with self._stats_lock:
            self.total_generated += 1
        if request.on_token is not None:
            try:
                request.on_token(token)
            except Exception:  # noqa: BLE001 — a stream consumer must not kill the loop
                log.exception("on_token callback failed")
        if len(slot.generated) >= opts.max_new_tokens or slot.position >= self.max_seq_len - 1:
            self._finish_slot(idx, "length")

    def _result(
        self, request: GenerationRequest, tokens: list[int], reason: str,
        first_token_at: float = 0.0, error: Optional[BaseException] = None,
    ) -> GenerationResult:
        return GenerationResult(
            tokens=list(tokens),
            finish_reason=reason,
            prompt_tokens=len(request.prompt_tokens),
            ttft_s=first_token_at - request.submitted_at if first_token_at else 0.0,
            total_s=time.monotonic() - request.submitted_at,
            error=error,
        )

    def _finish_slot(self, idx: int, reason: str, error: Optional[BaseException] = None) -> None:
        """Resolve the slot's request and free the slot and its pages —
        freed BEFORE the waiter wakes, so what it reads is current."""
        slot = self._slots[idx]
        request = slot.request
        assert request is not None
        result = self._result(request, slot.generated, reason, slot.first_token_at, error)
        slot.request = None
        slot.generated = []
        slot.position = 0
        self._freed_slots.append(idx)
        if self._paged:
            self._pagepool.free_slot(idx)
        request._finish(result)

    def _fail_all(self, error: BaseException) -> None:
        """Fail every request in flight or waiting; teardown first, every
        waiter woken last."""
        self._dead = error
        doomed: list[GenerationRequest] = list(self._page_deferred) + self._long_queue
        doomed += [st["request"] for st in self._longs.values()]
        if self._paged:
            for idx in self._longs:
                self._pagepool.free_slot(idx)
        if self._held_back is not None:
            doomed.append(self._held_back)
        self._page_deferred.clear()
        self._long_queue.clear()
        self._longs.clear()
        self._held_back = None
        for i, slot in enumerate(self._slots):
            if slot.request is not None:
                doomed.append(slot.request)
                slot.request = None
                slot.generated = []
                slot.position = 0
                if self._paged:
                    self._pagepool.free_slot(i)
        while True:
            try:
                doomed.append(self._queue.get_nowait())
            except queue.Empty:
                break
        with self._waiting_lock:
            self._waiting.clear()
        for request in doomed:
            request._finish(self._result(request, [], "error", error=error))
