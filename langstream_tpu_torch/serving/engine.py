"""Continuous-batching serving engine — the paged and dense KV layouts of
``langstream_tpu/serving/engine.py``'s ``ServingEngine``.

One engine thread owns the device. Each iteration (``_iterate``) first
drives the chunked-prefill streams, then admits a token-budgeted slice of
queued requests — batched per prompt bucket into admit groups: a prefill
into a local cache, the first sample, and the insert of that cache into
each row's reserved pages (paged) or into the slot's row of the big cache
(dense) — then dispatches one decode chunk of ``decode_chunk`` fused
decode+sample steps. Sampled tokens stay on the device and feed the next
step; the host receives them through a pinned-memory copy fenced by a CUDA
event, so chunk k+1 is queued on the stream while chunk k's tokens are
still on their way (the JAX engine's depth-1 pipeline).

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
the write sink of slots that ran past ``max_seq_len``); decode chunks read
it through a ``[..., :kv_bound]`` view; a long prompt's segments go into a
batch-1 local cache (``prefill_segment``), inserted into the slot's row
after the final one.

An MoE model's logits depend on the other rows of its batch (the experts'
capacity is shared), so its admit groups are padded to ``PREFILL_BATCH``
rows with the JAX engine's pad rows (token 0, length 1): the same groups
give the same tokens.

Not ported yet (later slices): request lifecycle (deadlines, drain, crash
recovery), prefix reuse, speculation, tenancy, adapters, grammars, SPMD
and the fetch thread.
"""

from __future__ import annotations

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
from langstream_tpu_torch.ops.attention import kernel_counts, kernel_path_ok
from langstream_tpu_torch.serving.pagepool import PagePool, default_num_pages
from langstream_tpu_torch.serving.sampling import sample

log = logging.getLogger(__name__)

# default prompt buckets (token widths of the admit-group prefills); the
# widest is also the chunked-prefill segment width
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


class ShedError(RuntimeError):
    """A request the engine can never serve (it needs more KV pages than
    the whole pool holds)."""


class LogitsNaNError(RuntimeError):
    """A slot's logits went non-finite; its request fails."""


def _rows(entry, n: int):
    """The first ``n`` batch rows of a cache [L, B, ...] (or its int8 dict)."""
    if isinstance(entry, dict):
        return {k: v[:, :n] for k, v in entry.items()}
    return entry[:, :n]


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
        """Cancel from any thread; honoured at the next chunk boundary."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def result(self, timeout: Optional[float] = None) -> "GenerationResult":
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        assert self._result is not None
        if self._result.error is not None:
            raise self._result.error
        return self._result

    def _finish(self, result: "GenerationResult") -> None:
        if self._done.is_set():
            return
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
    finish_reason: str  # stop | length | cancelled | error
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
    current stream and fenced by an event, so waiting for it never waits
    for work queued after it."""

    def __init__(self, tensor: torch.Tensor) -> None:
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event: Optional[torch.cuda.Event] = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor.clone()
            self._event = None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


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
    ) -> None:
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; supported: paged, dense")
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
        # bounded as in the JAX engine: a full queue blocks ``submit``
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_batch * 4)
        # admissions popped from the queue but waiting for pool pages;
        # retried ahead of the queue every iteration
        self._page_deferred: deque[GenerationRequest] = deque()
        # device-resident decode chain: last sampled token and next write
        # position per slot, plus the per-slot sampling params (they only
        # change on admit)
        dev = self.device
        self._tokens_dev = torch.zeros(self.max_batch, dtype=torch.long, device=dev)
        self._positions_dev = torch.zeros(self.max_batch, dtype=torch.long, device=dev)
        self._temp_dev = torch.zeros(self.max_batch, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros(self.max_batch, dtype=torch.long, device=dev)
        self._top_p_dev = torch.ones(self.max_batch, dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(int(rng_seed))
        # slots freed since the last dispatch: their device temperature is
        # zeroed so a dead slot never keeps the sampling path on
        self._freed_slots: list[int] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead: Optional[BaseException] = None
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

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._fail_all(RuntimeError("serving engine stopped"))

    # -- public API ------------------------------------------------------------

    def submit(self, request: GenerationRequest) -> GenerationRequest:
        """Thread-safe enqueue; a full queue blocks."""
        if self._dead is not None:
            raise RuntimeError("serving engine is stopped") from self._dead
        request.submitted_at = time.monotonic()
        n = len(request.prompt_tokens)
        limit = self.max_seq_len - 1
        if n > limit:
            raise ValueError(
                f"prompt of {n} tokens exceeds the engine limit of {limit} (max_seq_len - 1)"
            )
        self._queue.put(request)
        return request

    def generate(
        self,
        prompt_tokens: list[int],
        options: Optional[GenerationOptions] = None,
        on_token: Optional[Callable[[int], None]] = None,
        timeout: float = 300.0,
    ) -> GenerationResult:
        """Blocking submit + wait; a wait timeout cancels the request."""
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
                "nan-guard-total": self.nan_guard_total,
                "cancelled-total": self.cancelled_total,
                "kv-layout": self.kv_layout,
                "long-prefill-queued": len(self._long_queue) + (self._held_back is not None),
                "long-prefill-streams": len(self._longs),
                # launches of each attention kernel in this process (CUDA)
                # and calls of its plain version (CPU)
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
            out.update({
                "kv-cache-bytes": sum(
                    t.numel() * t.element_size()
                    for e in self._cache.values()
                    for t in (e.values() if isinstance(e, dict) else (e,))
                ),
            })
        return out

    # -- the loop --------------------------------------------------------------

    def _run(self) -> None:
        pending: deque[list[tuple]] = deque()
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    self._iterate(pending)
                while pending:
                    for entry in pending.popleft():
                        self._process_entry(entry)
        except BaseException as e:  # noqa: BLE001 — crash-only: fail everything
            log.exception("serving engine loop crashed")
            self._fail_all(e)

    def _iterate(self, pending: deque) -> None:
        """One fused iteration: a token-budgeted slice of prefill work
        (chunked-prefill segments first, so a long prompt cannot starve
        under short traffic, then admissions), then the decode chunk —
        back-to-back on the in-order stream — then host processing of
        whatever batch of earlier dispatches has landed."""
        self._inflight_steps = sum(e[3] for batch in pending for e in batch if e[0] == "chunk")
        had_active = any(s.active for s in self._slots)
        new_pending, spent = self._long_step(self.prefill_token_budget)
        new_pending.extend(self._admit(max(0, self.prefill_token_budget - spent)))
        if new_pending and not had_active:
            # cold start: nothing to overlap the first-token fetch with
            for entry in new_pending:
                self._process_entry(entry)
            new_pending = []
        if any(s.active for s in self._slots):
            new_pending.append(self._dispatch_chunk())
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
        full admission group."""
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
                if request._done.is_set():
                    continue
                if request.cancelled:
                    with self._stats_lock:
                        self.cancelled_total += 1
                    request._finish(self._result(request, [], "cancelled"))
                    continue
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
                entries.extend(self._prefill_group(width, group[start:start + self.PREFILL_BATCH]))
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
        return [("prefill", _Fetch(first), list(group), 0)]

    def _dev_prefill(self, tokens, lengths, temps, top_ks, top_ps, slots, rows: int):
        """Device layer of an admit group: local-cache prefill, the insert of
        that cache into each real row's pages (paged) or its slot's row of
        the big cache (dense), then the first sample and the chain seeding.
        Rows from ``rows`` on are padding: they prefill and are dropped."""
        dev = self.device
        n, width = tokens.shape
        local = make_kv_cache(self.config, n, width, device=dev)
        logits, local = prefill(
            self.params, torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev),
            local, self.config,
        )
        if rows < n:
            local = {name: _rows(entry, rows) for name, entry in local.items()}
            logits = logits[:rows]
            slots, lengths, temps = slots[:rows], lengths[:rows], temps[:rows]
            top_ks, top_ps = top_ks[:rows], top_ps[:rows]
        if self._paged:
            tables = torch.from_numpy(self._pagepool.tables[slots]).to(dev)
            paged_insert_cache(self._pagepool.dev, local, tables, self.page_size)
        else:
            dense_insert_cache(self._cache, local, torch.from_numpy(slots).to(dev))
        return self._seed_chain(logits, slots, lengths, temps, top_ks, top_ps)

    def _seed_chain(self, logits, slots, lengths, temps, top_ks, top_ps) -> torch.Tensor:
        """Sample the first token of each admitted row and seed its slot's
        device decode chain: token, next position, sampling params."""
        dev = self.device

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        temp_t, topk_t, topp_t = up(temps), up(top_ks), up(top_ps)
        samples = bool((temps > 0).any())
        filters = bool(((temps > 0) & ((top_ks > 0) | (top_ps < 1.0))).any())
        first = sample(logits, self._generator, temp_t, topk_t, topp_t, samples, filters)
        slots_t = up(slots)
        self._tokens_dev[slots_t] = first
        self._positions_dev[slots_t] = up(lengths)
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

    def _segment_step(self, st: dict) -> list[tuple]:
        """Dispatch one segment of one stream. Paged: the segment forward
        writes into the slot's reserved pages and reads its prefix through
        them. Dense: a fresh batch-1 local cache of ``_long_width`` columns
        plus a sink column on the first segment (the last, padded segment
        may run past that width), then the segment forward; the final
        segment inserts the local cache into the slot's row of the big
        cache. The final segment samples the first token (only it samples:
        its logits are the prompt's last token's), seeds the decode chain
        and activates the slot host-side. A cancelled stream ends here,
        before another segment is spent on it, and frees its pages."""
        request: GenerationRequest = st["request"]
        idx = st["idx"]
        if request.cancelled:
            del self._longs[idx]
            if self._paged:
                self._pagepool.free_slot(idx)
            with self._stats_lock:
                self.cancelled_total += 1
            request._finish(self._result(request, [], "cancelled"))
            return []
        dev = self.device
        prompt = request.prompt_tokens
        width = self.prefill_buckets[-1]
        s0 = st["seg"] * width
        seg = prompt[s0 : s0 + width]
        tokens = torch.zeros((1, width), dtype=torch.long)
        tokens[0, : len(seg)] = torch.tensor(seg)
        offsets = torch.tensor([s0], device=dev)
        seg_len = torch.tensor([len(seg)], device=dev)
        # readable columns: segment i never attends past s0 + width (the
        # exact bound, as for decode chunks)
        if self._paged:
            table = torch.from_numpy(self._pagepool.tables[idx : idx + 1]).to(dev)
            logits, _ = paged_prefill_segment_inplace(
                self.params, tokens.to(dev), offsets, seg_len, self._pagepool.dev, table,
                self.config, self.page_size, kv_bound=s0 + width,
            )
        else:
            t_long = self._long_width(len(prompt))
            if st["seg"] == 0:
                st["cache"] = make_kv_cache(self.config, 1, t_long + 1, device=dev)
            logits, _ = prefill_segment(
                self.params, tokens.to(dev), offsets, seg_len, st["cache"], self.config,
                kv_bound=min(s0 + width, t_long),
            )
        st["seg"] += 1
        with self._stats_lock:
            self.prefill_tokens_total += len(seg)
            self.prefill_segments_total += 1
        if s0 + width < len(prompt):
            return []  # more segments to go
        del self._longs[idx]
        slots = np.array([idx], np.int64)
        if not self._paged:
            dense_insert_cache(self._cache, st["cache"], torch.from_numpy(slots).to(dev))
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
        return [("prefill", _Fetch(first), [(idx, request)], 0)]

    def _decode_kv_bound(self, steps: int) -> int:
        """Readable columns of the big cache for this chunk: the highest host
        position, plus the steps in flight, plus this chunk (the JAX
        engine's rule, without its pow2 ladder: that bounds the programs
        XLA compiles, and PyTorch compiles none per width). The kernel path
        reads each row to its length whatever the bound; the bound narrows
        the reference path's masked read."""
        highest = max((s.position for s in self._slots if s.active), default=0)
        return min(self.max_seq_len, highest + self._inflight_steps + steps)

    def _dispatch_chunk(self) -> tuple:
        """Queue one decode chunk: ``steps`` x (decode step + sample) from
        the device-resident chain. Paged: inactive slots' table rows are the
        sentinel, so their (discarded) steps write only into the sink page.
        Dense: they write into their own rows (past max_seq_len, into the
        sink column) and read at most the chunk's bound."""
        steps = self.decode_chunk
        dev = self.device
        stale = [i for i in set(self._freed_slots) if not self._slots[i].active]
        self._freed_slots.clear()
        if stale:
            self._temp_dev[torch.as_tensor(stale, device=dev)] = 0.0
        if self._paged:
            pool = self._pagepool
            tables = pool.tables.copy()
            tables[[i for i, s in enumerate(self._slots) if not s.active]] = pool.oob
            table_t = torch.from_numpy(tables).to(dev)

            def step_fn(tokens, positions):
                return paged_decode_step_inplace(
                    self.params, tokens, positions, pool.dev, table_t, self.config,
                    self.page_size,
                )
        else:
            kv_bound = self._decode_kv_bound(steps)

            def step_fn(tokens, positions):
                return decode_step_inplace(
                    self.params, tokens, positions, self._cache, self.config, kv_bound
                )
        opts = [s.request.options for s in self._slots if s.active]
        samples = any(o.temperature > 0 for o in opts)
        filters = any(o.temperature > 0 and (o.top_k > 0 or o.top_p < 1.0) for o in opts)
        chunk = torch.empty((steps, self.max_batch), dtype=torch.long, device=dev)
        tokens, positions = self._tokens_dev, self._positions_dev
        for step in range(steps):
            logits, _ = step_fn(tokens, positions)
            tokens = sample(
                logits, self._generator, self._temp_dev, self._top_k_dev, self._top_p_dev,
                samples, filters,
            )
            positions = positions + 1
            chunk[step] = tokens
        self._tokens_dev, self._positions_dev = tokens, positions
        snapshot = [(i, s.request) for i, s in enumerate(self._slots) if s.active]
        with self._stats_lock:
            self.decode_chunks_total += 1
            self.decode_steps_total += steps
        return ("chunk", _Fetch(chunk), snapshot, steps)

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
            # sampling's NaN-guard sentinel: fail only this slot
            with self._stats_lock:
                self.nan_guard_total += 1
            self._finish_slot(
                idx, "error",
                error=LogitsNaNError(f"non-finite logits for slot {idx}; request failed"),
            )
            return
        if request.cancelled:
            with self._stats_lock:
                self.cancelled_total += 1
            self._finish_slot(idx, "cancelled")
            return
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
                if self._paged:
                    self._pagepool.free_slot(i)
        while True:
            try:
                doomed.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for request in doomed:
            request._finish(self._result(request, [], "error", error=error))
