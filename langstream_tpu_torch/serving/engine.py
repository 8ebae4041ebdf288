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

Prefix KV reuse (``prefix_cache="auto"``), paged layout: a radix
index (``serving/pagepool.PrefixPageIndex``) maps bucket-aligned prompt
prefixes to the pages that hold their KV. Every prefill that completes
(a cold admit group, a warm admission, a long prompt's final segment)
publishes the prompt's deepest bucket boundary by a refcount bump on the
slot's leading pages — no device copy. An admission (``_paged_bind``)
takes the deepest published prefix of its prompt: its full pages join the
slot's table by a refcount bump, a prefix that ends mid-page costs one
copy-on-write page copy (``page_copy``), and under pool pressure the LRU
unpinned entries are evicted first. A warm short admission is then one
batch-1 suffix segment at the reuse offset, straight into the slot's
pages (MoE too: no pad rows, as the JAX engine runs it); a warm long
prompt starts its segments at that offset. Decode reads the shared pages
through every aliasing slot's table and writes only at positions past
its prompt, never into a shared full page. A quarantined slot's published
entries are evicted before its pages are zeroed, and a restart resets the
index with the pool (its counters are cumulative). Dense layout (the JAX
engine's dense pool, ``serving/prefix_cache.PrefixCachePool``): every
completed prefill copies the slot's row into a pool row of the widest
bucket's columns (``ops/kvcopy.publish_prefix_rows``; LRU eviction of
unpinned rows when full, skipped when all are pinned); a short admission
whose deepest cached prefix leaves a suffix bucket inside the pool width
gathers that row into a pool-width local cache
(``gather_prefix_local``), prefills the suffix as one segment at the reuse
offset and inserts the local cache into its row; a long prompt reuses
only a full segment width, starting its stream's local cache from the
pool row. A restart resets the pool.

An MoE model's logits depend on the other rows of its batch (the experts'
capacity is shared), so its admit groups are padded to ``prefill_batch``
rows with the JAX engine's pad rows (token 0, length 1): the same groups
give the same tokens.

Self-speculative decoding (``speculation="auto"``, both layouts):
every admission seeds the slot's n-gram index
(``serving/speculation.NGramIndex``) with its whole prompt, and every
delivered token joins it. Each decode iteration is then one verify instead
of a decode chunk: the host drains every fetch in flight (drafts must
continue from the last accepted token), proposes up to
``speculation_tokens`` (k) drafts a slot, copies them into the static
``[B, k]`` draft buffer, and replays the captured ``_verify_chunk`` — one
``paged_verify_step_inplace`` (dense: ``verify_step_inplace``, the dense
decode kernel reading each row's k + 1 queries) over each slot's token
and its drafts, then
``speculative_verify`` — which advances the chain in place (the token at
the accepted length, ``positions += accept + 1``) and writes the packed
``[B, k + 2]`` output (emitted tokens and the accepted count). The host
delivers accept + 1 tokens a slot through the same ``_deliver_token`` as
decode chunks, so stop, length, cancel, deadline and the NaN sentinel act
mid-verify as they do mid-chunk. ``start()`` captures the verify once per
sampling branch instead of the decode chunk. A slot with no proposal rides
the verify with zero drafts: acceptance is decided against the model's own
outputs, so a draft never changes what greedy decode emits. Publish
boundaries stay prompt rows written by prefill, never verify columns.

Params streamed from a checkpoint (``models/streamload.py``) come with
their load's report (``weight_load_report``): ``stats()`` carries it as the JAX engine's
``weight-load-*`` keys, and a streamed load that returned with its copies
in flight is waited on (the load stream's last event) before ``start()``'s
warm-up and capture. The engine logs its memory plan
(``serving/memory.plan_serving_memory``) when it is built; it is kept as
``memory_plan``.

Multi-tenant overload control (``serving/tenancy.py``), as the JAX engine
runs it: the admission queue is a ``TenantQueue`` (weighted deficit
round-robin in prefill tokens across tenants, priority within a tenant,
per-tenant queue shares), ``_admit`` holds back tenants at their
``max_slots`` cap or their weighted share of the slots while others wait,
submit sheds over-quota tenants first while others wait, and a request's
``max_cost_tokens`` caps its generation (and its page reservation). Once
per iteration the brownout controller reads the load score (queue wait
under a backlog + slot occupancy + page-pool pressure) and walks its
ladder: level 1 halves the drafts a verify proposes, level 2 serves decode
chunks instead of verifies (after draining the verifies in flight), levels
3 and 4 shed low-priority and over-quota admissions at submit. With
speculation on and brownout not ``off``, ``start()`` therefore captures
both graph sets — the decode chunk and the verify, once per sampling
branch each, into the one shared pool — and each replay is counted by its
kind; the capture is timed part by part (the warm-up, each branch of each
set: ``graph-capture-parts-s``).

The agentic tier, as the JAX engine runs it, on both layouts. Multi-LoRA
(``adapters``): a fixed device pool of stacked low-rank factors
(``serving/adapters.py``); every prefill, decode step and verify gathers
each row's factors by its adapter row (``models/transformer.py``
``_lora_delta``), so base slots (row 0, zeros) and N adapters share one
captured program. Grammar-constrained decoding (``constrained_decoding``,
on by default as in the JAX engine; ``grammar_slots`` <= 0 turns it off):
a request's ``response_format`` compiles to a token DFA on the submitter's
thread (``serving/constrain.py``); the packed grammar pool lives on the
card, and every sample is masked by the bits of the row's (grammar row,
DFA state) and advances the state on the card (``_dfa_mask``,
``_dfa_advance``) — in the admit groups, a long prompt's final segment,
the captured decode chunk and the captured verify (whose per-position
states the host computes from the drafts, ``verify_states``). Base slots
ride grammar row 0 (all legal, a self-loop at state 0). The host mirrors
the state per delivered token: an illegal token fails the slot, a
complete state finishes it with ``"stop"``. With the tier on, every
captured set carries the LoRA gather, the mask and the advance: one graph
set, whatever the mix. Adapter and grammar rows are resolved (refcounted,
swapped in LRU on the engine thread's stream, behind the chunks in
flight) when a request leaves the queue; a pool pinned full sheds it with
a retry-after, and the request's finalize hook releases both when it ends,
on every path. The per-slot rows and DFA states are static buffers
written in place; the pools are never reallocated, a restart included.
An adapter request never reuses nor publishes a shared prefix (its K/V
hold its ``wk`` / ``wv`` deltas). The ``adapter`` fault site corrupts the
dispatch-facing row array; the check before every dispatch quarantines
that slot alone.

Observability (``serving/observability.py``, ``observability=False``
turns it off): host-side histograms at the JAX engine's sites (TTFT,
inter-token, queue wait, prefill dispatch, decode or verify step, accepted
tokens a verify, fetch), one ``engine.request`` span tree a request at
completion (the port's ``tracing.TRACER``), and a flight recorder of the
last ``flight_iterations`` iterations, dumped on a NaN or page quarantine,
an engine restart, a shed burst, a brownout transition and
``stats(dump=True)``. Nothing is recorded inside a captured chunk.

The host KV tier (``host_kv_fraction`` > 0, paged layout with the prefix
index), as the JAX engine runs it: a host arena of ``ceil(pages x
fraction)`` page slots (``serving/pagepool.HostPageTier``, pinned on the
card). Every published entry is a hibernation candidate; once idle past
``spill_idle_s`` the sweep at the iteration top (``_spill_tick``: at most 2
starts and 8 hops an iteration) queues its page copies — on the card on a
spill stream of their own, one 2-D DMA a page leaf straight from the pool
pages into the pinned slots, after the engine stream's work so far — and
the spill worker waits for them and stamps every slot's blake2b checksum
(the slots hashed in parallel). Under pool pressure the LRU eviction
demotes an entry whose host copy is secured (its device pages freed, the
entry kept) instead of dropping it; a page freed while its copy runs
carries the copy's completion event, which every writer of a freed page
(the allocator, a quarantine's zeroing) makes the engine stream wait on
first. An admission's radix hit on a hibernated entry restores it
(``_restore_entry``: pages allocated, every slot verified against its
stamp, then each uploaded into its page in place on the engine stream —
the pool is never rebound, the captured graphs hold its addresses); a
failed restore falls back to a
shallower candidate, then to a cold prefill. Restore, fallback and
recompute gauges count once a request. A restart stops the spill worker
before the pool resets and the graphs are captured again, resets the arena
(or allocates a fresh one when the worker is wedged) and restarts the
worker after the capture.

The durable session tier (``durable_dir``; ``serving/durable.py``): a
completed spill, and a host-only entry about to be evicted from the arena,
queue a checkpoint (page byte images and their spill-time stamps) to the
durable worker, which writes it crash-safe; ``hibernate()`` checkpoints
every live entry on the engine thread and writes the replica's hibernation
record. A new engine on the same directory rehydrates the index before its
first admission, and an admission nothing live covers restores the
deepest checkpointed boundary (``_durable_admit``: every page held against
the manifest's stamp, then uploaded in place and published); any failure
dumps ``durable-restore-failed`` and prefills cold.

Tensor parallelism and the SPMD serving plane (``mesh``, ``spmd``; the
JAX engine's ``_spmd_*`` side, ``parallel/spmd_serving.py``). With a mesh
whose expert x model axes exceed 1 the engine holds this rank's slices of
the weights (``parallel.sharding.shard_params``) and computes with the
rank's shapes (``local_config``: its heads, kv heads, ``d_ff`` slice),
every model call taking the mesh's ``TensorParallel`` handle (``tp``): the
collectives sit inside the captured chunks. One process a card, so every
rank must run the same dispatches in the same order: the leader (the
engine given ``spmd``, a ``SpmdChannel``) announces each device dispatch
as a fixed-shape control block before it runs it — admit groups
(``OP_PREFILL``), segments and warm paged admissions (``OP_LONG_SEG``),
dense warm admissions and publishes (``OP_PREFIX_ADMIT`` /
``OP_PREFIX_PUBLISH``), page binds with their copy-on-write pair, frees and
zeroing (``OP_PAGE_*``), dense row resets, decode chunks and verifies with
the active-slot mask, the stale slots and the sampling branch, and each
graph set's capture (``OP_WARMUP``) — and a follower engine (built the same
way, never started) replays them through the same ``_dev_*`` methods
(``follower_loop``). With ``echo`` every processed chunk's tokens ride
back out for the follower to hold against its own. Slice resilience as the
JAX engine runs it: a loop crash announces ``OP_RECOVER`` at a new epoch
and both sides rebuild (the generator re-seeded from seed + epoch) and
capture again; idle heartbeats (``OP_IDLE``) and a fetch wait bounded by
``spmd-watchdog-s`` (``EngineWedgedError`` → recovery); a follower's
divergence report is answered with ``OP_RESYNC``. A multi-rank replica in
one pod serves adapters, constrained decoding and the host KV tier, as the
JAX engine's single-process mesh does: the leader announces each adapter
and grammar swap-in (``OP_ADAPTER_SWAP`` / ``OP_GRAMMAR_SWAP``: the row and
the spec or the grammar's key; each rank loads its slices of the factors,
``shard_lora``, or compiles the same planes), an admission's rows when one
is not base (``OP_ADMIT_ROWS``), the per-slot rows before a chunk when they
changed (``OP_SLOT_ROWS``), a verify's DFA states (``OP_VERIFY_STATES``),
and every spill and restore (``OP_HOST_SPILL`` / ``OP_HOST_RESTORE``: page
ids and arena slots). The tier's decisions stay the leader's; every rank
copies its own shard of the pages into its own arena and keeps its own
fences, and a restore uploads only when every rank's shard passed its
checksum (the verdict agreed over the group, ``SpmdChannel.agree``), else
every rank takes the counted fallback. On a multi-host replica
(``multihost``) those tiers stay off with a warning, as the JAX engine
keeps them off under multi-host SPMD. The durable tier stays off on every
multi-rank replica (with a warning), KV-page migration commands are
refused, and a failed prefill or segment crashes the replica into recovery
instead of failing its request alone.

Ring prefill (a mesh whose "seq" axis is above 1, or a ``ring`` handle
given; dense layout only, as in the JAX engine). A long prompt with no
full-width prefix hit, no grammar and no adapter, whose pow2-block padding
(``_ring_pad``) fits max_seq_len, is admitted in ONE dispatch instead of
the segment loop: ``parallel.sp.ring_prefill`` over the seq ranks (each
embeds its block, ring attention rotates K/V), the blocks gathered over
the ring into the slot's row of the big cache (quantized for an int8
cache), and the first sample (``_dev_ring``). The leader streams the
prompt to the followers first (``OP_RING`` chunks) and every rank makes
the same dispatch; its tokens count against the iteration's prefill
budget, and its request's spans report the path ``ring``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import math
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
    _quantize_kv,
    decode_step_inplace,
    dense_insert_cache,
    make_kv_cache,
    page_copy,
    paged_decode_step_inplace,
    paged_insert_cache,
    paged_prefill_segment_inplace,
    paged_verify_step_inplace,
    prefill,
    prefill_segment,
    verify_step_inplace,
)
from langstream_tpu_torch.ops.attention import (
    add_counts,
    count_delta,
    count_snapshot,
    kernel_counts,
    kernel_path_ok,
)
from langstream_tpu_torch.serving.adapters import (
    AdapterPoolExhausted,
    AdapterRegistry,
    AdapterSpec,
    rows_for_fraction,
)
from langstream_tpu_torch.serving.constrain import GrammarRegistry, verify_states
from langstream_tpu_torch.serving.durable import DurableError, DurableStore
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.memory import plan_serving_memory, tree_bytes
from langstream_tpu_torch.serving.migrate import MigrationError
from langstream_tpu_torch.serving.observability import (
    EngineObservability,
    emit_request_spans,
    load_score,
)
from langstream_tpu_torch.ops.kvcopy import gather_prefix_local, publish_prefix_rows
from langstream_tpu_torch.parallel import spmd_serving as wire
from langstream_tpu_torch.parallel.ring_attention import seq_ring
from langstream_tpu_torch.parallel.sharding import local_config, shard_lora, tensor_parallel
from langstream_tpu_torch.serving.pagepool import (
    HostPageTier,
    PagePool,
    PrefixPageIndex,
    host_block,
    join_page_bytes,
    np_view,
    page_checksums,
    page_leaf_specs,
    page_read,
    page_write,
    pages_for_fraction,
    pool_leaves,
    prefix_digest,
    split_page_bytes,
)
from langstream_tpu_torch.serving.prefix_cache import (
    PrefixCachePool,
    PrefixEntry,
    pool_entries_for_fraction,
)
from langstream_tpu_torch.serving.sampling import sample, speculative_verify
from langstream_tpu_torch.serving.speculation import NGramIndex
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer
from langstream_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    BrownoutController,
    TenantQueue,
    TenantRegistry,
    TenantShareExceeded,
    TenantSpec,
    effective_max_new_tokens,
)

log = logging.getLogger(__name__)

# default prompt buckets (token widths of the admit-group prefills); the
# widest is also the chunked-prefill segment width
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
# the sampling branches a decode chunk is captured for, in capture order:
# (some row samples, some sampling row filters with top-k / top-p)
DECODE_BRANCHES = ((False, False), (True, False), (True, True))
# each branch's name in the capture's part timings
BRANCH_NAMES = {(False, False): "greedy", (True, False): "sampled", (True, True): "filtered"}
# one graph capture at a time in a process (``_capture_set``)
_CAPTURE_LOCK = threading.Lock()
# each branch's code on the SPMD wire (its index in DECODE_BRANCHES)
BRANCH_CODES = {b: i for i, b in enumerate(DECODE_BRANCHES)}


def _tenant(request: "GenerationRequest") -> str:
    return request.options.tenant or DEFAULT_TENANT
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


class EngineWedgedError(RuntimeError):
    """A per-iteration device wait exceeded the SPMD watchdog bound
    (``spmd-watchdog-s``): a dispatch hung past the deadline, which on a
    multi-rank replica would otherwise hang every rank. Raised out of the
    iteration so the loop supervisor escalates to a coordinated
    OP_RECOVER instead of the slice wedging silently. A plain Exception:
    the recovery path is the handler."""


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



@dataclass
class GenerationRequest:
    prompt_tokens: list[int]
    options: GenerationOptions
    # called from the engine thread with each new token id (stream path)
    on_token: Optional[Callable[[int], None]] = None
    # called from the engine thread once, with the final GenerationResult
    on_done: Optional[Callable[["GenerationResult"], None]] = None
    submitted_at: float = field(default_factory=time.monotonic)
    # the propagated ``ls-trace-id``: the request's spans join this trace
    trace_id: Optional[str] = None
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Optional["GenerationResult"] = None
    _cancelled: threading.Event = field(default_factory=threading.Event)
    # the engine's teardown hook (adapter and grammar refcount release),
    # run once inside ``_finish`` before the waiter wakes: every way a
    # request ends funnels through there
    _finalize: Optional[Callable[[], None]] = None
    # the compiled grammar (constrain.TokenDFA), attached at submit when
    # the options carry a response_format
    _dfa: Optional[Any] = None
    # the host-mirrored DFA state after the latest delivered token, set
    # before ``on_token`` fires for that token
    dfa_state: Optional[int] = None
    # (adapter row, grammar row, initial DFA state) once resolved when the
    # request left the queue (a page-deferred retry resolves nothing again)
    _agentic_rows: Optional[tuple[int, int, int]] = None
    # the tier's once-per-request flags (a page-deferred request re-binds
    # every iteration): its hit was a restore, that restore was counted, a
    # failed restore was counted, its cold bind was counted as a recompute
    # fallback, a durable restore of it failed for good
    _tier_restored: bool = field(default=False, repr=False)
    _tier_restored_counted: bool = field(default=False, repr=False)
    _tier_fallback_counted: bool = field(default=False, repr=False)
    _tier_recompute_counted: bool = field(default=False, repr=False)
    _durable_failed: bool = field(default=False, repr=False)

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
        if self._finalize is not None:
            fin, self._finalize = self._finalize, None
            try:
                fin()
            except Exception:  # noqa: BLE001 — teardown must not eat the result
                log.exception("request finalize hook failed")
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
    # observability: the inter-token clock and the request span's
    # attributes (host bookkeeping only)
    last_token_at: float = 0.0
    path: str = "cold"  # cold | warm | long | ring: the admission route
    prefill_chunks: int = 0
    decode_iters: int = 0
    verify_iters: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None

    def reset_obs(self, path: str, chunks: int) -> None:
        self.last_token_at = 0.0
        self.path = path
        self.prefill_chunks = chunks
        self.decode_iters = 0
        self.verify_iters = 0


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

    def result(self, timeout_s: Optional[float] = None) -> np.ndarray:
        """The host array; ``timeout_s`` (the SPMD watchdog) bounds the
        wait: past it ``EngineWedgedError`` escalates to recovery."""
        deadline = time.monotonic() + timeout_s if timeout_s else None
        poll = 0.5 if deadline is None else min(0.5, max(0.01, timeout_s / 8))
        while not self._landed.wait(poll if self._fetcher.alive() else 0):
            if not self._fetcher.alive():
                return self._materialize()
            if deadline is not None and time.monotonic() > deadline:
                raise EngineWedgedError(
                    f"device fetch exceeded the {timeout_s:.1f}s dispatch bound "
                    "(spmd-watchdog-s); escalating to coordinated recovery"
                )
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value


class _TokenFetcher:
    """The device-to-host fetch thread: one FIFO queue and one worker keep
    results in submission (= dispatch) order while the engine thread
    dispatches the next chunk. Consults the ``fetch`` fault site and
    records the fetch histogram."""

    def __init__(
        self,
        injector: Optional[FaultInjector] = None,
        obs: Optional[EngineObservability] = None,
    ) -> None:
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._injector = injector
        self._obs = obs

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
                t0 = time.monotonic()
                handle._value = handle._materialize()
                if self._obs is not None and self._obs.on:
                    self._obs.record("engine_fetch_s", time.monotonic() - t0)
            except BaseException as e:  # noqa: BLE001 — surfaces at result()
                handle._value = e
            handle._landed.set()


def _host_pages(pool: Any, n: int) -> list[list[torch.Tensor]]:
    """Pageable host blocks for ``n`` pages of ``pool``: one list of
    contiguous leaf blocks a page (``pool_leaves`` order), views of ONE
    buffer the caller owns."""
    leaves = pool_leaves(pool)
    shapes = [(leaf.shape[0],) + tuple(leaf.shape[2:]) for leaf in leaves]
    sizes = [math.prod(shape) * leaf.element_size() for shape, leaf in zip(shapes, leaves)]
    buf = torch.empty(n * sum(sizes), dtype=torch.uint8)
    out, off = [], 0
    for _ in range(n):
        page = []
        for shape, size, leaf in zip(shapes, sizes, leaves):
            page.append(buf[off:off + size].view(leaf.dtype).view(shape))
            off += size
        out.append(page)
    return out


class _StagingFull(Exception):
    """A device snapshot found too few free staging slots (engine thread
    only): the command waits for a later iteration."""


class _PoolFull(MigrationError):
    """A bind refused for room alone — the receiver's pool is exhausted or
    its prefix index is full of pinned entries. The one retryable bind
    failure: a later iteration may have room."""


class _MigrateStaging:
    """The host staging of device migration snapshots: one arena
    (``HostPageTier``, pinned on the card) of one slot's page table,
    allocated ONCE — at build with ``migrate_staging`` (the plan's
    ``migrate_staging_bytes``), else at the first device snapshot. A
    snapshot's page copies land in arena slots that stay held until BOTH
    its copies completed (their done event) and its caller let go of them
    (its ticket is set: the pages were copied out, or the caller gave up or
    raised) — so a slot is never handed to another snapshot while a DMA may
    still write it, whatever became of the reply. Engine thread only; the
    caller's side is the ticket (a ``threading.Event``)."""

    def __init__(self, dev_pool: Any, pages: int) -> None:
        self.arena = HostPageTier(dev_pool, pages)
        self._held: list[tuple[list[int], Optional[Any], threading.Event]] = []

    def take(self, n: int, ticket: threading.Event) -> list[int]:
        """``n`` free slots for one snapshot (raises _StagingFull)."""
        self.reclaim()
        slots = self.arena.alloc(n)
        if slots is None:
            raise _StagingFull
        self._held.append((slots, None, ticket))
        return slots

    def fence(self, slots: list[int], event: Optional[Any]) -> None:
        """The completion event of the copies into ``slots``."""
        self._held = [(s, event if s is slots else e, t) for s, e, t in self._held]

    def reclaim(self) -> None:
        """Free every snapshot's slots whose caller let go and whose
        copies landed."""
        keep = []
        for slots, event, ticket in self._held:
            if ticket.is_set() and (event is None or event.query()):
                self.arena.free(slots)
            else:
                keep.append((slots, event, ticket))
        self._held = keep


class _Spill:
    """One in-flight entry spill (device pages → host arena). Made on the
    engine thread once the page copies are queued (on the card: on the
    spill stream, after the engine stream's work so far, fenced by
    ``fence``, the copies' completion event; on the CPU the copies already
    ran); the spill worker waits for them and stamps each slot's checksum.
    ``cancelled`` is set by the engine when the entry is dropped mid-spill —
    the worker still finishes, and the drain frees the slots instead of
    attaching them. ``gen`` fences crash recovery: a handle from before a
    restart is discarded at the drain (the arena was reset)."""

    __slots__ = ("entry", "slots", "fence", "gen", "cancelled", "error", "event")

    def __init__(self, entry, slots: list, fence: Any, gen: int) -> None:
        self.entry = entry
        self.slots = slots
        self.fence = fence
        self.gen = gen
        self.cancelled = False
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


class _QueueWorker:
    """One daemon thread draining a FIFO queue through ``_handle`` (the
    spill and the checkpoint threads): ``submit`` from the engine thread,
    ``flush`` a barrier, ``stop`` a quiesce behind a sentinel."""

    name = "serving-worker"

    def __init__(self) -> None:
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.alive():
            return
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> bool:
        """Quiesce: jobs queued before the sentinel finish first, so after
        True no thread touches what the jobs write. False — the thread left
        registered, so ``alive()`` stays truthful — when it did not drain
        within ``timeout`` (a wedged copy or volume): the caller must not
        reuse what this thread may still write into."""
        t = self._thread
        if t is None:
            return True
        self._queue.put(None)
        t.join(timeout=timeout)
        if t.is_alive():
            return False
        self._thread = None
        return True

    def submit(self, job: Any) -> None:
        self._queue.put(job)

    def flush(self, timeout: float = 30.0) -> bool:
        """Barrier: True once every job queued before this call was
        handled."""
        if not self.alive():
            return True
        ev = threading.Event()
        self._queue.put(ev)
        return ev.wait(timeout)

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            if isinstance(job, threading.Event):
                job.set()
                continue
            self._handle(job)

    def _handle(self, job: Any) -> None:
        raise NotImplementedError


class _SpillWorker(_QueueWorker):
    """The spill thread (the fetch thread's pattern): the engine thread
    only queues the page copies and keeps the books; the wait for the
    copies and the checksum of every slot — the slow, bandwidth-bound part
    (blake2b runs without the GIL) — happen here, off the hot loop. One
    FIFO queue; completions flow back through ``done`` and are folded in by
    the engine at the iteration top (``_drain_spills``). It never collects
    garbage nor synchronizes the device: it waits on one event a handle."""

    name = "serving-spill"

    def __init__(
        self, tier: Any, done: "queue.SimpleQueue", obs: Optional[EngineObservability] = None,
    ) -> None:
        super().__init__()
        self._tier = tier
        self._done = done
        self._obs = obs

    def _handle(self, handle: _Spill) -> None:
        try:
            t0 = time.monotonic()
            if handle.fence is not None:
                handle.fence.synchronize()
            self._tier.stamp_slots(handle.slots)
            if self._obs is not None and self._obs.on:
                self._obs.record("engine_spill_s", time.monotonic() - t0)
        except BaseException as e:  # noqa: BLE001 — surfaced at the drain
            handle.error = e
        self._done.put(handle)
        handle.event.set()


class _DurableWorker(_QueueWorker):
    """The checkpoint thread of the durable tier (the spill worker's
    pattern one tier down): the engine thread materializes immutable jobs —
    page byte images and their spill-time checksums, copied out of the
    arena so a later drop cannot race the write — and the fsync-heavy temp
    + rename write runs here. Failures are counted by the store and logged,
    never raised: a failed checkpoint leaves the session restorable from
    its owner. Hibernation ``flush``es before it walks the index, so no
    session is checkpointed twice."""

    name = "serving-durable"

    def __init__(self, store: Any, obs: Optional[EngineObservability] = None) -> None:
        super().__init__()
        self._store = store
        self._obs = obs

    def _handle(self, job: dict) -> None:
        t0 = time.monotonic()
        try:
            self._store.checkpoint(
                job["digest"], job["length"], job["tokens"], job["pages_raw"],
                job["checksums"], job["page_size"], job["bytes_per_page"],
            )
            if self._obs is not None and self._obs.on:
                self._obs.record("engine_durable_checkpoint_s", time.monotonic() - t0)
        except DurableError as e:
            log.warning("durable checkpoint failed: %s", e)
        except BaseException:  # noqa: BLE001 — degrade one entry only
            log.exception("durable checkpoint crashed")


def _dfa_mask(pool: tuple, g: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Each row's packed legality bits for one sample: the bitmask plane
    gathered by (grammar row, DFA state) → [B, ceil(V/32)] int32
    (``sampling._expand_allowed`` unpacks it)."""
    return pool[0][g, state]


def _dfa_advance(pool: tuple, g: torch.Tensor, tokens: torch.Tensor, state: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Each row's DFA state past its sampled token, on the device: the
    state's default successor unless the row's sorted exception keys hold
    the composite key ``state · V + token`` (a row-wise ``searchsorted``;
    every legal non-modal transition is an exception, so legal tokens
    advance exactly as the dense table). The NaN sentinel (-1) clamps to
    token 0 and the result to >= 0; rows on grammar row 0 stay at 0."""
    _, defaults, exc_key, exc_next = pool
    state = state.long()
    key = (state * vocab_size + tokens.long().clamp(0, vocab_size - 1)).to(torch.int32)
    rows_k = exc_key[g]  # [B, E] sorted, sentinel-padded
    idx = torch.searchsorted(rows_k, key[:, None]).clamp_max(rows_k.shape[-1] - 1)  # [B, 1]
    hit_key = torch.gather(rows_k, 1, idx)[:, 0]
    hit_next = exc_next[g, idx[:, 0]]
    nxt = torch.where(hit_key == key, hit_next, defaults[g, state])
    return nxt.clamp_min(0).long()


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
        prefix_cache: Any = "off",
        prefix_cache_fraction: float = 0.25,
        prefix_cache_entries: Optional[int] = None,
        speculation: Any = "off",
        speculation_tokens: int = 4,
        weight_load_report: Optional[Any] = None,
        prefill_token_budget: Optional[int] = None,
        max_prefill_streams: Optional[int] = None,
        tenants: Optional[list] = None,
        brownout: Any = "auto",
        brownout_enter_load: float = 2.0,
        brownout_exit_load: float = 1.0,
        brownout_dwell_s: float = 0.5,
        observability: bool = True,
        flight_iterations: int = 256,
        flight_dir: Optional[str] = None,
        adapters: Optional[list] = None,
        adapter_pool_fraction: float = 0.1,
        adapter_rank: Optional[int] = None,
        adapter_pool_rows: Optional[int] = None,
        constrained_decoding: Any = "auto",
        grammar_slots: int = 64,
        grammar_states: int = 128,
        grammar_exceptions: int = 65536,
        grammar_tokenizer: Optional[Any] = None,
        host_kv_fraction: float = 0.0,
        spill: Any = "auto",
        spill_idle_s: float = 0.0,
        restore_stall_dump_s: float = 1.0,
        durable: Any = "auto",
        durable_dir: Optional[str] = None,
        durable_max_bytes: int = 0,
        durable_timeout_s: float = 5.0,
        migrate_staging: bool = False,
        prefill_batch: Optional[int] = None,
        mesh: Optional[Any] = None,
        spmd: Optional[Any] = None,
        ring: Optional[Any] = None,
        multihost: bool = False,
    ) -> None:
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; supported: paged, dense")
        if queue_depth is not None and int(queue_depth) <= 0:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if shed_policy not in ("block", "reject"):
            raise ValueError(f"unknown shed_policy {shed_policy!r}; supported: block, reject")
        self.device = resolve_device(device)
        # rows of an admit group (an MoE model's groups are padded to it)
        self.prefill_batch = int(prefill_batch) if prefill_batch else self.PREFILL_BATCH
        # tensor parallelism: the mesh's handle and this rank's shapes;
        # ``full_config`` keeps the model's own
        self.mesh = mesh
        self._tp = tensor_parallel(mesh, config)
        self.full_config = config
        if self._tp is not None:
            config = local_config(config, mesh)
        # a config the kernels cannot take on this device (a non-bf16 model
        # on the card) raises here, before anything is allocated
        kernel_path_ok(config, self.device)
        self.config = config
        # the SPMD channel (None: single process); set True on a follower
        # by ``follower_loop``
        self._spmd = spmd
        self._spmd_follower = False
        # a replica whose ranks span pods (``LANGSTREAM_TPU_HOSTS`` > 1):
        # the tiers stay off there, as the JAX engine keeps them off under
        # its multi-host SPMD; a multi-rank replica in one pod serves them
        self.multihost = bool(multihost)
        # a follower's pending admission rows (``OP_ADMIT_ROWS``) and the
        # pieces of a payload spanning blocks; the leader's last announced
        # per-slot rows (``OP_SLOT_ROWS``); a follower's spills in flight by
        # arena slot
        self._spmd_admit_rows: Optional[np.ndarray] = None
        self._spmd_payload_buf: list = []
        self._spmd_rows_sent: Optional[tuple] = None
        self._spmd_spills: dict[int, Any] = {}
        self._rng_seed = int(rng_seed)
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
        self.prefill_token_budget = max(
            1, int(prefill_token_budget or self.prefill_buckets[-1])
        )
        if max_prefill_streams is not None:
            self.MAX_PREFILL_STREAMS = max(1, int(max_prefill_streams))
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self.page_size = max(1, int(page_size))
        self._pagepool: Optional[PagePool] = None
        self._prefix_index: Optional[PrefixPageIndex] = None
        self._prefix_pool: Optional[PrefixCachePool] = None
        self._cache: Optional[KVCache] = None
        prefix_on = prefix_cache is True or str(prefix_cache).lower() in (
            "auto", "on", "true", "1"
        )
        # self-speculative decoding: host-side n-gram drafts, k of them per
        # slot and iteration, scored in one verify dispatch; one k
        # engine-wide (its static buffers and graphs have k + 1 columns)
        spec_on = speculation is True or str(speculation).lower() in (
            "auto", "on", "true", "1"
        )
        self._spec_enabled = spec_on
        self.spec_tokens = max(1, int(speculation_tokens)) if spec_on else 0
        self._spec_index: dict[int, NGramIndex] = {}
        if self._paged:
            # the pool: every slot can reach max_seq_len, plus the prefix
            # fraction's headroom for the pages the index holds
            num_pages = (
                int(kv_pages)
                if kv_pages is not None
                else pages_for_fraction(
                    self.max_batch, self.max_seq_len, self.page_size,
                    prefix_cache_fraction if prefix_on else 0.0,
                )
            )
            self._pagepool = PagePool(
                config, num_pages, self.page_size, self.max_batch, self.max_seq_len,
                device=self.device,
            )
            # prefix_cache_entries caps the index (0 disables reuse)
            entries = (
                int(prefix_cache_entries) if prefix_cache_entries is not None else 512
            )
            if prefix_on and entries > 0:
                self._prefix_index = PrefixPageIndex(self.prefill_buckets, max_entries=entries)
        else:
            # + one sink column: a slot that finished mid-chunk keeps
            # advancing on the device, and its writes past max_seq_len land
            # there (JAX drops them)
            self._cache = make_kv_cache(
                config, self.max_batch, self.max_seq_len + 1, device=self.device
            )
        # ring prefill: a mesh whose seq axis is above 1 (or a ring handle
        # given, ``spmd_serving.LoopbackRing``) admits long prompts in ONE
        # sequence-split dispatch instead of the segment loop. Dense layout
        # only: the ring admit splices into the big cache; on the paged
        # layout long prompts keep the segment loop, as in the JAX engine
        self._ring = ring if ring is not None else seq_ring(mesh)
        self._ring_admit = self._ring is not None and self._ring.n > 1 and not self._paged
        # a follower's OP_RING token chunks, until the final one
        self._spmd_ring_buf: list = []
        # the dense prefix pool: rows of the widest bucket's columns, as
        # many as the fraction of the cache's tokens (an explicit entry
        # count wins, 0 disables it); allocated after the memory plan
        pool_entries, pool_width = 0, 0
        if prefix_on and not self._paged:
            pool_width = self.prefill_buckets[-1]
            pool_entries = (
                int(prefix_cache_entries) if prefix_cache_entries is not None
                else pool_entries_for_fraction(
                    self.max_batch, self.max_seq_len, pool_width, prefix_cache_fraction
                )
            )
        # -- the host KV tier: idle published prefixes spill into a host
        # arena, demote to it under pool pressure, restore from it on a hit.
        # host-kv-fraction sizes the arena relative to the pool (2.0 = twice
        # the pool's pages in host RAM); 0 turns the tier off
        if str(spill).lower() not in ("auto", "on", "true", "1", "off", "false", "0"):
            raise ValueError(f"unknown spill {spill!r}; supported: auto, off")
        spill_off = str(spill).lower() in ("off", "false", "0")
        self.host_kv_fraction = max(0.0, float(host_kv_fraction))
        self.spill_idle_s = max(0.0, float(spill_idle_s))
        self._restore_stall_s = max(0.0, float(restore_stall_dump_s))
        spill_on = self._paged and not spill_off and self.host_kv_fraction > 0
        if spmd is not None and self.multihost and spill_on:
            # a multi-rank replica in one pod carries the tier on the wire
            # (``OP_HOST_SPILL`` / ``OP_HOST_RESTORE``); across pods it stays
            # off, as the JAX engine keeps it off under multi-host SPMD
            log.warning(
                "tiered KV host spill is not on the SPMD wire yet; off on this multi-host "
                "replica (host-kv-fraction %.2f ignored)", self.host_kv_fraction,
            )
            spill_on = False
        if spill_on and self._prefix_index is None:
            # nothing to hibernate without the alias index: spilled pages
            # are reachable only through prefix entries
            log.warning(
                "tiered KV host spill needs the prefix index "
                "(prefix-cache on, prefix-cache-entries > 0); off"
            )
            spill_on = False
        self._spill_on = spill_on
        self._host_tier: Optional[HostPageTier] = None
        self._spill_worker: Optional[_SpillWorker] = None
        # page copies off the engine stream (spills, migration snapshots)
        # run on this stream after an event the engine stream records
        self._spill_stream: Optional[Any] = (
            torch.cuda.Stream(self.device)
            if self._paged and self.device.type == "cuda" else None
        )
        self._spill_done: "queue.SimpleQueue" = queue.SimpleQueue()
        self._spill_gen = 0
        # device-only entries awaiting hibernation, oldest first (engine
        # thread); entries join when published or restored
        self._spill_candidates: deque = deque()
        self.spill_pages_total = 0
        self.spill_bytes_total = 0
        self.spill_failures_total = 0
        self.restore_pages_total = 0
        self.restore_bytes_total = 0
        self.restored_hits_total = 0
        self.restore_failures_total = 0
        self.recompute_fallbacks_total = 0
        # host seconds a restore spent verifying checksums (the rest of its
        # time is the upload's queueing); a restore's total is the
        # engine_restore_s histogram
        self.restore_verify_s_total = 0.0
        # host seconds of the restores that uploaded (verify, upload queueing)
        self.restore_s_total = 0.0
        # host ms of spill / restore bookkeeping this iteration (the flight
        # frames' phase_ms)
        self._spill_ms_iter = 0.0
        self._restore_ms_iter = 0.0
        # -- the durable session tier: crash-safe checkpoints on disk, so a
        # session survives its replica's restart, drain or scale to zero
        if str(durable).lower() not in ("auto", "on", "true", "1", "off", "false", "0"):
            raise ValueError(f"unknown durable {durable!r}; supported: auto, off")
        durable_off = str(durable).lower() in ("off", "false", "0")
        durable_ask = str(durable).lower() in ("on", "true", "1")
        self.durable_dir = str(durable_dir) if durable_dir else None
        self.durable_timeout_s = max(0.1, float(durable_timeout_s))
        self._durable_max_bytes = max(0, int(durable_max_bytes))
        durable_on = self._paged and not durable_off and self.durable_dir is not None
        if durable_ask and not durable_on:
            log.warning(
                "durable: on requested but unavailable (needs kv-layout: paged + "
                "durable-dir) — tier stays off"
            )
        if durable_on and self._prefix_index is None:
            log.warning("durable tier needs the prefix index (prefix-cache: auto) — off")
            durable_on = False
        if spmd is not None and durable_on:
            log.warning(
                "durable KV tier is not on the SPMD wire; off on this multi-rank replica "
                "(durable-dir %s ignored)", self.durable_dir,
            )
            durable_on = False
        self._durable_on = durable_on
        self._durable: Optional[DurableStore] = None
        self._durable_worker: Optional[_DurableWorker] = None
        # admissions a durable restore served (the ladder's third rung)
        self.durable_restored_hits_total = 0
        # True while a durable restore serves an admission (``restoring``)
        self._durable_restoring = False
        # ``hibernate()`` calls served on the engine thread at the iteration
        # top: (replica id, reply queue)
        self._hibernations: "queue.SimpleQueue" = queue.SimpleQueue()
        # KV-page migration commands (snapshot / bind / release) from other
        # threads, served on the engine thread at the iteration top — the
        # pool and the index are the engine thread's — each with its own
        # reply queue; callers wait with a deadline, never forever
        self._migrate_cmds: "queue.SimpleQueue" = queue.SimpleQueue()
        # snapshot commands waiting for staging slots, oldest first, and the
        # staging itself (``_MigrateStaging``; built by ``_staging``)
        self._migrate_waiting: deque = deque()
        self._mig_stage: Optional[_MigrateStaging] = None
        self.migrate_pages_out_total = 0
        self.migrate_bytes_out_total = 0
        self.migrate_pages_in_total = 0
        self.migrate_bytes_in_total = 0
        self.migrate_failures_total = 0
        # chunked-prefill streams: queued long requests, one held back when
        # that queue is full, and the active streams by slot (request, next
        # segment; dense: its local cache)
        self._long_queue: list[GenerationRequest] = []
        self._held_back: Optional[GenerationRequest] = None
        self._longs: dict[int, dict] = {}
        self._long_rr = -1
        # dense: each stream's batch-1 local cache by slot (a follower's too)
        self._long_caches: dict[int, KVCache] = {}
        # decode steps dispatched but not yet processed on the host: device
        # positions lead host positions by this much
        self._inflight_steps = 0
        self._slots = [_Slot() for _ in range(self.max_batch)]
        self.shed_policy = shed_policy
        # multi-tenant overload control: per-tenant weights, slot caps,
        # queue shares and token-rate quotas with their counters, and the
        # admission queue itself — weighted deficit round-robin in prefill
        # tokens (one tenant with default priorities: a FIFO)
        self._tenants = TenantRegistry([
            t if isinstance(t, TenantSpec) else TenantSpec.from_dict(t) for t in (tenants or [])
        ])
        self._queue = TenantQueue(
            maxsize=int(queue_depth) if queue_depth is not None else self.max_batch * 4,
            registry=self._tenants,
            cost_fn=lambda r: float(self._bucket(len(r.prompt_tokens))),
            quantum=float(self.prefill_buckets[-1]),
        )
        # the brownout ladder (None: brownout "off")
        brownout_off = brownout is False or str(brownout).lower() in ("off", "false", "0", "none")
        self._brownout: Optional[BrownoutController] = None if brownout_off else (
            BrownoutController(
                enter_load=float(brownout_enter_load),
                exit_load=float(brownout_exit_load),
                dwell_s=float(brownout_dwell_s),
            )
        )
        self.brownout_dumps_total = 0
        self._brownout_checked_at = 0.0
        self._brownout_lock = threading.Lock()
        # histograms, request spans and the flight recorder; every sample
        # is host-side (nothing inside a captured chunk)
        self._obs = EngineObservability(
            enabled=observability, flight_capacity=flight_iterations, flight_dir=flight_dir,
        )
        # engine iterations, idle ones too (the flight recorder's clock)
        self._iterations_total = 0
        # decode-step clock: the ready time of the last processed chunk, and
        # the EMA of one step's time (``decode-step-ms``, and the
        # denominator of ``hbm-gbps-decode``)
        self._last_chunk_ready_t = 0.0
        self._step_time_ema_s = 0.0
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
        # the agentic tier: the adapter pool and the grammar pool, their
        # per-slot rows (host: dispatch-facing and authoritative adapter
        # rows, for the ``adapter`` site's integrity check) and the host
        # mirror of each constrained slot's DFA state
        self._adapters: Optional[AdapterRegistry] = None
        self._constrain_reg: Optional[GrammarRegistry] = None
        self._adapter_rows = np.zeros(self.max_batch, np.int64)
        self._adapter_rows_auth = np.zeros(self.max_batch, np.int64)
        self._g_rows = np.zeros(self.max_batch, np.int64)
        self._slot_dfa: dict[int, Any] = {}
        self._dfa_host_state: dict[int, int] = {}
        self.constrained_requests_total = 0
        self._constrain_host_ema_ms = 0.0
        specs = [a if isinstance(a, AdapterSpec) else AdapterSpec.from_dict(a)
                 for a in (adapters or [])]
        explicit_constrain = constrained_decoding is True or str(constrained_decoding).lower() in (
            "on", "true", "1"
        )
        if spmd is not None and self.multihost and (specs or str(constrained_decoding).lower()
                                                      not in ("off", "false", "0", "none")):
            # a multi-rank replica in one pod carries the tier on the wire
            # (swaps, admission rows, slot rows, verify states); a multi-host
            # one serves base, free-form text only, as the JAX engine does
            # (auto degrades quietly, an explicit ask warns)
            log.log(
                logging.WARNING if specs or explicit_constrain else logging.INFO,
                "adapters / constrained decoding are not on the SPMD wire yet; off on this "
                "multi-host replica",
            )
            specs = []
            constrained_decoding = "off"
        if specs:
            rank = int(adapter_rank or max(s.rank for s in specs))
            rows = (
                int(adapter_pool_rows) if adapter_pool_rows is not None
                else rows_for_fraction(config, rank, tree_bytes(params), adapter_pool_fraction,
                                       n_registered=len(specs))
            )
            # under tensor parallelism each rank draws or loads the model's
            # factors and keeps the slices of its weights (``shard_lora``)
            self._adapters = AdapterRegistry(
                config, rows, rank, device=self.device, full_config=self.full_config,
                shard=(lambda host: shard_lora(host, mesh, self.full_config))
                if self._tp is not None else None,
            )
            for spec in specs:
                self._adapters.register(spec)
        constrain_on = constrained_decoding is True or str(constrained_decoding).lower() in (
            "auto", "on", "true", "1"
        )
        if constrain_on and int(grammar_slots) <= 0:
            # the disabled contract grammar_pool_bytes shares: no rows, no tier
            log.info("grammar-slots <= 0: constrained decoding disabled")
            constrain_on = False
        if constrain_on:
            self._constrain_reg = GrammarRegistry(
                grammar_tokenizer if grammar_tokenizer is not None else ByteTokenizer(),
                config.vocab_size, eos_token_id,
                slots=int(grammar_slots),
                max_states=max(2, int(grammar_states)),
                max_exceptions=max(1, int(grammar_exceptions)),
                device=self.device,
            )
        self._agentic = self._adapters is not None or self._constrain_reg is not None
        if spmd is not None:
            # the leader's swap-ins ride the wire (a follower loads rows
            # through ``load_row``, which calls no hook)
            if self._adapters is not None:
                self._adapters.on_swap = self._announce_adapter_swap
            if self._constrain_reg is not None:
                self._constrain_reg.on_swap = self._announce_grammar_swap
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
        # the captured chunks: sampling branch → (graph, per-kernel
        # launches of one replay). ``_graphs`` holds the engine's own set
        # (the decode chunk; with speculation the verify), ``_decode_graphs``
        # the decode chunks a speculative engine serves at brownout level 2
        self._graphs: dict[tuple[bool, bool], tuple[Any, dict]] = {}
        self._decode_graphs: dict[tuple[bool, bool], tuple[Any, dict]] = {}
        # the captures' side stream and shared pool (made at the first
        # capture of a set, dropped with the graphs on a rebuild)
        self._capture_pool: Any = None
        self._capture_stream: Any = None
        self._capture_reserved0: Optional[int] = None
        self.restart_backoff_s = max(0.01, float(restart_backoff_s))
        self.max_restarts = max(0, int(max_restarts))
        self._injector = (
            fault_injector if fault_injector is not None else FaultInjector.from_env()
        )
        self._fetcher = _TokenFetcher(self._injector, self._obs)
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
        self.ring_admissions_total = 0
        self.decode_chunks_total = 0
        self.decode_steps_total = 0
        self.nan_guard_total = 0
        self.cancelled_total = 0
        self.shed_total = 0
        self.deadline_queue_total = 0
        self.deadline_decode_total = 0
        self.quarantined_slots_total = 0
        self.engine_restarts_total = 0
        # SPMD slice resilience: the recovery epoch, the last divergence
        # poll and the ledger
        self._spmd_epoch = 0
        self._spmd_div_checked_at = 0.0
        self.spmd_recoveries_total = 0
        self.spmd_resyncs_total = 0
        self.spmd_watchdog_trips_total = 0
        self.graph_captures_total = 0
        self.graph_replays_total = 0
        self.graph_replays_by_kind = {"decode": 0, "verify": 0}
        self.graph_capture_s = 0.0
        # the last capture's seconds, part by part: the warm-up and each
        # set's branches ("decode-greedy", "verify-sampled", ...)
        self.graph_capture_parts_s: dict[str, float] = {}
        self.graph_pool_bytes = 0
        # prefix reuse: warm admissions (one suffix segment each) and
        # copy-on-write page copies
        self.warm_admissions_total = 0
        self.page_copies_total = 0
        # speculation (the JAX engine's counters): verify dispatches, drafts
        # proposed and accepted (capped at each proposal's length), tokens
        # delivered by verifies, (active slot, verify) pairs, and index
        # lookups with a proposal among them
        self.spec_dispatches_total = 0
        self.spec_draft_tokens_total = 0
        self.spec_accepted_tokens_total = 0
        self.spec_emitted_tokens_total = 0
        self.spec_slot_steps_total = 0
        self.spec_draft_lookups_total = 0
        self.spec_draft_hits_total = 0
        # the load these params came from (models/streamload.py's
        # WeightLoadReport; None for random weights): its numbers feed
        # stats() and the memory plan, and a load that returned with its
        # copies in flight is waited on in start()
        self._weight_load = weight_load_report
        self._weight_load_report: dict[str, Any] = (
            weight_load_report.as_dict() if weight_load_report is not None else {}
        )
        if self._weight_load_report.get("total-s"):
            self._obs.record("engine_weight_load_s", float(self._weight_load_report["total-s"]))
        self.memory_plan = plan_serving_memory(
            config, self.max_batch, self.max_seq_len,
            params=params,
            prefill_batch=self.prefill_batch,
            prefill_bucket=self.prefill_buckets[-1],
            prefill_streams=self.MAX_PREFILL_STREAMS,
            speculation_tokens=self.spec_tokens,
            graph_sets=self._graph_kinds(),
            kv_layout=self.kv_layout,
            page_size=self.page_size,
            kv_pages=self._pagepool.num_pages if self._paged else 0,
            prefix_pool_entries=pool_entries,
            prefix_pool_width=pool_width,
            weight_load_staging=int(self._weight_load_report.get("staging-peak-bytes", 0)),
            adapter_pool_rows=self._adapters.rows if self._adapters else 0,
            adapter_rank=self._adapters.rank if self._adapters else 0,
            grammar_slots=self._constrain_reg.slots if self._constrain_reg else 0,
            grammar_states=self._constrain_reg.max_states if self._constrain_reg else 0,
            grammar_exceptions=(
                self._constrain_reg.max_exceptions if self._constrain_reg else 0
            ),
            host_kv_fraction=self.host_kv_fraction if self._spill_on else 0.0,
            durable_max_bytes=self._durable_max_bytes if self._durable_on else 0,
            # a role-tagged replica's host staging of one in-flight migration
            migrate_staging=bool(migrate_staging) and self._paged,
        )
        log.info("serving memory plan (%s, B=%d, T=%d, %s): %s", config.name, self.max_batch,
                 self.max_seq_len, self.kv_layout, self.memory_plan.summary())
        if self._spill_on:
            self._build_host_tier()
        if self.memory_plan.migrate_staging_bytes and self._prefix_index is not None:
            self._staging()
        if self._durable_on:
            self._build_durable()
        if pool_entries > 0:
            self._prefix_pool = PrefixCachePool(
                config, pool_entries, pool_width, boundaries=self.prefill_buckets,
                device=self.device,
            )

    def _alloc_decode_state(self) -> None:
        """Fresh static buffers of the decode chunk: the chain (last sampled
        token and next write position per slot), the per-slot sampling
        params, the dispatch page table (paged; every row the sentinel) and
        the ``[steps, B]`` output; with speculation, the verify's ``[B, k]``
        drafts and its packed ``[B, k + 2]`` output; with the agentic tier,
        each slot's adapter row, grammar row and DFA state (and with
        speculation the verify's per-position states ``[B, k + 1]``). The
        graphs hold raw pointers to these: they are only ever written in
        place (a restart allocates them anew before it captures again)."""
        dev = self.device
        b = self.max_batch
        self._tokens_dev = torch.zeros(b, dtype=torch.long, device=dev)
        self._positions_dev = torch.zeros(b, dtype=torch.long, device=dev)
        self._temp_dev = torch.zeros(b, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros(b, dtype=torch.long, device=dev)
        self._top_p_dev = torch.ones(b, dtype=torch.float32, device=dev)
        self._chunk_out = torch.zeros((self.decode_chunk, b), dtype=torch.long, device=dev)
        k = self.spec_tokens
        self._drafts_dev = torch.zeros((b, k), dtype=torch.long, device=dev) if k else None
        self._verify_out = torch.zeros((b, k + 2), dtype=torch.long, device=dev) if k else None
        self._table_dev: Optional[torch.Tensor] = None
        self._table_uploaded: Optional[np.ndarray] = None
        reg = self._constrain_reg
        self._arows_dev = (
            torch.zeros(b, dtype=torch.long, device=dev) if self._adapters is not None else None
        )
        self._g_rows_dev = torch.zeros(b, dtype=torch.long, device=dev) if reg else None
        self._dfa_state_dev = torch.zeros(b, dtype=torch.long, device=dev) if reg else None
        self._vstates_dev = (
            torch.zeros((b, k + 1), dtype=torch.long, device=dev) if reg and k else None
        )
        # what the row buffers hold, so an unchanged array is not uploaded
        self._arows_uploaded = np.zeros(b, np.int64)
        self._g_rows_uploaded = np.zeros(b, np.int64)
        if self._paged:
            pool = self._pagepool
            self._table_dev = torch.full(
                pool.tables.shape, pool.oob, dtype=torch.int32, device=dev
            )
            self._table_uploaded = np.full(pool.tables.shape, pool.oob, np.int32)

    def _build_host_tier(self) -> None:
        """The host arena (``ceil(pages x host-kv-fraction)`` slots, pinned
        on the card), its spill worker and, on the card, the spill stream
        the page copies run on."""
        pool = self._pagepool
        host_pages = max(1, math.ceil(pool.num_pages * self.host_kv_fraction))
        self._host_tier = HostPageTier(pool.dev, host_pages)
        self._prefix_index.host_tier = self._host_tier
        self._spill_worker = _SpillWorker(self._host_tier, self._spill_done, self._obs)
        log.info(
            "tiered KV host arena: %d host pages (%.2f GiB %s RAM in %.2fs, %.2fx the device "
            "pool) — idle prefixes spill after %.1fs, LRU eviction demotes before dropping",
            host_pages, self._host_tier.bytes_total / 1024**3,
            "pinned" if self._host_tier.pinned else "host", self._host_tier.alloc_s,
            self.host_kv_fraction, self.spill_idle_s,
        )

    def _build_durable(self) -> None:
        """The durable store over ``durable-dir``, rehydrated (manifests
        only) before the first admission, and its checkpoint worker. An
        unusable directory turns the tier off, it never fails the build."""
        try:
            self._durable = DurableStore(
                self.durable_dir, max_bytes=self._durable_max_bytes, injector=self._injector,
            )
            rehydrated = self._durable.rehydrate()
        except OSError:
            log.exception("durable tier unavailable (%s) — off", self.durable_dir)
            self._durable = None
            return
        self._durable_worker = _DurableWorker(self._durable, self._obs)
        log.info(
            "durable KV tier: %s (%d checkpointed session prefix(es) rehydrated%s) — "
            "hibernated arenas checkpoint crash-safe; sessions survive replica death and "
            "scale-to-zero",
            self.durable_dir, rehydrated,
            f", cap {self._durable_max_bytes / 1024**3:.2f} GiB" if self._durable_max_bytes
            else "",
        )

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
        if self._weight_load is not None:
            # a load that returned with its copies in flight: this thread's
            # stream (and with it the capture's side stream) waits for the
            # load stream's last event before the first use of the params
            self._weight_load.wait(
                torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
            )
        if not self._graphs:
            self._capture_graphs()
        self._dead = None
        self._stop.clear()
        self._fetcher.start()
        # the tier's workers start after the capture (none runs during one)
        if self._spill_worker is not None:
            self._spill_worker.start()
        if self._durable_worker is not None:
            self._durable_worker.start()
        self._thread = threading.Thread(target=self._run, name="serving-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fetcher.stop()
        if self._spill_worker is not None:
            self._spill_worker.stop()
        if self._durable_worker is not None:
            self._durable_worker.stop()
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

    def _graph_kinds(self) -> tuple[str, ...]:
        """The graph sets ``start()`` captures: the decode chunk; with
        speculation the verify — and, unless brownout is off, the decode
        chunk beside it, which brownout level 2 serves instead."""
        if not self._spec_enabled:
            return ("decode",)
        return ("verify",) if self._brownout is None else ("verify", "decode")

    def _chunk_fn(self, kind: str) -> Callable[[bool, bool], None]:
        return self._verify_chunk if kind == "verify" else self._decode_chunk

    def _capture_graphs(self) -> None:
        """Capture each graph set (``_graph_kinds``: the decode chunk, the
        verify, or both) once per sampling branch, in ``DECODE_BRANCHES``
        order, into one shared pool (``_capture_set``). The SPMD leader
        announces each set as ``OP_WARMUP`` right before capturing it, so
        a follower captures the same set — with the same collectives
        inside — at the same point of the wire. Raises when a capture
        fails."""
        self._graphs, self._decode_graphs = {}, {}
        self._capture_pool = None
        with self._stats_lock:
            self.graph_capture_parts_s = {}
        t0 = time.monotonic()
        kinds = self._graph_kinds()
        for kind in kinds:
            if self._spmd is not None and not self._spmd_follower:
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_WARMUP, count=self._warmup_code(kind)
                ))
            self._capture_set(kind)
        if self._graphs or self._decode_graphs:
            log.info("captured %d graphs (%s) in %.2fs: %s", len(self._graphs) + len(
                self._decode_graphs), ", ".join(kinds), time.monotonic() - t0,
                ", ".join(f"{k} {v:.2f}s" for k, v in self.graph_capture_parts_s.items()))

    def _warmup_code(self, kind: str) -> int:
        """The ``OP_WARMUP`` kind a graph set is announced as."""
        if kind == "verify":
            return wire.WARMUP_VERIFY_LADDER
        return wire.WARMUP_PAGED if self._paged else wire.WARMUP_DECODE_LADDER

    def _capture_set(self, kind: str) -> None:
        """Capture one graph set, once per sampling branch — on the card
        with ``torch.cuda.CUDAGraph`` after one warm-up call of every
        branch on the side stream (cuBLAS handles, kernel attributes, the
        rope table and, under a mesh, the NCCL communicator are set up
        there, outside any capture), off the card only with a stand-in
        ``_graph_factory``. Each graph's kernel launches are counted at
        capture and removed from the totals (the capture launched nothing);
        each replay adds them back. The warm-up and each capture are timed
        (``graph_capture_parts_s``: the warm-ups summed as "warmup")."""
        factory = self._graph_factory
        cuda = self.device.type == "cuda"
        if factory is None and not cuda:
            return  # the CPU calls the chunk function directly
        # one capture at a time in a process: another engine's collection
        # or launches during a capture would poison it or its counts (an
        # SPMD loopback pair captures each set on both engines)
        with _CAPTURE_LOCK:
            self._capture_set_locked(kind, factory, cuda)

    def _capture_set_locked(self, kind: str, factory: Any, cuda: bool) -> None:
        t0 = time.monotonic()
        parts: dict[str, float] = {}
        fn = self._chunk_fn(kind)
        graphs: dict = {}
        with torch.no_grad():
            if factory is None:
                if self._capture_pool is None:
                    self._capture_stream = torch.cuda.Stream(self.device)
                    self._capture_pool = torch.cuda.graph_pool_handle()
                    self._capture_reserved0 = None
                stream, pool = self._capture_stream, self._capture_pool
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    for branch in DECODE_BRANCHES:
                        fn(*branch)
                torch.cuda.current_stream(self.device).wait_stream(stream)
                torch.cuda.synchronize(self.device)
                # the graph pool's bytes: what stays reserved past the
                # captures once every releasable block went back (garbage
                # of earlier engines too, or the difference goes negative)
                gc.collect()
                torch.cuda.empty_cache()
                if self._capture_reserved0 is None:
                    self._capture_reserved0 = torch.cuda.memory_reserved(self.device)

                def factory() -> _CudaGraph:
                    return _CudaGraph(pool, stream, self._generator)

            parts["warmup"] = time.monotonic() - t0
            # a garbage collection inside a capture could destroy another
            # engine's unreachable graphs (and free their pool), which a
            # capturing stream refuses: collect first, none during
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                for branch in DECODE_BRANCHES:
                    t_part = time.monotonic()
                    graph = factory()
                    before = count_snapshot()
                    graph.capture(lambda f=fn, b=branch: f(*b))
                    delta = count_delta(before, count_snapshot())
                    add_counts(delta, -1)
                    graphs[branch] = (graph, delta)
                    if cuda:
                        torch.cuda.synchronize(self.device)
                    parts[f"{kind}-{BRANCH_NAMES[branch]}"] = time.monotonic() - t_part
            finally:
                if collecting:
                    gc.enable()
            if cuda:
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
        own = "verify" if self._spec_enabled else "decode"
        if kind == own:
            self._graphs = graphs
        else:
            self._decode_graphs = graphs
        took = time.monotonic() - t0
        with self._stats_lock:
            self.graph_captures_total += len(graphs)
            self.graph_capture_s += took
            merged = dict(self.graph_capture_parts_s)
            merged["warmup"] = merged.get("warmup", 0.0) + parts.pop("warmup")
            merged.update(parts)
            self.graph_capture_parts_s = merged
            if cuda and getattr(self, "_capture_reserved0", None) is not None:
                self.graph_pool_bytes = (
                    torch.cuda.memory_reserved(self.device) - self._capture_reserved0
                )

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
        narrows the masked read. With the agentic tier each step gathers
        the slots' adapter rows, masks the sample by each slot's (grammar
        row, DFA state) and advances the state in place."""
        reg = self._constrain_reg
        lora = self._lora_kw(self._arows_dev)
        for step in range(self.decode_chunk):
            if self._paged:
                logits, _ = paged_decode_step_inplace(
                    self.params, self._tokens_dev, self._positions_dev, self._pagepool.dev,
                    self._table_dev, self.config, self.page_size, tp=self._tp, **lora,
                )
            else:
                logits, _ = decode_step_inplace(
                    self.params, self._tokens_dev, self._positions_dev, self._cache,
                    self.config, kv_bound, tp=self._tp, **lora,
                )
            allowed = (
                _dfa_mask(reg.pool, self._g_rows_dev, self._dfa_state_dev) if reg else None
            )
            tokens = sample(
                logits, self._generator, self._temp_dev, self._top_k_dev, self._top_p_dev,
                samples, filters, allowed,
            )
            if reg is not None:
                self._dfa_state_dev.copy_(_dfa_advance(
                    reg.pool, self._g_rows_dev, tokens, self._dfa_state_dev,
                    self.config.vocab_size,
                ))
            self._tokens_dev.copy_(tokens)
            self._positions_dev.add_(1)
            self._chunk_out[step].copy_(tokens)

    def _verify_chunk(self, samples: bool, filters: bool, kv_bound: Optional[int] = None) -> None:
        """One speculative verify over the static buffers: each slot's
        current token and its k drafts through ``paged_verify_step_inplace``
        (dense: ``verify_step_inplace``, reading a ``[..., :kv_bound]`` view
        of the big cache — ``max_seq_len`` by default, so no query reads
        the sink column; the CPU passes the exact bound) at ``[position,
        position + k]``, then ``speculative_verify``; the
        chain advances in place to the emitted token at the accepted length
        (``positions += accept + 1``) and ``_verify_out`` receives the
        emitted tokens and the accepted count — nothing rebound, no host
        sync, so the graphs capture it as they capture ``_decode_chunk``.
        Paged: rows of the dispatch table that are not active are the
        sentinel, so their (discarded) verify writes only into the sink
        page; dense: inactive rows write into their own rows. With the
        agentic tier each row's adapter serves all k + 1 of its inputs,
        position j is masked by the host-computed state ``_vstates_dev[:,
        j]`` (``verify_states``), and the DFA state advances from the
        state at the accepted length past the emitted token."""
        k = self.spec_tokens
        reg = self._constrain_reg
        inputs = torch.cat([self._tokens_dev[:, None], self._drafts_dev], dim=1)  # [B, k+1]
        lora = self._lora_kw(self._arows_dev)
        if self._paged:
            logits, _ = paged_verify_step_inplace(
                self.params, inputs, self._positions_dev, self._pagepool.dev, self._table_dev,
                self.config, self.page_size, tp=self._tp, **lora,
            )
        else:
            logits, _ = verify_step_inplace(
                self.params, inputs, self._positions_dev, self._cache, self.config,
                self.max_seq_len if kv_bound is None else kv_bound, tp=self._tp, **lora,
            )
        allowed = reg.pool[0][self._g_rows_dev[:, None], self._vstates_dev] if reg else None
        out, accept = speculative_verify(
            logits, self._drafts_dev, self._generator, self._temp_dev, self._top_k_dev,
            self._top_p_dev, samples, filters, allowed,
        )
        emitted = torch.gather(out, 1, accept[:, None])[:, 0]
        if reg is not None:
            pre = torch.gather(self._vstates_dev, 1, accept[:, None])[:, 0]
            self._dfa_state_dev.copy_(_dfa_advance(
                reg.pool, self._g_rows_dev, emitted, pre, self.config.vocab_size
            ))
        self._tokens_dev.copy_(emitted)
        self._positions_dev.add_(accept + 1)
        self._verify_out[:, : k + 1].copy_(out)
        self._verify_out[:, k + 1].copy_(accept)

    def _branch(self) -> tuple[bool, bool]:
        """The sampling branch the active slots need (host predicates)."""
        opts = [s.request.options for s in self._slots if s.active]
        samples = any(o.temperature > 0 for o in opts)
        filters = any(o.temperature > 0 and (o.top_k > 0 or o.top_p < 1.0) for o in opts)
        return samples, filters

    def _collect_stale(self) -> list[int]:
        """Slots freed since the last dispatch and not re-admitted: their
        device temperature is zeroed before the next chunk."""
        stale = sorted(i for i in set(self._freed_slots) if not self._slots[i].active)
        self._freed_slots.clear()
        return stale

    def _active_mask(self) -> np.ndarray:
        return np.array([1 if s.active else 0 for s in self._slots], np.int32)

    def _prepare_chunk(self) -> None:
        """Host writes into the static buffers before a chunk: zero the
        temperature of slots freed since the last dispatch (and not
        re-admitted), copy up the masked page table and the slots' adapter
        and grammar rows when they changed."""
        self._dev_prepare(self._collect_stale(), self._active_mask())
        self._refresh_agentic()

    def _dev_prepare(self, stale: list, mask: np.ndarray) -> None:
        """Device writes into the static buffers before a chunk (leader and
        SPMD follower alike): zero the temperature of the ``stale`` slots,
        copy up the page table masked to the ``mask``'s active slots when it
        changed."""
        for i in stale:
            self._temp_dev[int(i)] = 0.0
        if self._paged:
            self._refresh_table(self._dispatch_tables(mask))

    def _refresh_agentic(self) -> None:
        """Copy up the slots' adapter and grammar rows when they changed
        (a follower's arrive in ``OP_SLOT_ROWS``)."""
        if self._arows_dev is not None:
            self._refresh_rows(self._adapter_rows, self._arows_dev, self._arows_uploaded)
        if self._g_rows_dev is not None:
            self._refresh_rows(self._g_rows, self._g_rows_dev, self._g_rows_uploaded)

    def _refresh_rows(self, host: np.ndarray, dev: torch.Tensor, uploaded: np.ndarray) -> None:
        """Copy a per-slot row array into its static buffer when it differs
        from what the buffer holds (``uploaded``, updated in place)."""
        if np.array_equal(host, uploaded):
            return
        dev.copy_(self._upload(host), non_blocking=True)
        uploaded[:] = host

    def _lora_kw(self, rows) -> dict:
        """The adapter keywords of a model call: the pool and the rows
        (a device tensor, or a host array uploaded here); none without
        adapters."""
        if self._adapters is None:
            return {}
        if isinstance(rows, np.ndarray):
            rows = self._upload(rows)
        return {"lora": self._adapters.pool, "adapter_rows": rows}

    def _refresh_table(self, tables: np.ndarray) -> None:
        """Copy the dispatch table into the static ``[B, Tp]`` buffer when it
        differs from the one the device holds."""
        if np.array_equal(tables, self._table_uploaded):
            return
        self._table_dev.copy_(self._upload(tables), non_blocking=True)
        self._table_uploaded = tables.copy()

    def _chunk_kv_bound(self, kind: str) -> Optional[int]:
        """The dense reference path's readable columns for a chunk (None on
        the paged layout)."""
        if self._paged:
            return None
        steps = self.spec_tokens + 1 if kind == "verify" else self.decode_chunk
        return self._decode_kv_bound(steps)

    def _run_chunk(self, branch: tuple[bool, bool], kind: Optional[str] = None,
                   kv_bound: Optional[int] = None) -> None:
        """Run one decode chunk or one verify (``kind``; by default the
        engine's own: the verify with speculation, else the decode chunk):
        replay its captured graph and add the graph's launches to the
        kernel counts — or, on the CPU without a stand-in graph, call the
        chunk function (dense: with the exact bound, ``kv_bound`` when the
        caller computed it)."""
        own = "verify" if self._spec_enabled else "decode"
        kind = kind or own
        captured = (self._graphs if kind == own else self._decode_graphs).get(branch)
        if captured is None:
            if self.device.type == "cuda" or self._graph_factory is not None:
                raise RuntimeError(f"no captured {kind} graph: start() captures them")
            if kv_bound is None:
                kv_bound = self._chunk_kv_bound(kind)
            chunk = self._verify_chunk if kind == "verify" else self._decode_chunk
            chunk(*branch, kv_bound=kv_bound)
            return
        graph, delta = captured
        graph.replay()
        add_counts(delta)
        with self._stats_lock:
            self.graph_replays_total += 1
            self.graph_replays_by_kind[kind] += 1

    # -- public API ------------------------------------------------------------

    def submit(self, request: GenerationRequest) -> GenerationRequest:
        """Thread-safe enqueue, through the JAX engine's gates in its
        order: a draining engine sheds; a ``max_cost_tokens`` budget below
        1, or one the prompt leaves no generated token in, is a ValueError;
        brownout level 3 sheds low-priority requests and level 4 over-quota
        tenants; an over-quota tenant sheds while other tenants wait; a
        deadline that cannot survive the tenant's observed queue wait
        sheds. Then a full queue blocks (``shed_policy`` "block") or sheds
        ("reject"), and a tenant whose queue share is full sheds either
        way. Every shed counts against its tenant, with a retry-after
        estimate from the tenant's own wait."""
        if self._dead is not None:
            raise RuntimeError("serving engine is stopped") from self._dead
        # stamped on every submit attempt: a retry after ShedError reuses
        # the request, and its sleep is not queue wait
        request.submitted_at = time.monotonic()
        tenant = _tenant(request)
        self._tenants.note_submit(tenant)
        if self._draining:
            self._count_shed(tenant)
            raise ShedError("serving engine is draining", retry_after_s=5.0)
        n = len(request.prompt_tokens)
        limit = self.max_seq_len - 1
        if n > limit:
            raise ValueError(
                f"prompt of {n} tokens exceeds the engine limit of {limit} (max_seq_len - 1)"
            )
        opts = request.options
        budget = opts.max_cost_tokens
        if budget is not None:
            if int(budget) <= 0:
                raise ValueError(f"max_cost_tokens must be >= 1, got {budget}")
            if n + 1 > int(budget):
                # a client error, not a capacity problem: never a shed
                raise ValueError(
                    f"prompt of {n} tokens leaves no generation room in a "
                    f"max_cost_tokens budget of {budget}"
                )
        bo = self._brownout
        if bo is not None and bo.reject_low and opts.priority == "low":
            self._count_shed(tenant)
            raise ShedError(
                f"brownout level {bo.level}: low-priority admissions are shed until load clears",
                retry_after_s=max(self._tenant_wait_estimate(tenant), 0.5),
            )
        over_quota = self._tenants.over_quota(tenant)
        if bo is not None and bo.reject_quota and over_quota:
            self._count_shed(tenant)
            raise ShedError(
                f"brownout level {bo.level}: tenant {tenant!r} is over its token-rate quota",
                retry_after_s=max(self._tenants.quota_retry_after_s(tenant), 0.5),
            )
        # outside brownout, an over-quota tenant yields to the others under
        # queue pressure; with nobody else waiting its work still runs
        if over_quota and self._queue.qsize() > 0:
            if any(t != tenant for t in self._queue.tenants_with_work()):
                self._count_shed(tenant)
                raise ShedError(
                    f"tenant {tenant!r} is over its token-rate quota while other tenants wait",
                    retry_after_s=max(self._tenants.quota_retry_after_s(tenant), 0.1),
                )
        if opts.adapter and self._adapters is None:
            raise ValueError(
                f"request names adapter {opts.adapter!r} but this engine has no adapter "
                "registry (configure `adapters`)"
            )
        if opts.response_format and self._constrain_reg is None:
            raise ValueError(
                "request carries response_format but constrained decoding is off on this "
                "engine (constrained-decoding: off, or grammar-slots 0)"
            )
        if opts.response_format and request._dfa is None:
            # compiled (or a cache hit) on the submitter's thread: an
            # unsupported schema fails here, loudly, never the engine loop
            request._dfa = self._constrain_reg.compile(dict(opts.response_format))
        resume = opts.grammar_resume_state
        if request._dfa is not None and resume is not None and request._dfa.is_complete(
            int(resume)
        ):
            # the derivation had already finished when its stream was cut:
            # nothing is left to generate
            request.dfa_state = int(resume)
            request._finish(GenerationResult(
                tokens=[], finish_reason="stop", prompt_tokens=n, ttft_s=0.0, total_s=0.0,
            ))
            return request
        deadline_s = opts.deadline_s
        if deadline_s is not None:
            # the tenant's own observed wait decides hopelessness: a victim
            # with an empty lane is not hopeless because an aggressor
            # inflated the global EMA
            est_wait = self._tenant_wait_estimate(tenant)
            if deadline_s <= 0 or (self._queue.qsize() > 0 and est_wait >= deadline_s):
                self._count_shed(tenant)
                raise ShedError(
                    f"deadline of {deadline_s:.2f}s cannot survive the current "
                    f"~{est_wait:.2f}s queue wait",
                    retry_after_s=max(est_wait, 0.1),
                )
        with self._waiting_lock:
            self._waiting[id(request)] = request
        try:
            try:
                if self.shed_policy == "reject":
                    self._queue.put_nowait(request)
                else:
                    self._queue.put(request)
            except queue.Full:
                self._count_shed(tenant)
                raise ShedError(
                    f"admission queue full ({self._queue.maxsize} deep)",
                    retry_after_s=max(self._tenant_wait_estimate(tenant), 0.1),
                ) from None
            except TenantShareExceeded as e:
                # the tenant's slice is full, whatever room the queue has:
                # a shed for that tenant, never backpressure for everyone
                self._count_shed(tenant)
                raise ShedError(
                    str(e), retry_after_s=max(self._tenant_wait_estimate(tenant), 0.1),
                ) from None
        except BaseException:
            with self._waiting_lock:
                self._waiting.pop(id(request), None)
            raise
        return request

    def _tenant_wait_estimate(self, tenant: str) -> float:
        """The queue-wait estimate of shed decisions and retry-after: a
        named tenant's own EMA when it has one, else the global EMA (the
        default tenant reads the global EMA)."""
        if tenant == DEFAULT_TENANT:
            return self._queue_wait_ema_s
        own = self._tenants.queue_wait_ema_s(tenant)
        return own if own > 0 else self._queue_wait_ema_s

    def generate(
        self,
        prompt_tokens: Optional[list[int]] = None,
        options: Optional[GenerationOptions] = None,
        on_token: Optional[Callable[[int], None]] = None,
        timeout: float = 300.0,
        request: Optional[GenerationRequest] = None,
    ) -> GenerationResult:
        """Blocking submit + wait; a wait timeout cancels the request, so
        the engine does not keep decoding an orphan nobody reads.
        ``request``: submit a request the caller built instead (the fleet's
        dispatch registers it for cancellation first); ``prompt_tokens``,
        ``options`` and ``on_token`` are ignored then."""
        if request is None and prompt_tokens is None:
            raise ValueError("generate() needs prompt_tokens or request")
        req = request if request is not None else GenerationRequest(
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

    def _count_shed(self, tenant: Optional[str] = None) -> None:
        """Count a shed (against its tenant when known); a burst of them
        within a second leaves a ``shed-burst`` flight dump."""
        with self._stats_lock:
            self.shed_total += 1
        if tenant is not None:
            self._tenants.note_shed(tenant)
        if self._obs.on and self._obs.flight.note_shed():
            self._flight_dump("shed-burst")

    def _flight_dump(
        self, reason: str, extra: Optional[dict] = None, force: bool = False
    ) -> Optional[dict]:
        """Snapshot the flight ring into a dump, with the lifecycle counters
        and the injector's recent firings; debounced per reason by the
        recorder. Callable from any thread (sheds run on submitters)."""
        if not self._obs.on:
            return None
        extra = dict(extra or {})
        if self._injector is not None:
            extra["injector-events"] = self._injector.events_snapshot()
        return self._obs.flight.dump(
            reason, counters=self._counters_snapshot(), extra=extra, force=force,
        )

    def _counters_snapshot(self) -> dict[str, Any]:
        with self._stats_lock:
            return {
                "shed": self.shed_total,
                "cancelled": self.cancelled_total,
                "deadline-queue": self.deadline_queue_total,
                "deadline-decode": self.deadline_decode_total,
                "quarantined-slots": self.quarantined_slots_total,
                "nan-guard": self.nan_guard_total,
                "engine-restarts": self.engine_restarts_total,
                "spmd-recoveries": self.spmd_recoveries_total,
                "spmd-resyncs": self.spmd_resyncs_total,
                "spmd-watchdog-trips": self.spmd_watchdog_trips_total,
                "total-requests": self.total_requests,
                "total-generated-tokens": self.total_generated,
                "queued": self._queue.qsize(),
                "active-slots": sum(1 for s in self._slots if s.active),
            }

    def reset_histograms(self) -> None:
        """Zero the streaming histograms (their buckets stay)."""
        self._obs.reset_histograms()

    def prefill_tps_estimate(self) -> float:
        """Landed prefill throughput (tokens/s): the prefill tokens of
        landed dispatches over the summed wall time of the prefill-dispatch
        histogram, as the JAX engine estimates it. The fleet beacon ships it
        for the router's fetch-vs-prefill cost model; 0.0 until a dispatch
        lands or with observability off (the router then falls back to its
        flat threshold)."""
        if not self._obs.on:
            return 0.0
        h = self._obs.hist.get("engine_prefill_dispatch_s")
        if h is None:
            return 0.0
        total_s = float(h.snapshot().get("sum", 0.0))
        if total_s <= 0.0:
            return 0.0
        with self._stats_lock:
            tokens = self.prefill_tokens_total
        return round(tokens / total_s, 1)

    def _achieved_hbm_gbps(self) -> float:
        """The bytes one decode step reads by the memory plan (the weights,
        and the pages covering each active slot's written prefix — paged —
        or the cache columns up to the last bound — dense) over the step
        time's EMA: the achieved-bandwidth gauge, as the JAX engine's."""
        step_s = self._step_time_ema_s
        if step_s <= 0:
            return 0.0
        weights = self.memory_plan.weights_bytes
        if self._paged:
            pages_read = sum(
                -(-(s.position + 1) // self.page_size) for s in self._slots if s.active
            )
            return round((weights + self._pagepool.bytes_per_page * pages_read) / step_s / 1e9, 2)
        cache = self.memory_plan.cache_bytes * self.max_seq_len // (self.max_seq_len + 1)
        return round((weights + cache) / step_s / 1e9, 2)

    def stats(self, dump: bool = False) -> dict[str, Any]:
        """One consistent snapshot of the counters (read under the lock
        their writers hold), plain values only. ``dump=True`` also
        snapshots the flight recorder (``flight-recorder``)."""
        pool, index, dense_pool = self._pagepool, self._prefix_index, self._prefix_pool
        reuse = dense_pool if dense_pool is not None else index
        # the histograms and the tenants take their own locks, never
        # nested with the stats lock
        hist = self._obs.histograms()
        active_by_tenant: dict[str, int] = {}
        for slot in self._slots:
            request = slot.request
            if request is not None:
                t = _tenant(request)
                active_by_tenant[t] = active_by_tenant.get(t, 0) + 1
        tenants = self._tenants.snapshot(
            queued=self._queue.depth_by_tenant(), active=active_by_tenant
        )
        adapters, reg = self._adapters, self._constrain_reg
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
                "ring-admissions-total": self.ring_admissions_total,
                "decode-chunks-total": self.decode_chunks_total,
                "decode-steps-total": self.decode_steps_total,
                "kv-layout": self.kv_layout,
                "long-prefill-active": bool(self._longs),
                "long-prefill-queued": len(self._long_queue) + (self._held_back is not None),
                "long-prefill-streams": len(self._longs),
                # decode steps and verifies dispatched (a verify is one step:
                # one read of the weights)
                "busy-steps": self.decode_steps_total + self.spec_dispatches_total,
                # the step-time EMA of landed chunks (dispatch to tokens on
                # the host, a captured replay on the card) and the plan's
                # bytes a step over it
                "decode-step-ms": round(self._step_time_ema_s * 1e3, 3),
                "hbm-gbps-decode": self._achieved_hbm_gbps(),
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
                # the SPMD wire's accounting (bytes a block are measured,
                # not estimated) and the slice-resilience ledger; zeros
                # without a channel
                "spmd": self._spmd is not None,
                "spmd-announces-total": getattr(self._spmd, "announces_total", 0),
                "spmd-announce-bytes-total": getattr(self._spmd, "bytes_announced_total", 0),
                "spmd-recovery-epoch": self._spmd_epoch,
                "spmd-recoveries-total": self.spmd_recoveries_total,
                "spmd-resyncs-total": self.spmd_resyncs_total,
                "spmd-watchdog-trips-total": self.spmd_watchdog_trips_total,
                "queue-wait-ema-s": round(self._queue_wait_ema_s, 4),
                "fault-injection": (
                    self._injector.stats() if self._injector is not None else None
                ),
                # the decode graphs: live captures (the counterpart of the
                # JAX engine's compiled programs), all captures so far
                # (restarts capture again), replays, capture wall time and
                # the shared pool's bytes
                "compiled_programs": len(self._graphs) + len(self._decode_graphs),
                "graph-sets": list(self._graph_kinds()),
                "graph-captures-total": self.graph_captures_total,
                "graph-replays-total": self.graph_replays_total,
                "graph-replays-by-kind": dict(self.graph_replays_by_kind),
                "graph-capture-s": self.graph_capture_s,
                "graph-capture-parts-s": dict(self.graph_capture_parts_s),
                "graph-pool-bytes": self.graph_pool_bytes,
                "prefill-token-budget": self.prefill_token_budget,
                "max-prefill-streams": self.MAX_PREFILL_STREAMS,
                # launches of each attention kernel in this process (CUDA,
                # replays included) and calls of its plain version (CPU)
                "kernels": kernel_counts(),
                # prefix KV reuse (the JAX engine's keys and meanings; zeros
                # with reuse off): a warm admission's prefill tokens count
                # only its suffix, the saved ones count here
                # (from the dense pool or the paged index, whichever is live)
                "prefix-cache": reuse is not None,
                "prefix-cache-hit-rate": reuse.hit_rate() if reuse else 0.0,
                "prefill-tokens-saved-total": reuse.tokens_saved if reuse else 0,
                "prefix-copy-bytes-saved-total": index.copy_bytes_saved if index else 0,
                "prefix-pool-bytes-in-use": (
                    dense_pool.bytes_in_use() if dense_pool
                    else index.pages_held * pool.bytes_per_page if index else 0
                ),
                "prefix-cache-evictions-total": reuse.evictions if reuse else 0,
                "prefix-cache-entries": reuse.live_entries if reuse else 0,
                "kv-page-alias-rate": (
                    round(pool.aliased_pages_total / max(1, pool.reserved_pages_total), 4)
                    if pool else 0.0
                ),
                "kv-bytes-per-page": pool.bytes_per_page if pool else 0,
                "warm-admissions-total": self.warm_admissions_total,
                # copy-on-write page copies (one per mid-page prefix hit)
                "page-copies-total": self.page_copies_total,
                # the host KV tier (the JAX engine's keys; zeros with it off)
                "host-tier": self._host_tier is not None,
                "host-pages-total": self._host_tier.num_pages if self._host_tier else 0,
                "host-pages-in-use": self._host_tier.slots_in_use if self._host_tier else 0,
                "host-tier-bytes-total": self._host_tier.bytes_total if self._host_tier else 0,
                "spill-pages-total": self.spill_pages_total,
                "spill-bytes-total": self.spill_bytes_total,
                "spill-failures-total": self.spill_failures_total,
                "restore-pages-total": self.restore_pages_total,
                "restore-bytes-total": self.restore_bytes_total,
                # the restore-vs-recompute split of hits on hibernated
                # entries: restored (an upload) or re-prefilled (a fault,
                # a checksum, no room) — the tier's health gauge
                "restored-hits-total": self.restored_hits_total,
                "restore-failures-total": self.restore_failures_total,
                "recompute-fallbacks-total": self.recompute_fallbacks_total,
                "restore-verify-s-total": self.restore_verify_s_total,
                "host-demotions-total": index.demotions if index else 0,
                "host-evictions-total": index.host_evictions if index else 0,
                # the durable session tier (zeros with it off)
                "durable-tier": self._durable is not None,
                "durable-restored-hits-total": self.durable_restored_hits_total,
                **(self._durable.stats() if self._durable is not None
                   else DurableStore.empty_stats()),
                # KV-page migration: pages and bytes sent out of this pool
                # (counted once the receiver's ACK released them) and bound
                # in from a peer's (or a durable checkpoint's)
                "migrate-pages-out-total": self.migrate_pages_out_total,
                "migrate-bytes-out-total": self.migrate_bytes_out_total,
                "migrate-pages-in-total": self.migrate_pages_in_total,
                "migrate-bytes-in-total": self.migrate_bytes_in_total,
                "migrate-failures-total": self.migrate_failures_total,
                # self-speculative decoding (the JAX engine's keys, rounding
                # and meanings; zeros with speculation off)
                "speculation": self._spec_enabled,
                "speculation-tokens": self.spec_tokens,
                "spec-acceptance-rate": (
                    round(self.spec_accepted_tokens_total / self.spec_draft_tokens_total, 4)
                    if self.spec_draft_tokens_total else 0.0
                ),
                "spec-accepted-tokens-per-step": (
                    round(self.spec_emitted_tokens_total / self.spec_slot_steps_total, 4)
                    if self.spec_slot_steps_total else 0.0
                ),
                "spec-draft-hit-rate": (
                    round(self.spec_draft_hits_total / self.spec_draft_lookups_total, 4)
                    if self.spec_draft_lookups_total else 0.0
                ),
                "spec-draft-tokens-total": self.spec_draft_tokens_total,
                "spec-accepted-tokens-total": self.spec_accepted_tokens_total,
                "spec-verify-dispatches-total": self.spec_dispatches_total,
                # the checkpoint load these params came from (the JAX
                # engine's keys; zeros for random weights)
                "weight-load-streamed": bool(self._weight_load_report.get("streamed", False)),
                "weight-load-s": float(self._weight_load_report.get("total-s", 0.0)),
                "weight-load-read-s": float(self._weight_load_report.get("read-s", 0.0)),
                "weight-load-transform-s": float(
                    self._weight_load_report.get("transform-s", 0.0)
                ),
                "weight-load-transfer-s": float(self._weight_load_report.get("transfer-s", 0.0)),
                "weight-load-bytes-total": int(self._weight_load_report.get("bytes-read", 0)),
                "weight-load-staging-peak-bytes": int(
                    self._weight_load_report.get("staging-peak-bytes", 0)
                ),
                "weight-load-shards": int(self._weight_load_report.get("shards", 0)),
                "weight-load-workers": int(self._weight_load_report.get("workers", 0)),
                # the agentic tier (the JAX engine's keys; zeros when off)
                "adapters": adapters is not None,
                "adapters-registered": adapters.stats()["registered"] if adapters else 0,
                "adapters-resident": adapters.resident if adapters else 0,
                "adapter-pool-rows": adapters.rows - 1 if adapters else 0,
                "adapter-swaps-total": adapters.swaps_total if adapters else 0,
                "adapter-pool-bytes": adapters.pool_bytes if adapters else 0,
                "constrained-decoding": reg is not None,
                "constrained-requests-total": self.constrained_requests_total,
                "grammars-resident": reg.resident if reg else 0,
                "grammar-swaps-total": reg.swaps_total if reg else 0,
                "grammar-pool-bytes": reg.pool_bytes if reg else 0,
                "constrain-overhead-ms": round(self._constrain_host_ema_ms, 4),
            }
        # the JAX engine's name for the page size (0 on the dense layout),
        # which the fleet beacon reads; ``kv-page-size`` is the port's
        out["page-size"] = self.page_size if pool is not None else 0
        if pool is not None:
            out.update({
                "kv-page-size": self.page_size,
                "kv-pages-total": pool.num_pages,
                "kv-pages-in-use": pool.pages_in_use,
                "kv-pages-free": pool.free_pages,
                "kv-pool-bytes": pool.bytes_total,
            })
        else:
            # the plan's term is the cache's bytes (a restart rebuilding
            # the cache leaves nothing to read meanwhile)
            out["kv-cache-bytes"] = self.memory_plan.cache_bytes
        # multi-tenant overload control and observability (the JAX
        # engine's keys)
        bo = self._brownout
        out["tenants"] = tenants
        with self._brownout_lock:  # a transition's level, dump and counters together
            out["brownout"] = bo.snapshot() if bo is not None else None
            out["brownout-level"] = bo.level if bo is not None else 0
            out["brownout-transitions-total"] = bo.transitions_total if bo is not None else 0
            out["flight-dumps-total"] = self._obs.flight.dumps_total
        out["observability"] = self._obs.on
        out["histograms"] = hist
        page_pressure = (
            pool.pages_in_use / max(1, pool.num_pages)
            if pool is not None
            else min(1.0, out["queued"] / max(1, self._queue.maxsize))
        )
        out["load-score"] = load_score(
            hist.get("engine_queue_wait_s", {}).get("p90", 0.0),
            out["active-slots"] / max(1, self.max_batch),
            page_pressure,
        )
        if dump:
            out["flight-recorder"] = self._flight_dump("on-demand", force=True)
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
                        # a PROVEN leader/follower divergence stays fatal:
                        # half the mesh must never serve alone
                        and not isinstance(e, wire.SpmdDivergenceError)
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
                        if self._spmd is not None:
                            self.spmd_recoveries_total += 1
                        if isinstance(e, EngineWedgedError):
                            # the leader-side watchdog caught a wedged
                            # iteration and escalated it here
                            self.spmd_watchdog_trips_total += 1
                    # dump before _recover clears state: the ring holds
                    # the iterations that led to the crash
                    self._flight_dump(
                        "engine-restart", extra={"error": type(e).__name__, "restart": restarts},
                    )
                    log.exception(
                        "serving engine loop crashed; quarantining %d in-flight slot(s), "
                        "restarting in %.2fs (restart %d/%d)",
                        sum(1 for s in self._slots if s.active) + len(self._longs),
                        backoff, restarts, self.max_restarts,
                    )
                    if self._spmd is not None:
                        # the epoch first (the rebuild re-seeds from it),
                        # then the coordinated announce: the followers
                        # start their identical rebuild, and the seq chain
                        # restarts at the epoch base on both sides
                        self._spmd_epoch += 1
                        try:
                            self._spmd.announce(wire.ControlBlock(
                                op=wire.OP_RECOVER, count=self._spmd_epoch,
                            ))
                            self._spmd.reset_seq()
                        except Exception:  # noqa: BLE001 — transport gone: the
                            # followers' watchdogs end them
                            log.exception("failed to announce OP_RECOVER to followers")
                        self._flight_dump("spmd-recover", extra={
                            "epoch": self._spmd_epoch, "error": type(e).__name__,
                            "restart": restarts,
                        })
                    try:
                        self._recover(e)
                    except BaseException as e2:  # noqa: BLE001 — recovery itself failed
                        log.exception("crash recovery failed; engine is dead")
                        self._fail_all(e2)
                        return
                    if self._backoff_wait(backoff):
                        return  # stop() raced the backoff; it fails the rest
                    backoff = min(backoff * 2, 30.0)
        finally:
            self._recovering = False
            if self._spmd is not None:
                # release the followers parked in recv(), on the crash path
                # too; STOP is ordered after every dispatch (one thread)
                try:
                    self._spmd.announce(wire.ControlBlock(op=wire.OP_STOP))
                except Exception:  # noqa: BLE001 — the transport may be gone too
                    log.exception("failed to announce STOP to SPMD followers")

    def _backoff_wait(self, backoff_s: float) -> bool:
        """The restart-backoff sleep, sliced so SPMD followers keep seeing
        idle heartbeats through it (their watchdog cannot tell a backoff
        wait from a dead leader otherwise). True when stop() raced it."""
        spmd = self._spmd
        if spmd is None or getattr(spmd, "watchdog_s", 0) <= 0:
            return self._stop.wait(backoff_s)
        slice_s = max(0.05, spmd.watchdog_s / 4)
        deadline = time.monotonic() + backoff_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            if self._stop.wait(min(slice_s, remaining)):
                return True
            self._spmd_heartbeat()

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
        for i, slot in enumerate(self._slots):
            request = slot.request
            if request is not None:
                finished.append((request, self._result(
                    request, slot.generated, "error", slot.first_token_at, error
                )))
                slot.request = None
                slot.generated = []
                slot.position = 0
                self._slot_clear_agentic(i)
        for idx in list(self._longs):
            st = self._longs.pop(idx)
            finished.append((st["request"], self._result(st["request"], [], "error", error=error)))
        with self._stats_lock:
            self.quarantined_slots_total += len(finished)
        for request, result in finished:
            request._finish(result)
        self._inflight_steps = 0
        self._rebuild_device_state()
        if isinstance(error, EngineWedgedError):
            # the fetch thread may still be parked in the hung copy that
            # tripped the watchdog: every later fetch would queue behind it
            log.warning("abandoning the wedged fetch thread")
            self._fetcher = _TokenFetcher(self._injector, self._obs)
        if not self._fetcher.alive():
            self._fetcher.start()

    def _rebuild_device_state(self) -> None:
        """Fresh device state after a crash: the graphs are dropped first
        (they hold raw pointers into the buffers below), the pool's pages
        and tables or the dense cache are remade from scratch (the old
        ones released before the new ones are allocated), the decode
        buffers too, and the graphs are captured again. The generator
        keeps its live state — under SPMD it is re-seeded from the seed
        plus the recovery epoch on every rank (the crashed dispatch may have
        drawn on one side only). Shared by the leader's ``_recover`` and a
        follower's ``OP_RECOVER`` (``_spmd_follower_recover``), whose
        graphs are captured as the leader's ``OP_WARMUP`` replays."""
        self._freed_slots.clear()
        self._long_caches.clear()
        self._spmd_ring_buf.clear()
        self._spmd_payload_buf.clear()
        self._spmd_admit_rows = None
        # the fresh row buffers are zeros: the leader announces its rows
        # again at the next dispatch, a follower starts from base rows
        self._spmd_rows_sent = None
        if self._spmd_follower:
            self._adapter_rows[:] = 0
            self._g_rows[:] = 0
        self._pending_row_resets.clear()
        self._pending_page_zero.clear()
        self._spec_index.clear()
        self._step_time_ema_s = 0.0
        self._last_chunk_ready_t = 0.0
        self._graphs = {}
        self._decode_graphs = {}
        if self._paged:
            self._reset_host_tier()
            self._pagepool.reset()
            if self._prefix_index is not None:
                self._prefix_index.reset()
        else:
            self._cache = None
            self._cache = make_kv_cache(
                self.config, self.max_batch, self.max_seq_len + 1, device=self.device
            )
            if self._prefix_pool is not None:
                # rows may hold prefixes published from the poisoned cache
                self._prefix_pool.reset()
        self._alloc_decode_state()
        if self._spmd is not None:
            self._generator.manual_seed(self._rng_seed + self._spmd_epoch)
        if self._spmd_follower:
            self._graphs, self._decode_graphs = {}, {}
            self._capture_pool = None
        else:
            self._capture_graphs()
        if self._spill_worker is not None:
            self._spill_worker.start()

    def _reset_host_tier(self) -> None:
        """The tier's half of a restart, before the pool and the index
        reset: stop the spill worker (in-flight copies finish first, so no
        thread writes a slot the fresh free list re-issues, and none runs
        during the capture that follows), fence stale handles off with the
        generation bump, then reset the arena — or, when the worker is
        wedged past its join timeout, abandon arena and worker for fresh
        ones (a late write into a reset arena would land in a re-issued
        slot with a valid checksum: wrong KV at a later restore)."""
        quiesced = self._spill_worker.stop() if self._spill_worker is not None else True
        self._spill_gen += 1
        self._spill_candidates.clear()
        self._spmd_spills.clear()
        while True:
            try:
                self._spill_done.get_nowait()
            except queue.Empty:
                break
        if self._host_tier is None:
            return
        if quiesced:
            self._host_tier.reset()
            return
        log.error(
            "spill worker failed to quiesce — abandoning the host arena (%.2f GiB) and "
            "allocating a fresh one", self._host_tier.bytes_total / 1024**3,
        )
        self._host_tier = HostPageTier(self._pagepool.dev, self._host_tier.num_pages)
        self._prefix_index.host_tier = self._host_tier
        self._spill_worker = _SpillWorker(self._host_tier, self._spill_done, self._obs)

    def _iterate(self, pending: deque) -> None:
        """One fused iteration: the quarantine's zeroing, the expiry sweep,
        the brownout tick and the ``tenant-burst`` site, then a
        token-budgeted slice of prefill work (chunked-prefill segments
        first, so a long prompt cannot starve under short traffic, then
        admissions), then the decode chunk or the verify — back-to-back on
        the in-order stream — then host processing of whatever batch of
        earlier dispatches has landed, and one flight-recorder frame."""
        obs_on = self._obs.on
        self._iterations_total += 1
        t0 = time.monotonic() if obs_on else 0.0
        # SPMD slice resilience: the spmd-crash drill site, the divergence
        # poll and the idle heartbeat, outside any dispatch's announces
        if self._spmd is not None:
            self._spmd_tick()
        if self._pending_row_resets:
            self._flush_row_resets()
        if self._pending_page_zero:
            self._flush_page_zeros()
        # the host tier: fold completed spills in and start hibernation
        # spills of idle prefixes (bounded per iteration, O(1) when idle);
        # its restore half runs inside admission (_paged_bind)
        self._spill_ms_iter = 0.0
        self._restore_ms_iter = 0.0
        if self._spill_on:
            self._spill_tick()
        self._drain_hibernations()
        # migration commands cross into the engine thread here: O(1) when
        # idle, and an idle loop turns every ~1 ms
        self._drain_migrations()
        self._sweep_waiting()
        if self._brownout is not None:
            self._brownout_tick()
        if self._injector is not None:
            self._tenant_burst_tick()
        t_sweep = time.monotonic() if obs_on else 0.0
        self._inflight_steps = sum(e[3] for batch in pending for e in batch if e[0] == "chunk")
        had_active = any(s.active for s in self._slots)
        self._mid_iteration = True
        try:
            new_pending, spent = self._long_step(self.prefill_token_budget)
            n_long_entries = len(new_pending)
            new_pending.extend(self._admit(max(0, self.prefill_token_budget - spent)))
        finally:
            self._mid_iteration = False
        # prefill dispatched this iteration runs ahead of the chunk on the
        # stream: that chunk's step time is not sampled
        prefill_ahead = bool(new_pending) or spent > 0
        t_prefill = time.monotonic() if obs_on else 0.0
        n_admitted = sum(len(e[2]) for e in new_pending if e[0] == "prefill")
        prefill_tokens = spent + sum(
            len(req.prompt_tokens)
            for e in new_pending[n_long_entries:] if e[0] == "prefill"
            for _, req in e[2]
        )
        if new_pending and not had_active:
            # cold start: nothing to overlap the first-token fetch with
            for entry in new_pending:
                self._process_entry(entry)
            new_pending = []
        spec_off = self._brownout is not None and self._brownout.spec_off
        disp_kind, disp_steps = "", 0
        if (
            self._spec_enabled
            and not spec_off
            and (new_pending or pending or any(s.active for s in self._slots))
        ):
            # a verify's drafts continue from the last accepted token, which
            # only the fetches in flight know: drain them all first (the
            # pipelining speculation gives up for its k + 1 tokens a read)
            while pending:
                for entry in pending.popleft():
                    self._process_entry(entry)
            for entry in new_pending:
                self._process_entry(entry)
            new_pending = []
            if any(s.active for s in self._slots):
                verify = self._dispatch_verify(clean=not prefill_ahead)
                if verify is not None:
                    new_pending.append(verify)
                    disp_kind, disp_steps = "verify", self.spec_tokens + 1
        elif any(s.active for s in self._slots):
            if self._spec_enabled:
                # brownout level 2: decode chunks instead of verifies, once
                # the verifies in flight have delivered
                while any(e[0] == "verify" for batch in pending for e in batch):
                    for entry in pending.popleft():
                        self._process_entry(entry)
            if any(s.active for s in self._slots):
                chunk = self._dispatch_chunk(
                    clean=not prefill_ahead, pipelined=self._inflight_steps > 0
                )
                if chunk is not None:
                    new_pending.append(chunk)
                    disp_kind, disp_steps = "decode", chunk[3]
        elif not new_pending and not pending and not spent:
            time.sleep(0.001)
        t_dispatch = time.monotonic() if obs_on else 0.0
        pending.append(new_pending)
        # depth-1 pipeline: at most one dispatched batch waits unprocessed
        while pending and (
            len(pending) > 1
            or not new_pending
            or all(e[1].ready() for e in pending[0])
        ):
            for entry in pending.popleft():
                self._process_entry(entry)
        if obs_on and (disp_kind or n_admitted or spent or had_active):
            # one frame a working iteration (idle ones are skipped, so the
            # ring holds the work leading up to an incident); host only
            t_end = time.monotonic()
            self._obs.flight.record({
                "i": self._iterations_total,
                "t": round(time.time(), 3),
                "active": sum(1 for s in self._slots if s.active),
                "queued": self._queue.qsize(),
                "longs": len(self._longs),
                "admitted": n_admitted,
                "prefill_tokens": prefill_tokens,
                "dispatch": disp_kind,
                "steps": disp_steps,
                "kv_pages": self._pagepool.pages_in_use if self._pagepool else 0,
                # arena slots holding hibernated prefix pages (0, tier off)
                "host_pages": self._host_tier.slots_in_use if self._host_tier else 0,
                # distinct captured graphs (the JAX engine's compiled programs)
                "programs": len(self._graphs) + len(self._decode_graphs),
                "tenants": self._active_by_tenant(),
                "brownout": self._brownout.level if self._brownout is not None else 0,
                "injector": dict(self._injector.fired) if self._injector is not None else {},
                "phase_ms": {
                    "sweep": round((t_sweep - t0) * 1e3, 3),
                    "prefill": round((t_prefill - t_sweep) * 1e3, 3),
                    "dispatch": round((t_dispatch - t_prefill) * 1e3, 3),
                    "process": round((t_end - t_dispatch) * 1e3, 3),
                    "spill": round(self._spill_ms_iter, 3),
                    "restore": round(self._restore_ms_iter, 3),
                },
            })

    def _active_by_tenant(self) -> dict[str, int]:
        """Active slots by tenant (engine thread)."""
        out: dict[str, int] = {}
        for slot in self._slots:
            if slot.request is not None:
                t = _tenant(slot.request)
                out[t] = out.get(t, 0) + 1
        return out

    def _current_load_score(self) -> float:
        """The brownout controller's input: the load score over current
        signals — the queue-wait EMA while a backlog exists (0 once the
        queue empties, so the ladder can unwind), slot occupancy and
        page-pool pressure."""
        backlog_wait = self._queue_wait_ema_s if self._queue.qsize() > 0 else 0.0
        pool = self._pagepool
        page_pressure = (
            pool.pages_in_use / max(1, pool.num_pages)
            if pool is not None
            else min(1.0, self._queue.qsize() / max(1, self._queue.maxsize))
        )
        occupancy = sum(1 for s in self._slots if s.active) / max(1, self.max_batch)
        return load_score(backlog_wait, occupancy, page_pressure)

    def _brownout_tick(self) -> None:
        """Advance the brownout ladder off the current load score, at most
        every 50 ms. A transition either way is counted, logged and dumped
        (reason ``brownout``)."""
        now = time.monotonic()
        if now - self._brownout_checked_at < 0.05:
            return
        self._brownout_checked_at = now
        load = self._current_load_score()
        # the new level, its dump and its counters become visible to
        # stats() together (it reads them under the same lock)
        with self._brownout_lock:
            transition = self._brownout.observe(load, now)
            if transition is None:
                return
            old, new = transition
            snap = self._brownout.snapshot()
            log.warning("brownout %s: level %d -> %d (step %s, load %.3f)",
                        "escalated" if new > old else "released", old, new, snap["step"],
                        snap["last-load"])
            dumped = self._flight_dump("brownout", extra={
                "brownout-from": old,
                "brownout-to": new,
                "brownout-step": snap["step"],
                "load-score": snap["last-load"],
            })
            if dumped is not None:
                with self._stats_lock:
                    self.brownout_dumps_total += 1

    BURST_TENANT = "chaos-burst"

    def _tenant_burst_tick(self) -> None:
        """The ``tenant-burst`` fault site: when it fires, enqueue
        ``max_batch`` synthetic low-priority admissions under the
        "chaos-burst" tenant, without blocking (the engine thread never
        parks on its own queue): a full queue or queue share sheds them,
        counted against that tenant."""
        if not self._injector.fires("tenant-burst"):
            return
        for j in range(self.max_batch):
            request = GenerationRequest(
                prompt_tokens=[3 + (j % 5), 5, 7, 11, 13, 17, 19, 23],
                options=GenerationOptions(
                    max_new_tokens=16, tenant=self.BURST_TENANT, priority="low"
                ),
            )
            self._tenants.note_submit(self.BURST_TENANT)
            if self._draining:
                self._count_shed(self.BURST_TENANT)
                continue
            with self._waiting_lock:
                self._waiting[id(request)] = request
            try:
                self._queue.put_nowait(request)
            except (queue.Full, TenantShareExceeded):
                with self._waiting_lock:
                    self._waiting.pop(id(request), None)
                self._count_shed(self.BURST_TENANT)

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
            self._tenants.note_cancelled(_tenant(request))
            request._finish(GenerationResult(
                tokens=[], finish_reason="cancelled",
                prompt_tokens=len(request.prompt_tokens), ttft_s=0, total_s=wait,
            ))
            self._emit_queued_death_spans(request, "cancelled", now)
            return True
        if self._expired(request, now):
            opts = request.options
            with self._stats_lock:
                self.deadline_queue_total += 1
            self._tenants.note_deadline(_tenant(request))
            request._finish(GenerationResult(
                tokens=[], finish_reason="deadline",
                prompt_tokens=len(request.prompt_tokens), ttft_s=0, total_s=wait,
                error=DeadlineExceededError(
                    f"request waited {wait:.2f}s in queue against deadline={opts.deadline_s} "
                    f"max-queue-wait={opts.max_queue_wait_s}"
                ),
            ))
            self._emit_queued_death_spans(request, "deadline", now)
            return True
        return False

    def _emit_queued_death_spans(self, request: GenerationRequest, reason: str,
                                 now: float) -> None:
        """The span tree of a request that died before admission: the root
        and its ``engine.queued`` child only."""
        if not self._obs.on:
            return
        emit_request_spans(
            request.trace_id,
            {"submitted": request.submitted_at, "finished": now},
            {"slot": -1, "path": "queued", "prompt_len": len(request.prompt_tokens),
             "generated_tokens": 0, "finish_reason": reason},
            status="ok" if reason == "cancelled" else f"error: {reason}",
        )

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
        self._tenants.note_queue_wait(_tenant(request), wait)
        if self._obs.on:
            self._obs.record("engine_queue_wait_s", wait)
        return True

    def _flush_row_resets(self) -> None:
        """Zero the big-cache rows of NaN-quarantined slots (dense), so a
        poisoned row never reaches a later request of that slot."""
        stale = sorted(set(self._pending_row_resets))
        self._pending_row_resets.clear()
        if self._spmd is not None:
            self._spmd.announce(wire.ControlBlock(
                op=wire.OP_ROW_RESET, n_rows=len(stale), slots=np.asarray(stale, np.int32),
            ))
        self._dev_row_reset(stale)

    def _dev_row_reset(self, stale) -> None:
        for leaf in pool_leaves(self._cache):
            for idx in stale:
                leaf[:, idx].zero_()

    def _flush_page_zeros(self) -> None:
        """Zero the physical pages a quarantine freed, at the top of the
        iteration: on the in-order stream this lands after the chunks that
        still held them and before any admission that reuses them. Under
        SPMD each table-wide batch of pages rides the wire
        (``OP_PAGE_ZERO``)."""
        freed = sorted(set(self._pending_page_zero))
        self._pending_page_zero = []
        width = self._pagepool.table_len
        for i in range(0, len(freed), width):
            chunk = freed[i : i + width]
            if self._spmd is not None:
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_PAGE_ZERO, count=len(chunk), pages=np.asarray(chunk, np.int32),
                ))
            self._dev_page_zero(chunk)

    def _dev_page_zero(self, freed) -> None:
        # a freed page may still be read by a spill copy in flight (an
        # entry demoted on it while a slot aliased it): zero it after
        self._pagepool.wait_fences(freed)
        pages = self._upload(np.asarray(freed, np.int64))
        for leaf in pool_leaves(self._pagepool.dev):
            leaf.index_fill_(1, pages, 0)

    def _free_slot_pages(self, idx: int) -> list[int]:
        """Free slot ``idx``'s pages (``PagePool.free_slot``); under SPMD the
        table clear rides the wire (``OP_PAGE_FREE``) when it had pages."""
        if self._spmd is not None and self._pagepool.slot_pages(idx):
            self._spmd.announce(wire.ControlBlock(op=wire.OP_PAGE_FREE, long_idx=idx))
        return self._pagepool.free_slot(idx)

    # -- the host KV tier: spill, demotion, restore -----------------------------

    def _drain_spills(self) -> None:
        """Fold completed spills in (engine thread, iteration top): attach
        the arena slots to their entry — or free them when the entry died
        mid-copy, the copy failed, or the handle predates a restart (a
        stale generation: the arena was reset, its free list owns them)."""
        tier = self._host_tier
        if tier is None:
            return
        while True:
            try:
                handle = self._spill_done.get_nowait()
            except queue.Empty:
                return
            if handle.gen != self._spill_gen:
                continue
            entry = handle.entry
            if handle.cancelled or entry.dropped:
                tier.free(handle.slots)
                continue
            entry.spilling = None
            if handle.error is not None:
                log.warning("page spill failed: %s", handle.error)
                tier.free(handle.slots)
                self.spill_failures_total += 1
                if not entry.pages:
                    # demoted on the strength of this spill: with the copy
                    # failed it holds neither device nor host pages — a
                    # zombie a later hit would "restore" with zero pages
                    self._prefix_index._drop(self._pagepool, entry)
                continue
            entry.host = tuple(handle.slots)
            self._prefix_index._note_tier(entry)
            self.spill_pages_total += len(handle.slots)
            self.spill_bytes_total += len(handle.slots) * tier.bytes_per_page
            # the durable tier: a completed spill is the checkpoint trigger
            # (the arena bytes and their stamps are final now)
            self._maybe_checkpoint(entry)

    def _spill_copy(self, pages, slots) -> Optional[Any]:
        """Queue the copies of ``pages`` into arena ``slots``
        (``_page_copies``). The ordering also protects the arena: a slot a
        restore uploads from is rewritten only by a later spill, whose
        copies wait for this stream's work, the upload included."""
        return self._page_copies(pages, [self._host_tier.blocks(s) for s in slots])

    def _page_copies(self, pages, outs: list) -> Optional[Any]:
        """Queue the copies of ``pages`` into the host blocks ``outs`` (one
        list of leaf blocks a page, pinned on the card). On the card they
        run on the spill stream after the engine stream's work so far (an
        event recorded now), one 2-D DMA a page leaf straight from the pool
        pages — no device snapshot, no device temporaries — and every page
        carries the copies' completion event as its fence, so a page freed
        while its copy runs is not written before the copy read it (every
        writer of a freed page — the allocator, a quarantine's zeroing —
        makes the engine stream wait on the event first). Returns the
        completion event (None on the CPU, where the copies ran)."""
        pool = self._pagepool
        if self.device.type != "cuda":
            for page, out in zip(pages, outs):
                page_read(pool.dev, page, out)
            return None
        ready = torch.cuda.Event()
        ready.record()
        stream = self._spill_stream
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for leaf in pool_leaves(pool.dev):
                # the pool's memory is not reused before this stream's
                # reads finished (a restart frees the pool)
                leaf.record_stream(stream)
            for page, out in zip(pages, outs):
                page_read(pool.dev, page, out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        pool.fence(pages, done)
        return done

    def _ensure_spilled(self, entry) -> bool:
        """Secure a host copy for ``entry`` (the demote-before-drop gate):
        True when one exists, is in flight, or was queued now. The engine
        thread only queues the copies (``_spill_copy``) and keeps the books:
        the entry's device pages may be freed the moment this returns; the
        wait and the checksums run on the spill worker."""
        if not self._spill_on or self._spill_worker is None:
            return False
        if entry.host or entry.spilling is not None:
            return True
        if not entry.pages or entry.dropped:
            return False
        tier = self._host_tier
        slots = tier.alloc(len(entry.pages))
        if slots is None:
            self._evict_host_for(len(entry.pages), keep=entry)
            slots = tier.alloc(len(entry.pages))
            if slots is None:
                return False
        if self._spmd is not None:
            # every rank copies its shard of the same pages into the same
            # arena slots of its own arena
            self._spmd.announce_payload(wire.ControlBlock(
                op=wire.OP_HOST_SPILL, n_rows=len(slots),
            ), np.concatenate([np.asarray(entry.pages, np.int32), np.asarray(slots, np.int32)]))
        handle = _Spill(entry, slots, self._spill_copy(entry.pages, slots), self._spill_gen)
        entry.spilling = handle
        self._spill_worker.submit(handle)
        return True

    def _evict_host_for(self, need: int, keep=None) -> None:
        """Make arena room: free host copies LRU-first (a ``both`` victim
        loses its spare; a ``host``-only victim is checkpointed to the
        durable tier when it is on, then dropped). Never touches ``keep``
        (the entry the room is for) or pinned entries."""
        index, tier = self._prefix_index, self._host_tier
        while tier.free_slots < need:
            victims = [e for e in index._live if e.host and e.pins == 0 and e is not keep]
            if not victims:
                return
            victim = min(victims, key=lambda e: e.last_used)
            if victim.pages:
                tier.free(victim.host)
                victim.host = ()
                index._note_tier(victim)
                # device-only again: a spill candidate once the arena has
                # room (duplicates in the deque are skipped by the sweep)
                self._spill_candidates.append(victim)
            else:
                # the job holds its own byte copies, so the drop below
                # cannot race the disk write
                self._maybe_checkpoint(victim)
                index._drop(self._pagepool, victim)
            index.host_evictions += 1

    def _spill_tick(self) -> None:
        """The hibernation sweep, once an iteration: drain completed spills,
        then start at most 2 spills of entries idle past ``spill_idle_s``.
        The deque is publish-ordered, not idle-ordered (a hit refreshes
        ``last_used_t``): a candidate not idle yet rotates to the back, and
        the scan is bounded to 8 hops a tick. O(1) when there is nothing to
        do."""
        if not self._spill_on:
            return
        t0 = time.monotonic()
        self._drain_spills()
        started = 0
        now = time.monotonic()
        scanned, limit = 0, min(len(self._spill_candidates), 8)
        while self._spill_candidates and started < 2 and scanned < limit:
            scanned += 1
            entry = self._spill_candidates.popleft()
            if entry.dropped or entry.host or entry.spilling is not None:
                continue
            if now - entry.last_used_t < self.spill_idle_s:
                self._spill_candidates.append(entry)  # not idle: revisit
                continue
            if self._ensure_spilled(entry):
                started += 1
            else:
                # arena full and nothing evictable this tick: keep the
                # candidate (a live session's prefix never re-publishes)
                # and stop — every further one meets the same full arena
                self._spill_candidates.append(entry)
                break
        self._spill_ms_iter += (time.monotonic() - t0) * 1e3

    def _restore_entry(self, entry, p: int, count_failures: bool = True) -> bool:
        """Restore a hibernated entry for an admission: allocate device
        pages, verify every arena slot against its spill-time checksum
        (``HostPageTier.read``) and upload it into its page in place on the
        engine stream (``page_write``), then re-attach the pages. False —
        the entry intact (no device room: the caller falls back) or dropped
        (checksum mismatch, the ``spill`` fault, a spill that never
        completed: poison is not retried) — when the restore cannot serve
        the hit. Synchronous on the engine thread: the admission needs the
        pages before its suffix prefill. ``count_failures=False`` keeps a
        deferred request's retries off the failure gauge."""
        pool, index, tier = self._pagepool, self._prefix_index, self._host_tier
        if entry.dropped:
            return False
        fail = 1 if count_failures else 0
        t0 = time.monotonic()
        handle = entry.spilling
        if handle is not None:
            # the hit raced the copy: wait, bounded by the stall threshold
            # (this wait blocks every active session's decode); on expiry
            # fall back without dropping — the copy is healthy, only queued
            if not handle.event.wait(self._restore_stall_s):
                self.restore_failures_total += fail
                self._flight_dump("spill-stall", extra={
                    "restore-wait-ms": round((time.monotonic() - t0) * 1e3, 3),
                    "reuse-tokens": p,
                })
                return False
            self._drain_spills()
            if not entry.host or entry.dropped:
                self.restore_failures_total += fail
                if not entry.dropped:
                    index._drop(pool, entry)
                return False
        n = len(entry.host)
        if n == 0:
            # neither device nor host pages: nothing to serve
            self.restore_failures_total += fail
            index._drop(pool, entry)
            return False
        # pinned across the eviction below: its spill_cb can cascade into
        # _evict_host_for, whose LRU scan would otherwise pick this entry
        index.acquire(entry)
        try:
            if pool.free_pages < n:
                index.evict_for(pool, n, spill_cb=self._ensure_spilled)
            pages = pool.alloc_pages(n)
        finally:
            index.release(entry)
        if pages is None:
            # no device room even after demotions: the entry stays
            # hibernated and the admission recomputes (or defers)
            self.restore_failures_total += fail
            return False
        if entry.dropped or len(entry.host) != n:
            pool.decref(pages)
            self.restore_failures_total += fail
            if not entry.dropped:
                index._drop(pool, entry)
            return False
        if self._spmd is not None:
            # every rank verifies its own shard of the same slots and uploads
            # it into the same pages; the ``spmd-restore`` drill rots one
            # follower slot before its verify
            drill = self._injector is not None and self._injector.fires("spmd-restore")
            self._spmd.announce_payload(wire.ControlBlock(
                op=wire.OP_HOST_RESTORE, n_rows=n, width=int(drill),
            ), np.concatenate([np.asarray(pages, np.int32), np.asarray(entry.host, np.int32)]))
        if self._injector is not None:
            self._injector.corrupt_host_page(tier, entry.host)
        # every slot verified against its stamp before any page is uploaded
        t_v = time.monotonic()
        slot_blocks = tier.read_slots(entry.host)  # None: a stamp does not match
        if self._spmd is not None and not self._spmd.agree(slot_blocks is not None):
            # one rank's shard failed its stamp: every rank takes the same
            # branch, the fallback (a bad page is a recompute, not a crash)
            slot_blocks = None
        self.restore_verify_s_total += time.monotonic() - t_v
        if slot_blocks is None:
            pool.decref(pages)
            index._drop(pool, entry)  # frees the arena slots too
            self.restore_failures_total += fail
            log.warning("host-tier restore failed checksum (%d pages) — re-prefilling", n)
            return False
        self._restore_pages(pages, slot_blocks)
        index.attach_device_pages(pool, entry, pages)
        self.restore_pages_total += n
        self.restore_bytes_total += n * tier.bytes_per_page
        took = time.monotonic() - t0
        self.restore_s_total += took
        self._restore_ms_iter += took * 1e3
        if self._obs.on:
            self._obs.record("engine_restore_s", took)
        if took > self._restore_stall_s:
            self._flight_dump("spill-stall", extra={
                "restore-ms": round(took * 1e3, 3),
                "restore-pages": n,
                "reuse-tokens": p,
            })
        return True

    # -- the durable session tier ------------------------------------------------

    def _durable_job(self, entry) -> Optional[dict]:
        """One entry's checkpoint job (engine thread): page byte images and
        their SPILL-TIME checksums. A host-resident entry ships the arena's
        bytes and stored stamps as they are; a device-only entry (the
        hibernation path) reads its pages to the host and stamps them here
        — for a page that never spilled, this first hash is its spill-time
        stamp. None when the entry holds nothing checkpointable (a spill in
        flight, arena rot, no token path): the caller skips it."""
        tier, pool, index = self._host_tier, self._pagepool, self._prefix_index
        if entry.dropped or not entry.digest or entry.length <= 0:
            return None
        tokens = index.entry_tokens(entry)
        if len(tokens) != entry.length:
            return None
        n = math.ceil(entry.length / self.page_size)
        pages_raw: list[bytes] = []
        sums: list[str] = []
        if entry.host and entry.spilling is None and tier is not None and len(entry.host) >= n:
            if tier.read_slots(entry.host[:n]) is None:
                return None  # arena rot: the restore paths count it
            for slot in entry.host[:n]:
                pages_raw.append(tier.page_bytes(slot))
                sums.append(tier.checksum(slot).hex())
        elif entry.pages and len(entry.pages) >= n:
            blocks = []
            for pg in entry.pages[:n]:
                out = [torch.empty((leaf.shape[0],) + tuple(leaf.shape[2:]), dtype=leaf.dtype)
                       for leaf in pool_leaves(pool.dev)]
                page_read(pool.dev, pg, out)  # DMA on the card, synchronous
                blocks.append(out)
            pages_raw = [join_page_bytes(b) for b in blocks]
            sums = [d.hex() for d in page_checksums(blocks)]
        else:
            return None
        return {
            "digest": entry.digest, "length": int(entry.length), "tokens": tokens,
            "pages_raw": pages_raw, "checksums": sums, "page_size": self.page_size,
            "bytes_per_page": pool.bytes_per_page,
        }

    def _maybe_checkpoint(self, entry) -> None:
        """Queue a durable checkpoint of ``entry`` when the tier is on and
        none exists yet (the disk write runs on the durable worker).
        Anything not checkpointable is skipped; a later trigger retries."""
        if self._durable is None or self._durable_worker is None:
            return
        if self._durable.contains(entry.digest):
            return
        job = self._durable_job(entry)
        if job is not None:
            self._durable_worker.submit(job)

    def _durable_admit(self, request: GenerationRequest, prompt: list[int]) -> Optional[tuple]:
        """Resurrection on the admission path: no live candidate covered
        the prompt, so look for a checkpoint at the deepest boundary,
        restore and verify it (every page against the manifest's spill-time
        stamp) and bind it inline (``_bind_prefix``). Returns ``(length,
        entry)`` as a radix hit, or None — the request prefills cold. Every
        failure (torn file, CRC or checksum mismatch, stale manifest,
        stalled volume) dumps ``durable-restore-failed`` (token-content-free)
        and leaves the entry dead, so it fires once; a refused bind (a full
        pool) is the one retryable failure."""
        store, index = self._durable, self._prefix_index
        if store is None or request._durable_failed:
            return None
        digest, length = None, 0
        for b in reversed(index.boundaries):
            if b <= len(prompt) - 1:
                d = prefix_digest(prompt[:b])
                if store.contains(d):
                    digest, length = d, b
                    break
        if digest is None:
            return None
        t0 = time.monotonic()
        self._durable_restoring = True
        try:
            rec = store.restore(digest, timeout_s=self.durable_timeout_s)
            specs = page_leaf_specs(self._pagepool.dev)
            blocks = [split_page_bytes(raw, specs) for raw in rec["pages"]]
            for i, got in enumerate(page_checksums(blocks)):
                if got.hex() != rec["checksums"][i]:
                    # the manifest's stamp is the authority: poison is dead
                    store.invalidate(digest, f"page {i} failed its spill-time checksum")
                    raise DurableError(f"page {i} failed its spill-time checksum")
            # the bind core inline: a migration RPC from the engine thread
            # would wait on the queue this thread serves
            self._bind_prefix(list(prompt[:length]), length, blocks)
        except (DurableError, MigrationError, ValueError) as e:
            # a bind refused for room is the one retryable failure: a
            # later iteration may have room
            request._durable_failed = not isinstance(e, _PoolFull)
            self._flight_dump("durable-restore-failed", extra={
                "error": str(e),
                "entry-digest": digest,
                "reuse-tokens": length,
                "total-ms": round((time.monotonic() - t0) * 1e3, 3),
                "fallback": "local-cold-prefill",
            }, force=True)
            log.warning("durable restore of %s failed (%s); prefilling cold", digest, e)
            return None
        finally:
            self._durable_restoring = False
        took = time.monotonic() - t0
        if self._obs.on:
            self._obs.record("engine_durable_restore_s", took)
        self.durable_restored_hits_total += 1
        self._restore_ms_iter += took * 1e3
        for p_cand, cand in reversed(index.candidates(prompt)):
            if not cand.dropped and cand.pages:
                return p_cand, cand
        return None

    def _durable_snapshot(self, tokens) -> Optional[dict]:
        """A migration snapshot served from a durable checkpoint, for a
        prefix that outlived its index entry (engine thread, under
        ``_migrate_cmd``): the checkpoint's pages and spill-time stamps. None
        when no checkpoint covers ``tokens`` or its read fails (the
        caller's no-prefix error stands)."""
        store, index = self._durable, self._prefix_index
        if store is None:
            return None
        toks = list(tokens)
        for b in reversed(index.boundaries):
            if b > len(toks):
                continue
            digest = prefix_digest(toks[:b])
            if not store.contains(digest):
                continue
            try:
                rec = store.restore(digest, timeout_s=self.durable_timeout_s)
                specs = page_leaf_specs(self._pagepool.dev)
                blocks = [split_page_bytes(raw, specs) for raw in rec["pages"]]
            except (DurableError, ValueError) as e:
                log.warning("durable snapshot of %s failed (%s)", digest, e)
                return None
            return {
                "tier": "durable", "length": b, "digest": digest, "blocks": blocks,
                "checksums": [bytes.fromhex(c) for c in rec["checksums"]],
                "page_size": int(rec["page_size"]),
                "bytes_per_page": int(rec["bytes_per_page"]),
            }
        return None

    def _hibernate_now(self, replica_id: str) -> dict:
        """Checkpoint every live entry not checkpointed yet, synchronously,
        then write the replica's hibernation record (engine thread, or the
        caller's when the engine thread is not running)."""
        store, index = self._durable, self._prefix_index
        done, failures, total_bytes, digests = 0, 0, 0, []
        for entry in list(index._live):
            if entry.dropped or not entry.digest:
                continue
            if store.contains(entry.digest):
                digests.append(entry.digest)
                continue
            job = self._durable_job(entry)
            if job is None:
                failures += 1
                continue
            t0 = time.monotonic()
            try:
                total_bytes += store.checkpoint(
                    job["digest"], job["length"], job["tokens"], job["pages_raw"],
                    job["checksums"], job["page_size"], job["bytes_per_page"],
                )
            except (DurableError, OSError) as e:
                log.warning("hibernation checkpoint of %s failed: %s", entry.digest, e)
                failures += 1
                continue
            if self._obs.on:
                self._obs.record("engine_durable_checkpoint_s", time.monotonic() - t0)
            done += 1
            digests.append(entry.digest)
        try:
            store.write_hibernation(replica_id, digests)
        except OSError as e:
            log.warning("hibernation record write failed: %s", e)
            failures += 1
        return {"entries": done, "bytes": total_bytes, "failures": failures}

    def _drain_hibernations(self) -> None:
        """Serve queued ``hibernate()`` calls (iteration top): each replies
        on its own queue, an exception included — a failed hibernation
        never kills the loop."""
        while True:
            try:
                replica_id, reply = self._hibernations.get_nowait()
            except queue.Empty:
                return
            try:
                reply.put(("ok", self._hibernate_now(replica_id)))
            except Exception as e:  # noqa: BLE001 — degrade the hibernation only
                log.exception("hibernation failed")
                reply.put(("err", e))

    def hibernate(self, replica_id: str = "", timeout_s: float = 60.0) -> dict:
        """Checkpoint EVERY live prefix entry to the durable tier and write
        the replica's hibernation record — the drained replica's half of
        scale to zero. Call after ``drain()`` and before ``stop()``. Returns
        ``{"entries", "bytes", "failures"}`` (``{}`` with the tier off;
        failures -1 when the engine did not serve it in ``timeout_s``).
        Deadline-bounded: a wedged disk fails the hibernation, never the
        shutdown."""
        if self._durable is None:
            return {}
        if self._durable_worker is not None:
            # spill-triggered checkpoints first, so the walk skips them
            self._durable_worker.flush(timeout_s)
        thread = self._thread
        if thread is None or not thread.is_alive():
            return self._hibernate_now(str(replica_id))
        reply: "queue.SimpleQueue" = queue.SimpleQueue()
        self._hibernations.put((str(replica_id), reply))
        try:
            status, out = reply.get(timeout=max(0.05, float(timeout_s)))
        except queue.Empty:
            out, status = None, "err"
        if status == "err":
            log.warning("hibernation failed (%s) — sessions stay restorable from earlier "
                        "checkpoints only", out)
            return {"entries": 0, "bytes": 0, "failures": -1}
        return out

    @property
    def recovering(self) -> bool:
        """True inside the crash → rebuild → backoff window of a restart
        (one attribute read: cheap enough for a health probe)."""
        return self._recovering

    @property
    def restoring(self) -> bool:
        """True while a durable restore serves an admission."""
        return self._durable_restoring

    # -- KV-page migration ------------------------------------------------------

    def prefix_advertisement(
        self, top_k: int = 32,
    ) -> tuple[tuple[int, ...], list[tuple[str, int, str]]]:
        """The fleet beacon's affinity payload: the prefix index's boundaries
        and its ``top_k`` most recently used prefixes as ``(digest, length,
        tier)``, tier ``device`` | ``both`` | ``host`` — and, with the
        durable tier on, checkpoints that outlived their live entry at tier
        ``durable`` (a migration or a fetch reads them from disk). A probe
        from any thread: it touches neither LRU recency nor token content."""
        index = self._prefix_index if self._prefix_index is not None else self._prefix_pool
        if index is None:
            return (), []
        ads = index.advertised(top_k)
        if self._prefix_index is not None and self._durable is not None:
            live = {d for d, _, _ in ads}
            extra = top_k
            for digest, length in self._durable.entries():
                if extra <= 0:
                    break
                if digest in live:
                    continue
                ads.append((digest, length, "durable"))
                extra -= 1
        return tuple(index.boundaries), ads

    def _staging(self) -> _MigrateStaging:
        """The snapshot staging, built on first use: one slot's page table
        of host pages (the plan's ``migrate_staging_bytes``)."""
        if self._mig_stage is None:
            pages = math.ceil(self.max_seq_len / self.page_size)
            self._mig_stage = _MigrateStaging(self._pagepool.dev, pages)
            log.info("migration staging: %d host pages (%.2f GiB %s RAM)", pages,
                     self._mig_stage.arena.bytes_total / 1024**3,
                     "pinned" if self._mig_stage.arena.pinned else "host")
        return self._mig_stage

    def _drain_migrations(self) -> None:
        """Serve queued migration commands (engine thread, iteration top).
        Each replies on its own queue; a failing command replies with its
        error — a broken migration degrades ONE transfer, never the
        engine. A snapshot that finds the staging full waits for a later
        iteration, in order, until its caller gives up."""
        if self._mig_stage is not None:
            self._mig_stage.reclaim()
        cmds, self._migrate_waiting = self._migrate_waiting, deque()
        while True:
            try:
                cmds.append(self._migrate_cmds.get_nowait())
            except queue.Empty:
                break
        for cmd in cmds:
            kind, payload, reply = cmd
            ticket = payload.get("ticket")
            if ticket is not None and ticket.is_set():
                continue  # its caller gave up waiting
            if kind == "snapshot" and self._migrate_waiting:
                self._migrate_waiting.append(cmd)  # behind an older one
                continue
            try:
                reply.put(("ok", self._migrate_cmd(kind, payload)))
            except _StagingFull:
                self._migrate_waiting.append(cmd)
            except MigrationError as e:
                self.migrate_failures_total += 1
                reply.put(("err", e))
            except Exception as e:  # noqa: BLE001 — degrade the transfer only
                log.exception("migration command %s failed", kind)
                self.migrate_failures_total += 1
                reply.put(("err", MigrationError(f"{kind}: {e}")))

    def _migrate_cmd(self, kind: str, payload: dict) -> dict:
        """One migration command on the engine thread: ``snapshot`` (the
        deepest entry covering the tokens: a hibernated one's arena bytes
        and stored stamps, a device one's page copies queued behind the
        engine stream, else a durable checkpoint), ``bind`` (``_bind_prefix``)
        or ``release`` (drop the migrated-out entry once the receiver ACKed
        it, unless it is pinned or no longer the same entry)."""
        pool, index = self._pagepool, self._prefix_index
        if pool is None or index is None:
            raise MigrationError(
                "KV-page migration needs the paged layout with a prefix index "
                "(kv-layout: paged, prefix-cache: auto)"
            )
        if kind == "snapshot":
            tokens = list(payload["tokens"])
            hit = index.deepest_entry(tokens)
            if hit is None:
                durable = self._durable_snapshot(tokens)
                if durable is not None:
                    return durable
                raise MigrationError("no published prefix covers this prompt")
            length, entry = hit
            n = math.ceil(length / self.page_size)
            out = {
                "length": length, "digest": prefix_digest(tokens[:length]),
                "page_size": self.page_size, "bytes_per_page": pool.bytes_per_page,
            }
            tier = self._host_tier
            if entry.host and entry.spilling is None and tier is not None and len(entry.host) >= n:
                # a hibernated (or spilled) entry ships straight from the
                # arena with the stamps stored at spill time; the copies
                # leave the engine thread, whose next spill may reuse a slot
                slots = entry.host[:n]
                return dict(
                    out, tier="host",
                    blocks=[[b.clone() for b in tier.blocks(s)] for s in slots],
                    checksums=[tier.checksum(s) for s in slots],
                )
            if not entry.pages or len(entry.pages) < n:
                raise MigrationError(
                    "prefix entry holds no readable pages (a spill in flight and no "
                    "device half)"
                )
            stage = self._staging()
            slots = stage.take(n, payload["ticket"])
            blocks = [stage.arena.blocks(s) for s in slots]
            # the copies run off the engine thread's stream into staging
            # slots held until they landed and the caller let go; each
            # source page carries their completion event as its fence, so
            # an eviction that frees the entry mid-copy cannot hand a page
            # to a writer before its copy landed
            done = self._page_copies(entry.pages[:n], blocks)
            stage.fence(slots, done)
            return dict(out, tier="device", blocks=blocks, checksums=None, event=done)
        if kind == "bind":
            return self._bind_prefix(
                list(payload["tokens"]), int(payload["length"]), payload["blocks"]
            )
        if kind == "release":
            tokens, length = payload["tokens"], int(payload["length"])
            path = index._walk(tokens, limit=length)
            entry = path[-1].entry if path else None
            if entry is None or entry.length != length or entry.dropped or entry.pins > 0:
                # gone, replaced, or read by an admission in flight: retained
                # (refcounts keep its pages valid; LRU reclaims it)
                return {"released": False, "pages": 0}
            n = max(len(entry.pages), len(entry.host))
            index._drop(pool, entry)
            self.migrate_pages_out_total += n
            self.migrate_bytes_out_total += n * pool.bytes_per_page
            return {"released": True, "pages": n}
        raise MigrationError(f"unknown migration command {kind!r}")

    def _bind_prefix(self, tokens: list[int], length: int, blocks: list) -> dict:
        """The one bind core, of a migration and of a durable restore
        (engine thread): bind verified page blocks (``pool_leaves`` order,
        numpy or host tensors) as the prefix ``tokens[:length]``. Allocates
        pages (demoting LRU entries first), writes each block into its page
        IN PLACE (``page_write``: the pool is never rebound, the captured
        graphs hold its addresses), publishes the prefix. Idempotent: an
        already-resident prefix binds nothing (``already``). On any
        failure nothing stays bound — the receiver frees on abort — and
        MigrationError says why."""
        pool, index = self._pagepool, self._prefix_index
        if length not in index.boundaries:
            raise MigrationError(
                f"migrated length {length} is not a prefix boundary here (boundaries "
                f"{index.boundaries}) — sender and receiver disagree on buckets"
            )
        if index.has(tokens, length):
            return {"pages": 0, "bytes": 0, "already": True}
        n = math.ceil(length / self.page_size)
        if len(blocks) != n:
            raise MigrationError(
                f"migration carries {len(blocks)} pages for a {length}-token prefix; "
                f"expected {n}"
            )
        if pool.free_pages < n:
            index.evict_for(pool, n, spill_cb=self._ensure_spilled if self._spill_on else None)
        pages = pool.alloc_pages(n)
        if pages is None:
            raise _PoolFull(
                f"receiver pool exhausted ({pool.free_pages} free, {n} needed) — nothing "
                "was bound"
            )
        cuda = self.device.type == "cuda"
        dtypes = [leaf.dtype for leaf in pool_leaves(pool.dev)]
        t0 = time.perf_counter()
        try:
            for leaves, dst in zip(blocks, pages):
                # pageable blocks: the driver stages each upload before the
                # call returns, so they may go at once
                host = [host_block(np_view(b), dt) for b, dt in zip(leaves, dtypes)]
                page_write(pool.dev, dst, host, non_blocking=cuda)
            upload_ms = round((time.perf_counter() - t0) * 1e3, 3)
            entry = index.insert(pool, tokens, length, tuple(pages))
        finally:
            pool.decref(pages)  # the index holds the one reference, if any
        if entry is None:
            raise _PoolFull(
                "receiver prefix index is at capacity with every entry pinned — not bound"
            )
        if self._spill_on:
            self._spill_candidates.append(entry)  # hibernates like a published one
        self.migrate_pages_in_total += n
        self.migrate_bytes_in_total += n * pool.bytes_per_page
        return {"pages": n, "bytes": n * pool.bytes_per_page, "upload_ms": upload_ms}

    def _migrate_rpc(self, kind: str, payload: dict, timeout_s: float) -> dict:
        """The caller's half of a migration command: enqueue, wait at most
        ``timeout_s`` — a wedged engine fails the MIGRATION (the router
        falls back), it never parks the caller."""
        if self._dead is not None:
            raise MigrationError("engine is stopped") from self._dead
        if not self._paged:
            raise MigrationError("KV-page migration requires kv-layout: paged")
        if self._spmd is not None:
            # a bind's page writes are dispatches the SPMD wire does not carry
            raise MigrationError("KV-page migration is not on the SPMD wire")
        reply: "queue.SimpleQueue" = queue.SimpleQueue()
        self._migrate_cmds.put((kind, payload, reply))
        try:
            status, out = reply.get(timeout=max(0.05, float(timeout_s)))
        except queue.Empty:
            raise MigrationError(
                f"engine did not serve the {kind} command within {timeout_s:.1f}s"
            ) from None
        if status == "err":
            raise out
        return out

    def migrate_snapshot(self, tokens, timeout_s: float = 30.0) -> dict:
        """The deepest published prefix covering ``tokens``, for the
        migration frames (any thread): ``{"tier", "length", "digest",
        "blocks", "checksums", "page_size", "bytes_per_page", "copy_ms",
        "checksum_ms"}``, ``blocks`` one list of host leaf blocks a page.
        A device entry's pages are copied on the spill stream behind the
        engine stream's work and waited for HERE, then stamped here
        (``page_checksums``); a hibernated entry's arena copies carry their
        spill-time stamps, checked here. Raises MigrationError on any
        failure; nothing is freed (the sender retains until ACK). A device
        snapshot's pages are copied out of the staging here; its slots go
        back once this returns or raises AND the copies landed."""
        ticket = threading.Event()
        try:
            out = self._migrate_rpc(
                "snapshot", {"tokens": list(tokens), "ticket": ticket}, timeout_s
            )
            t0 = time.perf_counter()
            event = out.pop("event", None)
            if out["tier"] == "device":
                if event is not None:
                    event.synchronize()
                staged = out["blocks"]
                out["blocks"] = _host_pages(self._pagepool.dev, len(staged))
                for dst, src in zip(out["blocks"], staged):
                    for d, b in zip(dst, src):
                        d.copy_(b)
        finally:
            ticket.set()
        t1 = time.perf_counter()
        sums = page_checksums(out["blocks"])
        if out["checksums"] is None:
            out["checksums"] = sums
        elif sums != out["checksums"]:
            raise MigrationError(
                f"the {out['tier']} copy of the prefix failed its stored checksum"
            )
        out["copy_ms"] = round((t1 - t0) * 1e3, 3)
        out["checksum_ms"] = round((time.perf_counter() - t1) * 1e3, 3)
        return out

    def migrate_bind(self, tokens, length: int, blocks: list, timeout_s: float = 30.0) -> dict:
        """Bind already-VERIFIED migrated pages into this engine's pool and
        prefix index (any thread; ``serving/migrate.py`` owns the checks).
        On any failure nothing stays bound."""
        return self._migrate_rpc(
            "bind", {"tokens": list(tokens), "length": int(length), "blocks": blocks}, timeout_s
        )

    def migrate_release(self, tokens, length: int, timeout_s: float = 10.0) -> dict:
        """Drop the migrated-out prefix entry (sender side, ONLY after the
        receiver's ACK): pages still aliased by active slots survive by
        their refcounts; a pinned entry is retained for LRU."""
        return self._migrate_rpc(
            "release", {"tokens": list(tokens), "length": int(length)}, timeout_s
        )

    def migrate_limits(self) -> dict:
        """The pool's static geometry, which bounds what a migration
        receiver reads: ``{"bytes_per_page", "pages_total"}``, or ``{}``
        without a paged pool. Lock-free from any thread."""
        pool = self._pagepool
        if pool is None:
            return {}
        return {"bytes_per_page": int(pool.bytes_per_page), "pages_total": int(pool.num_pages)}

    # -- the SPMD plane: resilience and the follower's halves -----------------

    def _fetch_bound(self) -> Optional[float]:
        """The leader's per-fetch wait bound under SPMD (the channel's
        ``watchdog_s``; None: unbounded)."""
        wd = getattr(self._spmd, "watchdog_s", 0) if self._spmd is not None else 0
        return wd if wd > 0 else None

    def _spmd_tick(self) -> None:
        """SPMD resilience at the iteration top (leader, engine thread):
        fire the ``spmd-crash`` drill site (a raise here is a loop crash,
        driving the coordinated OP_RECOVER end to end), answer at most one
        pending divergence report (polled a few times a second), and keep
        the followers' watchdogs fed with idle heartbeats."""
        if self._injector is not None:
            self._injector.fire("spmd-crash")
        now = time.monotonic()
        wd = getattr(self._spmd, "watchdog_s", 0)
        if now - self._spmd_div_checked_at >= max(0.25, wd / 4):
            self._spmd_div_checked_at = now
            try:
                req = self._spmd.poll_divergence()
            except Exception:  # noqa: BLE001 — side channel gone is not a crash
                req = None
            if req is not None:
                self._spmd_resync(req)
        self._spmd_heartbeat()

    def _spmd_heartbeat(self) -> None:
        """Announce OP_IDLE when the wire has been quiet for a quarter of
        the watchdog bound, so silence past it means a dead leader, not an
        idle one. No-op with the watchdog off."""
        ch = self._spmd
        wd = getattr(ch, "watchdog_s", 0)
        if ch is None or wd <= 0:
            return
        if time.monotonic() - ch.last_announce_t >= max(0.05, wd / 4):
            try:
                ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
            except Exception:  # noqa: BLE001 — heartbeats are best-effort
                log.exception("SPMD idle heartbeat failed")

    def _spmd_resync(self, req: dict) -> None:
        """Answer a follower's divergence report with one OP_RESYNC: the
        authoritative per-slot page tables and device positions at a new
        epoch (and, in the block's mask, the slots active now), then the
        seq chain restarts at its base. The follower verifies its own
        against them and rejoins on a match; the leader only answers."""
        pool = self._pagepool
        b = self.max_batch
        tl = pool.table_len if pool is not None else 0
        parts = []
        if tl:
            parts.append(np.asarray(pool.tables[:b, :tl], np.int32).reshape(-1))
        parts.append(self._positions_dev.cpu().numpy().astype(np.int32)[:b])
        payload = np.concatenate(parts)
        epoch = self._spmd_epoch + 1
        log.warning("SPMD follower reported divergence (%s); answering with OP_RESYNC at "
                    "epoch %d", req.get("why", "?"), epoch)
        self._spmd.announce(wire.ControlBlock(
            op=wire.OP_RESYNC, long_idx=epoch, count=len(payload), n_rows=b, width=tl,
            echo=payload, mask=self._active_mask(),
        ))
        self._spmd.reset_seq()
        self._spmd_epoch = epoch
        with self._stats_lock:
            self.spmd_resyncs_total += 1
        self._flight_dump(
            "spmd-recover", extra={"kind": "resync", "epoch": epoch, "requested": dict(req)},
        )

    def _spmd_echo(self, kind: int, host: np.ndarray) -> None:
        """In echo mode, re-broadcast a processed chunk's fetched tokens:
        the follower holds them against its own result for the same
        dispatch."""
        if self._spmd is None or not getattr(self._spmd, "echo", False):
            return
        flat = np.asarray(host, np.int32).reshape(-1)
        self._spmd.announce(wire.ControlBlock(
            op=wire.OP_ECHO, long_idx=kind, count=len(flat), echo=flat,
        ))

    def _echo_capacity(self, mask: np.ndarray) -> np.ndarray:
        """Each slot's reserved columns for a dispatch with ``mask``: its
        mapped pages x page size (paged), max_seq_len (dense) — what the
        follower's echo check holds rows to (``spmd_serving._echo_valid``)."""
        if not self._paged:
            return np.full(self.max_batch, self.max_seq_len, np.int64)
        tables = self._dispatch_tables(mask)
        return (tables != self._pagepool.oob).sum(axis=1).astype(np.int64) * self.page_size

    def _spmd_apply_bind(self, idx: int, pages: list, cow_src: Optional[int],
                         cow_dst: Optional[int]) -> None:
        """Follower half of OP_PAGE_BIND: the leader's reservation into this
        rank's table and owned list (the only allocator state a follower
        keeps), and the same copy-on-write copy in the same stream order."""
        pool = self._pagepool
        # a bound page may still be read by this rank's spill copy in
        # flight (the leader demoted an entry on it): its new holder writes
        # it only after (each rank keeps its own fences)
        pool.wait_fences(pages)
        if pages:
            pool.tables[idx, : len(pages)] = pages
            pool.tables[idx, len(pages):] = pool.oob
        if cow_src is not None and cow_dst is not None:
            page_copy(pool.dev, cow_src, cow_dst)

    def _restore_pages(self, pages: list, slot_blocks: list) -> None:
        """Upload verified arena blocks into their pages in place on the
        engine stream (a restore's last step, leader and follower alike)."""
        cuda = self.device.type == "cuda"
        for dst, blocks in zip(pages, slot_blocks):
            page_write(self._pagepool.dev, int(dst), blocks, non_blocking=cuda)

    # -- the tiers on the SPMD wire ---------------------------------------------

    def _announce_adapter_swap(self, row: int, spec: AdapterSpec) -> None:
        """Leader: a swap-in's row and the adapter's spec (``OP_ADAPTER_SWAP``),
        announced before any admission reads the row."""
        text = json.dumps(dataclasses.asdict(spec), sort_keys=True)
        self._spmd.announce_payload(wire.ControlBlock(
            op=wire.OP_ADAPTER_SWAP, long_idx=row, prompt_len=len(text.encode()),
        ), wire.text_words(text))

    def _announce_grammar_swap(self, row: int, key: str) -> None:
        """Leader: a swap-in's row and the grammar's key, its
        ``response_format`` JSON (``OP_GRAMMAR_SWAP``)."""
        self._spmd.announce_payload(wire.ControlBlock(
            op=wire.OP_GRAMMAR_SWAP, long_idx=row, prompt_len=len(key.encode()),
        ), wire.text_words(key))

    def _announce_admit_rows(self, agentic: Optional[np.ndarray]) -> None:
        """Leader: the next admission's ``[3, n]`` (adapter row, grammar
        row, DFA start state) when a row is not base (``OP_ADMIT_ROWS``);
        a follower replays base rows otherwise."""
        if agentic is None or not agentic.any():
            return
        self._spmd.announce_payload(wire.ControlBlock(
            op=wire.OP_ADMIT_ROWS, n_rows=agentic.shape[1],
        ), agentic)

    def _announce_slot_rows(self) -> None:
        """Leader, before a decode or verify: the per-slot adapter and
        grammar rows (``OP_SLOT_ROWS``) when they changed since the last
        announcement."""
        if not self._agentic:
            return
        rows = (self._adapter_rows, self._g_rows)
        sent = self._spmd_rows_sent
        if sent is not None and all(np.array_equal(a, b) for a, b in zip(rows, sent)):
            return
        self._spmd.announce(wire.ControlBlock(
            op=wire.OP_SLOT_ROWS, n_rows=self.max_batch,
            slots=rows[0].astype(np.int32), mask=rows[1].astype(np.int32),
        ))
        self._spmd_rows_sent = (rows[0].copy(), rows[1].copy())

    def _spmd_take_admit_rows(self, n: int) -> Optional[np.ndarray]:
        """Follower: the announced rows of the admission being replayed, or
        base rows (None with the tier off)."""
        if not self._agentic:
            return None
        rows, self._spmd_admit_rows = self._spmd_admit_rows, None
        return rows if rows is not None else np.zeros((3, n), np.int64)

    def _spmd_adapter_swap(self, row: int, text: str) -> None:
        """Follower half of ``OP_ADAPTER_SWAP``: this rank's slices of the
        same adapter into the same row, on this thread's stream behind every
        replayed chunk that may still read the old row."""
        self._adapters.load_row(row, AdapterSpec(**json.loads(text)))

    def _spmd_grammar_swap(self, row: int, key: str) -> None:
        """Follower half of ``OP_GRAMMAR_SWAP``: the same planes into the
        same row (the pool is replicated: every rank masks the gathered
        vocabulary)."""
        self._constrain_reg.load_row(row, key)

    def _spmd_apply_slot_rows(self, adapter_rows: np.ndarray, grammar_rows: np.ndarray) -> None:
        """Follower half of ``OP_SLOT_ROWS``: the leader's per-slot rows into
        this rank's static buffers."""
        b = self.max_batch
        self._adapter_rows[:] = np.asarray(adapter_rows[:b], np.int64)
        self._g_rows[:] = np.asarray(grammar_rows[:b], np.int64)
        self._refresh_agentic()

    def _spmd_verify_states(self, states: np.ndarray) -> None:
        """Follower half of ``OP_VERIFY_STATES``: the leader's per-position
        DFA states into the verify's static buffer."""
        self._vstates_dev.copy_(self._upload(np.asarray(states, np.int64)), non_blocking=True)

    def _spmd_host_spill(self, pages: np.ndarray, slots: np.ndarray) -> None:
        """Follower half of ``OP_HOST_SPILL``: this rank's shard of the
        pages into the same slots of its own arena — on the spill stream
        after everything replayed so far, each page fenced — and the slots
        stamped by this rank's spill worker."""
        self._spmd_reap_spills()
        if self._spill_worker is not None and not self._spill_worker.alive():
            self._spill_worker.start()
        pages, slots = [int(p) for p in pages], [int(x) for x in slots]
        handle = _Spill(None, slots, self._spill_copy(pages, slots), self._spill_gen)
        for slot in slots:
            self._spmd_spills[slot] = handle
        self._spill_worker.submit(handle)
        self.spill_pages_total += len(slots)

    def _spmd_reap_spills(self) -> None:
        """Follower: forget finished spills (their completions are the
        leader's to fold in)."""
        while True:
            try:
                self._spill_done.get_nowait()
            except queue.Empty:
                break
        done = [s for s, h in self._spmd_spills.items() if h.event.is_set()]
        for slot in done:
            del self._spmd_spills[slot]

    def _spmd_host_restore(self, pages: np.ndarray, slots: np.ndarray, drill: bool) -> None:
        """Follower half of ``OP_HOST_RESTORE``: wait for this rank's spills
        of the slots and for the pages' fences, verify its shard of every
        slot against its own stamp (the drill rots one first), agree on the
        verdict with every rank, then upload — or, when any rank's shard
        failed, take the same fallback (counted)."""
        t0 = time.monotonic()
        pages, slots = [int(p) for p in pages], [int(x) for x in slots]
        tier = self._host_tier
        ok = tier is not None
        for slot in slots:
            handle = self._spmd_spills.get(slot)
            if ok and handle is not None:
                ok = handle.event.wait(max(self._restore_stall_s, 1.0)) and handle.error is None
        self._pagepool.wait_fences(pages)
        if ok and drill:
            tier.corrupt(slots[0])
        blocks = tier.read_slots(slots) if ok else None
        if not self._spmd.agree(blocks is not None, leader=False):
            self.restore_failures_total += 1
            return
        self._restore_pages(pages, blocks)
        self.restore_pages_total += len(pages)
        self.restore_bytes_total += len(pages) * tier.bytes_per_page
        self.restore_s_total += time.monotonic() - t0

    def _spmd_follower_stop(self) -> None:
        """Follower at OP_STOP: its spill worker quiesces."""
        if self._spill_worker is not None:
            self._spill_worker.stop()

    def _spmd_follower_recover(self, epoch: int) -> None:
        """Follower half of OP_RECOVER: adopt the leader's epoch and run the
        same rebuild (its graphs come back with the leader's OP_WARMUP
        announcements)."""
        self._spmd_epoch = int(epoch)
        self._long_caches.clear()
        self._rebuild_device_state()

    # -- admission -------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def _pop_admission(self, allow_new: bool, skip: Optional[set] = None) -> GenerationRequest:
        """Page-deferred admissions retry first; ``skip`` (tenants held
        back this pop) goes to the tenant queue's round-robin only."""
        if self._page_deferred:
            return self._page_deferred.popleft()
        if not allow_new:
            raise queue.Empty
        return self._queue.get_nowait(skip=skip)

    def _tenant_occupancy(self) -> dict[str, int]:
        """Active slots and chunked-prefill streams by tenant, once an
        ``_admit`` call (slots activate after its pop loop)."""
        active = self._active_by_tenant()
        for st in self._longs.values():
            t = _tenant(st["request"])
            active[t] = active.get(t, 0) + 1
        return active

    def _tenant_slot_skip(self, occupancy: dict[str, int],
                          pending_counts: dict[str, int]) -> set:
        """Tenants that must not claim another slot now: at their
        ``max_slots`` cap, or at their weighted fair share of the slots
        (max_batch x weight / the contenders' weights) while other tenants
        wait. A lone tenant is never capped by fairness, and when every
        waiting tenant is at its fair share with slots free, the fair caps
        relax (``max_slots`` never does)."""
        waiting = self._queue.tenants_with_work()
        if not waiting:
            return set()
        active = dict(occupancy)
        for t, n in pending_counts.items():
            active[t] = active.get(t, 0) + n
        hard: set = set()
        fair_skip: set = set()
        contending = set(waiting) | {t for t, n in active.items() if n}
        multi = len(contending) > 1
        total_w = sum(self._tenants.weight(t) for t in contending) or 1.0
        for t in waiting:
            spec = self._tenants.state(t).spec
            n = active.get(t, 0)
            if spec.max_slots is not None and n >= spec.max_slots:
                hard.add(t)
                continue
            if multi:
                fair = max(1, round(self.max_batch * self._tenants.weight(t) / total_w))
                if n >= fair:
                    fair_skip.add(t)
        if fair_skip and set(waiting) <= (fair_skip | hard):
            fair_skip = set()
        return fair_skip | hard

    def _admit(self, budget: int) -> list[tuple]:
        """Move queued requests into free slots, batched per prompt bucket
        into admit groups; returns the deferred first-token fetch entries.
        ``budget`` caps this iteration's prefill tokens, floored at one
        full admission group. Paged: once the slice is popped, each
        admission binds its pages in pop order (``_paged_bind``, the JAX
        engine's order): a prefix hit is admitted at once as a warm suffix
        segment (which publishes before the next bind looks up), a pool
        that cannot cover it defers it, the rest join the cold groups,
        which publish after their prefill. A group whose prefill fails (the
        ``prefill`` fault site) fails its own requests only."""
        free = [
            i for i, slot in enumerate(self._slots) if not slot.active and i not in self._longs
        ]
        pairs: list[tuple[int, GenerationRequest]] = []
        admitted_tokens = 0
        # while deferred admissions wait for pages, only they retry
        allow_new = not self._page_deferred
        widest = self.prefill_buckets[-1]
        # fair-share slot division: tenants admitted in this call count
        # toward their share at once
        pending_counts: dict[str, int] = {}
        occupancy = self._tenant_occupancy()
        # a held-back long request gets first claim on freed long-queue room
        if self._held_back is not None and len(self._long_queue) < self.LONG_QUEUE_CAP:
            self._long_queue.append(self._held_back)
            self._held_back = None
        for idx in free:
            got = False
            while not got and self._held_back is None:
                if admitted_tokens >= budget and len(pairs) >= self.prefill_batch:
                    break
                try:
                    request = self._pop_admission(
                        allow_new, skip=self._tenant_slot_skip(occupancy, pending_counts)
                    )
                except queue.Empty:
                    break
                with self._waiting_lock:
                    self._waiting.pop(id(request), None)
                if request._done.is_set() or not self._prequalify(request):
                    continue  # resolved by the sweep, or dead on its way out
                n = len(request.prompt_tokens)
                tenant = _tenant(request)
                if n > widest:
                    # the chunked-prefill path, its queue bounded so
                    # submit's backpressure still engages under long traffic
                    if len(self._long_queue) >= self.LONG_QUEUE_CAP:
                        self._held_back = request
                        break
                    self._long_queue.append(request)
                    pending_counts[tenant] = pending_counts.get(tenant, 0) + 1
                    continue
                if self._agentic and not self._resolve_agentic(request):
                    continue  # unknown adapter / pinned-full pool: resolved
                pairs.append((idx, request))
                admitted_tokens += self._bucket(n)
                pending_counts[tenant] = pending_counts.get(tenant, 0) + 1
                got = True
            if not got:
                break
        entries: list[tuple] = []
        if self._paged:
            cold: list[tuple[int, GenerationRequest]] = []
            for idx, request in pairs:
                base = self._paged_bind(idx, request)
                if base is None:
                    # pool exhausted: defer (retried first next iteration)
                    self._page_deferred.append(request)
                elif base == 0:
                    cold.append((idx, request))
                elif base > 0:
                    entries.extend(self._paged_prefill_prefix(idx, request, base))
                # base < 0: can never fit, resolved with ShedError
            pairs = cold
        elif self._prefix_pool is not None:
            # dense: in pop order, a request whose cached prefix extends in
            # place is admitted at once as a warm suffix segment (which
            # publishes before the next lookup); an adapter request neither
            # looks up nor publishes — its K/V carry its wk / wv deltas
            cold = []
            for idx, request in pairs:
                hit = None if request.options.adapter else self._dense_prefix_lookup(
                    request.prompt_tokens
                )
                if hit is None:
                    cold.append((idx, request))
                else:
                    entries.extend(self._dense_prefill_prefix(idx, request, *hit))
            pairs = cold
        groups: dict[int, list[tuple[int, GenerationRequest]]] = {}
        for idx, request in pairs:
            groups.setdefault(self._bucket(len(request.prompt_tokens)), []).append(
                (idx, request)
            )
        for width, group in sorted(groups.items()):
            for start in range(0, len(group), self.prefill_batch):
                sub = group[start:start + self.prefill_batch]
                try:
                    entries.extend(self._prefill_group(width, sub))
                except Exception as e:  # noqa: BLE001 — fail the group, not the engine
                    if _is_sticky(e) or self._spmd is not None:
                        raise  # multi-rank: crash the replica into a coordinated recovery
                    log.exception("prefill failed for a group of %d requests", len(sub))
                    for idx, request in sub:
                        if self._paged:
                            self._free_slot_pages(idx)  # reserved above
                        request._finish(self._result(request, [], "error", error=e))
        return entries

    def _paged_bind(self, idx: int, request: GenerationRequest) -> Optional[int]:
        """Reserve slot ``idx``'s worst-case pages (prompt plus
        max_new_tokens), aliasing the deepest published prefix of the
        prompt when the index has one: its full pages join the table by a
        refcount bump (no copy), a prefix that ends mid-page gets one
        copy-on-write page copy. The entry is pinned while this runs, and
        under pool pressure the LRU unpinned entries are evicted first
        (with the host tier: demoted to their host copy). The hit is taken
        down a ladder: a device-resident candidate, else a hibernated one
        restored from the arena, else a durable checkpoint, else cold.
        Returns the reuse offset (0: cold), None — slot untouched — when
        the pool cannot cover the reservation now (the caller defers), or
        -1 when it never can (the request is resolved with ``ShedError``).
        The short and the long path both bind here."""
        pool, index = self._pagepool, self._prefix_index
        prompt = request.prompt_tokens
        # a max_cost_tokens budget shrinks the reservation with the cap
        need = pool.pages_needed(
            len(prompt), max(1, effective_max_new_tokens(request.options, len(prompt)))
        )
        if need > pool.num_pages:
            request._finish(self._result(
                request, [], "error",
                error=ShedError(
                    f"request needs {need} KV pages but the pool has only "
                    f"{pool.num_pages}; raise kv-pages (or lower max-new-tokens)"
                ),
            ))
            return -1
        hit = None
        if index is not None and not request.options.adapter:
            # the deepest usable candidate wins (an adapter request never
            # aliases the shared prefixes — its K/V carry its wk / wv
            # deltas); a hibernated candidate (host tier, no device pages)
            # is restored in place, and a failed restore (checksum, fault,
            # no room) falls back to the next shallower candidate, then to
            # a recompute
            failed_restores = 0
            counted = request._tier_fallback_counted
            for p_cand, cand in reversed(index.candidates(prompt)):
                if cand.dropped:
                    # a deeper candidate's restore can evict a shallower one
                    # out of this already-taken list: stale, not a hit
                    continue
                if cand.pages:
                    hit = (p_cand, cand)
                    break
                if self._restore_entry(cand, p_cand, count_failures=not counted):
                    hit = (p_cand, cand)
                    request._tier_restored = True
                    break
                failed_restores += 1
            if failed_restores:
                # failures count once per request: a page-deferred request
                # re-runs this loop every iteration; whether it ends as a
                # recompute is decided at bind time below
                request._tier_fallback_counted = True
            if hit is None and self._durable is not None:
                # the ladder's third rung: nothing live covers the prompt —
                # a durable checkpoint may (any failure: cold prefill)
                hit = self._durable_admit(request, prompt)
                if hit is not None:
                    request._tier_restored = True
        shared: tuple[int, ...] = ()
        cow_src = None
        p, entry = hit if hit is not None else (0, None)
        if entry is not None:
            full = p // self.page_size
            shared = entry.pages[:full]
            if p % self.page_size:
                cow_src = entry.pages[full]
            index.acquire(entry)  # eviction below must not free it
        try:
            want_fresh = need - len(shared)
            if index is not None and pool.free_pages < want_fresh:
                # with the host tier, victims demote to their host copy (the
                # pool is a cache over host RAM) before anything is dropped
                index.evict_for(
                    pool, want_fresh, spill_cb=self._ensure_spilled if self._spill_on else None
                )
            cow_dst = pool.reserve(idx, need, shared)
            if cow_dst is None:
                return None
            # the restore-vs-recompute gauges are decided here, once a
            # request and on one side only: a deferral is neither
            if entry is not None and request._tier_restored and not request._tier_restored_counted:
                self.restored_hits_total += 1
                request._tier_restored_counted = True
            elif (
                entry is None
                and request._tier_fallback_counted
                and not request._tier_recompute_counted
            ):
                # bound cold after a failed restore (a shallower device
                # candidate serving warm is not a recompute)
                self.recompute_fallbacks_total += 1
                request._tier_recompute_counted = True
            if self._spmd is not None:
                # the reservation's RESULT rides the wire: followers bind the
                # same pages to the same slot's table (aliased ones too) and
                # make the same copy-on-write copy; the free list, refcounts
                # and index stay the leader's
                owned = pool.slot_pages(idx)
                cow = entry is not None and cow_src is not None
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_PAGE_BIND, long_idx=idx, count=len(owned),
                    pages=np.asarray(owned, np.int32),
                    cow_src=cow_src if cow else -1, cow_dst=cow_dst if cow else -1,
                ))
            if index is not None:
                index.record_lookup(entry)
            if entry is None:
                return 0
            if cow_src is not None:
                page_copy(pool.dev, cow_src, cow_dst)
                with self._stats_lock:
                    self.page_copies_total += 1
            index.tokens_saved += p
            saved = int(p * pool.bytes_per_page / self.page_size) - (
                pool.bytes_per_page if cow_src is not None else 0
            )
            index.copy_bytes_saved += max(saved, 0)
            return p
        finally:
            if entry is not None:
                index.release(entry)

    def _paged_prefill_prefix(
        self, idx: int, request: GenerationRequest, p: int
    ) -> list[tuple]:
        """A warm short admission: the aliased pages are already in the
        slot's table (``_paged_bind``), so the device runs one batch-1
        suffix segment of ``_bucket(len(suffix))`` tokens at offset ``p``
        straight into the slot's pages (no pad rows, MoE included), then
        samples the first token and seeds the chain. Publishes the prompt
        before returning. A failed segment (the ``segment`` fault site)
        fails this request only and frees its pages."""
        prompt = request.prompt_tokens
        suffix = prompt[p:]
        width = self._bucket(len(suffix))
        tokens = np.zeros((1, width), np.int64)
        tokens[0, : len(suffix)] = suffix
        opts = request.options
        slots = np.array([idx], np.int64)
        agentic = self._row_agentic([request], 1)
        started = time.monotonic()
        try:
            if self._injector is not None:
                self._injector.fire("segment")
            if self._spmd is not None:
                # one warm paged admission = one suffix segment over pages
                # the preceding OP_PAGE_BIND aliased on every rank
                self._announce_admit_rows(agentic)
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_LONG_SEG, width=width, n_rows=1, tokens=tokens.astype(np.int32),
                    s0=p, seg_len=len(suffix), long_idx=idx, long_final=True,
                    prompt_len=len(prompt), temps=np.array([opts.temperature], np.float32),
                    top_ks=np.array([opts.top_k], np.int32),
                    top_ps=np.array([opts.top_p], np.float32),
                ))
            first = self._dev_paged_segment(
                tokens, p, len(suffix), idx, opts.temperature, opts.top_k, opts.top_p,
                final=True, prompt_len=len(prompt), agentic=agentic,
            )
        except Exception as e:  # noqa: BLE001 — fail the request, not the engine
            if _is_sticky(e) or self._spmd is not None:
                raise  # multi-rank: crash the replica into a coordinated recovery
            log.exception("warm prefix admission failed (p=%d)", p)
            self._free_slot_pages(idx)
            request._finish(self._result(request, [], "error", error=e))
            return []
        if self._obs.on:
            self._obs.record("engine_prefill_dispatch_s", time.monotonic() - started)
        slot = self._slots[idx]
        slot.request = request
        slot.position = len(prompt)
        slot.generated = []
        slot.started_at = started
        slot.first_token_at = 0.0
        slot.reset_obs("warm", 1)
        self._slot_bind_agentic(idx, request)
        self._spec_admit(idx, prompt)
        with self._stats_lock:
            self.total_requests += 1
            self.warm_admissions_total += 1
            self.prefill_tokens_total += len(suffix)
        self._note_tenant_admitted(request)
        self._maybe_publish(idx, prompt)
        return [("prefill", self._fetcher.submit(first), [(idx, request)], 0)]

    def _dev_paged_segment(self, tokens: np.ndarray, s0: int, seg_len: int, idx: int,
                           temp: float, top_k: int, top_p: float, final: bool,
                           prompt_len: int, agentic: Optional[np.ndarray] = None,
                           ) -> Optional[torch.Tensor]:
        """Device layer of one paged segment (a long prompt's, or a warm
        admission's suffix): the segment forward straight into slot
        ``idx``'s pages, reading ``s0 + width`` columns; the final one
        samples the first token and seeds the chain (→ the first token)."""
        width = tokens.shape[1]
        logits, _ = paged_prefill_segment_inplace(
            self.params, self._upload(tokens), self._upload(np.array([s0], np.int64)),
            self._upload(np.array([seg_len], np.int64)), self._pagepool.dev,
            self._upload(self._pagepool.tables[idx : idx + 1]), self.config,
            self.page_size, kv_bound=s0 + width, tp=self._tp,
            **self._lora_kw(agentic[0] if agentic is not None else None),
        )
        if not final:
            return None
        return self._seed_chain(
            logits, np.array([idx], np.int64), np.array([prompt_len], np.int64),
            np.array([temp], np.float32), np.array([top_k], np.int64),
            np.array([top_p], np.float32), agentic,
        )

    def _dense_prefix_lookup(
        self, prompt: list[int], full_width_only: bool = False
    ) -> Optional[tuple[int, PrefixEntry]]:
        """The deepest usable cached prefix of ``prompt`` as ``(p, entry)``
        (``p`` may be shorter than the entry: its row's first p columns),
        the lookup counted in the pool's hit rate — the JAX engine's
        ``_prefix_lookup``. A short prompt takes only a ``p`` whose suffix
        bucket fits the pool-width local cache; a long one
        (``full_width_only``) only a full segment width, so its segments
        stay on the segment grid."""
        pool = self._prefix_pool
        best = None
        for p, entry in pool.candidates(prompt):  # ascending by p
            if full_width_only:
                if p == pool.width:
                    best = (p, entry)
            elif p + self._bucket(len(prompt) - p) <= pool.width:
                best = (p, entry)
        pool.record_lookup(best[1] if best else None)
        return best

    def _dense_prefill_prefix(
        self, idx: int, request: GenerationRequest, p: int, entry: PrefixEntry
    ) -> list[tuple]:
        """A warm short admission on the dense layout: pool row → a
        pool-width batch-1 local cache (``gather_prefix_local``), one
        suffix segment of ``_bucket(len(suffix))`` tokens at offset ``p``
        (the segment kernels on the kernel path), the insert into the
        slot's row, the first sample and the chain — the cold path without
        the prefix's prefill. The entry is pinned while it is read.
        Publishes the prompt before returning. A failed segment (the
        ``segment`` fault site) fails this request only."""
        pool = self._prefix_pool
        prompt = request.prompt_tokens
        suffix = prompt[p:]
        width = self._bucket(len(suffix))
        tokens = np.zeros((1, width), np.int64)
        tokens[0, : len(suffix)] = suffix
        opts = request.options
        slots = np.array([idx], np.int64)
        agentic = self._row_agentic([request], 1)
        started = time.monotonic()
        pool.acquire(entry)
        try:
            if self._injector is not None:
                self._injector.fire("segment")
            if self._spmd is not None:
                self._announce_admit_rows(agentic)
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_PREFIX_ADMIT, width=width, n_rows=1,
                    tokens=tokens.astype(np.int32), s0=p, seg_len=len(suffix),
                    kv_bound=p + width, entry_row=entry.row, long_idx=idx,
                    prompt_len=len(prompt), temps=np.array([opts.temperature], np.float32),
                    top_ks=np.array([opts.top_k], np.int32),
                    top_ps=np.array([opts.top_p], np.float32),
                ))
            first = self._dev_prefix_admit(
                tokens, p, len(suffix), p + width, entry.row, opts.temperature, opts.top_k,
                opts.top_p, idx, len(prompt), agentic,
            )
        except Exception as e:  # noqa: BLE001 — fail the request, not the engine
            if _is_sticky(e) or self._spmd is not None:
                raise
            log.exception("warm prefix admission failed (p=%d)", p)
            request._finish(self._result(request, [], "error", error=e))
            return []
        finally:
            pool.release(entry)
        pool.tokens_saved += p
        if self._obs.on:
            self._obs.record("engine_prefill_dispatch_s", time.monotonic() - started)
        slot = self._slots[idx]
        slot.request = request
        slot.position = len(prompt)
        slot.generated = []
        slot.started_at = started
        slot.first_token_at = 0.0
        slot.reset_obs("warm", 1)
        self._slot_bind_agentic(idx, request)
        self._spec_admit(idx, prompt)
        with self._stats_lock:
            self.total_requests += 1
            self.warm_admissions_total += 1
            self.prefill_tokens_total += len(suffix)
        self._note_tenant_admitted(request)
        self._maybe_publish(idx, prompt)
        return [("prefill", self._fetcher.submit(first), [(idx, request)], 0)]

    def _dev_prefix_admit(self, tokens: np.ndarray, p: int, seg_len: int, kv_bound: int,
                          row: int, temp: float, top_k: int, top_p: float, idx: int,
                          prompt_len: int, agentic: Optional[np.ndarray] = None,
                          ) -> torch.Tensor:
        """Device layer of a dense warm admission: prefix-pool ``row`` → a
        pool-width local cache, the suffix segment at offset ``p``, the
        insert into slot ``idx``'s row, the first sample and the chain."""
        pool = self._prefix_pool
        local = gather_prefix_local(pool.dev, row, self.config, pool.width, device=self.device)
        logits, _ = prefill_segment(
            self.params, self._upload(tokens), self._upload(np.array([p], np.int64)),
            self._upload(np.array([seg_len], np.int64)), local, self.config,
            kv_bound=kv_bound, tp=self._tp,
            **self._lora_kw(agentic[0] if agentic is not None else None),
        )
        slots = np.array([idx], np.int64)
        dense_insert_cache(self._cache, local, self._upload(slots))
        return self._seed_chain(
            logits, slots, np.array([prompt_len], np.int64), np.array([temp], np.float32),
            np.array([top_k], np.int64), np.array([top_p], np.float32), agentic,
        )

    def _dev_prefix_publish(self, idx: int, row: int) -> None:
        """Device layer of a dense publish: slot ``idx``'s row into prefix
        pool row ``row``."""
        publish_prefix_rows(self._prefix_pool.dev, self._cache, idx, row)

    def _spec_admit(self, idx: int, prompt: list[int]) -> None:
        """Give an admitted slot its draft index, seeded with the whole
        prompt (a warm admission's aliased prefix too): the prompt is where
        repeated spans live. Delivered tokens join it in
        ``_deliver_token``, never a verify's rejected columns."""
        if self._spec_enabled:
            index = NGramIndex()
            index.extend(prompt)
            self._spec_index[idx] = index

    def _maybe_publish(self, idx: int, prompt: list[int]) -> None:
        """Publish the prompt's deepest bucket boundary after its prefill.
        Paged: host bookkeeping only — the slot's first ``ceil(p /
        page_size)`` pages join the index by a refcount bump. Dense: the
        slot's row (its first pool-width columns) is copied into a pool
        row (``publish_prefix_rows``), the LRU unpinned entry evicted when
        the pool is full; skipped when every row is pinned. Skipped when
        reuse is off, the prefix is already published, or no boundary fits
        — and for an adapter slot, whose K/V carry its adapter's deltas.
        Boundaries are prompt rows written by prefill, never verify
        columns."""
        if self._adapter_rows_auth[idx] != 0:
            return
        pool = self._prefix_pool
        if pool is not None:
            p = pool.publish_length(len(prompt))
            if p <= 0 or pool.has(prompt, p):
                return
            row = pool.allocate()
            if row is None:
                return  # every row pinned: skip, never stall an admission
            if self._spmd is not None:
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_PREFIX_PUBLISH, long_idx=idx, entry_row=row,
                ))
            self._dev_prefix_publish(idx, row)
            pool.insert(prompt, p, row)
            return
        index = self._prefix_index
        if index is None:
            return
        p = index.publish_length(len(prompt))
        if p <= 0 or index.has(prompt, p):
            return
        n = -(-p // self.page_size)
        owned = self._pagepool.slot_pages(idx)
        if len(owned) >= n:
            entry = index.insert(self._pagepool, prompt, p, tuple(owned[:n]))
            if entry is not None and self._spill_on:
                # a hibernation candidate: once idle past spill-idle-s the
                # sweep spills its pages (published pages are stable —
                # positions only grow — so the copy is valid while the
                # publisher keeps decoding)
                self._spill_candidates.append(entry)

    def _prefill_group(self, width: int, group: list[tuple[int, GenerationRequest]]) -> list[tuple]:
        """One admit group: every (slot, request) pair of one prompt bucket,
        prompts right-padded with zeros to the bucket width. An MoE model's
        group also gets pad rows (token 0, length 1) up to ``prefill_batch``,
        as the JAX engine pads every group: the rows share the experts'
        capacity, so the same rows give the same logits."""
        n = self.prefill_batch if self.config.is_moe else len(group)
        tokens = np.zeros((n, width), np.int64)
        lengths = np.ones(n, np.int64)
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int64)
        top_ps = np.ones(n, np.float32)
        # pad rows ride with the out-of-range slot max_batch
        slots = np.full(n, self.max_batch, np.int64)
        started = time.monotonic()
        for j, (idx, request) in enumerate(group):
            prompt = request.prompt_tokens
            tokens[j, : len(prompt)] = prompt
            lengths[j] = len(prompt)
            temps[j] = request.options.temperature
            top_ks[j] = request.options.top_k
            top_ps[j] = request.options.top_p
            slots[j] = idx
        # pad rows ride as base rows (adapter row 0, grammar row 0)
        agentic = self._row_agentic([r for _, r in group], n)
        if self._spmd is not None:
            self._announce_admit_rows(agentic)
            self._spmd.announce(wire.ControlBlock(
                op=wire.OP_PREFILL, width=width, n_rows=n, tokens=tokens.astype(np.int32),
                lengths=lengths.astype(np.int32), slots=slots.astype(np.int32), temps=temps,
                top_ks=top_ks.astype(np.int32), top_ps=top_ps,
            ))
        first = self._dev_prefill(tokens, lengths, temps, top_ks, top_ps, slots, len(group),
                                  agentic)
        if self._obs.on:
            self._obs.record("engine_prefill_dispatch_s", time.monotonic() - started)
        for idx, request in group:
            slot = self._slots[idx]
            slot.request = request
            slot.position = len(request.prompt_tokens)
            slot.generated = []
            slot.started_at = started
            slot.first_token_at = 0.0
            slot.reset_obs("cold", 1)
            self._slot_bind_agentic(idx, request)
            self._spec_admit(idx, request.prompt_tokens)
            self._note_tenant_admitted(request)
        with self._stats_lock:
            self.total_requests += len(group)
            self.admit_groups_total += 1
            self.prefill_tokens_total += sum(len(r.prompt_tokens) for _, r in group)
        for idx, request in group:
            self._maybe_publish(idx, request.prompt_tokens)
        return [("prefill", self._fetcher.submit(first), list(group), 0)]

    def _dev_prefill(self, tokens, lengths, temps, top_ks, top_ps, slots, rows: int,
                     agentic: Optional[np.ndarray] = None):
        """Device layer of an admit group: local-cache prefill (with each
        row's adapter, ``agentic``: ``_row_agentic``), the insert of that
        cache into each real row's pages (paged) or its slot's row of the
        big cache (dense), then the first sample and the chain seeding.
        Rows from ``rows`` on are padding: they prefill and are dropped.
        The ``prefill`` fault site fires before any state changes."""
        if self._injector is not None:
            self._injector.fire("prefill")
        dev = self.device
        n, width = tokens.shape
        local = make_kv_cache(self.config, n, width, device=dev)
        logits, local = prefill(
            self.params, self._upload(tokens), self._upload(lengths), local, self.config,
            tp=self._tp, **self._lora_kw(agentic[0] if agentic is not None else None),
        )
        if rows < n:
            local = {name: _rows(entry, rows) for name, entry in local.items()}
            logits = logits[:rows]
            slots, lengths, temps = slots[:rows], lengths[:rows], temps[:rows]
            top_ks, top_ps = top_ks[:rows], top_ps[:rows]
            agentic = agentic[:, :rows] if agentic is not None else None
        if self._paged:
            tables = self._upload(self._pagepool.tables[slots])
            paged_insert_cache(self._pagepool.dev, local, tables, self.page_size)
        else:
            dense_insert_cache(self._cache, local, self._upload(slots))
        return self._seed_chain(logits, slots, lengths, temps, top_ks, top_ps, agentic)

    def _seed_chain(self, logits, slots, lengths, temps, top_ks, top_ps,
                    agentic: Optional[np.ndarray] = None) -> torch.Tensor:
        """Sample the first token of each admitted row and seed its slot's
        device decode chain in place: token, next position, sampling
        params. With constrained decoding the sample is masked by each
        row's (grammar row, initial state) — ``agentic`` rows 1 and 2 — and
        the state past it seeds the slot's DFA state."""
        temp_t, topk_t, topp_t = self._upload(temps), self._upload(top_ks), self._upload(top_ps)
        samples = bool((temps > 0).any())
        filters = bool(((temps > 0) & ((top_ks > 0) | (top_ps < 1.0))).any())
        reg = self._constrain_reg
        allowed = None
        if reg is not None:
            g_t, s0_t = self._upload(agentic[1]), self._upload(agentic[2])
            allowed = _dfa_mask(reg.pool, g_t, s0_t)
        first = sample(logits, self._generator, temp_t, topk_t, topp_t, samples, filters, allowed)
        slots_t = self._upload(slots)
        if reg is not None:
            self._dfa_state_dev[slots_t] = _dfa_advance(
                reg.pool, g_t, first, s0_t, self.config.vocab_size
            )
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
            if self._agentic and not self._resolve_agentic(request):
                continue  # unknown adapter / pinned-full pool: resolved
            base = 0
            st: dict = {"idx": free, "request": request, "seg": 0}
            if self._paged:
                # any published boundary works: paged segments write at
                # global positions, so the stream starts at the reuse offset
                base = self._paged_bind(free, request)
                if base is None:
                    self._long_queue.insert(0, request)  # waits for pages
                    break
                if base < 0:
                    continue  # can never fit: resolved with ShedError
            elif self._prefix_pool is not None and not request.options.adapter:
                # dense: a cached full segment width starts the stream at
                # the reuse point (the segment grid stays aligned); the
                # entry is pinned until the first segment has gathered it
                hit = self._dense_prefix_lookup(request.prompt_tokens, full_width_only=True)
                if hit is not None:
                    base, st["prefix"] = hit
                    self._prefix_pool.acquire(st["prefix"])
            if (
                self._ring_admit
                and "prefix" not in st
                # the ring admit threads no adapter and no grammar: agentic
                # requests take the segment loop, as in the JAX engine
                and request._dfa is None
                and not request.options.adapter
                and self._ring_pad(len(request.prompt_tokens)) is not None
            ):
                # the whole prompt in ONE sequence-split dispatch: it never
                # becomes a stream, but its tokens count against this
                # iteration's prefill budget
                entries.extend(self._ring_step(free, request))
                spent += len(request.prompt_tokens)
                if spent >= budget:
                    return entries, spent
                continue
            st["base"] = base
            self._longs[free] = st
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
            self._free_slot_pages(idx)
        entry = st.pop("prefix", None)
        if entry is not None:
            self._prefix_pool.release(entry)
        self._long_caches.pop(idx, None)
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
        prompt = request.prompt_tokens
        width = self.prefill_buckets[-1]
        # a warm paged stream starts at its reuse offset ``base``
        s0 = st["base"] + st["seg"] * width
        seg = prompt[s0 : s0 + width]
        tokens = np.zeros((1, width), np.int64)
        tokens[0, : len(seg)] = seg
        agentic = self._row_agentic([request], 1)
        opts = request.options
        final = s0 + width >= len(prompt)
        start = st["seg"] == 0
        t_long = 0 if self._paged else self._long_width(len(prompt))
        # readable columns: segment i never attends past s0 + width (the
        # exact bound, as for decode chunks)
        kv_bound = s0 + width if self._paged else min(s0 + width, t_long)
        entry = st.get("prefix") if start else None
        started = time.monotonic()
        try:
            if self._injector is not None:
                self._injector.fire("segment")
            if self._spmd is not None:
                self._announce_admit_rows(agentic)
                self._spmd.announce(wire.ControlBlock(
                    op=wire.OP_LONG_SEG, width=width, n_rows=1, tokens=tokens.astype(np.int32),
                    s0=s0, seg_len=len(seg), kv_bound=kv_bound, t_long=t_long,
                    long_start=start, long_final=final, long_idx=idx, prompt_len=len(prompt),
                    # dense warm start: the follower seeds its local cache
                    # from the same pool row
                    entry_row=entry.row if entry is not None else -1,
                    temps=np.array([opts.temperature], np.float32),
                    top_ks=np.array([opts.top_k], np.int32),
                    top_ps=np.array([opts.top_p], np.float32),
                ))
            if self._paged:
                first = self._dev_paged_segment(
                    tokens, s0, len(seg), idx, opts.temperature, opts.top_k, opts.top_p,
                    final=final, prompt_len=len(prompt), agentic=agentic,
                )
            else:
                first = self._dev_long_segment(
                    tokens, s0, len(seg), kv_bound, t_long, opts.temperature, opts.top_k,
                    opts.top_p, start=start, final=final, idx=idx, prompt_len=len(prompt),
                    prefix_row=entry.row if entry is not None else None, agentic=agentic,
                )
        except Exception as e:  # noqa: BLE001 — fail the stream, not the engine
            if _is_sticky(e) or self._spmd is not None:
                raise  # multi-rank: crash the replica into a coordinated recovery
            log.exception("chunked prefill failed at segment %d", st["seg"])
            self._end_stream(st, "error", error=e)
            return []
        st["seg"] += 1
        entry = st.pop("prefix", None)
        if entry is not None:  # gathered: unpinned, its columns counted saved
            self._prefix_pool.release(entry)
            self._prefix_pool.tokens_saved += st["base"]
        if self._obs.on:
            self._obs.record("engine_prefill_dispatch_s", time.monotonic() - started)
        with self._stats_lock:
            self.prefill_tokens_total += len(seg)
            self.prefill_segments_total += 1
        if not final:
            return []  # more segments to go
        del self._longs[idx]
        slot = self._slots[idx]
        slot.request = request
        slot.position = len(prompt)
        slot.generated = []
        slot.started_at = time.monotonic()
        slot.first_token_at = 0.0
        slot.reset_obs("long", st["seg"])
        self._slot_bind_agentic(idx, request)
        self._spec_admit(idx, prompt)
        with self._stats_lock:
            self.total_requests += 1
        self._note_tenant_admitted(request)
        self._maybe_publish(idx, prompt)
        return [("prefill", self._fetcher.submit(first), [(idx, request)], 0)]

    def _dev_long_segment(self, tokens: np.ndarray, s0: int, seg_len: int, kv_bound: int,
                          t_long: int, temp: float, top_k: int, top_p: float, start: bool,
                          final: bool, idx: int, prompt_len: int,
                          prefix_row: Optional[int] = None,
                          agentic: Optional[np.ndarray] = None) -> Optional[torch.Tensor]:
        """Device layer of one dense segment: on the first, a fresh batch-1
        local cache of ``t_long`` columns plus a sink column (a warm stream's
        starts as prefix-pool row ``prefix_row``); the segment forward over
        ``kv_bound`` columns; on the final, the insert into slot ``idx``'s
        row, the first sample and the chain (→ the first token)."""
        if start:
            self._long_caches[idx] = (
                make_kv_cache(self.config, 1, t_long + 1, device=self.device)
                if prefix_row is None
                else gather_prefix_local(self._prefix_pool.dev, prefix_row, self.config,
                                         t_long + 1, device=self.device)
            )
        cache = self._long_caches[idx]
        logits, _ = prefill_segment(
            self.params, self._upload(tokens), self._upload(np.array([s0], np.int64)),
            self._upload(np.array([seg_len], np.int64)), cache, self.config,
            kv_bound=kv_bound, tp=self._tp,
            **self._lora_kw(agentic[0] if agentic is not None else None),
        )
        if not final:
            return None
        del self._long_caches[idx]
        slots = np.array([idx], np.int64)
        dense_insert_cache(self._cache, cache, self._upload(slots))
        return self._seed_chain(
            logits, slots, np.array([prompt_len], np.int64), np.array([temp], np.float32),
            np.array([top_k], np.int64), np.array([top_p], np.float32), agentic,
        )

    # -- ring prefill ------------------------------------------------------------

    def _ring_pad(self, prompt_len: int) -> Optional[int]:
        """Padded width for the ring path: seq-axis-many pow2 blocks of at
        least 128 tokens (few distinct shapes). None when that padding
        cannot fit max_seq_len — the prompt then takes the segment loop,
        which has no divisibility constraint."""
        n = self._ring.n
        block = 128
        while block * n < prompt_len:
            block *= 2
        s_pad = block * n
        return s_pad if s_pad <= self.max_seq_len else None

    def _ring_step(self, idx: int, request: GenerationRequest) -> list[tuple]:
        """One-dispatch ring prefill of a long prompt into slot ``idx``,
        which activates at once. Under SPMD the leader first streams the
        prompt to the followers (``_announce_ring``), so every rank makes
        the same dispatch. A failure fails the request on a single-rank
        engine and crashes the replica into a coordinated recovery under
        SPMD. A request cancelled or expired in the long queue resolves
        here instead, with no dispatch."""
        if self._resolve_if_dead(request, time.monotonic()):
            return []
        prompt = request.prompt_tokens
        s_pad = self._ring_pad(len(prompt))
        assert s_pad is not None  # the caller checked
        tokens = np.zeros((1, s_pad), np.int64)
        tokens[0, : len(prompt)] = prompt
        opts = request.options
        agentic = self._row_agentic([request], 1)
        started = time.monotonic()
        try:
            if self._spmd is not None:
                self._announce_ring(tokens, len(prompt), opts, idx)
            first = self._dev_ring(tokens, len(prompt), opts.temperature, opts.top_k,
                                   opts.top_p, idx, agentic)
        except Exception as e:  # noqa: BLE001 — fail the request, not the engine
            if _is_sticky(e) or self._spmd is not None:
                raise  # multi-rank: crash the replica into a coordinated recovery
            log.exception("ring prefill failed")
            request._finish(self._result(request, [], "error", error=e))
            return []
        if self._obs.on:
            self._obs.record("engine_prefill_dispatch_s", time.monotonic() - started)
        slot = self._slots[idx]
        slot.request = request
        slot.position = len(prompt)
        slot.generated = []
        slot.started_at = time.monotonic()
        slot.first_token_at = 0.0
        slot.reset_obs("ring", 1)
        self._slot_bind_agentic(idx, request)
        self._spec_admit(idx, prompt)
        with self._stats_lock:
            self.total_requests += 1
            self.prefill_tokens_total += len(prompt)
            self.ring_admissions_total += 1
        self._note_tenant_admitted(request)
        self._maybe_publish(idx, prompt)
        return [("prefill", self._fetcher.submit(first), [(idx, request)], 0)]

    def _announce_ring(self, tokens: np.ndarray, prompt_len: int, opts, idx: int) -> None:
        """Stream the PROMPT (not its padding: the follower derives the same
        ``_ring_pad`` and zero-pads itself) over the fixed-shape channel in
        chunks of prefill_batch x max_width tokens; the final chunk carries
        the sampling params and fires the follower's ``_dev_ring``."""
        flat = tokens.reshape(-1)[:prompt_len]
        width = self._spmd.max_width
        chunk_cap = self._spmd.prefill_batch * width
        for start in range(0, prompt_len, chunk_cap):
            piece = flat[start:start + chunk_cap]
            rows = -(-len(piece) // width)
            padded = np.zeros(rows * width, np.int32)
            padded[: len(piece)] = piece
            self._spmd.announce(wire.ControlBlock(
                op=wire.OP_RING, width=width, n_rows=rows, tokens=padded.reshape(rows, width),
                seg_len=len(piece), long_start=start == 0,
                long_final=start + chunk_cap >= prompt_len, long_idx=idx,
                prompt_len=prompt_len,
                temps=np.asarray([opts.temperature], np.float32),
                top_ks=np.asarray([opts.top_k], np.int32),
                top_ps=np.asarray([opts.top_p], np.float32),
            ))

    def _dev_ring(self, tokens: np.ndarray, prompt_len: int, temp: float, top_k: int,
                  top_p: float, idx: int,
                  agentic: Optional[np.ndarray] = None) -> torch.Tensor:
        """Device layer of the ring admit (leader and followers alike): the
        sequence-split prefill (``parallel.sp.ring_prefill``), the K/V
        blocks gathered over the ring (the serving cache is replicated over
        the seq axis, so every rank holds the whole prompt), quantized for
        an int8 cache, written into ``[:, idx, :, :s_pad]`` of the big cache
        in place (never the sink column; the captured graphs hold the
        cache's address), then the first sample and the chain (→ the first
        token, the same on every rank)."""
        from langstream_tpu_torch.parallel.sp import ring_prefill

        ring = self._ring
        s_pad = tokens.shape[1]
        sl = s_pad // ring.n
        logits, kv = ring_prefill(
            self.params, self._upload(tokens), self._upload(np.array([prompt_len], np.int64)),
            self.config, ring, tp=self._tp,
        )
        for name in ("k", "v"):
            big, small = self._cache[name], kv.pop(name)
            if isinstance(big, dict):
                q, scale = _quantize_kv(small)
                leaves = [(big["q"], q), (big["s"], scale)]
            else:
                leaves = [(big, small)]
            for dst, src in leaves:
                blocks = ring.all_gather(src[:, 0].to(dst.dtype))  # [n, L, Hkv, Sl, ...]
                dst[:, idx, :, :s_pad].unflatten(2, (ring.n, sl)).copy_(blocks.movedim(0, 2))
        slots = np.array([idx], np.int64)
        return self._seed_chain(
            logits, slots, np.array([prompt_len], np.int64), np.array([temp], np.float32),
            np.array([top_k], np.int64), np.array([top_p], np.float32), agentic,
        )

    # -- decode dispatch -------------------------------------------------------

    def _decode_kv_bound(self, steps: int) -> int:
        """Readable columns of the big cache for a chunk on the reference
        path (the CPU): the highest host position, plus the steps in
        flight, plus this chunk (the JAX engine's rule, without its pow2
        ladder). The kernels read each row to its length, so the card's
        graphs read the whole cache and need no bound."""
        highest = max((s.position for s in self._slots if s.active), default=0)
        return min(self.max_seq_len, highest + self._inflight_steps + steps)

    def _dispatch_tables(self, mask: Optional[np.ndarray] = None) -> np.ndarray:
        """The page tables of a decode dispatch: every slot that is not
        active (``mask``, the leader's slot liveness on the SPMD wire) gets
        the sentinel row, so a decode step never writes into a stream's
        pages mid-prefill (or into pages a quarantine freed)."""
        pool = self._pagepool
        if mask is None:
            mask = self._active_mask()
        tables = pool.tables.copy()
        inactive = np.flatnonzero(np.asarray(mask) == 0)
        if len(inactive):
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
            self._flight_dump("page-quarantine", extra={"slot": i})
            self._finish_slot(
                i, "error",
                error=RuntimeError(
                    f"page-table corruption detected for slot {i}; slot quarantined, "
                    "pages freed and zeroed"
                ),
            )

    def _quarantine_pages(self, idx: int) -> None:
        """Evict every prefix entry that shares the slot's pages (poisoned
        KV is never aliased again), free the slot's pages through the owned
        list and queue the ones no holder keeps for zeroing at the top of
        the next iteration."""
        pool = self._pagepool
        if self._prefix_index is not None:
            self._prefix_index.evict_touching(pool, pool.slot_pages(idx))
        self._pending_page_zero.extend(self._free_slot_pages(idx))

    def _dispatch_chunk(self, clean: bool = False, pipelined: bool = False) -> Optional[tuple]:
        """Queue one decode chunk: the page-table integrity check (paged),
        the ``decode`` fault site (a raise crashes the loop into the restart
        path), the host writes into the static buffers, then the replay;
        the chunk's output goes to the fetch thread right behind it. None
        when the integrity check quarantined every active slot. ``clean``
        (no prefill ahead of it on the stream) and ``pipelined`` (chunks
        still in flight ahead of it) decide how its step time is read."""
        if self._paged:
            self._page_integrity_check()
        self._adapter_integrity_check()
        if not any(s.active for s in self._slots):
            return None
        if self._injector is not None:
            self._injector.fire("decode")
        steps = self.decode_chunk
        branch = self._branch()
        stale, mask = self._collect_stale(), self._active_mask()
        kv_bound = self._chunk_kv_bound("decode")
        if self._spmd is not None:
            self._announce_slot_rows()
            self._spmd.announce(wire.ControlBlock(
                op=wire.OP_DECODE, steps=steps, n_rows=len(stale),
                slots=np.asarray(stale, np.int32), kv_bound=kv_bound or 0, mask=mask,
                width=BRANCH_CODES[branch],
            ))
        self._refresh_agentic()
        t_dispatch = time.monotonic()
        # on a speculative engine: brownout level 2
        self._dev_decode(steps, stale, kv_bound, mask, BRANCH_CODES[branch])
        snapshot = [(i, s.request) for i, s in enumerate(self._slots) if s.active]
        with self._stats_lock:
            self.decode_chunks_total += 1
            self.decode_steps_total += steps
        return ("chunk", self._fetcher.submit(self._chunk_out), snapshot, steps, t_dispatch,
                clean, pipelined)

    def _dev_decode(self, steps: int, stale, kv_bound: Optional[int], mask: np.ndarray,
                    branch: int) -> torch.Tensor:
        """Device layer of a decode chunk (leader and SPMD follower): the
        stale temperatures, the masked table, then the replay of the
        ``branch``'s decode graph → the ``[steps, B]`` output buffer."""
        self._dev_prepare(stale, mask)
        branch = DECODE_BRANCHES[int(branch)]
        if self._spmd_follower:
            self._run_chunk(branch, "decode", kv_bound)  # the leader's bound
        elif self._spec_enabled:
            self._run_chunk(branch, "decode")  # brownout level 2
        else:
            self._run_chunk(branch)
        return self._chunk_out

    def _dev_verify(self, drafts: np.ndarray, stale, kv_bound: Optional[int],
                    mask: np.ndarray, branch: int) -> torch.Tensor:
        """Device layer of a verify (leader and SPMD follower): the drafts
        into their static buffer, the stale temperatures, the masked table,
        then the replay of the ``branch``'s verify graph → the packed ``[B,
        k + 2]`` output buffer."""
        if self._spmd_follower:
            self._drafts_dev.copy_(self._upload(np.asarray(drafts, np.int64)),
                                   non_blocking=True)
            self._dev_prepare(stale, mask)
            self._run_chunk(DECODE_BRANCHES[int(branch)], "verify", kv_bound)
        else:  # the leader's drafts are in place (_propose_drafts)
            self._dev_prepare(stale, mask)
            self._run_chunk(DECODE_BRANCHES[int(branch)])
        return self._verify_out

    def _propose_drafts(self) -> tuple[np.ndarray, np.ndarray]:
        """Up to k drafts per active slot from its n-gram index, counted
        (lookups, hits, draft tokens) and copied into the static ``[B, k]``
        buffer in place (pinned, asynchronous; zeros where a slot has no
        proposal) → (the drafts, each slot's proposal length). Brownout
        level 1 proposes half as many: drafts are data, so the buffer keeps
        its shape."""
        k = self.spec_tokens
        k_prop = self._brownout.draft_k(k) if self._brownout is not None else k
        drafts = np.zeros((self.max_batch, k), np.int64)
        proposed = np.zeros(self.max_batch, np.int64)
        lookups = hits = tokens = 0
        for i, slot in enumerate(self._slots):
            index = self._spec_index.get(i)
            if not slot.active or index is None:
                continue
            prop = index.propose(k_prop)
            lookups += 1
            if prop:
                hits += 1
                tokens += len(prop)
                drafts[i, : len(prop)] = prop
                proposed[i] = len(prop)
        with self._stats_lock:
            self.spec_draft_lookups_total += lookups
            self.spec_draft_hits_total += hits
            self.spec_draft_tokens_total += tokens
        self._drafts_dev.copy_(self._upload(drafts), non_blocking=True)
        return drafts, proposed

    def _upload_verify_states(self, drafts: np.ndarray) -> None:
        """Each constrained slot's DFA state at every verify position, from
        its host mirror (current: the host drained every fetch before the
        drafts were proposed) over its drafts (``verify_states``), copied
        into the static ``[B, k + 1]`` buffer; other rows ride state 0."""
        t0 = time.monotonic()
        vstates = np.zeros(self._vstates_dev.shape, np.int64)
        for i, slot in enumerate(self._slots):
            dfa = self._slot_dfa.get(i)
            if slot.active and dfa is not None:
                vstates[i] = verify_states(dfa, self._dfa_host_state.get(i, 0), drafts[i])
        self._note_constrain_host((time.monotonic() - t0) * 1e3)
        if self._spmd is not None:
            self._spmd.announce_payload(wire.ControlBlock(
                op=wire.OP_VERIFY_STATES, n_rows=vstates.shape[0], width=vstates.shape[1],
            ), vstates)
        self._vstates_dev.copy_(self._upload(vstates), non_blocking=True)

    def _dispatch_verify(self, clean: bool = False) -> Optional[tuple]:
        """Queue one speculative verify: the page-table integrity check, up
        to k drafts per active slot from its n-gram index (host-side; a
        slot with no proposal rides with zero drafts), the drafts copied
        into the static buffer in place (pinned, asynchronous), the
        ``decode`` fault site (a raise crashes the loop into the restart
        path), the host writes of a decode chunk, then the replay; the
        packed ``[B, k + 2]`` output goes to the fetch thread right behind
        it. None when the integrity check quarantined every active slot."""
        if self._paged:
            self._page_integrity_check()
        self._adapter_integrity_check()
        if not any(s.active for s in self._slots):
            return None
        drafts, proposed = self._propose_drafts()
        if self._vstates_dev is not None:
            self._upload_verify_states(drafts)
        if self._injector is not None:
            self._injector.fire("decode")
        branch = self._branch()
        stale, mask = self._collect_stale(), self._active_mask()
        kv_bound = self._chunk_kv_bound("verify")
        if self._spmd is not None:
            # the proposals ride the wire (steps = k); acceptance is decided
            # on every rank's device alike
            self._announce_slot_rows()
            self._spmd.announce(wire.ControlBlock(
                op=wire.OP_VERIFY, steps=self.spec_tokens, n_rows=len(stale),
                slots=np.asarray(stale, np.int32), kv_bound=kv_bound or 0,
                drafts=drafts.astype(np.int32), mask=mask, width=BRANCH_CODES[branch],
            ))
        self._refresh_agentic()
        t_dispatch = time.monotonic()
        self._dev_verify(drafts, stale, kv_bound, mask, BRANCH_CODES[branch])
        snapshot = [(i, s.request) for i, s in enumerate(self._slots) if s.active]
        with self._stats_lock:
            self.spec_dispatches_total += 1
        return ("verify", self._fetcher.submit(self._verify_out), snapshot, proposed,
                t_dispatch, clean)

    # -- host processing -------------------------------------------------------

    def _process_entry(self, entry: tuple) -> None:
        if entry[0] == "verify":
            self._process_verify(entry)
            return
        if entry[0] == "prefill":
            _, fetch, group, _ = entry
            first = fetch.result(self._fetch_bound())
            now = time.monotonic()
            for j, (idx, request) in enumerate(group):
                slot = self._slots[idx]
                if slot.request is not request:
                    continue
                slot.first_token_at = now
                slot.last_token_at = now  # the inter-token clock starts here
                ttft = now - request.submitted_at
                if self._obs.on:
                    self._obs.record("engine_ttft_s", ttft)
                self._tenants.note_ttft(_tenant(request), ttft)
                self._deliver_token(idx, int(first[j]))
            return
        _, fetch, snapshot, steps, t_dispatch, clean, pipelined = entry
        host = fetch.result(self._fetch_bound())  # [steps, B]
        # the step time before delivery: a request finishing mid-chunk
        # wakes its waiter inside the loop below
        self._sample_step_time(snapshot, steps, t_dispatch, clean, pipelined)
        # the echo is the device's truth, before the host-side corruption
        # drill (which must not read as an SPMD divergence)
        self._spmd_echo(wire.ECHO_DECODE, host)
        if self._injector is not None:
            host, _ = self._injector.corrupt_tokens(host, snapshot)
        for idx, request in snapshot:
            slot = self._slots[idx]
            if slot.request is not request:  # freed / reassigned meanwhile
                continue
            slot.decode_iters += 1
            t_prev = slot.last_token_at
            delivered = 0
            for s in range(steps):
                slot.position += 1
                self._deliver_token(idx, int(host[s, idx]))
                delivered += 1
                if slot.request is not request:  # finished mid-chunk
                    break
            self._record_intertoken(slot, request, t_prev, delivered)

    def _sample_step_time(self, snapshot, steps: int, t_dispatch: float, clean: bool,
                          pipelined: bool) -> None:
        """One decode-step sample when a chunk's tokens land, for chunks
        with no prefill ahead of them on the stream: a pipelined chunk ran
        right after its predecessor, so its steps took the interval since
        that one landed; a chunk dispatched to an idle stream took the
        interval since its dispatch."""
        now = time.monotonic()
        step_s = None
        if snapshot and clean:
            if pipelined and self._last_chunk_ready_t > 0:
                step_s = (now - self._last_chunk_ready_t) / max(1, steps)
            elif not pipelined:
                step_s = (now - t_dispatch) / max(1, steps)
        if step_s is not None:
            self._note_step(step_s)
        self._last_chunk_ready_t = now

    def _note_step(self, step_s: float) -> None:
        """One decode-step sample: the step-time EMA (``decode-step-ms``)
        and, with observability on, the step histogram."""
        self._step_time_ema_s = (
            step_s if self._step_time_ema_s == 0 else 0.9 * self._step_time_ema_s + 0.1 * step_s
        )
        if self._obs.on:
            self._obs.record("engine_decode_step_s", step_s)

    def _record_intertoken(self, slot: _Slot, request: GenerationRequest, t_prev: float,
                           delivered: int) -> None:
        """One inter-token sample a slot a processed chunk or verify: the
        mean gap over the tokens it delivered."""
        if not self._obs.on or not delivered:
            return
        now = time.monotonic()
        if t_prev:
            self._obs.record("engine_intertoken_s", (now - t_prev) / delivered)
        if slot.request is request:  # not freed mid-chunk
            slot.last_token_at = now

    def _process_verify(self, entry: tuple) -> None:
        """Host half of a verify: the packed ``[B, k + 2]`` fetch (emitted
        tokens, accepted count; the ``verify`` fault site may poison one
        slot's row), then accept + 1 tokens a slot through
        ``_deliver_token``. A slot's accepted drafts count up to its real
        proposal's length (zero drafts that match the model are luck, not
        drafts); emitted tokens count per token delivered."""
        _, fetch, snapshot, proposed, t_dispatch, clean = entry
        host = fetch.result(self._fetch_bound())
        self._spmd_echo(wire.ECHO_VERIFY, host)
        if self._injector is not None:
            host = self._injector.corrupt_verify(host, snapshot)
        # one verify is one read of the weights: one step sample (the host
        # drained everything before dispatching it)
        now = time.monotonic()
        if snapshot and clean:
            self._note_step(now - t_dispatch)
        self._last_chunk_ready_t = now
        out, accept = host[:, :-1], host[:, -1]
        for idx, request in snapshot:
            slot = self._slots[idx]
            if slot.request is not request:  # freed / reassigned meanwhile
                continue
            slot.verify_iters += 1
            t_prev = slot.last_token_at
            delivered = 0
            n_acc = int(accept[idx])
            with self._stats_lock:
                if proposed[idx] > 0:
                    self.spec_accepted_tokens_total += min(n_acc, int(proposed[idx]))
                self.spec_slot_steps_total += 1
            for j in range(n_acc + 1):
                slot.position += 1
                token = int(out[idx, j])
                if token >= 0:
                    with self._stats_lock:
                        self.spec_emitted_tokens_total += 1
                    delivered += 1
                self._deliver_token(idx, token)
                if slot.request is not request:  # finished mid-verify
                    break
            if self._obs.on and delivered:
                self._obs.record("engine_accepted_tokens_per_step", delivered)
            self._record_intertoken(slot, request, t_prev, delivered)

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
            # the postmortem: the iterations that led here
            self._flight_dump("nan-quarantine", extra={"slot": idx})
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
            self._tenants.note_deadline(_tenant(request))
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
        index = self._spec_index.get(idx)
        if index is not None:
            # the next verify's drafts continue from the delivered token
            index.append(token)
        finished = None
        dfa = self._slot_dfa.get(idx)
        if dfa is not None:
            # the host half of constrained decoding: the device's advance
            # mirrored per delivered token (same table, so in lockstep);
            # a complete grammar finishes the request, and what the sink's
            # self-loop generated after it is dropped by the snapshot check
            state = self._dfa_host_state.get(idx, 0)
            nxt = dfa.advance(state, token)
            if nxt < 0:
                # unreachable while host and device share the table: off-
                # grammar output fails loudly, it never streams on
                self._finish_slot(idx, "error", error=RuntimeError(
                    f"constrained decode diverged at slot {idx}: token {token} is illegal "
                    f"in DFA state {state}"
                ))
                return
            self._dfa_host_state[idx] = nxt
            request.dfa_state = nxt  # before on_token: a callback reads the token's state
            if dfa.is_complete(nxt):
                finished = "stop"
        with self._stats_lock:
            self.total_generated += 1
        self._tenants.note_generated(_tenant(request))
        if request.on_token is not None:
            try:
                request.on_token(token)
            except Exception:  # noqa: BLE001 — a stream consumer must not kill the loop
                log.exception("on_token callback failed")
        # max_cost_tokens (prompt + generated) caps the length too
        if finished is None and (
            len(slot.generated) >= effective_max_new_tokens(opts, len(request.prompt_tokens))
            or slot.position >= self.max_seq_len - 1
        ):
            finished = "length"
        if finished is not None:
            self._finish_slot(idx, finished)

    def _note_tenant_admitted(self, request: GenerationRequest) -> None:
        """An admission bills its prompt's prefill tokens to its tenant."""
        self._tenants.note_admitted(_tenant(request), len(request.prompt_tokens))

    # -- the agentic tier ------------------------------------------------------

    def _resolve_agentic(self, request: GenerationRequest) -> bool:
        """Resolve a request's adapter name and grammar to their pool rows,
        refcounting both (a swap-in is enqueued on this thread's stream);
        idempotent, so a page-deferred retry resolves nothing again. A
        failure fails the request, never the engine: an unknown adapter
        with its KeyError; a pool pinned full by active requests
        (``AdapterPoolExhausted``, every grammar row pinned) sheds it with a
        retry-after; a resume state outside the grammar is a ValueError.
        Installs the finalize hook that releases both rows once, however
        the request ends."""
        if request._agentic_rows is not None:
            return True
        opts = request.options
        name = opts.adapter
        arow, grow = 0, 0
        try:
            if name:
                arow = self._adapters.acquire(name)
            if request._dfa is not None:
                t0 = time.monotonic()
                try:
                    grow = self._constrain_reg.acquire(request._dfa)
                except Exception:
                    if name:
                        self._adapters.release(name)
                    raise
                self._note_constrain_host((time.monotonic() - t0) * 1e3)
                with self._stats_lock:
                    self.constrained_requests_total += 1
        except Exception as e:  # noqa: BLE001 — fail the request, not the loop
            log.warning("agentic resolution failed: %s", e)
            if isinstance(e, AdapterPoolExhausted) or (
                request._dfa is not None and "pinned" in str(e)
            ):
                # every row pinned by active requests: a transient
                # saturation, shed with a retry-after
                self._count_shed(_tenant(request))
                e = ShedError(str(e), retry_after_s=max(self._queue_wait_ema_s, 0.25))
            request._finish(self._result(request, [], "error", error=e))
            return False
        state0 = 0
        if request._dfa is not None and opts.grammar_resume_state is not None:
            state0 = int(opts.grammar_resume_state)
            if not 0 <= state0 < request._dfa.n_states:
                # the carried state indexes another grammar: continuing
                # would emit off-grammar output dressed as valid
                if name:
                    self._adapters.release(name)
                self._constrain_reg.release(request._dfa)
                request._finish(self._result(request, [], "error", error=ValueError(
                    f"grammar-resume-state {state0} is out of range for this grammar "
                    f"({request._dfa.n_states} states) — the resumed stream's grammar "
                    "does not match"
                )))
                return False
        request._agentic_rows = (arow, grow, state0)

        def release() -> None:
            if name:
                self._adapters.release(name)
            if request._dfa is not None:
                self._constrain_reg.release(request._dfa)

        request._finalize = release
        return True

    def _row_agentic(self, requests: list, n: int) -> Optional[np.ndarray]:
        """Per-row (adapter row, grammar row, initial DFA state) of an
        admission of ``n`` rows as a ``[3, n]`` array (row j serves
        ``requests[j]``; pad rows are base rows at state 0); None with the
        tier off."""
        if not self._agentic:
            return None
        out = np.zeros((3, n), np.int64)
        for j, request in enumerate(requests[:n]):
            out[:, j] = request._agentic_rows or (0, 0, 0)
        return out

    def _slot_bind_agentic(self, idx: int, request: GenerationRequest) -> None:
        """Copy the request's resolved rows into the slot's host state when
        the slot activates; the device buffers follow at the next
        dispatch."""
        arow, grow, state0 = request._agentic_rows or (0, 0, 0)
        self._adapter_rows[idx] = arow
        self._adapter_rows_auth[idx] = arow
        self._g_rows[idx] = grow
        if request._dfa is not None:
            # a resumed derivation starts at its carried state: the
            # admission seeded the device state from the same one
            self._slot_dfa[idx] = request._dfa
            self._dfa_host_state[idx] = state0
            request.dfa_state = state0

    def _slot_clear_agentic(self, idx: int) -> None:
        self._adapter_rows[idx] = 0
        self._adapter_rows_auth[idx] = 0
        self._g_rows[idx] = 0
        self._slot_dfa.pop(idx, None)
        self._dfa_host_state.pop(idx, None)

    def _note_constrain_host(self, ms: float) -> None:
        """EMA of the host's constrained-decoding work (grammar swap-ins,
        verify state tables): ``constrain-overhead-ms``."""
        self._constrain_host_ema_ms = (
            ms if self._constrain_host_ema_ms == 0
            else 0.9 * self._constrain_host_ema_ms + 0.1 * ms
        )

    def _adapter_integrity_check(self) -> None:
        """Hold every active slot's dispatch-facing adapter row against the
        authoritative copy before a decode or verify dispatch (the
        ``adapter`` fault site's detection path: a corrupted row would serve
        a slot with another tenant's weights). A mismatch quarantines only
        that slot: its row is restored, its KV reset, its request failed,
        and an ``adapter-quarantine`` flight dump is left."""
        if self._adapters is None:
            return
        if self._injector is not None:
            snapshot = [(i, s.request) for i, s in enumerate(self._slots) if s.active]
            self._injector.corrupt_adapter_rows(self._adapter_rows, snapshot)
        for i, slot in enumerate(self._slots):
            if not slot.active or self._adapter_rows[i] == self._adapter_rows_auth[i]:
                continue
            with self._stats_lock:
                self.quarantined_slots_total += 1
            self._adapter_rows[i] = self._adapter_rows_auth[i]
            if self._paged:
                self._quarantine_pages(i)
            else:
                self._pending_row_resets.append(i)
            self._flight_dump("adapter-quarantine", extra={"slot": i})
            self._finish_slot(i, "error", error=RuntimeError(
                f"adapter-row corruption detected for slot {i}; slot quarantined"
            ))

    def adapter_advertisement(self) -> tuple[str, ...]:
        """Resident adapter names (never weights), for a router's adapter
        affinity."""
        return self._adapters.advertised() if self._adapters is not None else ()

    def register_adapter(self, spec) -> None:
        """Register an adapter at run time (host work; it becomes resident
        at its first request). Call while the engine serves only other
        adapters' traffic, or quiesce first."""
        if self._adapters is None:
            raise RuntimeError("this engine has no adapter registry")
        self._adapters.register(spec)

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
        now = time.monotonic()
        result = self._result(request, slot.generated, reason, slot.first_token_at, error)
        stamps = {
            "submitted": request.submitted_at,
            "admitted": slot.started_at or None,
            "first_token": slot.first_token_at or None,
            "finished": now,
        }
        attrs = {
            "slot": idx,
            "path": slot.path,
            "prompt_len": len(request.prompt_tokens),
            "generated_tokens": len(slot.generated),
            "finish_reason": reason,
            "prefill_chunks": slot.prefill_chunks,
            "decode_iterations": slot.decode_iters,
            "verify_dispatches": slot.verify_iters,
            "kv_pages": len(self._pagepool.slot_pages(idx)) if self._paged else 0,
        }
        slot.request = None
        slot.generated = []
        slot.position = 0
        slot.last_token_at = 0.0
        self._spec_index.pop(idx, None)
        self._slot_clear_agentic(idx)
        self._freed_slots.append(idx)
        if self._paged:
            self._free_slot_pages(idx)
        request._finish(result)
        if self._obs.on:
            # the request's lifecycle as one span tree, emitted once
            emit_request_spans(
                request.trace_id, stamps, attrs,
                status="ok" if error is None else f"error: {type(error).__name__}",
            )

    def _fail_all(self, error: BaseException) -> None:
        """Fail every request in flight or waiting; teardown first, every
        waiter woken last."""
        self._dead = error
        doomed: list[GenerationRequest] = list(self._page_deferred) + self._long_queue
        doomed += [st["request"] for st in self._longs.values()]
        if self._paged:
            for idx in self._longs:
                self._free_slot_pages(idx)
        if self._held_back is not None:
            doomed.append(self._held_back)
        self._page_deferred.clear()
        self._long_queue.clear()
        self._longs.clear()
        self._held_back = None
        self._spec_index.clear()
        for i, slot in enumerate(self._slots):
            if slot.request is not None:
                doomed.append(slot.request)
                slot.request = None
                slot.generated = []
                slot.position = 0
                self._slot_clear_agentic(i)
                if self._paged:
                    self._free_slot_pages(i)
        while True:
            try:
                doomed.append(self._queue.get_nowait())
            except queue.Empty:
                break
        with self._waiting_lock:
            self._waiting.clear()
        for request in doomed:
            request._finish(self._result(request, [], "error", error=error))
