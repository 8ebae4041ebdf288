"""Leader-broadcast SPMD dispatch — the port's ``parallel/spmd_serving.py``.

One logical serving replica spans N processes: the ranks of a mesh (one
process a card; ``resources.tpu.hosts`` pods, or the provider's follower
processes on one host); every process must run the SAME dispatches in the
same order for the model's collectives (and each rank's CUDA graphs) to
line up, but only the leader (process 0) owns the
broker consumer and the request queue. The leader therefore broadcasts,
before every device dispatch, a fixed-shape CONTROL BLOCK describing the
call (op + host-side inputs); followers sit in a replay loop executing the
identical `_dev_*` engine methods with the received inputs
(`serving/engine.py` call sites).

Protocol v2 (docs/SERVING.md §14): every host-side decision the
FAST paths make now rides the wire, so prefix reuse, self-speculative
decoding and ``kv_layout="paged"`` run under SPMD instead of being
construction-disabled:

- ``OP_VERIFY`` ships the leader's n-gram drafts (the index itself is
  deterministic given the replayed token stream, so only the drafts need
  the wire — acceptance is computed ON DEVICE identically on every host).
- ``OP_PREFIX_ADMIT`` / ``OP_PREFIX_PUBLISH`` replay the dense prefix
  cache's gather+suffix-segment admissions and copy-on-publish rows (the
  pool ROW index rides the wire; the radix trie stays leader-only).
- ``OP_PAGE_BIND`` / ``OP_PAGE_FREE`` / ``OP_PAGE_ZERO`` replay the paged
  allocator's observable RESULTS — the page lists bound to a slot
  (aliased prefix pages included, plus the one copy-on-write pair), table
  clears, and quarantine page-zero dispatches. Followers keep only the
  per-slot TABLES (what device dispatches read); the free list, refcounts
  and the prefix page index remain leader-only state.
- Every ``OP_DECODE``/``OP_VERIFY`` block carries an explicit ACTIVE-slot
  mask: the leader's slot liveness (a host-side property followers cannot
  observe — completions are discovered at fetch time) masks non-active
  page-table rows to the out-of-bounds sentinel on every host.
- ``OP_ROW_RESET`` replays the dense NaN-quarantine row zero, so an SPMD
  replica quarantines a poisoned slot victim-only
  instead of crashing the whole replica.
- ``OP_WARMUP`` replays a whole precompile family (decode ladder, verify
  ladder, paged surface, prefill buckets, prefix programs) as ONE
  announcement — both sides run the identical deterministic dispatch
  sequence from shared config, so the warmups stay off the hot wire.

Every announcement carries a monotonically increasing ``seq``; followers
verify contiguity. With ``echo`` enabled on the channel the leader also
re-broadcasts each decode/verify chunk's FETCHED tokens (``OP_ECHO``)
and the follower compares them against its own device results.

Slice resilience (docs/SERVING.md §20). The crash-only
multi-host contract is gone; three mechanisms replace it:

- ``OP_RECOVER`` + recovery epochs: a leader engine-loop crash under
  SPMD announces OP_RECOVER carrying a new epoch number instead of STOP.
  Both sides quarantine their in-flight device state and run the SAME
  deterministic rebuild (``engine._rebuild_device_state`` — the OP_WARMUP
  rule: identical config ⇒ identical dispatch sequence), the seq counter
  resets to the epoch base (0, so the first post-recovery announcement is
  seq 1), and the replica resumes under the leader's existing
  ``engine-restart-backoff``/``engine-max-restarts`` supervisor with
  QUEUED admissions preserved leader-side. Zero process exits.
- Watchdog: ``recv()`` takes a deadline (``watchdog_s`` on the channel —
  the ``spmd-watchdog-s`` knob). The leader announces OP_IDLE heartbeats
  whenever the wire would otherwise go quiet (idle iterations AND the
  restart-backoff wait), so silence past the deadline is evidence of a
  dead or wedged leader: the follower dumps a ``spmd-wedge`` flight
  record and exits with ``SpmdWedgeError`` (bounded-time detection
  instead of parking in the collective forever). The leader symmetrically
  bounds its per-iteration fetch waits by the same knob and escalates a
  wedged iteration to OP_RECOVER (``EngineWedgedError`` → the supervisor)
  instead of hanging the slice.
- Divergence resync: an echo TOKEN mismatch or a seq gap first requests
  ONE coordinated resync (``report_divergence`` — follower→leader via a
  shared flag on the loopback channel, via the process group's c10d
  store across processes, unsupported ⇒ the old fatal path). The
  leader answers with ``OP_RESYNC``: its authoritative per-slot page
  tables and device positions at a new epoch (the active-slot mask is
  per-dispatch wire data and needs no resync). The follower
  VERIFIES its own tables/positions against them — a match means the
  divergence was transient wire loss (e.g. a dropped idle heartbeat) and
  the follower rejoins at the new epoch; a mismatch, a second divergence
  while a resync is pending, or any divergence within ``resync_window_s``
  of the previous resync stays fatal (``SpmdDivergenceError`` + the
  ``spmd-divergence`` dump). Structural divergences (unknown op, echo
  SHAPE mismatch, failed replay) never attempt resync — leader and
  follower configs provably disagree and re-verification cannot help.
  Wrong output is never served from half the mesh.

The transport is ``torch.distributed.broadcast`` from rank 0 over the
mesh's gloo control group, of CPU int32 tensors (the float vectors ride
as their bit patterns): the control block never touches the card or the
NCCL stream, and every announcement is a lockstep point — followers park
inside the broadcast until the leader's next dispatch arrives. Each phase
of a block is ONE broadcast of its arrays concatenated; the arrays
themselves are the JAX package's ``_pack`` arrays, element for element.
The receive deadline is the broadcast's ``Work.wait(timeout)``; the
divergence side channel is the process group's c10d store. All
announcements are made from the leader's engine thread (and from
``start()`` before it exists), preserving a single total order; only the
follower loop's thread receives.

The port's engine differs in one place: its follower captures CUDA graphs
too. It captures them when it replays ``OP_WARMUP`` — one announcement a
graph set (``WARMUP_DECODE_LADDER`` / ``WARMUP_PAGED``: the decode set,
``WARMUP_VERIFY_LADDER``: the verify set), so both ranks capture the same
graphs, with the same collectives inside, in the same order; the prefill
and prefix families have nothing to capture in the port and replay as
nothing. ``OP_DECODE`` / ``OP_VERIFY`` carry the sampling branch of the
graph to replay in ``width`` (0 greedy, 1 sampled, 2 filtered). Ring
prefill (``OP_RING``): the leader streams a long prompt in chunks of
``prefill_batch x max_width`` tokens, the follower gathers them and, at
the final one, pads the prompt as the leader did (``_ring_pad``) and makes
the same ``_dev_ring`` dispatch — each rank its own block of the ring. A
loopback pair runs its ring through ``LoopbackRing``: two engines of one
process (one card) as seq ranks 0 and 1.

The tiers (the port's ops 17–23; JAX keeps these tiers off under SPMD
and serves them only on a single-process mesh): a swap-in's row and the
adapter's spec or the grammar's key (``OP_ADAPTER_SWAP`` /
``OP_GRAMMAR_SWAP``: each rank loads its slices of the factors, or
compiles the same planes), an admission's adapter / grammar rows and DFA
start states when one is not base (``OP_ADMIT_ROWS``), the per-slot rows
before a chunk that reads changed ones (``OP_SLOT_ROWS``), a verify's
per-position DFA states (``OP_VERIFY_STATES``), and the host KV tier's
spills and restores (``OP_HOST_SPILL`` / ``OP_HOST_RESTORE``: page ids and
arena slots; every rank copies its own shard into its own arena). A
restore's checksum verdict is agreed over the group (``agree``, a MIN of
the ranks' ok flags) before any rank uploads, so every rank takes the
same branch: the upload, or the counted recompute fallback.

Fixed shapes: collectives require every process to present identical
shapes, so the block is padded to (prefill_batch, max bucket width) and
sliced host-side after receipt. The page/draft/echo payloads get their own
fixed-shape buffers (sized from ``table_len`` / ``spec_tokens`` at
construction — identical on every process because the engine config is).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

_monotonic = time.monotonic

OP_IDLE = 0
OP_PREFILL = 1
OP_LONG_SEG = 2
OP_DECODE = 3
OP_STOP = 4
OP_RING = 5  # ring long-prefill: padded prompt streamed in token chunks
OP_VERIFY = 6  # speculative verify dispatch (drafts payload)
OP_PREFIX_ADMIT = 7  # dense warm admission: gather + suffix segment
OP_PREFIX_PUBLISH = 8  # dense copy-on-publish into a pool row
OP_PAGE_BIND = 9  # paged reservation result: slot's page list (+ COW pair)
OP_PAGE_FREE = 10  # slot's table clears (completion / quarantine / abort)
OP_PAGE_ZERO = 11  # quarantine page-zero dispatch
OP_ROW_RESET = 12  # dense NaN-quarantine row zero dispatch
OP_ECHO = 13  # leader's fetched chunk result (divergence check, optional)
OP_WARMUP = 14  # replay a whole precompile family (count = WARMUP_* kind)
OP_RECOVER = 15  # leader loop crashed: both sides rebuild (count = epoch)
OP_RESYNC = 16  # leader's authoritative tables/positions/mask (divergence
#                 resync; long_idx = epoch, count = payload elements)
# The port's own ops: the agentic tier and the host KV tier on the wire
# (JAX's 17 ops above pack byte-equal to the JAX channel's; these ride the
# same block, their state in the echo payload or the phase-1 vectors, never
# in a wider head). A payload longer than the echo buffer spans consecutive
# blocks of one op (``long_start`` / ``long_final``, ``s0`` = its total
# elements, ``announce_payload``); the follower acts on the last.
OP_ADAPTER_SWAP = 17  # long_idx = adapter pool row; payload = the spec's JSON
OP_GRAMMAR_SWAP = 18  # long_idx = grammar pool row; payload = the grammar key
OP_ADMIT_ROWS = 19  # the next admission's [adapter rows, grammar rows, DFA
#                     start states] (n_rows rows; only when one is not base)
OP_SLOT_ROWS = 20  # per-slot adapter rows (slots) and grammar rows (mask),
#                    phase 1 only; announced when they changed
OP_VERIFY_STATES = 21  # the verify's per-position DFA states [n_rows, width]
OP_HOST_SPILL = 22  # device pages → arena slots (payload [pages, slots])
OP_HOST_RESTORE = 23  # arena slots → device pages (payload [pages, slots]),
#                       the checksum verdict agreed over the group;
#                       width = 1 plants the follower-corruption drill

# the port's ops whose state rides the echo payload (``announce_payload``)
PAYLOAD_OPS = (OP_ADAPTER_SWAP, OP_GRAMMAR_SWAP, OP_ADMIT_ROWS, OP_VERIFY_STATES,
               OP_HOST_SPILL, OP_HOST_RESTORE)


def text_words(text: str) -> np.ndarray:
    """UTF-8 text as int32 words (4 bytes a word, zero-padded) for a
    payload; ``words_text`` inverts it given the byte length."""
    raw = text.encode()
    return np.frombuffer(raw + b"\0" * (-len(raw) % 4), np.int32).copy()


def words_text(words: np.ndarray, nbytes: int) -> str:
    return np.ascontiguousarray(words, np.int32).view(np.uint8)[:nbytes].tobytes().decode()


# OP_WARMUP kinds (ControlBlock.count)
WARMUP_DECODE_LADDER = 0
WARMUP_VERIFY_LADDER = 1
WARMUP_PAGED = 2
WARMUP_PREFILL_BUCKETS = 3
WARMUP_PREFIX_PROGRAMS = 4

# OP_ECHO kinds (ControlBlock.long_idx)
ECHO_DECODE = 0
ECHO_VERIFY = 1

# head vector layout (int32[_HEAD_LEN])
_H_OP = 0
_H_WIDTH = 1
_H_STEPS = 2
_H_NROWS = 3
_H_S0 = 4
_H_SEG_LEN = 5
_H_KV_BOUND = 6
_H_LONG_START = 7
_H_LONG_FINAL = 8
_H_LONG_IDX = 9
_H_PROMPT_LEN = 10
_H_T_LONG = 11
_H_ENTRY_ROW = 12  # prefix pool row (dense admit/publish, long warm start); -1 = none
_H_COW_SRC = 13  # copy-on-write source page (paged bind); -1 = none
_H_COW_DST = 14  # copy-on-write destination page; -1 = none
_H_SEQ = 15  # announcement sequence number (follower verifies contiguity)
_H_COUNT = 16  # page count / echo element count / warmup kind
_HEAD_LEN = 17


@dataclass
class ControlBlock:
    """One decoded announcement."""

    op: int
    width: int = 0
    steps: int = 0
    n_rows: int = 0
    s0: int = 0
    seg_len: int = 0
    kv_bound: int = 0
    long_start: bool = False
    long_final: bool = False
    long_idx: int = 0
    prompt_len: int = 0
    t_long: int = 0
    entry_row: int = -1
    cow_src: int = -1
    cow_dst: int = -1
    seq: int = 0
    count: int = 0
    tokens: Optional[np.ndarray] = None  # [n_rows, width] int32
    lengths: Optional[np.ndarray] = None  # [n_rows]
    slots: Optional[np.ndarray] = None  # [n_rows] (or stale idxs for DECODE)
    temps: Optional[np.ndarray] = None
    top_ks: Optional[np.ndarray] = None
    top_ps: Optional[np.ndarray] = None
    # active-slot mask [max_batch] (decode/verify: the leader's host-side
    # slot liveness — followers mask page-table rows with it)
    mask: Optional[np.ndarray] = None
    drafts: Optional[np.ndarray] = None  # [max_batch, k] int32 (OP_VERIFY)
    pages: Optional[np.ndarray] = None  # [count] int32 (bind/zero)
    echo: Optional[np.ndarray] = None  # flat int32[count] (OP_ECHO)


class SpmdChannel:
    """Fixed-shape broadcast channel between the replica's processes.

    ``table_len`` (paged layouts), ``spec_tokens`` (speculation) and
    ``decode_chunk`` size the page/draft/echo payload buffers; all derive
    from the engine config, so every process builds the identical channel.
    ``echo=True`` adds the leader→follower result echo after every
    processed decode/verify chunk (one extra broadcast per chunk — the
    divergence-detection mode the parity suite runs under; off by default
    in production).

    ``watchdog_s`` (the ``spmd-watchdog-s`` knob, 0 = off) arms the slice
    resilience machinery on BOTH sides: followers bound ``recv()`` by 2×
    it (the leader's own per-dispatch wait is bounded by 1×, so only
    silence past the leader's bound PLUS its escalation budget reads as
    dead → ``SpmdTimeout``), the leader announces OP_IDLE heartbeats at
    ``watchdog_s / 4`` whenever the wire would otherwise go quiet, and
    bounds its own per-iteration fetch waits by it. ``resync_window_s``
    is the follower's repeat-divergence window: a second divergence
    within it of a granted resync stays fatal. ``fault_injector`` drives the ``spmd-wedge`` (leader
    goes silent — every later announcement dropped) and ``spmd-drop``
    (one idle heartbeat lost → seq gap) drill sites at the transport
    layer (serving/faultinject.py)."""

    def __init__(
        self,
        prefill_batch: int,
        max_width: int,
        max_batch: int,
        table_len: int = 0,
        spec_tokens: int = 0,
        echo: bool = False,
        decode_chunk: int = 64,
        watchdog_s: float = 0.0,
        resync_window_s: float = 60.0,
        fault_injector: Optional[Any] = None,
        group: Optional[Any] = None,
        src: int = 0,
    ) -> None:
        # the gloo control group the blocks are broadcast over (None: the
        # default process group) and the leader's global rank
        self.group = group
        self.src = int(src)
        self.prefill_batch = int(prefill_batch)
        self.max_width = int(max_width)
        self.max_batch = int(max_batch)
        self.table_len = int(table_len)
        self.spec_tokens = int(spec_tokens)
        self.echo = bool(echo)
        self.decode_chunk = int(decode_chunk)
        self.watchdog_s = max(0.0, float(watchdog_s))
        self.resync_window_s = max(0.0, float(resync_window_s))
        # transport-layer fault injector (spmd-wedge / spmd-drop sites);
        # the ENGINE's injector is follower-nulled by follower_loop, this
        # one belongs to the channel itself
        self.injector = fault_injector
        # monotonic time of the last announce() ATTEMPT (wedged/dropped
        # announcements count — the leader believes it announced; that gap
        # between belief and wire is exactly what the watchdog detects)
        self.last_announce_t = 0.0
        self._wedged = False
        # divergence-resync bookkeeping (report_ on followers, poll_ on
        # the leader; the base transport carries requests through the
        # c10d store — one polled-counter lane per follower process)
        self._resync_reported = 0
        self._resync_polled: dict[int, int] = {}
        # slots/stale padded to max(prefill rows, batch) so DECODE's stale
        # list and PREFILL's slot list share one field
        self.n_pad = max(self.prefill_batch, self.max_batch)
        self.page_pad = max(1, self.table_len)
        self.draft_pad = max(1, self.spec_tokens)
        # echo buffer: big enough for a full decode chunk ([steps ≤
        # decode_chunk, B] — a chunk never exceeds the engine's configured
        # chunk size; the ctor default covers every chunk the engine knob
        # allows by default) and a verify result ([B, k+2]); announce()
        # asserts the fit so a mis-sized config fails loudly on the
        # leader, never as a silent truncation
        # ALSO sized for the OP_RESYNC payload (per-slot tables + device
        # positions, flattened int32 — docs/SERVING.md §20), which rides
        # the same buffer: resyncs are rare, a dedicated buffer would
        # bloat every recv's shape template for nothing
        self.echo_pad = max(
            self.prefill_batch * self.max_width,
            self.max_batch * (self.draft_pad + 2),
            self.max_batch * max(1, self.decode_chunk),
            self.max_batch * (self.table_len + 1),
        )
        # wire accounting: bytes broadcast per announce
        # — the measured ControlBlock overhead per engine iteration
        self.announces_total = 0
        self.bytes_announced_total = 0
        # verdicts agreed over the group (``agree``: the host tier's restores)
        self.agreements_total = 0
        self._seq = 0
        # immutable zero templates: _pack copies ONLY the arrays an op
        # actually writes (head/slots/mask + its payload kind) and passes
        # the shared read-only blanks for the rest — a head-only OP_DECODE
        # on the hot path must not allocate the (large) echo/drafts/token
        # buffers it never ships. recv() reuses the blanks as pure shape
        # templates (broadcast returns new arrays; inputs are not mutated).
        self._blank = self._zeros()
        for a in self._blank:
            a.setflags(write=False)

    # -- packing -------------------------------------------------------------

    def _zeros(self) -> tuple:
        return (
            np.zeros(_HEAD_LEN, np.int32),
            np.zeros((self.prefill_batch, self.max_width), np.int32),
            np.zeros(self.n_pad, np.int32),  # lengths
            np.zeros(self.n_pad, np.int32),  # slots / stale
            np.zeros(self.n_pad, np.float32),  # temps
            np.zeros(self.n_pad, np.int32),  # top_ks
            np.ones(self.n_pad, np.float32),  # top_ps
            np.zeros(self.max_batch, np.int32),  # active mask
            np.zeros((self.max_batch, self.draft_pad), np.int32),  # drafts
            np.full(self.page_pad, -1, np.int32),  # pages
            np.zeros(self.echo_pad, np.int32),  # echo
        )

    def _pack(self, block: ControlBlock) -> tuple:
        blank = self._blank
        kind = self._payload_kind(block.op)
        head, slots, mask = blank[0].copy(), blank[3].copy(), blank[7].copy()
        if kind == "tokens":
            tokens, lengths = blank[1].copy(), blank[2].copy()
            temps, top_ks, top_ps = (
                blank[4].copy(), blank[5].copy(), blank[6].copy()
            )
        else:
            tokens, lengths, temps, top_ks, top_ps = (
                blank[1], blank[2], blank[4], blank[5], blank[6]
            )
        drafts = blank[8].copy() if kind == "drafts" else blank[8]
        pages = blank[9].copy() if kind == "pages" else blank[9]
        echo = blank[10].copy() if kind == "echo" else blank[10]
        head[_H_OP] = block.op
        head[_H_WIDTH] = block.width
        head[_H_STEPS] = block.steps
        head[_H_NROWS] = block.n_rows
        head[_H_S0] = block.s0
        head[_H_SEG_LEN] = block.seg_len
        head[_H_KV_BOUND] = block.kv_bound
        head[_H_LONG_START] = int(block.long_start)
        head[_H_LONG_FINAL] = int(block.long_final)
        head[_H_LONG_IDX] = block.long_idx
        head[_H_PROMPT_LEN] = block.prompt_len
        head[_H_T_LONG] = block.t_long
        head[_H_ENTRY_ROW] = block.entry_row
        head[_H_COW_SRC] = block.cow_src
        head[_H_COW_DST] = block.cow_dst
        head[_H_SEQ] = block.seq
        head[_H_COUNT] = block.count

        def fill(dst: np.ndarray, src: Optional[np.ndarray]) -> None:
            if src is not None and len(src):
                dst[: len(src)] = src

        if block.tokens is not None:
            n, w = block.tokens.shape
            tokens[:n, :w] = block.tokens
        fill(lengths, block.lengths)
        fill(slots, block.slots)
        fill(temps, block.temps)
        fill(top_ks, block.top_ks)
        fill(top_ps, block.top_ps)
        fill(mask, block.mask)
        if block.drafts is not None:
            n, k = block.drafts.shape
            assert k <= self.draft_pad, (
                f"drafts k={k} exceed the channel's spec_tokens={self.draft_pad}"
            )
            drafts[:n, :k] = block.drafts
        if block.pages is not None:
            assert len(block.pages) <= self.page_pad, (
                f"{len(block.pages)} pages exceed the channel's "
                f"table_len={self.page_pad}"
            )
            pages[: len(block.pages)] = block.pages
        if block.echo is not None:
            flat = np.asarray(block.echo, np.int32).reshape(-1)
            assert len(flat) <= self.echo_pad, (
                f"echo of {len(flat)} elements exceeds the channel's "
                f"{self.echo_pad}-element buffer"
            )
            echo[: len(flat)] = flat
        return (
            head, tokens, lengths, slots, temps, top_ks, top_ps,
            mask, drafts, pages, echo,
        )

    def _unpack(self, packed: tuple) -> ControlBlock:
        (
            head, tokens, lengths, slots, temps, top_ks, top_ps,
            mask, drafts, pages, echo,
        ) = (np.asarray(x) for x in packed)
        n = int(head[_H_NROWS])
        w = int(head[_H_WIDTH])
        count = int(head[_H_COUNT])
        return ControlBlock(
            op=int(head[_H_OP]),
            width=w,
            steps=int(head[_H_STEPS]),
            n_rows=n,
            s0=int(head[_H_S0]),
            seg_len=int(head[_H_SEG_LEN]),
            kv_bound=int(head[_H_KV_BOUND]),
            long_start=bool(head[_H_LONG_START]),
            long_final=bool(head[_H_LONG_FINAL]),
            long_idx=int(head[_H_LONG_IDX]),
            prompt_len=int(head[_H_PROMPT_LEN]),
            t_long=int(head[_H_T_LONG]),
            entry_row=int(head[_H_ENTRY_ROW]),
            cow_src=int(head[_H_COW_SRC]),
            cow_dst=int(head[_H_COW_DST]),
            seq=int(head[_H_SEQ]),
            count=count,
            tokens=tokens[:n, :w] if w else tokens[:n],
            lengths=lengths[:n],
            slots=slots[:n],
            temps=temps[:n],
            top_ks=top_ks[:n],
            top_ps=top_ps[:n],
            mask=mask,
            drafts=drafts,
            pages=pages[:count],
            echo=echo[:count],
        )

    # -- transport -----------------------------------------------------------

    def _broadcast(self, payload: tuple, timeout_s: Optional[float] = None) -> tuple:
        """ONE ``dist.broadcast`` from rank ``src`` of the arrays of
        ``payload`` concatenated as int32 (float32 arrays by their bits) —
        the leader's values out, the follower's template shapes back
        filled. ``timeout_s`` bounds the wait (``SpmdTimeout``)."""
        import datetime

        import torch
        import torch.distributed as dist

        flat = np.concatenate([
            np.ascontiguousarray(a).view(np.int32).reshape(-1) for a in payload
        ])
        t = torch.from_numpy(flat)
        work = dist.broadcast(t, src=self.src, group=self.group, async_op=True)
        try:
            if timeout_s is not None and timeout_s > 0:
                work.wait(timeout=datetime.timedelta(seconds=timeout_s))
            else:
                work.wait()
        except RuntimeError as e:
            if timeout_s is not None and timeout_s > 0 and "timed out" in str(e).lower():
                raise SpmdTimeout(
                    f"no leader announcement within {timeout_s:.1f}s (spmd-watchdog-s)"
                ) from None
            raise
        out, at = [], 0
        got = t.numpy()
        for a in payload:
            n = a.size
            out.append(got[at : at + n].view(a.dtype).reshape(a.shape).copy())
            at += n
        return tuple(out)

    @staticmethod
    def _payload_kind(op: int) -> Optional[str]:
        """Which second-phase payload an op ships. DECODE/STOP/IDLE and the
        page/row bookkeeping ops carry everything in the head + phase-1
        vectors — two-phase keeps the per-decode-chunk hot path small."""
        if op in (OP_PREFILL, OP_LONG_SEG, OP_RING, OP_PREFIX_ADMIT):
            return "tokens"
        if op == OP_VERIFY:
            return "drafts"
        if op in (OP_PAGE_BIND, OP_PAGE_ZERO):
            return "pages"
        if op in (OP_ECHO, OP_RESYNC) or op in PAYLOAD_OPS:
            # OP_RESYNC reuses the echo buffer (tables ++ positions ++
            # mask, flattened; sized into echo_pad at construction), and
            # so do the port's payload ops
            return "echo"
        return None

    @classmethod
    def _phases(cls, packed: tuple, op: int) -> tuple[tuple, Optional[tuple]]:
        """Split one packed block into its broadcast phases: the phase-1
        triple every announcement ships, plus the op's payload phase (or
        None). The ONE definition both transports (broadcast + loopback)
        and both directions (announce + recv) build from, so the protocol
        cannot drift between them — the wire-byte accounting PERF.md
        presents as exact is summed off these same tuples."""
        (
            head, tokens, lengths, slots, temps, top_ks, top_ps,
            mask, drafts, pages, echo,
        ) = packed
        phase1 = (head, slots, mask)
        kind = cls._payload_kind(op)
        if kind == "tokens":
            return phase1, (tokens, lengths, temps, top_ks, top_ps)
        if kind == "drafts":
            return phase1, (drafts,)
        if kind == "pages":
            return phase1, (pages,)
        if kind == "echo":
            return phase1, (echo,)
        return phase1, None

    # seq is carried in an int32 head slot: wrap BELOW 2^31 so a replica
    # that lives through billions of announcements keeps running instead
    # of dying on a numpy OverflowError (followers wrap identically)
    SEQ_MOD = 0x7FFFFFFF

    def _next_seq(self) -> int:
        self._seq = self._seq % self.SEQ_MOD + 1
        return self._seq

    def reset_seq(self) -> None:
        """Leader: reset the announcement sequence to the epoch base after
        an OP_RECOVER/OP_RESYNC announcement — the first post-recovery
        announcement is seq 1, and the follower resets its contiguity
        tracker when it processes the recover/resync block, so both sides
        agree on the base without a handshake (docs/SERVING.md §20)."""
        self._seq = 0

    def _deliver(self, op: int) -> bool:
        """Transport-layer fault sites (drills — serving/faultinject.py):
        ``spmd-wedge`` silences the leader permanently (every later
        announcement dropped: the follower watchdog's detection target),
        ``spmd-drop`` loses ONE idle heartbeat (seq still consumed — the
        next delivered announcement carries the gap the resync drill
        detects). Both model wire loss: the leader believes it announced."""
        if self._wedged:
            return False
        inj = self.injector
        if inj is None:
            return True
        if inj.fires("spmd-wedge"):
            self._wedged = True
            return False
        if op == OP_IDLE and inj.fires("spmd-drop"):
            return False
        return True

    # -- divergence resync signalling ----------------------------------------
    #
    # The broadcast wire is one-way (leader → followers); the resync
    # REQUEST needs the opposite direction. The loopback channel carries
    # it as a shared flag (same process); the real transport uses the
    # process group's c10d store — followers set a monotonically numbered
    # key, the leader polls the next expected one (throttled by the
    # engine, never on a dispatch's critical path). Where neither exists
    # report_divergence returns False and the follower keeps the fatal
    # contract.

    @staticmethod
    def _kv_client():
        try:
            import torch.distributed as dist

            if not dist.is_initialized():
                return None
            return dist.distributed_c10d._get_default_store()
        except Exception:  # noqa: BLE001 — no store: no side channel
            return None

    def report_divergence(self, seq: int, op: int, why: str) -> bool:
        """Follower: ask the leader for one coordinated OP_RESYNC. True
        when the request was delivered (the follower then keeps replaying
        while it waits); False when no side channel exists (fatal path).
        Keys are namespaced by THIS follower's process index — every
        follower counts its own requests, so two followers diverging
        never collide on a key and the leader polls each lane
        independently."""
        import json

        import torch.distributed as dist

        client = self._kv_client()
        if client is None:
            return False
        try:
            self._resync_reported += 1
            client.set(
                f"lstpu-spmd-resync-p{dist.get_rank()}"
                f"-{self._resync_reported}",
                json.dumps({"seq": int(seq), "op": int(op), "why": str(why)}),
            )
            return True
        except Exception:  # noqa: BLE001 — coordinator gone ⇒ fatal path
            return False

    def poll_divergence(self) -> Optional[dict]:
        """Leader: the next pending resync request from ANY follower, or
        None. Non-blocking; the engine throttles calls to a few per
        second. One per-process polled counter per follower lane."""
        import json

        import torch.distributed as dist

        client = self._kv_client()
        if client is None:
            return None
        for proc in range(dist.get_world_size()):
            if proc == self.src:
                continue
            seen = self._resync_polled.get(proc, 0)
            key = f"lstpu-spmd-resync-p{proc}-{seen + 1}"
            try:
                raw = client.get(key) if client.check([key]) else None
            except Exception:  # noqa: BLE001 — store gone: nothing pending
                continue
            if not raw:
                continue
            self._resync_polled[proc] = seen + 1
            raw = raw.decode() if isinstance(raw, bytes) else raw
            try:
                req = json.loads(raw)
            except Exception:  # noqa: BLE001 — still a request, degraded
                req = {"why": "unparseable resync request"}
            req["process"] = proc
            return req
        return None

    def announce(self, block: ControlBlock) -> None:
        """Leader: publish the next device dispatch (engine thread only —
        announcements must form one total order). ONE prologue for every
        transport — seq assignment, the wedge/drop fault sites and the
        wire accounting live here so the loopback drills can never drift
        from the real broadcast; subclasses override only ``_send``."""
        self.last_announce_t = _monotonic()
        block.seq = self._next_seq()
        if not self._deliver(block.op):
            return
        packed = self._pack(block)
        phase1, payload = self._phases(packed, block.op)
        self._send(packed, phase1, payload)
        self.announces_total += 1
        self.bytes_announced_total += sum(a.nbytes for a in phase1) + (
            sum(a.nbytes for a in payload) if payload is not None else 0
        )

    def announce_payload(self, block: ControlBlock, data: np.ndarray) -> None:
        """Leader: announce ``block`` with ``data`` (int32, flattened) as
        its payload, over as many consecutive blocks as the echo buffer
        needs (``long_start`` on the first, ``long_final`` on the last,
        ``s0`` = the payload's elements on each)."""
        flat = np.asarray(data, np.int32).reshape(-1)
        cap = self.echo_pad
        n = max(1, -(-len(flat) // cap))
        for i in range(n):
            piece = flat[i * cap:(i + 1) * cap]
            self.announce(dataclasses.replace(
                block, echo=piece, count=len(piece), s0=len(flat),
                long_start=i == 0, long_final=i == n - 1,
            ))

    def agree(self, ok: bool, leader: bool = True) -> bool:
        """Every rank's verdict on one announced operation → True only when
        all are True (a MIN over the control group; each rank calls it in
        the same place of the block order). Bounded by the watchdog when it
        is armed (``SpmdTimeout``)."""
        import datetime

        import torch
        import torch.distributed as dist

        t = torch.tensor([1 if ok else 0], dtype=torch.int32)
        work = dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group, async_op=True)
        if self.watchdog_s > 0:
            try:
                work.wait(timeout=datetime.timedelta(seconds=2 * self.watchdog_s))
            except RuntimeError as e:
                raise SpmdTimeout(f"no verdict from every rank: {e}") from None
        else:
            work.wait()
        self.agreements_total += 1
        return bool(t.item())

    def _send(self, packed: tuple, phase1: tuple, payload) -> None:
        """Transport hook: put the announcement on the wire."""
        self._broadcast(phase1)
        if payload is not None:
            self._broadcast(payload)

    def recv(self, timeout_s: Optional[float] = None) -> ControlBlock:
        """Follower: block until the leader's next dispatch. With
        ``timeout_s`` the wait for the block's first phase is bounded by
        the broadcast's ``Work.wait(timeout)`` and ``SpmdTimeout`` is
        raised on expiry (a tripped watchdog means this process is about
        to exit, so the pending broadcast is abandoned with it)."""
        return self._recv_blocking(timeout_s)

    def close(self, timeout_s: float = 1.0) -> None:
        """Nothing to retire: the receive deadline needs no helper thread
        (kept for the JAX package's channel surface)."""

    def _recv_blocking(self, timeout_s: Optional[float] = None) -> ControlBlock:
        zeros = self._blank  # shape templates only; broadcast never mutates
        head, slots, mask = self._broadcast((zeros[0], zeros[3], zeros[7]), timeout_s)
        tokens, lengths, temps, top_ks, top_ps = (
            zeros[1], zeros[2], zeros[4], zeros[5], zeros[6]
        )
        drafts, pages, echo = zeros[8], zeros[9], zeros[10]
        kind = self._payload_kind(int(np.asarray(head)[_H_OP]))
        if kind == "tokens":
            tokens, lengths, temps, top_ks, top_ps = self._broadcast(
                (tokens, lengths, temps, top_ks, top_ps)
            )
        elif kind == "drafts":
            (drafts,) = self._broadcast((drafts,))
        elif kind == "pages":
            (pages,) = self._broadcast((pages,))
        elif kind == "echo":
            (echo,) = self._broadcast((echo,))
        return self._unpack((
            head, tokens, lengths, slots, temps, top_ks, top_ps,
            mask, drafts, pages, echo,
        ))


class LoopbackChannel(SpmdChannel):
    """In-process channel for tests and the multichip dryrun: announce
    enqueues the packed block, recv dequeues it. Exercises the exact
    pack/unpack/fixed-shape discipline of the real broadcast path, with a
    leader engine and a follower engine sharing one process (and one
    device mesh) — the state-lockstep property is identical."""

    def __init__(
        self,
        prefill_batch: int,
        max_width: int,
        max_batch: int,
        table_len: int = 0,
        spec_tokens: int = 0,
        echo: bool = False,
        decode_chunk: int = 64,
        watchdog_s: float = 0.0,
        resync_window_s: float = 60.0,
        fault_injector: Optional[Any] = None,
    ) -> None:
        super().__init__(
            prefill_batch, max_width, max_batch,
            table_len=table_len, spec_tokens=spec_tokens, echo=echo,
            decode_chunk=decode_chunk, watchdog_s=watchdog_s,
            resync_window_s=resync_window_s, fault_injector=fault_injector,
        )
        import queue as _queue
        import threading as _threading

        self._q: Any = _queue.Queue()
        # the leader's and the follower's verdicts (``agree``)
        self._verdicts = (_queue.Queue(), _queue.Queue())
        # same-process resync side channel (report_/poll_divergence)
        self._div_lock = _threading.Lock()
        self._div_req: Optional[dict] = None

    def _send(self, packed: tuple, phase1: tuple, payload) -> None:
        # the shared announce() prologue already split phases / counted
        # bytes off the SAME splitter the broadcast transport uses —
        # loopback benches measure the real per-iteration wire overhead
        self._q.put(packed)

    def recv(self, timeout_s: Optional[float] = None) -> ControlBlock:
        import queue as _queue

        try:
            packed = (
                self._q.get(timeout=timeout_s)
                if timeout_s is not None and timeout_s > 0
                else self._q.get()
            )
        except _queue.Empty:
            raise SpmdTimeout(
                f"no leader announcement within {timeout_s:.1f}s "
                "(spmd-watchdog-s)"
            ) from None
        return self._unpack(packed)

    def agree(self, ok: bool, leader: bool = True) -> bool:
        import queue as _queue

        # the pair's verdicts cross through one queue each way
        mine, theirs = self._verdicts if leader else self._verdicts[::-1]
        mine.put(bool(ok))
        try:
            other = theirs.get(timeout=2 * self.watchdog_s if self.watchdog_s > 0 else None)
        except _queue.Empty:
            raise SpmdTimeout("no verdict from the other rank") from None
        self.agreements_total += 1
        return bool(ok) and other

    def report_divergence(self, seq: int, op: int, why: str) -> bool:
        with self._div_lock:
            self._div_req = {"seq": int(seq), "op": int(op), "why": str(why)}
        return True

    def poll_divergence(self) -> Optional[dict]:
        with self._div_lock:
            req, self._div_req = self._div_req, None
        return req


class LoopbackRing:
    """A ring handle (``parallel.ring_attention``) for ``n`` seq ranks in
    ONE process: a loopback pair's leader and follower engines (one card,
    or the CPU), each on its own thread. Used by tests and
    ``chip_smoke.py`` — NCCL cannot put two ranks of one group on one card,
    so this is how a seq ring runs on a single card; the provider never
    builds it. ``LoopbackRing.ranks(n)`` makes the handles.

    Every operation is an exchange: each rank deposits its tensors (and,
    on the card, an event its stream recorded after making them), waits
    until every rank has deposited, and reads the others'. A reader's
    stream waits on the writer's event, and each tensor it reads is marked
    in use by the reader's stream (``record_stream``), so the writer's
    allocator cannot hand the memory out again before the reader is done.
    Deposited tensors are never written again; the sum and the gather
    return new tensors, made in rank order (bit-equal on every rank)."""

    class _Hub:
        def __init__(self, n: int, timeout_s: float) -> None:
            import threading as _threading

            self.n = n
            self.timeout_s = timeout_s
            self.cond = _threading.Condition()
            self.calls = [0] * n
            self.slots: dict = {}

        def exchange(self, rank: int, value: tuple) -> list:
            with self.cond:
                key = self.calls[rank]
                self.calls[rank] += 1
                slot = self.slots.setdefault(key, {"values": [None] * self.n, "read": 0})
                slot["values"][rank] = value
                self.cond.notify_all()
                if not self.cond.wait_for(
                    lambda: all(v is not None for v in slot["values"]), self.timeout_s
                ):
                    raise RuntimeError(
                        f"loopback ring: rank {rank} waited {self.timeout_s:.0f}s at exchange "
                        f"{key} for the other ranks"
                    )
                slot["read"] += 1
                if slot["read"] == self.n:
                    del self.slots[key]
                return list(slot["values"])

    def __init__(self, hub: "LoopbackRing._Hub", rank: int) -> None:
        self._hub = hub
        self.n = hub.n
        self.rank = rank

    @classmethod
    def ranks(cls, n: int = 2, timeout_s: float = 600.0) -> list["LoopbackRing"]:
        hub = cls._Hub(n, timeout_s)
        return [cls(hub, r) for r in range(n)]

    def _exchange(self, tensors: tuple) -> list:
        import torch

        event = None
        if tensors[0].device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        got = self._hub.exchange(self.rank, (tensors, event))
        out = []
        for r, (ts, ev) in enumerate(got):
            if ev is not None and r != self.rank:
                stream = torch.cuda.current_stream(ts[0].device)
                stream.wait_event(ev)
                for t in ts:
                    t.record_stream(stream)
            out.append(ts)
        return out

    def permute(self, *tensors):
        """This rank's tensors to the next rank; the previous rank's back."""
        return list(self._exchange(tensors)[(self.rank - 1) % self.n])

    def all_reduce(self, x):
        """The sum over the ranks, in rank order (a new tensor)."""
        parts = [ts[0] for ts in self._exchange((x,))]
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total

    def all_gather(self, x):
        """``[n, *x.shape]``, rank order (a new tensor)."""
        import torch

        return torch.stack([ts[0] for ts in self._exchange((x,))])


class SpmdDivergenceError(RuntimeError):
    """Leader and follower state provably disagree (echo mismatch, sequence
    gap, or an un-replayable block) and a resync was unavailable, already
    pending, inside the repeat window, or failed verification. The replica
    must crash and restart together — continuing would serve garbage from
    half the mesh. ``resyncable`` marks detections a coordinated OP_RESYNC
    may heal (token-level echo mismatch, seq gap); structural disagreements
    (unknown op, shape mismatch, failed replay) never are."""

    def __init__(self, message: str, resyncable: bool = False) -> None:
        super().__init__(message)
        self.resyncable = resyncable


class SpmdTimeout(RuntimeError):
    """``recv(timeout_s)`` expired with no leader announcement — the
    watchdog's raw signal (docs/SERVING.md §20)."""


class SpmdWedgeError(RuntimeError):
    """The follower watchdog detected a silenced leader: no announcement
    (idle heartbeats included) within ``watchdog_s``. The follower has
    dumped a ``spmd-wedge`` flight record and exits deliberately so the
    replica's pods restart together instead of parking in the collective
    forever."""


def follower_loop(
    engine: Any, channel: SpmdChannel, watchdog_s: Optional[float] = None,
    on_warmup: Optional[Callable[[], None]] = None,
) -> None:
    """Replay the leader's dispatches on a follower process. ``engine`` is
    a ServingEngine constructed with the SAME config/params/mesh/seed but
    never start()ed (its graphs are captured as OP_WARMUP replays) — only
    its device-touching ``_dev_*`` methods (and the
    page-table bookkeeping the wire replays) run, so its sharded state
    evolves in lockstep with the leader's.

    Slice resilience (docs/SERVING.md §20): OP_RECOVER runs the same
    deterministic device rebuild the leader's crash recovery runs and
    rejoins at the announced epoch (zero process exits); a seq gap or an
    echo TOKEN mismatch requests ONE coordinated OP_RESYNC and keeps
    replaying while it waits — the resync block's authoritative
    tables/positions must VERIFY against this side's or the divergence is
    fatal after all; ``watchdog_s`` (default: the channel's) bounds every
    recv, and silence past it dumps ``spmd-wedge`` and raises
    SpmdWedgeError. Structural failures (unknown op, shape drift, a replay
    that raises) stay fatal by design, with the ``spmd-divergence`` flight
    dump tagged with the ControlBlock seq as the incident artifact.
    ``on_warmup`` runs after each replayed OP_WARMUP (a follower process
    zeroes its kernel counts there, so its exit line counts served work)."""
    import logging
    from collections import deque

    log = logging.getLogger(__name__)
    # a follower must never fire its own faults: the leader's announced ops
    # already reflect ITS injector, and an independent follower schedule
    # would diverge the replicas by construction
    engine._injector = None
    # a follower's rebuild (OP_RECOVER) does not capture: the leader's
    # OP_WARMUP announcements that follow it do
    engine._spmd_follower = True
    # device results of replayed decode/verify dispatches, kept only while
    # the channel runs in echo (divergence-check) mode; OP_ECHO pops the
    # oldest — leader processes fetches in dispatch order, so FIFO order
    # matches by construction
    pending_echo: deque = deque()
    last_seq = 0
    # strict next-seq expectation. None ONLY before the very first block
    # (a follower may attach mid-stream); after an OP_RECOVER/OP_RESYNC
    # epoch reset the expectation is exactly 1 — losing the FIRST
    # post-epoch announcement must read as the gap it is, not slip
    # through a relaxed sentinel check
    expected_seq: Optional[int] = None
    # divergence-resync state: one request may be outstanding, and a
    # granted resync opens a repeat window inside which any further
    # divergence is fatal (transient wire loss does not repeat; real
    # state divergence does)
    resync_pending = False
    last_resync_t = 0.0

    def _divergence(block: ControlBlock, why: str, resyncable: bool) -> bool:
        """True = a resync was requested (keep replaying); raises when the
        divergence must stay fatal."""
        nonlocal resync_pending
        now = time.monotonic()
        if (
            not resyncable
            or resync_pending
            or (last_resync_t and now - last_resync_t < channel.resync_window_s)
            or not channel.report_divergence(block.seq, block.op, why)
        ):
            _fail_divergence(engine, block, why, resyncable=resyncable)
        log.warning(
            "SPMD divergence at seq %d (op %d): %s — resync requested",
            block.seq, block.op, why,
        )
        _dump_divergence(engine, block, why + " (resync requested)")
        resync_pending = True
        return True

    while True:
        # re-read per iteration: the channel's watchdog_s is the live
        # knob (drills arm it after warmup; cold-start compiles on the
        # leader's engine thread can exceed any sane bound, so the bound
        # only means something once the replica is warm)
        wd = channel.watchdog_s if watchdog_s is None else max(0.0, watchdog_s)
        if expected_seq is None and watchdog_s is None:
            # before the first block: a follower process may be up before
            # its leader has built its engine, so the wait is unbounded
            wd = 0.0
        try:
            # deadline = 2× the bound: the LEADER's own per-dispatch wait
            # is bounded by watchdog_s, so a leader mid-escalation (silent
            # while it waits out a wedged fetch, then announcing
            # OP_RECOVER) must never read as dead — only silence past the
            # leader's bound PLUS its escalation budget is. This is the
            # "detection within 2× spmd-watchdog-s" contract (§20).
            block = channel.recv(timeout_s=2 * wd if wd > 0 else None)
        except SpmdTimeout as e:
            # the leader is dead or wedged: leave the incident artifact
            # and exit deliberately (bounded-time detection — the whole
            # point of the watchdog) instead of blocking forever
            log.error("SPMD follower watchdog tripped: %s", e)
            try:
                engine._flight_dump(
                    "spmd-wedge",
                    extra={
                        "last-seq": last_seq,
                        "watchdog-s": wd,
                        "why": str(e),
                    },
                )
            except Exception:  # noqa: BLE001 — the exit must proceed
                log.exception("spmd-wedge dump failed")
            raise SpmdWedgeError(
                f"leader silent past 2x the {wd:.1f}s watchdog (last seq "
                f"{last_seq}); follower exiting for a coordinated restart"
            ) from e
        if block.seq:
            if expected_seq is not None and block.seq != expected_seq:
                _divergence(
                    block,
                    f"announcement sequence gap: got seq {block.seq} after "
                    f"{last_seq} (expected {expected_seq}; a block was "
                    "lost or reordered)",
                    resyncable=True,
                )
            last_seq = block.seq
            expected_seq = block.seq % SpmdChannel.SEQ_MOD + 1  # wrap rule
        if block.op == OP_STOP:
            stop = getattr(engine, "_spmd_follower_stop", None)  # a stand-in engine has none
            if stop is not None:
                stop()
            channel.close()
            return
        if block.op == OP_IDLE:
            continue
        if block.op == OP_RECOVER:
            # leader loop crash: run the IDENTICAL deterministic rebuild
            # (the OP_WARMUP rule — same config, same dispatch sequence),
            # drop any unechoed replay results (the leader's in-flight
            # chunks died unprocessed), and rejoin at the epoch base
            log.warning(
                "SPMD leader announced recovery (epoch %d); rebuilding "
                "device state in place", block.count,
            )
            pending_echo.clear()
            engine._spmd_follower_recover(block.count)
            last_seq = 0
            expected_seq = 1  # the epoch base — strictly
            resync_pending = False
            # the full rebuild wiped whatever state the repeat-divergence
            # window was guarding — a post-rebuild transient drop gets a
            # fresh one-resync allowance instead of a stale fatality
            last_resync_t = 0.0
            continue
        if block.op == OP_RESYNC:
            _apply_resync(engine, block)  # raises when verification fails
            log.warning(
                "SPMD resync verified; rejoining at epoch %d", block.long_idx,
            )
            last_seq = 0
            expected_seq = 1  # the epoch base — strictly
            resync_pending = False
            last_resync_t = time.monotonic()
            continue
        try:
            _replay(engine, block, channel, pending_echo)
            if block.op == OP_WARMUP and on_warmup is not None:
                on_warmup()
        except SpmdDivergenceError as e:
            if not getattr(e, "resyncable", False):
                raise
            _divergence(block, str(e), resyncable=True)
        except Exception:
            log.exception("SPMD replay failed (op=%d); crashing replica", block.op)
            _dump_divergence(engine, block, "replay raised")
            raise


def _dump_divergence(engine: Any, block: ControlBlock, why: str) -> None:
    """Best-effort flight-recorder dump on a detected divergence — the
    SPMD incident artifact. Debounced per reason like every other dump
    path (a resync storm must not write N dumps per second); the FIRST
    detection in a burst is the evidence that matters."""
    try:
        engine._flight_dump(
            "spmd-divergence",
            extra={"seq": block.seq, "op": block.op, "why": why},
        )
    except Exception:  # noqa: BLE001 — the crash must proceed regardless
        import logging

        logging.getLogger(__name__).exception("divergence dump failed")


def _fail_divergence(
    engine: Any, block: ControlBlock, why: str, resyncable: bool = False,
) -> None:
    _dump_divergence(engine, block, why)
    raise SpmdDivergenceError(
        f"SPMD divergence at seq {block.seq} (op {block.op}): {why}",
        resyncable=resyncable,
    )


def _apply_resync(engine: Any, block: ControlBlock) -> None:
    """Verify the leader's authoritative OP_RESYNC snapshot against this
    follower's state: per-slot page tables (paged layouts) and device
    positions must MATCH — a match proves the divergence was transient
    wire loss and the follower rejoins; a mismatch means real state
    divergence and stays fatal (non-resyncable — a second resync could
    not change the verdict). The active-slot mask is NOT part of the
    snapshot: it is per-dispatch wire data, re-shipped authoritatively
    on every decode/verify block."""
    b, tl = block.n_rows, block.width
    data = np.asarray(block.echo[: block.count], np.int32)
    if block.count != b * tl + b or len(data) != block.count:
        _fail_divergence(
            engine, block,
            f"resync payload shape mismatch: {block.count} elements for "
            f"{b} slots × table_len {tl} (config drift between hosts)",
        )
    if tl:
        theirs = data[: b * tl].reshape(b, tl)
        mine = np.asarray(engine._pagepool.tables[:b, :tl], np.int32)
        if not np.array_equal(mine, theirs):
            _fail_divergence(
                engine, block,
                "resync verification failed: per-slot page tables diverged "
                "(real allocator-state divergence, not wire loss)",
            )
    # positions are held for the slots active on the leader now (the
    # block's mask): a masked slot's chain reads the shared sink page, whose
    # bytes rows race for, so the port leaves it out (JAX holds every slot)
    live = np.asarray(block.mask)[:b] != 0
    theirs_pos = np.where(live, data[b * tl :], 0)
    mine_pos = np.where(live, engine._positions_dev.cpu().numpy().astype(np.int32)[:b], 0)
    if not np.array_equal(mine_pos, theirs_pos):
        _fail_divergence(
            engine, block,
            "resync verification failed: device positions diverged (a "
            "material dispatch was lost, not just a heartbeat)",
        )


def _i64(a: Optional[np.ndarray]) -> np.ndarray:
    return np.asarray(a, np.int64)


def _replay(
    engine: Any,
    block: ControlBlock,
    channel: SpmdChannel,
    pending_echo,
) -> None:
    if block.op == OP_PREFILL:
        # pad rows ride with slot max_batch (the JAX engine's out-of-range
        # slot); the real rows come first
        rows = int(np.count_nonzero(np.asarray(block.slots) < engine.max_batch))
        engine._dev_prefill(
            _i64(block.tokens),
            _i64(block.lengths),
            np.asarray(block.temps, np.float32),
            _i64(block.top_ks),
            np.asarray(block.top_ps, np.float32),
            _i64(block.slots),
            rows,
            engine._spmd_take_admit_rows(block.n_rows),
        )
    elif block.op == OP_LONG_SEG:
        if engine._paged:
            # paged segments (long-prompt chunks AND warm suffix segments)
            # write straight into the slot's wire-bound pages
            engine._dev_paged_segment(
                _i64(block.tokens),
                block.s0,
                block.seg_len,
                block.long_idx,
                float(block.temps[0]),
                int(block.top_ks[0]),
                float(block.top_ps[0]),
                final=block.long_final,
                prompt_len=block.prompt_len,
                agentic=engine._spmd_take_admit_rows(1),
            )
        else:
            engine._dev_long_segment(
                _i64(block.tokens),
                block.s0,
                block.seg_len,
                block.kv_bound,
                block.t_long,
                float(block.temps[0]),
                int(block.top_ks[0]),
                float(block.top_ps[0]),
                start=block.long_start,
                final=block.long_final,
                idx=block.long_idx,
                prompt_len=block.prompt_len,
                prefix_row=block.entry_row if block.entry_row >= 0 else None,
                agentic=engine._spmd_take_admit_rows(1),
            )
    elif block.op == OP_DECODE:
        if channel.echo:
            pos0, cap = engine._positions_dev.cpu().numpy(), engine._echo_capacity(block.mask)
        # kv_bound=0 replays an unbounded chunk; width is the branch
        chunk = engine._dev_decode(
            block.steps, list(block.slots), block.kv_bound or None, mask=block.mask,
            branch=block.width,
        )
        if channel.echo:
            # the output buffer is static: the next replay overwrites it
            pending_echo.append((ECHO_DECODE, chunk.clone(),
                                 _echo_valid(ECHO_DECODE, tuple(chunk.shape), pos0, cap,
                                             block.mask)))
    elif block.op == OP_VERIFY:
        if channel.echo:
            pos0, cap = engine._positions_dev.cpu().numpy(), engine._echo_capacity(block.mask)
        k = block.steps  # drafts per slot (engine.spec_tokens on the leader)
        packed = engine._dev_verify(
            _i64(block.drafts[:, :k]),
            list(block.slots),
            block.kv_bound or None,
            mask=block.mask,
            branch=block.width,
        )
        if channel.echo:
            pending_echo.append((ECHO_VERIFY, packed.clone(),
                                 _echo_valid(ECHO_VERIFY, tuple(packed.shape), pos0, cap,
                                             block.mask)))
    elif block.op == OP_PREFIX_ADMIT:
        engine._dev_prefix_admit(
            _i64(block.tokens),
            block.s0,
            block.seg_len,
            block.kv_bound,
            block.entry_row,
            float(block.temps[0]),
            int(block.top_ks[0]),
            float(block.top_ps[0]),
            block.long_idx,
            block.prompt_len,
            engine._spmd_take_admit_rows(1),
        )
    elif block.op == OP_PREFIX_PUBLISH:
        engine._dev_prefix_publish(block.long_idx, block.entry_row)
    elif block.op == OP_PAGE_BIND:
        engine._spmd_apply_bind(
            block.long_idx,
            [int(p) for p in block.pages],
            block.cow_src if block.cow_src >= 0 else None,
            block.cow_dst if block.cow_dst >= 0 else None,
        )
    elif block.op == OP_PAGE_FREE:
        # the follower tracks TABLES only (never the free list/refcounts —
        # future reservations arrive as explicit BIND results)
        engine._pagepool.free_slot(block.long_idx)
    elif block.op == OP_PAGE_ZERO:
        engine._dev_page_zero([int(p) for p in block.pages])
    elif block.op == OP_ROW_RESET:
        engine._dev_row_reset([int(i) for i in block.slots])
    elif block.op == OP_WARMUP:
        _replay_warmup(engine, block)
    elif block.op == OP_ECHO:
        _check_echo(engine, block, pending_echo)
    elif block.op == OP_RING:
        # the prompt streams in (prefill_batch x max_width)-token chunks;
        # the final chunk fires the one-dispatch ring admit
        if block.long_start:
            engine._spmd_ring_buf.clear()
        engine._spmd_ring_buf.append(
            np.asarray(block.tokens, np.int32).reshape(-1)[: block.seg_len]
        )
        if block.long_final:
            prompt = np.concatenate(engine._spmd_ring_buf)
            engine._spmd_ring_buf.clear()
            # the leader's padding, derived from the shared config: only
            # the prompt itself rides the wire
            s_pad = engine._ring_pad(block.prompt_len) if engine._ring_admit else None
            if s_pad is None or len(prompt) != block.prompt_len:
                _fail_divergence(
                    engine, block,
                    f"OP_RING: {len(prompt)} of {block.prompt_len} prompt tokens, padding "
                    f"{s_pad} (this rank has no ring admit, or lost a chunk)",
                )
            tokens = np.zeros((1, s_pad), np.int64)
            tokens[0, : len(prompt)] = prompt
            engine._dev_ring(
                tokens,
                block.prompt_len,
                float(block.temps[0]),
                int(block.top_ks[0]),
                float(block.top_ps[0]),
                block.long_idx,
                engine._spmd_take_admit_rows(1),
            )
    elif block.op == OP_SLOT_ROWS:
        engine._spmd_apply_slot_rows(block.slots, block.mask)
    elif block.op in PAYLOAD_OPS:
        data = _gather_payload(engine, block)
        if data is not None:
            _replay_payload(engine, block, data)
    else:
        _fail_divergence(engine, block, f"unknown op {block.op}")


def _gather_payload(engine: Any, block: ControlBlock) -> Optional[np.ndarray]:
    """A payload op's elements once its last block arrived (None before)."""
    buf = engine._spmd_payload_buf
    if block.long_start:
        buf.clear()
    buf.append(np.asarray(block.echo[: block.count], np.int32).copy())
    if not block.long_final:
        return None
    data = np.concatenate(buf)
    buf.clear()
    if len(data) != block.s0:
        _fail_divergence(
            engine, block, f"payload of {len(data)} of {block.s0} elements (a block was lost)",
        )
    return data


def _replay_payload(engine: Any, block: ControlBlock, data: np.ndarray) -> None:
    """The port's payload ops (the agentic tier and the host KV tier)."""
    op, n = block.op, block.n_rows
    if op == OP_ADAPTER_SWAP:
        engine._spmd_adapter_swap(block.long_idx, words_text(data, block.prompt_len))
    elif op == OP_GRAMMAR_SWAP:
        engine._spmd_grammar_swap(block.long_idx, words_text(data, block.prompt_len))
    elif op == OP_ADMIT_ROWS:
        engine._spmd_admit_rows = data.reshape(3, n).astype(np.int64)
    elif op == OP_VERIFY_STATES:
        engine._spmd_verify_states(data.reshape(n, block.width))
    elif op == OP_HOST_SPILL:
        engine._spmd_host_spill(data[:n], data[n:])
    else:  # OP_HOST_RESTORE
        engine._spmd_host_restore(data[:n], data[n:], drill=bool(block.width))


def _replay_warmup(engine: Any, block: ControlBlock) -> None:
    """Capture the announced graph set — both sides capture the identical
    chunks (same config ⇒ same shapes, the same collectives inside, the
    same generator draws), one announcement a set. The prefill-bucket and
    prefix-program families have nothing to capture in the port."""
    kind = block.count
    if kind in (WARMUP_DECODE_LADDER, WARMUP_PAGED):
        engine._capture_set("decode")
    elif kind == WARMUP_VERIFY_LADDER:
        engine._capture_set("verify")
    elif kind in (WARMUP_PREFILL_BUCKETS, WARMUP_PREFIX_PROGRAMS):
        return
    else:
        _fail_divergence(engine, block, f"unknown warmup kind {kind}")


def _echo_valid(kind: int, shape: tuple, pos0: np.ndarray, cap: np.ndarray,
                mask: np.ndarray) -> np.ndarray:
    """The elements of a dispatch's output the echo check compares: those
    of active rows (``mask``) computed from K/V inside the row's reserved
    columns (``cap``: its pages x page size, or max_seq_len dense), given
    its position before the dispatch ``pos0``. A position past the
    reservation writes its K/V into the shared sink, where rows' writes
    collide in one scatter and the winner is not deterministic; the
    leader never delivers those tokens, and its JAX counterpart drops the
    writes instead. Decode ``[steps, B]``: step s of row b when ``pos0 + s
    < cap``. Verify ``[B, k + 2]``: column j when ``pos0 + j < cap``, the
    accepted count when the whole window fits."""
    pos0 = np.asarray(pos0, np.int64)
    cap = np.asarray(cap, np.int64)
    live = np.asarray(mask) != 0
    if kind == ECHO_DECODE:
        steps = shape[0]
        return live[None, :] & (pos0[None, :] + np.arange(steps)[:, None] < cap[None, :])
    k1 = shape[1] - 1
    cols = pos0[:, None] + np.arange(k1)[None, :] < cap[:, None]
    accept = (pos0 + k1 - 1 < cap)[:, None]
    return np.concatenate([cols, accept], axis=1) & live[:, None]


def _check_echo(engine: Any, block: ControlBlock, pending_echo) -> None:
    """Compare the leader's fetched chunk tokens against the follower's own
    device result for the same dispatch — the strongest per-chunk
    divergence check the protocol offers (opt-in: one device→host copy per
    chunk on the follower). Only the elements ``_echo_valid`` names are
    compared; the shapes always are."""
    if not pending_echo:
        _fail_divergence(
            engine, block, "echo arrived with no pending replayed dispatch"
        )
    kind, dev, valid = pending_echo.popleft()
    if kind != block.long_idx:
        _fail_divergence(
            engine, block,
            f"echo kind mismatch: leader says {block.long_idx}, follower "
            f"replayed {kind}",
        )
    full = np.asarray(dev.cpu().numpy(), np.int32).reshape(-1)
    if len(full) != block.count:
        # a shape drift (e.g. mismatched spec_tokens/decode_chunk config)
        # must report as the divergence it is — checked against the FULL
        # follower result, in either direction, before any truncation
        _fail_divergence(
            engine, block,
            f"echo length mismatch: leader sent {block.count} elements, "
            f"follower's replayed result has {len(full)}",
        )
    keep = np.asarray(valid).reshape(-1)
    mine = np.where(keep, full[: block.count], 0)
    theirs = np.where(keep, np.asarray(block.echo[: block.count], np.int32), 0)
    if not np.array_equal(mine, theirs):
        # token-level disagreement is the one divergence class a transient
        # cause (one corrupted broadcast) can explain — resync-eligible;
        # if it repeats, the window rule makes it fatal (§20)
        bad = int(np.argmax(mine != theirs))
        _fail_divergence(
            engine, block,
            f"token divergence at element {bad}: leader {int(theirs[bad])} "
            f"vs follower {int(mine[bad])}",
            resyncable=True,
        )


def main(argv: Optional[list] = None) -> int:
    """A follower rank as its own process: ``python -m
    langstream_tpu_torch.parallel.spmd_serving --config '<resource JSON>'
    --rank R --world N --init-method file:///...`` joins the process
    group, builds the same engine as the leader's provider on
    ``cuda:(R % device_count)`` (or the CPU with ``device: cpu``) without
    starting it, and replays the leader's announcements until OP_STOP —
    the JAX package's follower entrypoint. Exits 0 on a clean stop."""
    import argparse
    import json
    import logging
    import sys

    parser = argparse.ArgumentParser(prog="langstream_tpu_torch.parallel.spmd_serving")
    parser.add_argument("--config", required=True, help="the tpu-serving resource, as JSON")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init-method", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    resource = json.loads(args.config)
    service = TorchCompletionsService(resource, rank=args.rank, world=args.world,
                                      init_method=args.init_method)
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts

    engine = service.build_engine(start=False)
    try:
        # counts zeroed after each announced capture: the exit line counts
        # the replays of served work only, as the fleet replica's does
        follower_loop(engine, service.spmd_channel(), on_warmup=reset_kernel_counts)
    finally:
        service.release_follower()
    # the exit line: this rank's kernel launches since its last capture,
    # and its share of the tiers (host-tier pages, swaps, its arena)
    launches = {k: v["launches"] for k, v in kernel_counts().items()}
    tier = {
        "spill-pages": engine.spill_pages_total, "restore-pages": engine.restore_pages_total,
        "restore-failures": engine.restore_failures_total, "restore-s": engine.restore_s_total,
        "arena-bytes": engine._host_tier.bytes_total if engine._host_tier is not None else 0,
    }
    for name, reg in (("adapter", engine._adapters), ("grammar", engine._constrain_reg)):
        if reg is not None:
            tier[f"{name}-swaps"], tier[f"{name}-swap-s"] = reg.swaps_total, reg.swap_s_total
    print(json.dumps({"follower": args.rank, "exit": "stop", "kernels": launches,
                      "tier": tier}), flush=True)
    return 0


if __name__ == "__main__":
    # ``python -m`` runs this file as ``__main__``, a second copy of its
    # globals: call the IMPORTED module's main, which the engine's
    # imports share
    import sys

    from langstream_tpu_torch.parallel import spmd_serving as _mod

    sys.exit(_mod.main())
