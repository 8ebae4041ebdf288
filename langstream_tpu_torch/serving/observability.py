"""Engine observability of the port: its own copy of
``langstream_tpu/serving/observability.py`` — streaming histograms, the
request-lifecycle spans and the flight recorder.

- **Histograms** (``ENGINE_HISTOGRAMS``, ``api/metrics.Histogram``): the
  same names, bucket bounds and help texts as the JAX engine's. The engine
  records TTFT, inter-token latency, queue wait, prefill dispatch, decode
  (or verify) step time, accepted tokens per verify and fetch latency
  where the JAX engine records them — every sample on the host, never
  inside a captured chunk — and the host KV tier's spill (on its worker)
  and restore (on the admission path) and the durable tier's checkpoint
  and restore.
- **Load score** (``load_score``): queue-wait p90 + slot occupancy +
  page-pool pressure, the brownout controller's input.
- **Request spans** (``emit_request_spans``): one ``engine.request`` span a
  request with ``engine.queued`` / ``engine.prefill`` / ``engine.decode``
  children, built from phase stamps once, at completion, into the port's
  ``tracing.TRACER``.
- **Flight recorder** (``FlightRecorder``): a ring of the last N engine
  iterations, dumped as JSON (schema ``lstpu-flight-v1``, never token
  content: ``validate_flight_dump`` refuses a dump that carries it) when a
  NaN or page quarantine, an engine restart, a shed burst, a brownout
  transition, a stalled restore (``spill-stall``) or a failed durable
  restore (``durable-restore-failed``) fires, and on ``stats(dump=True)``. ``flight_dir`` (or
  ``LSTPU_FLIGHT_DIR``) also writes each dump to a file. In the port an
  iteration's ``programs`` counts the engine's distinct captured graphs.

Host code only: no torch import.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

from langstream_tpu_torch.api.metrics import Histogram, log_buckets
from langstream_tpu_torch.tracing import TRACER, Span

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Histogram taxonomy (docs/SERVING.md §12 — names, units, what moves them)
# ---------------------------------------------------------------------------

ENGINE_HISTOGRAMS: dict[str, dict[str, Any]] = {
    "engine_ttft_s": {
        "help": "time to first token, submit to first delivered token (s)",
        "buckets": log_buckets(1e-3, 120.0, 4),
    },
    "engine_intertoken_s": {
        "help": "inter-token latency per slot, consecutive deliveries (s)",
        "buckets": log_buckets(1e-4, 10.0, 4),
    },
    "engine_queue_wait_s": {
        "help": "admission queue wait, submit to queue exit (s)",
        "buckets": log_buckets(1e-4, 120.0, 4),
    },
    "engine_prefill_dispatch_s": {
        "help": "host wall time of one prefill/segment dispatch (s)",
        "buckets": log_buckets(1e-4, 60.0, 4),
    },
    "engine_decode_step_s": {
        "help": "device decode/verify step time, per token step (s)",
        "buckets": log_buckets(1e-5, 10.0, 4),
    },
    "engine_accepted_tokens_per_step": {
        "help": "tokens emitted per slot per verify dispatch (speculation)",
        "buckets": (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0),
    },
    "engine_fetch_s": {
        "help": "device-to-host token fetch latency per chunk (s)",
        "buckets": log_buckets(1e-4, 10.0, 4),
    },
    # tiered KV (docs/SERVING.md §16): spill runs on its dedicated worker
    # thread (device→host copy + arena write + checksum, per entry);
    # restore runs ON the admission path (host→device upload of a
    # hibernated prefix) — its tail is literally added TTFT, which is why
    # it gets its own histogram instead of folding into prefill dispatch
    "engine_spill_s": {
        "help": "host-tier spill (device→host copy + checksum) per entry (s)",
        "buckets": log_buckets(1e-4, 60.0, 4),
    },
    "engine_restore_s": {
        "help": "host-tier restore (host→device page upload) per warm "
                "admission (s)",
        "buckets": log_buckets(1e-4, 60.0, 4),
    },
    # durable session tier (docs/SERVING.md §23): checkpoint runs on the
    # durable worker thread (arena/device bytes → temp+fsync+rename frame
    # stream, per entry); restore runs ON the admission path (disk read +
    # CRC/checksum verify + device upload of a checkpointed prefix) — its
    # tail is added TTFT for a resurrected session, same reasoning as
    # engine_restore_s above, one tier further down
    "engine_durable_checkpoint_s": {
        "help": "durable-tier checkpoint (serialize + fsync + rename) per "
                "entry (s)",
        "buckets": log_buckets(1e-4, 120.0, 4),
    },
    "engine_durable_restore_s": {
        "help": "durable-tier restore (disk read + verify + device "
                "upload) per resurrected admission (s)",
        "buckets": log_buckets(1e-4, 120.0, 4),
    },
    # cold start (docs/SERVING.md §22): one sample per engine
    # build — checkpoint-to-device wall time of the weight load (streamed
    # pipeline or eager). Sparse by design (engines build once), but the
    # fleet-wide histogram is exactly the scale-up drill's headline: a
    # replica resurrected against a warm compile cache should be weight-
    # load-bound, and this is that bound
    "engine_weight_load_s": {
        "help": "checkpoint→device weight load per engine build, read + "
                "transform + transfer wall (s)",
        "buckets": log_buckets(1e-2, 600.0, 4),
    },
}


# the fleet router's distributions (serving/fleet.py): owned by the router,
# not the engine — the same names, bucket bounds and help texts as the JAX
# package's
FLEET_HISTOGRAMS: dict[str, dict[str, Any]] = {
    "fleet_hop_s": {
        "help": "remote fleet hop wall time, dispatch to terminal frame "
                "OR hop failure (s) — failed/wedged hops count, so the "
                "tail moves during incidents",
        "buckets": log_buckets(1e-3, 600.0, 4),
    },
    # one sample per attempted KV-page migration, snapshot to ACK or to the
    # failure that sent the stream to decode in place
    "fleet_migrate_s": {
        "help": "KV-page migration wall time, snapshot dispatch to "
                "receiver ACK or failure (s) — failed migrations count",
        "buckets": log_buckets(1e-4, 120.0, 4),
    },
}


def build_histograms() -> dict[str, Histogram]:
    return {
        name: Histogram(name, spec["help"], spec["buckets"])
        for name, spec in ENGINE_HISTOGRAMS.items()
    }


def load_score(
    queue_wait_p90_s: float, occupancy: float, page_pressure: float
) -> float:
    """Per-engine load score for the (future) cache-aware balancer:
    queue-wait p90 (seconds — the dominant term under real overload) +
    slot occupancy (0..1) + page-pool pressure (0..1). Higher = more
    loaded; compare across replicas, not against a threshold."""
    return round(
        max(0.0, queue_wait_p90_s)
        + min(max(occupancy, 0.0), 1.0)
        + min(max(page_pressure, 0.0), 1.0),
        4,
    )


# ---------------------------------------------------------------------------
# Request-lifecycle spans
# ---------------------------------------------------------------------------


def _span_id() -> str:
    return uuid.uuid4().hex[:16]


def emit_request_spans(
    trace_id: Optional[str],
    stamps: dict[str, float],
    attributes: dict[str, Any],
    status: str = "ok",
) -> Optional[str]:
    """Emit the per-request span tree from monotonic phase ``stamps``
    (``submitted`` required; ``admitted`` / ``first_token`` / ``finished``
    optional — missing phases collapse: a request cancelled in queue gets
    only the root + ``engine.queued``). Returns the trace id used.

    Called ONCE per request at completion, from the engine thread (or the
    expiry sweep) — never from the token delivery loop."""
    if not TRACER.enabled:
        return trace_id
    submitted = stamps.get("submitted")
    if submitted is None:
        return trace_id
    now_mono = time.monotonic()
    finished = stamps.get("finished", now_mono)
    offset = time.time() - now_mono  # monotonic → wall conversion
    trace_id = trace_id or uuid.uuid4().hex[:16]
    root = Span(
        name="engine.request",
        trace_id=trace_id,
        span_id=_span_id(),
        parent_id=None,
        start_s=submitted + offset,
        duration_s=max(0.0, finished - submitted),
        attributes=dict(attributes),
        status=status,
    )
    children: list[Span] = []

    def child(name: str, start: float, end: float, **attrs: Any) -> None:
        children.append(
            Span(
                name=name,
                trace_id=trace_id,
                span_id=_span_id(),
                parent_id=root.span_id,
                start_s=start + offset,
                duration_s=max(0.0, end - start),
                attributes=attrs,
            )
        )

    admitted = stamps.get("admitted")
    first_token = stamps.get("first_token")
    child(
        "engine.queued",
        submitted,
        admitted if admitted is not None else finished,
        slot=attributes.get("slot", -1),
    )
    if admitted is not None:
        child(
            "engine.prefill",
            admitted,
            first_token if first_token is not None else finished,
            slot=attributes.get("slot", -1),
            path=attributes.get("path", ""),
            prefill_chunks=attributes.get("prefill_chunks", 0),
        )
    if first_token is not None:
        child(
            "engine.decode",
            first_token,
            finished,
            slot=attributes.get("slot", -1),
            decode_iterations=attributes.get("decode_iterations", 0),
            verify_dispatches=attributes.get("verify_dispatches", 0),
        )
    # children first so /traces consumers see a complete tree the moment
    # the root appears
    for span in children:
        TRACER.emit(span)
    TRACER.emit(root)
    return trace_id


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

FLIGHT_SCHEMA = "lstpu-flight-v1"

# every ring entry carries at least these (engine._iterate builds them);
# extra keys are allowed, token CONTENT is not (see validate_flight_dump)
ITERATION_FIELDS = (
    "i",        # engine iteration number (monotonic, counts idle too)
    "t",        # wall-clock seconds
    "active",   # active decode slots
    "queued",   # admission queue depth
    "dispatch", # "decode" | "verify" | "" (nothing dispatched)
    "steps",    # decode steps (or k+1 verify width) dispatched
    "kv_pages", # physical pages in use (0 under the dense layout)
    "host_pages", # host-tier arena slots in use (0 with the tier off)
    "programs", # distinct compiled device programs so far
    "phase_ms", # {"sweep","prefill","dispatch","process","spill","restore"}
                # host-wall ms (spill/restore are 0 with the tier off)
)

# token content must never reach a dump: dumps travel to incident channels
_FORBIDDEN_KEYS = frozenset(
    {"tokens", "token", "prompt", "prompt_tokens", "generated", "text",
     "drafts", "value"}
)

DUMP_REASONS = (
    "nan-quarantine", "page-quarantine", "adapter-quarantine",
    "engine-restart", "shed-burst",
    "on-demand",
    # a host-tier restore blocked an admission past the bound (slow host
    # RAM, checksum thrash, or a spill the hit had to wait out) — dumped
    # by the engine's restore path, token-content-free like every reason
    "spill-stall",
    # SPMD leader/follower disagreement (echo mismatch, sequence gap, or a
    # failed replay): dumped on the FOLLOWER, tagged with the ControlBlock
    # seq — on first detection a resync is requested (§20) and the dump is
    # the evidence; a fatal repeat/structural divergence dumps the same
    # reason (debounced per reason like every dump path)
    "spmd-divergence",
    # a replica died mid-STREAM on the fleet wire and the router re-
    # dispatched prompt + delivered tokens to a survivor (docs/SERVING.md
    # §17): dumped by the ROUTER's recorder with the hop's frame TRACE
    # (seq/kind/count metadata, never token content) in extra — its
    # iteration ring is empty because the router runs no engine loop
    "fleet-failover",
    # a KV-page migration between replicas failed (checksum mismatch,
    # wire cut, deadline, receiver pool exhaustion — docs/SERVING.md
    # §18): dumped by the ROUTER with per-phase timings (snapshot /
    # transfer / bind ms) and the fallback taken, never page content
    "migrate-failed",
    # the brownout controller walked the degradation ladder (either
    # direction — docs/SERVING.md §19): dumped with the level, the step
    # name and the load score that drove it, so a postmortem shows WHAT
    # the engine turned off (and back on) under the overload it captured
    "brownout",
    # SPMD slice resilience (docs/SERVING.md §20). spmd-recover: the
    # LEADER entered coordinated recovery — an engine-loop crash answered
    # with OP_RECOVER at a fresh epoch (extra: epoch, error, restart), or
    # a follower divergence report answered with OP_RESYNC (extra: kind
    # "resync", the follower's request). spmd-wedge: the FOLLOWER
    # watchdog detected a silenced leader (no announcement, heartbeats
    # included, within spmd-watchdog-s) and is exiting for a coordinated
    # pod restart — the dump (extra: last-seq, watchdog-s) is the
    # incident artifact a hung slice otherwise never leaves
    "spmd-recover",
    "spmd-wedge",
    # a P2P page fetch from a prefix-owning peer failed (checksum, cut
    # wire, deadline, owner gone — docs/SERVING.md §21): dumped by the
    # ROUTER with the owner/destination ids, the advertised match depth
    # and the fallback taken (local cold prefill), never page content
    "p2p-fetch-failed",
    # a durable-tier restore failed (torn/corrupt checkpoint, stale
    # manifest, missing object, stalled or full volume — docs/SERVING.md
    # §23): dumped by the ENGINE's admit path with the entry digest, the
    # failure and the fallback taken (local cold prefill) — the entry is
    # marked dead so the failure fires once, never page or token content
    "durable-restore-failed",
)

# process-global recent dumps (newest last): the runtime HTTP server's
# /flight endpoint reads this without holding an engine reference. The
# lock covers append AND copy — iterating a deque while another thread
# appends raises, and /flight must not 500 at the exact moment an
# incident produces a dump
RECENT_DUMPS: deque = deque(maxlen=8)
_RECENT_LOCK = threading.Lock()


def recent_dumps() -> list[dict[str, Any]]:
    with _RECENT_LOCK:
        return list(RECENT_DUMPS)


class FlightRecorder:
    """Bounded ring of per-iteration engine records. ``record`` is engine-
    thread-only and lock-cheap (one deque append under a lock); ``dump``
    may be called from any thread (submit-side shed bursts) and is
    debounced per reason so a fault storm produces one artifact, not
    hundreds."""

    # lock discipline registry (analysis pass `locks`): ring, dump
    # sequencing and the shed-burst window are all record/dump
    # cross-thread state.
    _GUARDED = {
        "_lock": ("_ring", "_seq", "_last_dump_t", "_shed_window"),
    }

    def __init__(
        self,
        capacity: int = 256,
        dump_dir: Optional[str] = None,
        min_dump_interval_s: float = 2.0,
    ) -> None:
        self.capacity = max(8, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dump_dir = dump_dir
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._last_dump_t: dict[str, float] = {}
        self._seq = 0
        self.dumps_total = 0
        self.last_dump: Optional[dict[str, Any]] = None
        # shed-burst detection: sheds within a sliding 1s window
        self._shed_window: deque = deque(maxlen=64)
        self.shed_burst_threshold = 5

    def record(self, entry: dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(entry)

    def iterations(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def note_shed(self) -> bool:
        """Register one shed; True when the 1s sliding window crosses the
        burst threshold (the caller then dumps with reason shed-burst)."""
        now = time.monotonic()
        with self._lock:
            self._shed_window.append(now)
            recent = sum(1 for t in self._shed_window if now - t <= 1.0)
        return recent >= self.shed_burst_threshold

    def dump(
        self,
        reason: str,
        counters: Optional[dict[str, Any]] = None,
        extra: Optional[dict[str, Any]] = None,
        force: bool = False,
    ) -> Optional[dict[str, Any]]:
        """Snapshot the ring into a postmortem artifact. Returns the dump
        dict (also kept as ``last_dump``, appended to ``RECENT_DUMPS`` and
        written under ``dump_dir`` when set), or None when debounced."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_dump_t.get(reason, -1e9) < (
                self.min_dump_interval_s
            ):
                return None
            self._last_dump_t[reason] = now
            iterations = list(self._ring)
            self._seq += 1
            seq = self._seq
        doc: dict[str, Any] = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "at": round(time.time(), 3),
            "seq": seq,
            "iterations": iterations,
            "counters": dict(counters or {}),
            "extra": dict(extra or {}),
        }
        self.last_dump = doc
        self.dumps_total += 1
        with _RECENT_LOCK:
            RECENT_DUMPS.append(doc)
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir, f"flight-{seq:04d}-{reason}.json"
                )
                with open(path, "w") as f:
                    json.dump(doc, f, indent=1)
                log.warning("flight recorder dumped %d iteration(s) to %s "
                            "(reason: %s)", len(iterations), path, reason)
            except OSError:
                log.exception("flight recorder dump write failed")
        else:
            log.warning(
                "flight recorder dumped %d iteration(s) in memory (reason: %s)",
                len(iterations), reason,
            )
        return doc


def _walk_forbidden(obj: Any, path: str) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            if str(k) in _FORBIDDEN_KEYS:
                raise ValueError(
                    f"flight dump carries token-content key {k!r} at {path}"
                )
            _walk_forbidden(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk_forbidden(v, f"{path}[{i}]")


def validate_flight_dump(doc: dict[str, Any]) -> bool:
    """Validate a dump against the documented schema (docs/SERVING.md §12):
    raises ValueError with the first violation, returns True when clean.
    Used by the chaos CI step and the observability tests — the schema IS
    the contract incident tooling parses."""
    if not isinstance(doc, dict):
        raise ValueError("flight dump must be a JSON object")
    if doc.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(f"unknown flight schema {doc.get('schema')!r}")
    if doc.get("reason") not in DUMP_REASONS:
        raise ValueError(f"unknown dump reason {doc.get('reason')!r}")
    if not isinstance(doc.get("at"), (int, float)):
        raise ValueError("dump missing numeric 'at' timestamp")
    iterations = doc.get("iterations")
    if not isinstance(iterations, list):
        raise ValueError("dump missing 'iterations' list")
    for j, entry in enumerate(iterations):
        if not isinstance(entry, dict):
            raise ValueError(f"iteration {j} is not an object")
        for key in ITERATION_FIELDS:
            if key not in entry:
                raise ValueError(f"iteration {j} missing field {key!r}")
    if not isinstance(doc.get("counters"), dict):
        raise ValueError("dump missing 'counters' object")
    _walk_forbidden(doc, "$")
    json.dumps(doc)  # must be plain-serializable end to end
    return True


# ---------------------------------------------------------------------------
# Engine-facing bundle
# ---------------------------------------------------------------------------


class EngineObservability:
    """Everything the engine consults, behind one ``on`` flag so the
    `observability: off` escape hatch (and the overhead bench's off leg)
    is a single branch on the hot paths."""

    def __init__(
        self,
        enabled: bool = True,
        flight_capacity: int = 256,
        flight_dir: Optional[str] = None,
    ) -> None:
        self.on = bool(enabled)
        self.hist: dict[str, Histogram] = build_histograms() if self.on else {}
        self.flight = FlightRecorder(
            capacity=flight_capacity,
            dump_dir=flight_dir
            if flight_dir is not None
            else (os.environ.get("LSTPU_FLIGHT_DIR") or None),
        )

    def record(self, name: str, value: float) -> None:
        h = self.hist.get(name)
        if h is not None:
            h.record(value)

    def histograms(self) -> dict[str, dict[str, Any]]:
        return {name: h.snapshot() for name, h in self.hist.items()}

    def reset_histograms(self) -> None:
        for h in self.hist.values():
            h.reset()
