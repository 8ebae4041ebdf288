"""Fleet router over serving-engine replicas (the port's own copy of the
in-process half of ``langstream_tpu/serving/fleet.py``): prefix-affinity
routing, cache-aware load balancing, disaggregated prefill/decode with
KV-page migration, and the peer-to-peer prefix fetch.

- **Beacons** (``beacon_from_engine``): each replica advertises a compact
  state document — its ``load_score``, queue-wait EMA, free KV pages,
  drain / quarantine / recovering flags, role, wire capabilities and the
  top-K prefix DIGESTS its radix index holds (``pagepool.prefix_digest``:
  8-byte hashes, never token content). The probes behind it
  (``stats()``, ``prefix_advertisement``) never touch LRU recency.

- **Router** (``FleetRouter``): prefix affinity first, load second. It
  hashes the prompt at every advertised boundary and scores each replica

      score(r) = expected_match_tokens(r) − λ · load_score(r)

  routing to the argmax, or to the least-loaded replica when nobody holds
  a usable prefix. Sticky sessions keep a chat on the replica whose pages
  it aliased; overload sheds against the replicas' own exported signals;
  a replica that dies mid-stream is quarantined and the stream resumes on
  a survivor with ``prompt + delivered`` tokens.

- **Disaggregated prefill/decode**: with a ``prefill``- and a
  ``decode``-tagged replica routable, a prompt whose estimated prefill
  reaches ``prefill_route_threshold`` prefills and samples its first
  token on the prefill replica; its published prefix's pages then migrate
  (``serving/migrate.py``) into the decode replica, where the stream
  resumes warm. Every failure of the transfer decodes in place on the
  prefill replica, with the same tokens.

- **P2P fetch**: when another live replica advertises the prompt's prefix
  at least ``p2p_threshold`` tokens deeper than the routed one, the router
  copies the pages from the owner (which keeps them) before dispatch, and
  the prompt admits warm.

- **Autoscale hints** (``desired_replicas``, ``desired_replicas_by_role``).

Transports are duck-typed: ``InProcessReplica`` serves an engine of this
process, ``HttpReplica`` a replica in another process behind its runtime
HTTP server (``runtime/http_server.py``; stdlib ``urllib`` on the client
side). Between processes a migration is pushed over ``POST /fleet/migrate``
and a P2P fetch pulled over ``POST /fleet/pages`` (``serving/migrate.py``);
peers that advertise the ``kvmig2`` / ``frames2`` caps speak the v2 binary
codecs (``serving/wire.py``), others v1 NDJSON.

Run ``python -m langstream_tpu_torch.serving.fleet --config '<json>'`` to
serve one replica (engine, ``/state``, ``/fleet/*``) as a standalone
process: it prints ``{"url": ..., "replica": ...}`` once its engine is warm
and serves until its stdin closes.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import os
import queue
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

from langstream_tpu_torch.api.metrics import Histogram, log_buckets
from langstream_tpu_torch.models.configs import GenerationOptions
from langstream_tpu_torch.serving import lifecycle
from langstream_tpu_torch.serving import migrate as migrate_mod
from langstream_tpu_torch.serving import wire as wire_mod
from langstream_tpu_torch.serving.engine import GenerationRequest, ShedError
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.migrate import MigrationError
from langstream_tpu_torch.serving.observability import FLEET_HISTOGRAMS, FlightRecorder
from langstream_tpu_torch.serving.pagepool import prefix_digest

log = logging.getLogger(__name__)

BEACON_SCHEMA = "lstpu-beacon-v1"
STATE_SCHEMA = "lstpu-state-v1"

# the fleet hop's streaming frame protocol (docs/SERVING.md §17):
# newline-delimited JSON frames over chunked transfer-encoding, one
# monotone per-request ``seq`` per frame starting at 0. Frame kinds:
#   tokens     {"seq", "kind": "tokens", "tokens": [ids]} — a token chunk
#   heartbeat  {"seq", "kind": "heartbeat"} — idle keepalive, so the
#              client can tell slow-decode (heartbeats flow) from a dead
#              peer (the wire goes silent past its idle timeout)
#   end        terminal: finish_reason + usage + ttft_s/total_s — a stream
#              that closes WITHOUT one is a failed hop, never a success
#   error      terminal: the engine failed after streaming began (token
#              content already delivered stays valid for failover resume)
FRAME_SCHEMA = "lstpu-frames-v1"

# hop budget when the request carries no deadline of its own; with one,
# the hop is bounded by the REMAINING deadline + slack (hop_timeout_s) —
# a 10s-deadline request must never hold a connection for 10 minutes
DEFAULT_HOP_TIMEOUT_S = 600.0
HOP_DEADLINE_SLACK_S = 5.0


def hop_timeout_s(
    options: Optional[dict], default: float = DEFAULT_HOP_TIMEOUT_S,
) -> float:
    """Total wall budget for one fleet hop, derived from the request's own
    ``deadline`` option (plus transport/queue slack) when it has one. The
    deadline ALSO rides the hop payload, so the peer's engine enforces it
    server-side; this bound is the client's backstop for a wedged peer."""
    # GenerationOptions.from_dict owns the option-key spellings: parsing
    # them here again would let the engine enforce a deadline the hop
    # doesn't see. A malformed options dict falls back to the default —
    # the peer's own parse will reject it properly.
    try:
        d = GenerationOptions.from_dict(options or {}).deadline_s
    except (TypeError, ValueError, KeyError):
        return float(default)
    if d is None or d <= 0:
        return float(default)
    return min(float(default), d + HOP_DEADLINE_SLACK_S)


# ---------------------------------------------------------------------------
# Wire fault injector (docs/SERVING.md §17): ONE process-wide injector for
# the net-* sites, consulted by the HttpReplica transport (net-connect), the
# /fleet/generate streaming handler (net-stall / net-cut / net-corrupt) and
# the migration export (``migrate``: a corrupted page payload; ``net-cut``:
# a stream cut between frames). Separate from the engine's injector — the
# wire is a different failure domain — but activated the same two ways:
# set_wire_injector() in tests / the replica server's config, or the
# LSTPU_FAULTS env spec.
# ---------------------------------------------------------------------------

_WIRE_LOCK = threading.Lock()
_WIRE_INJECTOR: Optional[Any] = None
_WIRE_ENV_CHECKED = False


def set_wire_injector(injector: Optional[Any]) -> None:
    """Install (or, with None, clear) the process-wide wire injector."""
    global _WIRE_INJECTOR, _WIRE_ENV_CHECKED
    with _WIRE_LOCK:
        _WIRE_INJECTOR = injector
        _WIRE_ENV_CHECKED = True


def wire_injector() -> Optional[Any]:
    global _WIRE_INJECTOR, _WIRE_ENV_CHECKED
    with _WIRE_LOCK:
        if not _WIRE_ENV_CHECKED:
            _WIRE_INJECTOR = FaultInjector.from_env()
            _WIRE_ENV_CHECKED = True
        return _WIRE_INJECTOR


def result_frames(out: dict[str, Any], prompt_len: int = 0) -> Iterator[dict]:
    """Wrap an already-computed one-shot ``generate()`` result dict into
    the §17 frame shapes — the single adapter behind every transport /
    registration / legacy peer that doesn't stream natively."""
    toks = [int(t) for t in out.get("tokens") or []]
    seq = 0
    if toks:
        yield {
            "v": FRAME_SCHEMA, "seq": 0, "kind": "tokens",
            "tokens": toks,
        }
        seq = 1
    yield {
        "seq": seq, "kind": "end",
        "finish_reason": str(out.get("finish_reason", "stop")),
        "prompt_tokens": int(out.get("prompt_tokens", prompt_len)),
        "ttft_s": float(out.get("ttft_s", 0.0)),
        "total_s": float(out.get("total_s", 0.0)),
        "usage": {
            "prompt_tokens": int(out.get("prompt_tokens", prompt_len)),
            "completion_tokens": len(toks),
        },
    }


def close_frames(frames: Any) -> None:
    """Close a frame iterator that may STILL be executing a ``next()`` on
    an executor thread (the async consumer was cancelled mid-fetch): try
    now, and if the generator is mid-step, retire it from a daemon thread
    once the in-flight step returns. Closing is what cancels the
    underlying engine request / hop socket, so best-effort-now is not
    enough."""
    close = getattr(frames, "close", None)
    if close is None:
        return
    try:
        close()
        return
    except ValueError:  # "generator already executing" — executor race
        pass

    def _later() -> None:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            time.sleep(0.05)
            try:
                close()
                return
            except ValueError:
                continue
        log.warning("frame stream still executing after 30s; leaking it")

    threading.Thread(
        target=_later, name="fleet-frame-close", daemon=True
    ).start()

# λ default: tokens of expected prefix match one unit of load score is
# worth. load_score ≈ queue-wait p90 seconds + occupancy (0..1) + page
# pressure (0..1); at λ=256 a fully-busy replica (occupancy+pages ≈ 2)
# still wins the route when it holds ≥512 more warm prefix tokens than an
# idle one, but one second of queue wait erases a 256-token advantage.
DEFAULT_LAMBDA = 256.0


class FleetShedError(RuntimeError):
    """The fleet cannot place this request right now (every routable
    replica is saturated, or none is routable). Callers surface it exactly
    like the engine's ShedError — HTTP 429 with Retry-After."""

    def __init__(self, reason: str, retry_after_s: float = 1.0) -> None:
        super().__init__(reason)
        self.retry_after_s = retry_after_s


class ReplicaError(RuntimeError):
    """A dispatch to one replica failed (process died, HTTP unreachable,
    engine stopped). The router quarantines the replica and fails the
    request over to a survivor — this error type is what separates
    'replica is broken' from 'replica said no' (FleetShedError)."""


# ---------------------------------------------------------------------------
# Beacon
# ---------------------------------------------------------------------------


def beacon_from_engine(
    replica_id: str, engine: Any, url: str = "", top_k: int = 32,
    role: str = "mixed",
) -> dict[str, Any]:
    """Build the compact state beacon one replica advertises. Token content
    never appears — prefixes travel as (digest, length) pairs. Safe to call
    from any thread (engine.stats() and the advertisement registries take
    their own locks). ``role`` is the disaggregated-serving tag
    (``prefill`` | ``decode`` | ``mixed`` — the `fleet-role` knob, §18):
    the router steers long-prompt admissions at prefill-tagged replicas
    and migrates their KV to decode-tagged ones."""
    if role not in ("prefill", "decode", "mixed"):
        raise ValueError(
            f"unknown fleet role {role!r}; supported: prefill, decode, mixed"
        )
    stats = engine.stats()
    adv = getattr(engine, "prefix_advertisement", None)
    boundaries, prefixes = adv(top_k) if adv is not None else ((), [])
    hist = stats.get("histograms") or {}
    ttft = hist.get("engine_ttft_s") or {}
    thread = getattr(engine, "_thread", None)
    dead = getattr(engine, "_dead", None) is not None or (
        thread is None or not thread.is_alive()
    )
    pages_total = stats.get("kv-pages-total", 0)
    return {
        "schema": BEACON_SCHEMA,
        "id": str(replica_id),
        "url": url,
        "role": role,
        "at": round(time.time(), 3),
        "load_score": stats.get("load-score", 0.0),
        "queue_wait_ema_s": stats.get("queue-wait-ema-s", 0.0),
        "active_slots": stats.get("active-slots", 0),
        "max_batch": stats.get("max-batch", 0),
        "queued": stats.get("queued", 0),
        "queue_depth": int(getattr(engine, "_queue", None).maxsize or 0)
        if getattr(engine, "_queue", None) is not None
        else 0,
        "shed_policy": getattr(engine, "shed_policy", "block"),
        "shed_total": stats.get("shed-total", 0),
        "kv_pages_total": pages_total,
        "kv_pages_free": max(0, pages_total - stats.get("kv-pages-in-use", 0)),
        "draining": bool(stats.get("draining", False)),
        "quarantined": bool(dead),
        # SPMD slice resilience (§20): True through the replica's
        # crash→rebuild→backoff window. Routers EXCLUDE a recovering
        # replica without quarantining it — recovery is seconds, the
        # fail_cooldown_s quarantine is not — and HOLD its sticky
        # sessions so they resume on their owner when it returns.
        "recovering": bool(stats.get("recovering", False)),
        "prefix_hit_rate": stats.get("prefix-cache-hit-rate", 0.0),
        "prefill_tokens_saved_total": stats.get("prefill-tokens-saved-total", 0),
        "ttft_p50_ms": round(float(ttft.get("p50", 0.0)) * 1e3, 3),
        "ttft_p99_ms": round(float(ttft.get("p99", 0.0)) * 1e3, 3),
        "boundaries": [int(b) for b in boundaries],
        # device-resident prefixes vs hibernated ones (tiered KV, §16):
        # a spilled session's digest keeps advertising so sticky routing
        # survives hibernation — the router scores it at a discount (the
        # restore is cheap but not free). Advertisement triples may come
        # from the dense pool too, where everything is device-resident.
        "prefixes": [
            [d, int(n)]
            for d, n, tier in prefixes
            if tier not in ("host", "durable")
        ],
        # "host" AND "durable" tiers beacon here (§16/§23): both serve a
        # sticky hit without device residency — host via arena restore,
        # durable via disk restore (or a P2P fetch from this replica's
        # checkpoint). Routers score both at the same discount.
        "spilled_prefixes": [
            [d, int(n)]
            for d, n, tier in prefixes
            if tier in ("host", "durable")
        ],
        # resident LoRA adapters (NAMES only, never factors): the router's
        # adapter-affinity signal — landing a tenant's request on a replica
        # already holding its adapter skips a hot-swap dispatch (§15)
        "adapters": [
            str(a)
            for a in (
                engine.adapter_advertisement()
                if hasattr(engine, "adapter_advertisement")
                else ()
            )
        ],
        # per-tenant queue pressure (docs/SERVING.md §19): the router's
        # tenant-aware shed/route signal — an aggressor's backlog on THIS
        # replica must not get its overflow balanced onto the replica
        # serving the victim. Tenant IDS only (they already ride HTTP
        # headers), never token content; bounded to the busiest 16.
        "tenants": _beacon_tenants(stats.get("tenants") or {}),
        # brownout ladder level (0 = normal): routers prefer un-browned
        # replicas at equal affinity, and operators see degradation
        # fleet-wide
        "brownout_level": int(stats.get("brownout-level", 0) or 0),
        # wire capabilities (§18/§21): what this replica's VERSION
        # understands. "kvmig" = binds inbound KV-page migrations;
        # "dfa-resume" = honors grammar-resume-state; "kvmig2"/"frames2"
        # = speaks the v2 binary codecs (lstpu-kvmig-v2 /
        # lstpu-frames-v2); "p2p" = serves and fetches pages
        # peer-to-peer on radix miss. The router refuses to migrate to —
        # or resume a constrained stream on — a peer that does not
        # advertise the capability: a legacy peer would silently drop the
        # option and restart the DFA at state 0 (invalid output dressed
        # as valid), the exact class the §17 refusal existed to prevent.
        # Version negotiation for the binary wire rides this same field:
        # senders emit v2 only toward peers that advertise it, so a
        # mixed-version fleet keeps exchanging byte-identical v1 NDJSON
        # with legacy members (rolling-upgrade safe).
        "caps": ["kvmig", "kvmig2", "dfa-resume", "p2p", "frames2"]
        + (
            # "durable" = crash-safe disk checkpoints (§23): the replica
            # can hibernate, serve P2P fetches from disk, and resurrect
            # sessions after a restart. Scale-to-zero requires EVERY live
            # replica to advertise it (sessions must survive the drain).
            ["durable"]
            if getattr(engine, "_durable", None) is not None
            else []
        ),
        # landed prefill throughput (tokens/s) for the router's
        # fetch-vs-prefill cost model (§23): what recomputing a prefix
        # locally costs, measured, not configured. 0.0 until a dispatch
        # lands — the router then falls back to its flat page threshold.
        "prefill_tps": (
            engine.prefill_tps_estimate()
            if hasattr(engine, "prefill_tps_estimate")
            else 0.0
        ),
        # page geometry so a router can turn "pages" into "bytes" for the
        # same cost model without a second RPC
        "bytes_per_page": int(stats.get("kv-bytes-per-page", 0) or 0),
        "page_size": int(stats.get("page-size", 0) or 0),
    }


def _beacon_tenants(tenants: dict[str, Any]) -> dict[str, dict[str, Any]]:
    """Compact per-tenant pressure block for the beacon: queue depth,
    wait EMA, quota state and cumulative sheds — the fields the router's
    tenant-aware decisions read. Bounded to the 16 busiest tenants so a
    many-tenant replica cannot bloat every beacon fetch."""
    busiest = sorted(
        tenants.items(),
        key=lambda kv: (
            -int(kv[1].get("queued", 0)),
            -float(kv[1].get("queue-wait-ema-s", 0.0)),
        ),
    )[:16]
    return {
        str(name): {
            "queued": int(t.get("queued", 0)),
            "queue_wait_ema_s": float(t.get("queue-wait-ema-s", 0.0)),
            "over_quota": bool(t.get("over-quota", False)),
            "shed_total": int(t.get("shed-total", 0)),
            "active_slots": int(t.get("active-slots", 0)),
        }
        for name, t in busiest
    }


def validate_beacon(doc: dict[str, Any]) -> bool:
    """Schema check for one beacon (docs/SERVING.md §13): raises ValueError
    on the first violation. Enforces the redaction contract — a beacon
    carries digests, never tokens."""
    if not isinstance(doc, dict):
        raise ValueError("beacon must be a JSON object")
    if doc.get("schema") != BEACON_SCHEMA:
        raise ValueError(f"unknown beacon schema {doc.get('schema')!r}")
    for key in (
        "id", "at", "load_score", "queue_wait_ema_s", "draining",
        "quarantined", "prefixes",
    ):
        if key not in doc:
            raise ValueError(f"beacon missing field {key!r}")
    for key in ("prefixes", "spilled_prefixes"):
        for j, pair in enumerate(doc.get(key) or []):
            if (
                not isinstance(pair, (list, tuple))
                or len(pair) != 2
                or not isinstance(pair[0], str)
                or not isinstance(pair[1], int)
            ):
                raise ValueError(
                    f"{key} advertisement {j} is not [digest, length]"
                )
    for j, name in enumerate(doc.get("adapters") or []):
        if not isinstance(name, str):
            raise ValueError(f"adapter advertisement {j} is not a name string")
    role = doc.get("role", "mixed")
    if role not in ("prefill", "decode", "mixed"):
        raise ValueError(f"unknown beacon role {role!r}")
    for j, cap in enumerate(doc.get("caps") or []):
        if not isinstance(cap, str):
            raise ValueError(f"capability advertisement {j} is not a string")
    tenants = doc.get("tenants")
    if tenants is not None:
        if not isinstance(tenants, dict):
            raise ValueError("beacon tenants must be an object")
        for name, t in tenants.items():
            if not isinstance(name, str) or not isinstance(t, dict):
                raise ValueError(
                    f"tenant advertisement {name!r} is not name -> object"
                )
            for key in ("queued", "queue_wait_ema_s", "over_quota"):
                if key not in t:
                    raise ValueError(
                        f"tenant advertisement {name!r} missing {key!r}"
                    )
    for forbidden in ("tokens", "prompt", "text", "prompt_tokens"):
        if forbidden in doc:
            raise ValueError(f"beacon carries token-content key {forbidden!r}")
    json.dumps(doc)
    return True


# ---------------------------------------------------------------------------
# Local replica registry (what the runtime HTTP server's /state and
# /fleet/* handlers read — the same process-global pattern as
# observability.RECENT_DUMPS, so the server never holds an engine reference)
# ---------------------------------------------------------------------------

_LOCAL_LOCK = threading.Lock()
_LOCAL: dict[str, dict[str, Callable]] = {}


def register_local(
    replica_id: str,
    beacon_fn: Callable[[], dict],
    generate_fn: Optional[Callable[[dict], dict]] = None,
    reset_fn: Optional[Callable[[], None]] = None,
    generate_stream_fn: Optional[Callable[[dict], Iterator[dict]]] = None,
    migrate_bind_fn: Optional[Callable[..., dict]] = None,
    migrate_out_fn: Optional[Callable[[dict], dict]] = None,
    recovering_fn: Optional[Callable[[], bool]] = None,
    migrate_pages_fn: Optional[Callable[[dict], Iterator[dict]]] = None,
    p2p_fetch_fn: Optional[Callable[[dict], dict]] = None,
    migrate_limits_fn: Optional[Callable[[], dict]] = None,
    restoring_fn: Optional[Callable[[], bool]] = None,
) -> None:
    """Expose this process's engine on the runtime HTTP server: ``GET
    /state`` serves ``beacon_fn``, ``POST /fleet/generate`` runs
    ``generate_fn`` (fleet-internal dispatch; with ``stream: true`` in the
    payload it prefers ``generate_stream_fn`` — frames per §17 — and falls
    back to wrapping ``generate_fn``'s one-shot result), ``POST
    /fleet/reset`` runs ``reset_fn`` (bench warmup hygiene), ``POST
    /fleet/migrate`` binds an inbound KV-page migration through
    ``migrate_bind_fn`` and ``POST /fleet/migrate-out`` commands this
    replica to push one through ``migrate_out_fn`` (docs/SERVING.md §18).
    The §21 P2P surface: ``POST /fleet/pages`` serves migration frames
    covering a prefix WITHOUT releasing them through
    ``migrate_pages_fn`` (a fetch copies, a migration moves), ``POST
    /fleet/fetch`` commands this replica to pull pages from a named
    owner through ``p2p_fetch_fn``, and ``migrate_limits_fn`` reports
    the pool geometry the migrate receiver uses to bound wire reads."""
    with _LOCAL_LOCK:
        _LOCAL[str(replica_id)] = {
            "beacon": beacon_fn, "generate": generate_fn, "reset": reset_fn,
            "generate_stream": generate_stream_fn,
            "migrate_bind": migrate_bind_fn,
            "migrate_out": migrate_out_fn,
            "recovering": recovering_fn,
            "migrate_pages": migrate_pages_fn,
            "p2p_fetch": p2p_fetch_fn,
            "migrate_limits": migrate_limits_fn,
            "restoring": restoring_fn,
        }


def local_recovering() -> bool:
    """True while ANY engine registered in this process is inside its
    crash→rebuild→backoff recovery window (§20). Reads one attribute per
    engine (never stats()), cheap enough for /healthz — k8s readiness can
    hold traffic through a recovery without killing the pod."""
    with _LOCAL_LOCK:
        fns = [e.get("recovering") for e in _LOCAL.values()]
    out = False
    for fn in fns:
        if fn is None:
            continue
        try:
            out = out or bool(fn())
        except Exception:  # noqa: BLE001 — health probes must not raise
            log.exception("recovering probe failed")
    return out


def local_restoring() -> bool:
    """True while ANY engine registered in this process is serving a
    durable-tier restore (§23) — the resurrection-in-progress signal
    /healthz surfaces so scale-from-zero readiness probes can tell "still
    rehydrating sessions" from "wedged". Same cheap-attribute discipline
    as local_recovering()."""
    with _LOCAL_LOCK:
        fns = [e.get("restoring") for e in _LOCAL.values()]
    out = False
    for fn in fns:
        if fn is None:
            continue
        try:
            out = out or bool(fn())
        except Exception:  # noqa: BLE001 — health probes must not raise
            log.exception("restoring probe failed")
    return out


def unregister_local(replica_id: str) -> None:
    with _LOCAL_LOCK:
        _LOCAL.pop(str(replica_id), None)


def local_state() -> dict[str, Any]:
    """The /state document: every engine registered in this process (one,
    for every real topology)."""
    with _LOCAL_LOCK:
        entries = list(_LOCAL.items())
    replicas = []
    for replica_id, fns in entries:
        try:
            replicas.append(fns["beacon"]())
        except Exception:  # noqa: BLE001 — a crashed engine still beacons
            log.exception("beacon build failed for %s", replica_id)
            replicas.append(
                {
                    "schema": BEACON_SCHEMA, "id": replica_id, "url": "",
                    "at": round(time.time(), 3), "load_score": 1e9,
                    "queue_wait_ema_s": 0.0, "draining": False,
                    "quarantined": True, "prefixes": [],
                }
            )
    return {"schema": STATE_SCHEMA, "replicas": replicas}


def local_generate(payload: dict[str, Any]) -> dict[str, Any]:
    """Fleet-internal dispatch into this process's engine (the POST
    /fleet/generate body). Blocking — the HTTP server runs it in an
    executor. Raises ReplicaError when no engine is registered (the
    router treats that as a dead replica and fails over)."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            raise ReplicaError("no serving engine registered in this process")
        fns = next(iter(_LOCAL.values()))
    gen = fns.get("generate")
    if gen is None:
        raise ReplicaError("registered engine does not accept fleet dispatch")
    return gen(payload)


def local_generate_stream(payload: dict[str, Any]) -> Iterator[dict]:
    """Streaming fleet-internal dispatch into this process's engine (the
    POST /fleet/generate ``stream: true`` body). Returns the frame
    iterator EAGERLY-submitted (docs/SERVING.md §17): pre-stream failures
    — shed, bad request, dead engine — raise HERE, before the HTTP layer
    has committed to a chunked response, so they still map to real status
    codes. Registrations without a stream fn degrade to one final tokens
    frame wrapped around the blocking ``generate`` result."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            raise ReplicaError("no serving engine registered in this process")
        fns = next(iter(_LOCAL.values()))
    stream = fns.get("generate_stream")
    if stream is not None:
        return stream(payload)
    gen = fns.get("generate")
    if gen is None:
        raise ReplicaError("registered engine does not accept fleet dispatch")
    return result_frames(gen(payload))


def local_migrate_bind(frames: Iterator[dict], timeout_s: float = 30.0) -> dict:
    """Inbound KV-page migration into this process's engine (the POST
    /fleet/migrate body, §18). Blocking — the HTTP server runs it in an
    executor. Raises ReplicaError when no engine is registered."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            raise ReplicaError("no serving engine registered in this process")
        fns = next(iter(_LOCAL.values()))
    bind = fns.get("migrate_bind")
    if bind is None:
        raise ReplicaError(
            "registered engine does not accept KV-page migrations"
        )
    return bind(frames, timeout_s)


def local_migrate_out(payload: dict) -> dict:
    """Outbound migration command (the POST /fleet/migrate-out body): this
    process's engine exports the prefix and pushes it to ``dest``."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            raise ReplicaError("no serving engine registered in this process")
        fns = next(iter(_LOCAL.values()))
    out = fns.get("migrate_out")
    if out is None:
        raise ReplicaError(
            "registered engine does not accept KV-page migrations"
        )
    return out(payload)


def local_migrate_pages(payload: dict) -> Iterator[dict]:
    """P2P page serve (the POST /fleet/pages body, §21): export migration
    frames covering the deepest published prefix of ``prompt_tokens``
    WITHOUT releasing anything — the owner keeps its copy. Pre-stream
    failures (no engine, no published prefix) raise here so the HTTP
    layer can still answer a JSON error instead of a broken stream."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            raise ReplicaError("no serving engine registered in this process")
        fns = next(iter(_LOCAL.values()))
    pages = fns.get("migrate_pages")
    if pages is None:
        raise ReplicaError("registered engine does not serve P2P page fetch")
    return pages(payload)


def local_p2p_fetch(payload: dict) -> dict:
    """Inbound P2P fetch command (the POST /fleet/fetch body, §21): this
    process's engine pulls pages from the ``source`` peer and admits the
    prefix warm. Blocking — the HTTP server runs it in an executor."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            raise ReplicaError("no serving engine registered in this process")
        fns = next(iter(_LOCAL.values()))
    fetch = fns.get("p2p_fetch")
    if fetch is None:
        raise ReplicaError("registered engine does not serve P2P page fetch")
    return fetch(payload)


_LOCAL_ROUTER: Optional[Any] = None


def register_local_router(router: Any) -> None:
    """Expose this process's FleetRouter for the HTTP prefetch surface
    (POST /fleet/prefetch, §23). One router per process — latest wins,
    matching the _EngineHolder singleton that builds it."""
    global _LOCAL_ROUTER
    with _LOCAL_LOCK:
        _LOCAL_ROUTER = router


def unregister_local_router() -> None:
    global _LOCAL_ROUTER
    with _LOCAL_LOCK:
        _LOCAL_ROUTER = None


def local_prefetch(payload: dict) -> dict:
    """Prefetch-on-hint command (the POST /fleet/prefetch body, §23): a
    gateway that KNOWS a session's next turn is coming (client typing, a
    scheduled agent step, a resurrection hint for a hibernated replica)
    posts the session's token prefix here, and the router pulls the
    pages to the replica the request WILL route to — before the request
    exists. Blocking — the HTTP server runs it in an executor."""
    with _LOCAL_LOCK:
        router = _LOCAL_ROUTER
    if router is None:
        raise ReplicaError("no fleet router in this process")
    tokens = payload.get("prompt_tokens")
    if not isinstance(tokens, list) or not all(
        isinstance(t, int) for t in tokens
    ):
        raise ValueError("prompt_tokens must be a list of token ids")
    session = payload.get("session")
    adapter = payload.get("adapter")
    tenant = payload.get("tenant")
    return router.prefetch(
        tokens,
        session_id=str(session) if session else None,
        adapter=str(adapter) if adapter else None,
        tenant=str(tenant) if tenant else None,
    )


def local_migrate_limits() -> dict:
    """Static pool geometry for the migrate receiver's wire bounds (§21
    hardening): ``{"bytes_per_page", "pages_total"}``, or ``{}`` when no
    engine (or a non-paged one) is registered — the receiver then falls
    back to flat caps."""
    with _LOCAL_LOCK:
        if not _LOCAL:
            return {}
        fns = next(iter(_LOCAL.values()))
    limits = fns.get("migrate_limits")
    if limits is None:
        return {}
    try:
        return dict(limits() or {})
    except Exception:  # noqa: BLE001 — bounds probe must not kill a bind
        log.exception("migrate limits probe failed")
        return {}


def engine_migrate_bind(
    engine: Any, frames: Iterator[dict], timeout_s: float = 30.0,
) -> dict:
    """The canonical ``migrate_bind_fn`` for ``register_local``: verify
    and bind one inbound migration into the local engine."""
    return migrate_mod.bind_frames(engine, frames, timeout_s=timeout_s)


def engine_migrate_out(engine: Any, payload: dict) -> dict:
    """The canonical ``migrate_out_fn`` for ``register_local``: export the
    prefix covering ``prompt_tokens`` from the local engine, push it to
    the ``dest`` replica's ``POST /fleet/migrate`` — or, for a ``dest`` of
    this process (an ``InProcessReplica`` url, ``local:<replica id>``), bind
    it there — and release the local copy on its ACK (never before).
    Returns the receiver's ACK with the sender's phase timings."""
    tokens = [int(t) for t in payload.get("prompt_tokens") or []]
    if not tokens:
        raise ValueError("migrate-out payload carries no prompt_tokens")
    dest = str(payload.get("dest") or "")
    if not dest:
        raise ValueError("migrate-out payload carries no dest url")
    bind = None
    if dest.startswith("local:"):
        with _LOCAL_LOCK:
            bind = (_LOCAL.get(dest[len("local:"):]) or {}).get("migrate_bind")
        if bind is None:
            raise MigrationError(f"no replica in this process binds migrations as {dest}")
    timeout_s = float(payload.get("timeout-s") or 30.0)
    wire = "v2" if payload.get("wire") == "v2" else "v1"
    phases: dict[str, Any] = {}
    frames = migrate_mod.export_frames(
        engine, tokens, timeout_s=timeout_s,
        state=payload.get("state") or {}, phases=phases,
        raw=wire == "v2",
    )
    t0 = time.monotonic()
    if bind is not None:
        ack = bind(frames, timeout_s)
    else:
        ack = migrate_mod.push_migration(dest, frames, timeout_s, wire=wire)
    phases["transfer_ms"] = round((time.monotonic() - t0) * 1e3, 3)
    migrate_mod._release_on_ack(engine, tokens, ack)  # noqa: SLF001
    ack["phases"] = dict(phases, **(ack.get("phases") or {}))
    return ack


def engine_migrate_pages(engine: Any, payload: dict) -> Iterator[dict]:
    """The canonical ``migrate_pages_fn`` for ``register_local``: export
    the prefix covering ``prompt_tokens`` for a P2P fetch (§21) — same
    frames as a migration but the owner RELEASES NOTHING; the fetcher
    gets a copy and both replicas keep serving the prefix. ``wire: v2``
    asks for raw leaf-byte payloads (the binary codec's data plane);
    hibernated entries ship straight from the host arena either way."""
    tokens = [int(t) for t in payload.get("prompt_tokens") or []]
    if not tokens:
        raise ValueError("page-fetch payload carries no prompt_tokens")
    return migrate_mod.export_frames(
        engine, tokens,
        timeout_s=float(payload.get("timeout-s") or 30.0),
        raw=payload.get("wire") == "v2",
    )


def engine_p2p_fetch(engine: Any, payload: dict) -> dict:
    """The canonical ``p2p_fetch_fn`` for ``register_local``: pull the
    prefix covering ``prompt_tokens`` from the ``source`` peer's ``POST
    /fleet/pages`` and bind it into the local engine (§21). Failures
    propagate as MigrationError — the commanding router degrades to the
    local cold path; nothing here retries."""
    tokens = [int(t) for t in payload.get("prompt_tokens") or []]
    if not tokens:
        raise ValueError("p2p-fetch payload carries no prompt_tokens")
    source = str(payload.get("source") or "")
    if not source:
        raise ValueError("p2p-fetch payload carries no source url")
    timeout_s = float(payload.get("timeout-s") or 30.0)
    frames = migrate_mod.fetch_pages(
        source, tokens, timeout_s, wire="v2" if payload.get("wire") == "v2" else "v1",
    )
    return migrate_mod.bind_frames(engine, frames, timeout_s=timeout_s)


def local_reset() -> None:
    with _LOCAL_LOCK:
        entries = list(_LOCAL.values())
    for fns in entries:
        reset = fns.get("reset")
        if reset is not None:
            reset()


def engine_generate(
    engine: Any, payload: dict[str, Any],
    timeout_s: float = DEFAULT_HOP_TIMEOUT_S,
) -> dict[str, Any]:
    """The canonical ``generate_fn`` for ``register_local``: run one
    completion on the local engine from a fleet-dispatch payload
    (``{"prompt_tokens": [...], "options": {...}}``) and return a plain
    JSON-able result. Engine sheds propagate as FleetShedError so the HTTP
    layer can answer 429 + Retry-After.

    Cross-process cancel (ROADMAP 3b): when the options carry a
    ``cancel-key`` (the client session id the dispatching gateway routes
    disconnects by), the in-flight request registers in THIS process's
    lifecycle registry, so a forwarded ``POST /fleet/cancel`` from the
    gateway frees the slot at the next chunk boundary."""

    tokens = [int(t) for t in payload.get("prompt_tokens") or []]
    if not tokens:
        raise ValueError("fleet dispatch payload carries no prompt_tokens")
    options = payload.get("options") or {}
    opts = GenerationOptions.from_dict(options)
    # deadline discipline (§17): the forwarded deadline bounds the server-
    # side wait too — a 10s-deadline request must not park an executor
    # thread here for the full default hop budget on a wedged engine
    timeout_s = min(timeout_s, hop_timeout_s(options, timeout_s))
    cancel_key = str(options.get("cancel-key") or "")
    # pre-built so it can register for cross-process cancel BEFORE the
    # submit; engine.generate keeps the submit/wait/cancel-on-timeout
    # contract in one place
    request = GenerationRequest(prompt_tokens=tokens, options=opts)
    if cancel_key:
        lifecycle.register(cancel_key, request)
    try:
        try:
            result = engine.generate(request=request, timeout=timeout_s)
        except ShedError as e:
            raise FleetShedError(str(e), retry_after_s=e.retry_after_s) from e
    finally:
        if cancel_key:
            lifecycle.unregister(cancel_key, request)
    return {
        "tokens": [int(t) for t in result.tokens],
        "finish_reason": result.finish_reason,
        "prompt_tokens": result.prompt_tokens,
        "ttft_s": round(result.ttft_s, 6),
        "total_s": round(result.total_s, 6),
    }


class _EngineFrameStream:
    """Frame iterator whose ``close()`` is safe BEFORE the first
    ``next()``: the consumer may abandon the hop between the eager submit
    and iteration (response prepare failed, handler cancelled), and the
    engine request must still be cancelled + unregistered — a generator's
    ``finally`` only runs once its body has started."""

    def __init__(self, request: Any, cancel_key: str, gen: Iterator[dict]):
        self._request = request
        self._cancel_key = cancel_key
        self._gen = gen

    def __iter__(self) -> "_EngineFrameStream":
        return self

    def __next__(self) -> dict:
        return next(self._gen)

    def close(self) -> None:
        try:
            self._gen.close()
        finally:
            # idempotent with the generator's own finally (cancel() and
            # unregister() both tolerate repeats): this leg covers the
            # pre-start abandon, where the generator body never ran
            if not self._request._done.is_set():  # noqa: SLF001
                self._request.cancel()
            if self._cancel_key:
                lifecycle.unregister(self._cancel_key, self._request)


def engine_generate_stream(
    engine: Any,
    payload: dict[str, Any],
    timeout_s: float = DEFAULT_HOP_TIMEOUT_S,
    heartbeat_s: Optional[float] = None,
) -> Iterator[dict]:
    """The streaming twin of ``engine_generate`` (docs/SERVING.md §17):
    submit one completion on the local engine and return an iterator of
    ``lstpu-frames-v1`` frames — token chunks as the engine delivers them
    (so a remote route keeps local TTFT semantics), heartbeats while the
    stream idles, ONE terminal ``end``/``error`` frame.

    The SUBMIT happens eagerly, before the iterator is returned: shed /
    bad-request / dead-engine failures raise here, while the HTTP layer
    can still answer with a status code instead of a broken stream.
    Closing the iterator mid-stream (client disconnected, net-cut drill)
    cancels the in-flight request — a vanished consumer must not burn the
    slot to max_new_tokens.

    Token-delivery contract: every generated token rides a ``tokens``
    frame (the engine calls on_token exactly once per kept token), so the
    client-accumulated list IS result.tokens — what makes failover resume
    (prompt + delivered) token-exact. The ``end`` frame carries counts and
    usage, never token content the client doesn't already have."""

    tokens = [int(t) for t in payload.get("prompt_tokens") or []]
    if not tokens:
        raise ValueError("fleet dispatch payload carries no prompt_tokens")
    options = payload.get("options") or {}
    opts = GenerationOptions.from_dict(options)
    timeout_s = min(timeout_s, hop_timeout_s(options, timeout_s))
    hb = float(payload.get("heartbeat-s") or heartbeat_s or 2.0)
    hb = max(0.05, hb)
    cancel_key = str(options.get("cancel-key") or "")
    q: "queue.Queue[tuple[str, Any]]" = queue.Queue()
    request = GenerationRequest(
        prompt_tokens=tokens,
        options=opts,
        on_done=lambda res: q.put(("done", res)),
    )
    # on_token runs on the ENGINE thread, which writes request.dfa_state
    # strictly before invoking it — pairing token and state here is what
    # lets a constrained stream's tokens frames carry the host-mirrored
    # DFA state, so a survivor can resume mid-derivation (§18) instead of
    # refusing. None for unconstrained requests (and legacy peers).
    request.on_token = lambda t: q.put(("tok", (int(t), request.dfa_state)))
    if cancel_key:
        lifecycle.register(cancel_key, request)
    try:
        try:
            engine.submit(request)
        except ShedError as e:
            raise FleetShedError(str(e), retry_after_s=e.retry_after_s) from e
    except BaseException:
        if cancel_key:
            lifecycle.unregister(cancel_key, request)
        raise

    def frames() -> Iterator[dict]:
        seq = 0
        result = None
        hard_stop = time.monotonic() + timeout_s
        try:
            while result is None:
                try:
                    item = q.get(timeout=hb)
                except queue.Empty:
                    if time.monotonic() >= hard_stop:
                        # wedged engine / blown hop budget: cancel and fail
                        # the hop — the deadline already rode the options,
                        # so this fires only when the engine ignores it
                        request.cancel()
                        yield {
                            "seq": seq, "kind": "error",
                            "error": f"hop budget ({timeout_s:.1f}s) "
                                     "exhausted mid-stream",
                        }
                        return
                    beat = {"seq": seq, "kind": "heartbeat"}
                    if seq == 0:
                        beat["v"] = FRAME_SCHEMA
                    yield beat
                    seq += 1
                    continue
                batch = [item]
                while True:
                    try:
                        batch.append(q.get_nowait())
                    except queue.Empty:
                        break
                toks = [v[0] for k, v in batch if k == "tok"]
                dfa_state = None
                for kind, value in batch:
                    if kind == "done":
                        result = value
                    elif kind == "tok" and value[1] is not None:
                        # the state matching the LAST token of this frame
                        # (per-token states are monotone within a batch)
                        dfa_state = int(value[1])
                if toks:
                    frame = {"seq": seq, "kind": "tokens", "tokens": toks}
                    if dfa_state is not None:
                        frame["dfa_state"] = dfa_state
                    if seq == 0:
                        frame["v"] = FRAME_SCHEMA
                    yield frame
                    seq += 1
            if result.error is not None:
                yield {
                    "seq": seq, "kind": "error", "error": str(result.error),
                }
                return
            end = {
                "seq": seq, "kind": "end",
                "finish_reason": result.finish_reason,
                "prompt_tokens": result.prompt_tokens,
                "ttft_s": round(result.ttft_s, 6),
                "total_s": round(result.total_s, 6),
                "usage": {
                    "prompt_tokens": result.prompt_tokens,
                    "completion_tokens": len(result.tokens),
                },
            }
            if seq == 0:
                end["v"] = FRAME_SCHEMA
            yield end
        finally:
            if result is None:
                # consumer walked away mid-stream (disconnect, failover
                # cut): free the slot at the next chunk boundary
                request.cancel()
            if cancel_key:
                lifecycle.unregister(cancel_key, request)

    return _EngineFrameStream(request, cancel_key, frames())


# ---------------------------------------------------------------------------
# Replica transports (duck-typed: .replica_id, .fetch_beacon(), .generate())
# ---------------------------------------------------------------------------


class InProcessReplica:
    """A replica living in this process — the unit-test / embedded-runner
    transport, and the 'self' handle when the completions service fronts
    its own engine plus remote peers."""

    is_local = True

    def __init__(
        self, replica_id: str, engine: Any, url: str = "",
        role: str = "mixed",
    ) -> None:
        self.replica_id = str(replica_id)
        self.engine = engine
        self.url = url or f"local:{replica_id}"
        self.role = str(role)

    def fetch_beacon(self) -> dict[str, Any]:
        return beacon_from_engine(
            self.replica_id, self.engine, url=self.url, role=self.role
        )

    def generate(
        self, tokens, options: Optional[dict] = None, timeout_s: float = 600.0,
    ) -> dict[str, Any]:
        try:
            return engine_generate(
                self.engine,
                {"prompt_tokens": list(tokens), "options": options or {}},
                timeout_s=timeout_s,
            )
        except (FleetShedError, ValueError):
            # sheds re-route; a BAD REQUEST is the caller's bug — neither
            # may quarantine the replica (a malformed request retried
            # across the fleet would mark every replica failed)
            raise
        except Exception as e:  # noqa: BLE001 — stopped/crashed engine
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e

    def generate_stream(
        self, tokens, options: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Iterator[dict]:
        """Streaming dispatch into the in-process engine: the same §17
        frame iterator the HTTP transport yields, so the router's warm-
        failover path treats local and remote replicas identically."""
        options = dict(options or {})
        try:
            frames = engine_generate_stream(
                self.engine,
                {"prompt_tokens": list(tokens), "options": options},
                timeout_s=(
                    timeout_s if timeout_s is not None
                    else hop_timeout_s(options)
                ),
            )
        except (FleetShedError, ValueError):
            raise  # sheds re-route; a bad REQUEST never quarantines
        except Exception as e:  # noqa: BLE001 — stopped/crashed engine
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e
        return self._guard_frames(frames)

    def _guard_frames(self, frames: Iterator[dict]) -> Iterator[dict]:
        # mid-stream engine failures surface as ReplicaError so failover
        # handling is one code path across transports; error frames are
        # consumed here (the router never sees transport-internal kinds)
        try:
            for frame in frames:
                if frame.get("kind") == "error":
                    raise ReplicaError(
                        f"replica {self.replica_id}: {frame.get('error')}"
                    )
                yield frame
        except (FleetShedError, ReplicaError, ValueError):
            raise
        except Exception as e:  # noqa: BLE001 — engine died mid-stream
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e
        finally:
            close = getattr(frames, "close", None)
            if close is not None:
                close()  # cancels the engine request if the consumer left

    def reset_histograms(self) -> None:
        self.engine.reset_histograms()


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


@dataclass
class HttpReplica:
    """A replica behind its runtime HTTP server (entrypoint pods, the
    bench's subprocess fleet). Uses stdlib urllib — these calls run on the
    router's refresher thread and dispatch executors, never an event loop."""

    is_local = False

    def __init__(
        self, replica_id: str, base_url: str,
        beacon_timeout_s: float = 2.0,
        generate_timeout_s: float = DEFAULT_HOP_TIMEOUT_S,
        stream_idle_timeout_s: float = 20.0,
    ) -> None:
        self.replica_id = str(replica_id)
        self.url = base_url.rstrip("/")
        self.beacon_timeout_s = beacon_timeout_s
        self.generate_timeout_s = generate_timeout_s
        # dead-peer detection on an OPEN stream (§17): the peer heartbeats
        # every ~idle/4 while decoding slowly, so a wire silent past this
        # bound is a dead/stalled peer, not a slow one — the hop fails and
        # the router's warm failover takes over. The request's deadline
        # (when tighter) bounds the whole hop regardless.
        self.stream_idle_timeout_s = float(stream_idle_timeout_s)
        # wire capabilities from the peer's last beacon (§21 negotiation):
        # dispatch asks for the v2 binary stream only once the peer has
        # PROVEN it speaks it — before the first beacon lands (or toward
        # a legacy peer) every hop stays v1 NDJSON
        self.caps: frozenset = frozenset()

    def _get(self, path: str, timeout_s: float) -> dict[str, Any]:
        with urllib.request.urlopen(self.url + path, timeout=timeout_s) as r:
            return json.loads(r.read().decode("utf-8"))

    @staticmethod
    def _tighten_read_timeout(resp: Any, timeout_s: float) -> None:
        """Once the response HEADERS have arrived, drop the socket timeout
        from the hop budget to the idle bound: from here on, silence
        between frames longer than the heartbeat cadence means a dead
        peer. Best-effort over stdlib internals (no public accessor for
        the response's socket) — on failure the hop budget remains the
        only bound, i.e. the pre-§17 behavior."""
        try:
            resp.fp.raw._sock.settimeout(  # noqa: SLF001
                max(0.1, float(timeout_s))
            )
        except (AttributeError, OSError):
            pass

    def fetch_beacon(self) -> dict[str, Any]:
        try:
            doc = self._get("/state", self.beacon_timeout_s)
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e
        replicas = doc.get("replicas") or []
        for b in replicas:
            if b.get("id") == self.replica_id:
                self.caps = frozenset(str(c) for c in b.get("caps") or ())
                return b
        if replicas:
            self.caps = frozenset(
                str(c) for c in replicas[0].get("caps") or ()
            )
            return replicas[0]
        raise ReplicaError(f"replica {self.replica_id}: empty /state")

    def generate(
        self, tokens, options: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> dict[str, Any]:
        """Blocking dispatch: drain the streaming hop into the one-shot
        result shape (back-compat surface for callers that want the whole
        completion — the wire underneath always streams, §17)."""
        out_tokens: list[int] = []
        end: Optional[dict] = None
        for frame in self.generate_stream(tokens, options, timeout_s=timeout_s):
            kind = frame.get("kind")
            if kind == "tokens":
                out_tokens.extend(int(t) for t in frame.get("tokens") or [])
            elif kind == "end":
                end = frame
        if end is None:  # generate_stream raises first; belt and braces
            raise ReplicaError(
                f"replica {self.replica_id}: stream ended without a "
                "terminal frame"
            )
        return {
            "tokens": out_tokens,
            "finish_reason": str(end.get("finish_reason", "stop")),
            "prompt_tokens": int(end.get("prompt_tokens", 0)),
            "ttft_s": float(end.get("ttft_s", 0.0)),
            "total_s": float(end.get("total_s", 0.0)),
        }

    def generate_stream(
        self, tokens, options: Optional[dict] = None,
        timeout_s: Optional[float] = None,
        idle_timeout_s: Optional[float] = None,
    ) -> Iterator[dict]:
        """One streaming fleet hop (docs/SERVING.md §17): POST the request
        with ``stream: true`` and yield validated frames as they arrive.
        The request's deadline bounds CONNECT and every READ (hop budget =
        remaining deadline + slack, never the flat default); the idle
        timeout catches a silent peer between heartbeats. Frame validation
        — contiguous seq, parseable JSON, terminal frame present — fails
        the hop as ReplicaError, which is the router's failover signal;
        tokens already yielded stay valid for a warm resume."""
        options = dict(options or {})
        injector = wire_injector()
        if injector is not None and injector.fires("net-connect"):
            raise ReplicaError(
                f"replica {self.replica_id}: injected net-connect fault"
            )
        total_s = (
            float(timeout_s) if timeout_s is not None
            else hop_timeout_s(options, self.generate_timeout_s)
        )
        idle_s = float(
            idle_timeout_s if idle_timeout_s is not None
            else self.stream_idle_timeout_s
        )
        # urlopen's timeout is the SOCKET timeout: it bounds the connect
        # and then every individual recv — exactly the per-read bound we
        # want between frames
        read_timeout = max(0.1, min(total_s, idle_s))
        payload: dict[str, Any] = {
            "prompt_tokens": list(map(int, tokens)),
            "options": options,
            "stream": True,
            # ask the peer to heartbeat well inside our idle timeout
            "heartbeat-s": round(max(0.05, read_timeout / 4.0), 3),
        }
        if "frames2" in self.caps:
            # §21 negotiation: the peer's beacon advertised the binary
            # token-stream codec — ask for it; its answer's Content-Type
            # is authoritative (a restarted-as-v1 peer still answers
            # NDJSON and the hop just reads v1)
            payload["wire"] = "v2"
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/fleet/generate", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        hard_stop = time.monotonic() + total_s
        try:
            # the HOP BUDGET (not the idle bound) governs connect + time-
            # to-headers: the peer's eager submit may legitimately block
            # on admission backpressure (shed-policy "block") with no
            # bytes flowing yet — quarantining a merely-busy replica
            # after idle_s would flap the whole fleet under load. Once
            # the stream opens, the socket timeout tightens to the idle
            # bound below.
            resp = urllib.request.urlopen(req, timeout=max(0.1, total_s))
        except urllib.error.HTTPError as e:
            if e.code == 429:
                retry = float(e.headers.get("Retry-After") or 1.0)
                raise FleetShedError(
                    f"replica {self.replica_id} shed", retry_after_s=retry
                ) from e
            if 400 <= e.code < 500:
                # the REQUEST is bad, not the replica: retrying it on the
                # rest of the fleet would brown out every replica
                raise ValueError(
                    f"replica {self.replica_id} rejected request: "
                    f"HTTP {e.code} {e.reason}"
                ) from e
            raise ReplicaError(
                f"replica {self.replica_id}: HTTP {e.code}"
            ) from e
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e
        self._tighten_read_timeout(resp, read_timeout)
        ctype = str(resp.headers.get("Content-Type") or "")
        if "lstpu-frames2" in ctype:
            try:
                with resp:
                    yield from self._v2_frames(resp, hard_stop, total_s)
            except GeneratorExit:
                resp.close()
                raise
            return
        expected_seq = 0
        try:
            with resp:
                while True:
                    if time.monotonic() >= hard_stop:
                        raise ReplicaError(
                            f"replica {self.replica_id}: hop budget "
                            f"({total_s:.1f}s) exhausted mid-stream"
                        )
                    try:
                        line = resp.readline()
                    except (OSError, http.client.HTTPException, ValueError) as e:
                        # socket timeout (idle peer), connection reset
                        # (net-cut), chunked-decode garbage — all one
                        # verdict: this hop is dead
                        raise ReplicaError(
                            f"replica {self.replica_id}: stream read failed "
                            f"({e or type(e).__name__})"
                        ) from e
                    if not line:
                        raise ReplicaError(
                            f"replica {self.replica_id}: stream closed "
                            "before terminal frame"
                        )
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        frame = json.loads(line.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError) as e:
                        raise ReplicaError(
                            f"replica {self.replica_id}: corrupt stream "
                            f"frame ({e})"
                        ) from e
                    if (
                        expected_seq == 0
                        and isinstance(frame, dict)
                        and "seq" not in frame
                        and ("tokens" in frame or "finish_reason" in frame)
                    ):
                        # a NOT-YET-UPGRADED peer ignored `stream: true`
                        # and answered the legacy one-shot JSON body:
                        # adapt it instead of quarantining a healthy
                        # replica mid-rolling-upgrade
                        try:
                            adapted = list(result_frames(
                                frame, prompt_len=len(list(tokens))
                            ))
                        except (TypeError, ValueError) as e:
                            raise ReplicaError(
                                f"replica {self.replica_id}: corrupt "
                                f"legacy response body ({e})"
                            ) from e
                        for a in adapted:
                            yield a
                        return
                    if (
                        not isinstance(frame, dict)
                        or frame.get("seq") != expected_seq
                    ):
                        got = (
                            frame.get("seq") if isinstance(frame, dict)
                            else None
                        )
                        raise ReplicaError(
                            f"replica {self.replica_id}: stream sequence "
                            f"broken (got {got!r}, want {expected_seq})"
                        )
                    expected_seq += 1
                    kind = frame.get("kind")
                    if kind == "error":
                        raise ReplicaError(
                            f"replica {self.replica_id}: "
                            f"{frame.get('error')}"
                        )
                    if kind == "tokens":
                        # the wire is untrusted: a parseable frame whose
                        # token VALUES are garbage must fail the hop (the
                        # failover signal), never leak a ValueError the
                        # router would misread as a bad client request
                        try:
                            frame["tokens"] = [
                                int(t) for t in frame.get("tokens") or []
                            ]
                        except (TypeError, ValueError) as e:
                            raise ReplicaError(
                                f"replica {self.replica_id}: corrupt "
                                f"tokens frame ({e})"
                            ) from e
                    yield frame
                    if kind == "end":
                        return
        except GeneratorExit:
            # consumer abandoned the stream (local shortcut, failover of
            # ANOTHER hop): close the socket so the peer's handler sees
            # the disconnect and cancels its engine request
            resp.close()
            raise

    def _v2_frames(
        self, resp: Any, hard_stop: float, total_s: float,
    ) -> Iterator[dict]:
        """Read one ``lstpu-frames-v2`` binary stream body (§21) and yield
        the same validated §17 frame dicts the NDJSON path yields — seq
        contiguity, error→ReplicaError, terminal-frame-required and the
        hop budget all enforced identically; only the bytes differ. Any
        codec violation (truncated prelude, CRC mismatch, bad magic) is a
        dead hop: ReplicaError, the router's failover signal, never a
        hang (the socket timeout bounds every read underneath)."""
        def read(n: int) -> bytes:
            try:
                return resp.read(n)
            except (OSError, http.client.HTTPException, ValueError) as e:
                raise ReplicaError(
                    f"replica {self.replica_id}: stream read failed "
                    f"({e or type(e).__name__})"
                ) from e

        expected_seq = 0
        ended = False
        try:
            preamble = wire_mod.read_exact(
                read, len(wire_mod.FRAMES2_PREAMBLE)
            )
            if preamble != wire_mod.FRAMES2_PREAMBLE:
                raise wire_mod.WireError(
                    f"bad frames2 preamble {preamble!r}"
                )
            for frame in wire_mod.decode_stream_frames(read):
                if time.monotonic() >= hard_stop:
                    raise ReplicaError(
                        f"replica {self.replica_id}: hop budget "
                        f"({total_s:.1f}s) exhausted mid-stream"
                    )
                if frame.get("seq") != expected_seq:
                    raise ReplicaError(
                        f"replica {self.replica_id}: stream sequence "
                        f"broken (got {frame.get('seq')!r}, "
                        f"want {expected_seq})"
                    )
                expected_seq += 1
                kind = frame.get("kind")
                if kind == "error":
                    raise ReplicaError(
                        f"replica {self.replica_id}: {frame.get('error')}"
                    )
                yield frame
                if kind == "end":
                    ended = True
                    break
        except wire_mod.WireError as e:
            raise ReplicaError(
                f"replica {self.replica_id}: corrupt v2 stream ({e})"
            ) from e
        if not ended:
            raise ReplicaError(
                f"replica {self.replica_id}: stream closed before "
                "terminal frame"
            )

    def migrate_out(
        self, tokens, dest_url: str, state: Optional[dict],
        timeout_s: float, wire: str = "v1",
    ) -> dict:
        """Command this (remote) replica to push a KV-page migration to
        ``dest_url``'s ``POST /fleet/migrate`` (§18). ``wire="v2"`` asks
        the source to ship the binary codec — set only when the DEST
        advertises ``kvmig2`` (the source falls back to v1 if its own
        version predates the key). Returns the receiver's ACK as relayed
        by the source. Failures raise MigrationError — the source retains
        its pages (it frees only on the ACK it relays here)."""
        body = json.dumps({
            "prompt_tokens": [int(t) for t in tokens],
            "dest": str(dest_url),
            "state": dict(state or {}),
            "timeout-s": float(timeout_s),
            "wire": "v2" if wire == "v2" else "v1",
        }).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/fleet/migrate-out", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=max(0.1, float(timeout_s) + 2.0)
            ) as r:
                ack = json.loads(r.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise MigrationError(
                f"replica {self.replica_id} migrate-out failed: {e}"
            ) from e
        if not ack.get("ok"):
            raise MigrationError(
                f"replica {self.replica_id} migrate-out rejected: "
                f"{ack.get('error')!r}"
            )
        return ack

    def p2p_fetch(
        self, tokens, source_url: str, timeout_s: float, wire: str = "v1",
    ) -> dict:
        """Command this (remote) replica to pull the pages covering
        ``tokens`` from ``source_url``'s ``POST /fleet/pages`` and bind
        them (§21). Returns the bind ACK. Failures raise MigrationError —
        the commanding router falls back to the cold path; the owner
        never released anything (a fetch copies)."""
        body = json.dumps({
            "prompt_tokens": [int(t) for t in tokens],
            "source": str(source_url),
            "timeout-s": float(timeout_s),
            "wire": "v2" if wire == "v2" else "v1",
        }).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/fleet/fetch", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=max(0.1, float(timeout_s) + 2.0)
            ) as r:
                ack = json.loads(r.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise MigrationError(
                f"replica {self.replica_id} p2p fetch failed: {e}"
            ) from e
        if not ack.get("ok"):
            raise MigrationError(
                f"replica {self.replica_id} p2p fetch rejected: "
                f"{ack.get('error')!r}"
            )
        return ack

    def reset_histograms(self) -> None:
        try:
            urllib.request.urlopen(
                urllib.request.Request(
                    self.url + "/fleet/reset", data=b"{}", method="POST",
                    headers={"Content-Type": "application/json"},
                ),
                timeout=self.beacon_timeout_s,
            ).read()
        except (urllib.error.URLError, OSError) as e:
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


@dataclass
class _ReplicaState:
    handle: Any
    beacon: dict[str, Any] = field(default_factory=dict)
    beacon_at: float = -1e18  # monotonic of last SUCCESSFUL refresh
    failed_at: float = -1e18  # monotonic of last mark_failed
    digests: dict[str, int] = field(default_factory=dict)  # digest → length
    # hibernated (host-tier) prefix digests: the session's KV survives on
    # the replica but needs a restore — scored at spill_discount
    spilled_digests: dict[str, int] = field(default_factory=dict)
    adapters: frozenset = frozenset()  # resident LoRA adapter names
    # disaggregated serving (§18): the replica's advertised phase role —
    # prefill replicas absorb long-prompt bursts, decode replicas hold the
    # steady state, mixed (the default) serves both
    role: str = "mixed"
    # advertised wire capabilities ("kvmig", "dfa-resume", ...): empty for
    # legacy peers — the router only migrates to / resumes constrained
    # streams on replicas that prove they understand the payload
    caps: frozenset = frozenset()
    # per-tenant queue pressure (docs/SERVING.md §19): tenant id →
    # {queued, queue_wait_ema_s, over_quota, ...} from the beacon; empty
    # for legacy peers (tenant-aware routing simply has no signal then)
    tenants: dict[str, dict] = field(default_factory=dict)
    # the replica's brownout ladder level (0 = normal)
    brownout_level: int = 0
    # circuit breaker (docs/SERVING.md §17): consecutive beacon-fetch +
    # dispatch failures drive an exponential probe backoff — the refresh
    # loop stops hammering a dead peer's /state every interval, and the
    # backoff expiry IS the half-open probe slot (one beacon fetch; a
    # fresh beacon closes the circuit, a failure doubles the backoff)
    fails: int = 0
    backoff_until: float = -1e18
    circuit_open: bool = False


@dataclass
class RouteDecision:
    replica_id: str
    handle: Any
    kind: str  # affinity | sticky | balanced | prefill | migrated
    expected_match: int
    score: float
    # disaggregated handoff (§18): True when this route lands the PREFILL
    # phase on a prefill-tagged replica and the router intends to migrate
    # the KV to a decode replica once the first token lands — the
    # completions fast path must NOT short-circuit such a route even when
    # it is local (the router owns the orchestration)
    disagg: bool = False
    # P2P page fetch hint (§21): the live peer whose advertised prefix
    # beats this replica's own match by ≥ p2p_threshold tokens — the
    # router pulls the pages from it before dispatch so the prefix admits
    # warm; None when nobody qualifies. Best-effort: every fetch failure
    # degrades to the local cold path.
    p2p_source: Optional[str] = None
    p2p_match: int = 0


class FleetRouter:
    """Prefix-affinity-first, load-second dispatch across replicas.

    ``route()`` is pure host bookkeeping under one lock — no I/O, no
    hashing beyond one digest per advertised boundary length (<1 ms p50,
    histogram-enforced by the bench). Beacons refresh on a background
    thread (``start()``); a replica whose beacon goes stale, whose process
    stops answering, or that advertises drain/quarantine simply drops out
    of the routable set — requests re-route, nothing hangs."""

    POLICIES = ("affinity", "round-robin", "least-loaded")

    # lock discipline registry (analysis pass `locks`, docs/ANALYSIS.md):
    # routing state and every counter stats() snapshots live under _lock;
    # histograms record under their own _hist_lock so a slow percentile
    # read never blocks route().
    _GUARDED = {
        "_lock": (
            "_replicas", "_sticky", "_rr", "_last_demand_t", "_p2p_bw_ema",
            "routed_affinity_total", "routed_sticky_total",
            "sticky_held_total", "routed_balanced_total",
            "routed_adapter_total", "shed_total", "failover_total",
            "stream_failover_total", "beacon_failures_total",
            "circuit_open_total", "tenant_shed_total",
            "routed_tenant_affinity_total", "routed_prefill_total",
            "migrations_total", "migrate_pages_total",
            "migrate_bytes_total", "migrate_fallbacks_total",
            "p2p_fetch_total", "p2p_fetch_fallback_total",
            "p2p_bytes_in_total", "p2p_cost_routed_total",
            "prefetch_total", "prefetch_fetch_total",
        ),
    }

    def __init__(
        self,
        replicas: list[Any],
        *,
        lam: float = DEFAULT_LAMBDA,
        policy: str = "affinity",
        beacon_ttl_s: float = 10.0,
        refresh_interval_s: float = 0.5,
        sticky_ttl_s: float = 600.0,
        fail_cooldown_s: float = 5.0,
        shed_queue_wait_s: float = 30.0,
        adapter_affinity_tokens: float = 512.0,
        tenant_affinity_tokens: float = 256.0,
        brownout_penalty_tokens: float = 128.0,
        spill_discount: float = 0.5,
        beacon_backoff_max_s: float = 30.0,
        circuit_failures: int = 3,
        prefill_route_threshold: int = 2048,
        migrate: bool = True,
        migrate_timeout_s: float = 30.0,
        p2p: bool = True,
        p2p_threshold: int = 256,
        p2p_min_gap: int = 0,
    ) -> None:
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown fleet policy {policy!r}; supported: {self.POLICIES}"
            )
        if not replicas:
            raise ValueError("fleet router needs >= 1 replica")
        self.lam = float(lam)
        self.policy = policy
        self.beacon_ttl_s = float(beacon_ttl_s)
        self.refresh_interval_s = float(refresh_interval_s)
        self.sticky_ttl_s = float(sticky_ttl_s)
        self.fail_cooldown_s = float(fail_cooldown_s)
        self.shed_queue_wait_s = float(shed_queue_wait_s)
        # adapter affinity in PREFIX-TOKEN units: routing a tenant to a
        # replica already holding its adapter is scored as worth this many
        # warm prefix tokens (a hot-swap dispatch ≈ re-prefilling that
        # much prompt on the engines measured; tune alongside λ — §15)
        self.adapter_affinity_tokens = float(adapter_affinity_tokens)
        # tenant-aware routing (§19): a tenant's queued backlog on a
        # replica scores its NEXT request toward that same replica (in
        # prefix-token units) — aggressor overflow concentrates where the
        # aggressor already queues, away from the victim's replica; a
        # browned-out replica is penalized per ladder level
        self.tenant_affinity_tokens = float(tenant_affinity_tokens)
        self.brownout_penalty_tokens = float(brownout_penalty_tokens)
        # a HIBERNATED prefix match (the owner spilled the session's pages
        # to host RAM) is worth this fraction of a device-resident match:
        # the restore is a DMA upload, cheaper than re-prefilling but not
        # free — and it says nothing about the replica being otherwise
        # idle. 0 ignores spilled advertisements; 1 scores them at par.
        self.spill_discount = min(1.0, max(0.0, float(spill_discount)))
        # probe backoff cap + the consecutive-failure count at which the
        # breaker is DECLARED open (routability is already gated by beacon
        # freshness from the first failure; the threshold only decides
        # when the state — and the circuit_open_total transition counter —
        # reads "open" rather than "blip")
        self.beacon_backoff_max_s = float(beacon_backoff_max_s)
        self.circuit_failures = max(1, int(circuit_failures))
        # disaggregated prefill/decode (§18): an admission whose ESTIMATED
        # prefill (prompt minus the best advertised prefix match) reaches
        # the threshold routes to a prefill-tagged replica, prefills + its
        # first token there, then its KV pages MIGRATE to a decode replica
        # where the stream finishes — one 32k prompt never camps on the
        # replicas holding 95 steady decode streams. Takes effect only
        # when both roles are present and routable; `migrate=False` keeps
        # role-aware routing but decodes in place (no transfer).
        self.prefill_route_threshold = max(1, int(prefill_route_threshold))
        self.migrate_enabled = bool(migrate)
        self.migrate_timeout_s = float(migrate_timeout_s)
        # peer-to-peer page fetch on radix miss (§21, ROADMAP 2a): when
        # the chosen replica's own best match trails another live peer's
        # advertised (resident or spilled) prefix by at least
        # p2p_threshold tokens, the router commands a page fetch from the
        # owner over the migration wire before dispatch — the prefix
        # admits warm instead of re-prefilling, and every failure
        # (checksum, net-cut, deadline, no capable peer) degrades to the
        # local cold path. Both sides must advertise the "p2p" cap.
        self.p2p_enabled = bool(p2p)
        self.p2p_threshold = max(1, int(p2p_threshold))
        # fetch-vs-prefill cost model (§23): once both sides publish the
        # inputs — the owner's page geometry, the destination's measured
        # prefill tokens/s, and this router's observed fetch bandwidth —
        # the P2P decision compares ESTIMATED seconds (bytes moved over
        # the wire vs the gap re-prefilled locally) instead of the flat
        # token threshold. The flat threshold stays as the fallback when
        # any input is missing (legacy beacons, cold router), and
        # p2p_min_gap is the compat FLOOR either way: a gap below it
        # never fetches, however favorable the estimate — pulling 3
        # pages' worth of tokens is never worth a wire round-trip. 0
        # derives the floor from the threshold.
        self.p2p_min_gap = (
            max(1, int(p2p_min_gap))
            if p2p_min_gap
            else min(64, self.p2p_threshold)
        )
        # observed P2P fetch bandwidth (bytes/s, EMA over landed fetches):
        # the cost model's wire-speed input — measured, like the beacon's
        # prefill_tps, so the estimate tracks the actual deployment
        self._p2p_bw_ema = 0.0
        self._lock = threading.Lock()
        self._replicas: dict[str, _ReplicaState] = {}
        for r in replicas:
            if r.replica_id in self._replicas:
                raise ValueError(f"duplicate replica id {r.replica_id!r}")
            self._replicas[r.replica_id] = _ReplicaState(handle=r)
        self._sticky: dict[str, tuple[str, float]] = {}
        self._rr = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters (under _lock) + the dispatch-overhead histogram the
        # acceptance criterion reads
        self.routed_affinity_total = 0
        self.routed_sticky_total = 0
        # sticky pins held through an owner's recovery window (§20): the
        # session served elsewhere WITHOUT repointing, so it lands back on
        # its owner after the backoff
        self.sticky_held_total = 0
        self.routed_balanced_total = 0
        self.routed_adapter_total = 0
        self.shed_total = 0
        self.failover_total = 0
        # wire hardening (docs/SERVING.md §17): mid-STREAM warm failovers
        # (a cold failover before the first frame counts only in
        # failover_total), beacon-fetch failures, and circuit-open
        # transitions
        self.stream_failover_total = 0
        self.beacon_failures_total = 0
        self.circuit_open_total = 0
        # multi-tenant overload control (§19): router-level tenant sheds
        # (over-quota fleet-wide — counted inside shed_total too) and
        # tenant-pressure-affinity routes (the aggressor's overflow kept
        # on its own replica instead of balanced onto the victim's)
        self.tenant_shed_total = 0
        self.routed_tenant_affinity_total = 0
        # disaggregated serving (§18): prefill-handoff routes, completed
        # migrations (pages/bytes by receiver ACK), and fallbacks (the
        # migration failed and the stream decoded in place / re-prefilled)
        self.routed_prefill_total = 0
        self.migrations_total = 0
        self.migrate_pages_total = 0
        self.migrate_bytes_total = 0
        self.migrate_fallbacks_total = 0
        # P2P page fetch (§21): completed fetches (with bytes pulled in,
        # by receiver ACK) and fallbacks — a failed fetch costs one
        # counter bump and a flight dump, then the request prefills cold
        self.p2p_fetch_total = 0
        self.p2p_fetch_fallback_total = 0
        self.p2p_bytes_in_total = 0
        # fetch-vs-prefill cost model + prefetch-on-hint (§23): hints
        # admitted by the ESTIMATE (not the flat threshold), prefetch
        # calls taken, and prefetches that actually moved pages
        self.p2p_cost_routed_total = 0
        self.prefetch_total = 0
        self.prefetch_fetch_total = 0
        # scale-to-zero (§23): monotonic stamp of the last routed demand —
        # desired_replicas() returns 0 only once demand has been quiet for
        # a full target window AND every live replica checkpoints durably
        self._last_demand_t = time.monotonic()
        self._hist_lock = threading.Lock()
        self.dispatch_hist = Histogram(
            "fleet_dispatch_s",
            "router route() host wall time per dispatch (s)",
            log_buckets(1e-7, 1.0, 4),
        )
        self.hop_hist = Histogram(
            "fleet_hop_s",
            FLEET_HISTOGRAMS["fleet_hop_s"]["help"],
            FLEET_HISTOGRAMS["fleet_hop_s"]["buckets"],
        )
        self.migrate_hist = Histogram(
            "fleet_migrate_s",
            FLEET_HISTOGRAMS["fleet_migrate_s"]["help"],
            FLEET_HISTOGRAMS["fleet_migrate_s"]["buckets"],
        )
        # the router's own flight recorder: its ring stays empty (no
        # engine loop here) — fleet-failover dumps carry the hop's frame
        # TRACE in extra instead, token-content-free like every dump
        self._flight = FlightRecorder(
            capacity=8,
            dump_dir=os.environ.get("LSTPU_FLIGHT_DIR") or None,
        )

    # -- beacon refresh -----------------------------------------------------

    def refresh_all(self, force: bool = True) -> int:
        """Fetch every replica's beacon once (synchronously). Returns how
        many refreshed successfully. Failures just leave the old beacon to
        age out — route() treats stale as unroutable — and feed the
        per-replica circuit breaker (§17): consecutive failures back the
        probe off exponentially (capped at ``beacon_backoff_max_s``), so
        the refresh loop stops hitting a dead peer's /state every interval
        forever. ``force=False`` (the background loop) honors the backoff
        — a skipped replica is simply not yet due for its half-open probe;
        the default probes everything (manual refresh, tests, start())."""
        ok = 0
        for state in list(self._replicas.values()):
            if not force:
                with self._lock:
                    if time.monotonic() < state.backoff_until:
                        continue  # circuit open: not due for the probe
            try:
                beacon = state.handle.fetch_beacon()
            except ReplicaError as e:
                log.debug("beacon refresh failed: %s", e)
                with self._lock:
                    self._note_failure_locked(state, beacon_fetch=True)
                continue
            except Exception:  # noqa: BLE001 — refresher must never die
                log.exception(
                    "beacon refresh crashed for %s", state.handle.replica_id
                )
                with self._lock:
                    self._note_failure_locked(state, beacon_fetch=True)
                continue
            with self._lock:
                state.beacon = beacon
                state.beacon_at = time.monotonic()
                state.digests = {
                    d: int(n) for d, n in (beacon.get("prefixes") or [])
                }
                state.spilled_digests = {
                    d: int(n)
                    for d, n in (beacon.get("spilled_prefixes") or [])
                }
                state.adapters = frozenset(
                    str(a) for a in (beacon.get("adapters") or [])
                )
                role = str(beacon.get("role") or "mixed")
                state.role = (
                    role if role in ("prefill", "decode", "mixed")
                    else "mixed"
                )
                state.caps = frozenset(
                    str(c) for c in (beacon.get("caps") or [])
                )
                state.tenants = {
                    str(name): dict(t)
                    for name, t in (beacon.get("tenants") or {}).items()
                    if isinstance(t, dict)
                }
                state.brownout_level = int(
                    beacon.get("brownout_level", 0) or 0
                )
                # a fresh beacon is the half-open probe SUCCEEDING: close
                # the circuit and forget the backoff
                if state.circuit_open:
                    log.info(
                        "circuit closed for replica %s (fresh beacon after "
                        "%d failure(s))", state.handle.replica_id, state.fails,
                    )
                state.fails = 0
                state.backoff_until = -1e18
                state.circuit_open = False
            ok += 1
        return ok

    def _note_failure_locked(
        self, state: _ReplicaState, beacon_fetch: bool
    ) -> None:
        """One beacon-fetch or dispatch failure (caller holds ``_lock``):
        advance the breaker — exponential probe backoff from the first
        failure, the OPEN transition (counted once) at the threshold."""
        state.fails += 1
        if beacon_fetch:
            self.beacon_failures_total += 1
        base = max(self.refresh_interval_s, 0.1)
        state.backoff_until = time.monotonic() + min(
            base * (2 ** min(state.fails - 1, 16)), self.beacon_backoff_max_s
        )
        if state.fails >= self.circuit_failures and not state.circuit_open:
            state.circuit_open = True
            self.circuit_open_total += 1
            log.warning(
                "circuit OPEN for replica %s after %d consecutive "
                "failure(s); half-open probe in <= %.1fs",
                state.handle.replica_id, state.fails,
                max(0.0, state.backoff_until - time.monotonic()),
            )

    def start(self, initial_refresh: bool = True) -> None:
        if initial_refresh:
            self.refresh_all()
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._refresh_loop, name="fleet-beacons", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            # the loop honors per-replica backoff: a dead peer is probed
            # on the circuit's half-open schedule, not every interval
            self.refresh_all(force=False)

    # -- health -------------------------------------------------------------

    @property
    def replica_count(self) -> int:
        return len(self._replicas)

    def note_failover(self, replica_id: str) -> None:
        """A caller-observed mid-dispatch death: quarantine the replica AND
        count the failover — the completions path's failover loop must show
        up in fleet stats exactly like router.generate's own."""
        self.mark_failed(replica_id)
        with self._lock:
            self.failover_total += 1

    def mark_failed(self, replica_id: str) -> None:
        """A dispatch to this replica failed: quarantine it for
        ``fail_cooldown_s`` (and until a FRESH beacon proves it back). Its
        sticky sessions fail over cold at their next request. Dispatch
        failures feed the same circuit breaker as beacon-fetch failures —
        readmission is always through the half-open beacon probe."""
        with self._lock:
            state = self._replicas.get(replica_id)
            if state is None:
                return
            now = time.monotonic()
            state.failed_at = now
            # the beacon that routed us here predates the failure — drop it
            # so recovery requires a refresh newer than the incident
            state.beacon_at = -1e18
            self._note_failure_locked(state, beacon_fetch=False)

    def _routable(self, state: _ReplicaState, now: float) -> bool:
        if now - state.failed_at < self.fail_cooldown_s:
            return False
        if now - state.beacon_at > self.beacon_ttl_s:
            return False
        b = state.beacon
        # `recovering` excludes WITHOUT quarantining (§20): no failed_at
        # stamp, no circuit-breaker count — the replica readmits itself
        # with its first post-recovery beacon instead of serving a
        # fail_cooldown_s sentence for a recovery that took seconds
        return not (
            b.get("draining") or b.get("quarantined") or b.get("recovering")
        )

    def _recovering_hold(self, state: Optional["_ReplicaState"], now: float) -> bool:
        """True when a sticky session's replica is out of rotation ONLY
        because its fresh beacon says `recovering`: the pin is HELD (not
        popped, not repointed) so the session resumes on its owner after
        the backoff window instead of migrating cold elsewhere (§20)."""
        return (
            state is not None
            and now - state.beacon_at <= self.beacon_ttl_s
            and now - state.failed_at >= self.fail_cooldown_s
            and bool(state.beacon.get("recovering"))
            and not state.beacon.get("quarantined")
            and not state.beacon.get("draining")
        )

    # -- routing ------------------------------------------------------------

    @staticmethod
    def _load(beacon: dict[str, Any]) -> float:
        return float(beacon.get("load_score", 0.0) or 0.0)

    def route(
        self,
        tokens,
        session_id: Optional[str] = None,
        exclude: Optional[set] = None,
        adapter: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> RouteDecision:
        """Pick the replica for one request. Raises FleetShedError when no
        replica is routable or every routable replica is saturated (full
        admission queue, or queue-wait EMA past ``shed_queue_wait_s``).
        ``adapter``: the request's LoRA adapter name — replicas advertising
        it resident score an ``adapter_affinity_tokens`` bonus alongside
        prefix affinity. ``tenant``: the request's tenant id — drives the
        tenant-aware shed (over-quota anywhere → 429, never balanced onto
        another replica) and the pressure-affinity term that keeps an
        aggressor's overflow off the replica serving the victim (§19)."""
        t0 = time.perf_counter()
        try:
            return self._route(
                list(tokens), session_id, exclude or set(), adapter, tenant
            )
        finally:
            # Histogram.record is single-writer by contract (the engine's
            # histograms have exactly one writer thread); route() runs on
            # many dispatch threads, so the router serializes its own
            # recording
            with self._hist_lock:
                self.dispatch_hist.record(time.perf_counter() - t0)

    def _route(
        self, tokens: list, session_id: Optional[str], exclude: set,
        adapter: Optional[str] = None, tenant: Optional[str] = None,
    ) -> RouteDecision:
        now = time.monotonic()
        with self._lock:
            # scale-to-zero demand clock (§23): EVERY route attempt is
            # demand, even one that sheds — the autoscaler must not scale
            # to zero under a backlog it happens to be rejecting
            self._last_demand_t = now
            live = [
                s
                for rid, s in self._replicas.items()
                if rid not in exclude and self._routable(s, now)
            ]
            if not live:
                self.shed_total += 1
                raise FleetShedError(
                    "no routable replica (all stale, draining, quarantined "
                    "or excluded)",
                    retry_after_s=max(self.refresh_interval_s, 0.5),
                )
            # tenant-aware shed (docs/SERVING.md §19): a tenant over its
            # token-rate quota on any routable replica is shed AT THE
            # ROUTER — its overflow must never be balanced onto the
            # replica serving a within-quota victim. Retry-After comes
            # from the tenant's own worst queue-wait EMA, not the fleet's.
            if tenant:
                pressured = [
                    s.tenants[tenant] for s in live if tenant in s.tenants
                ]
                if any(t.get("over_quota") for t in pressured):
                    self.shed_total += 1
                    self.tenant_shed_total += 1
                    raise FleetShedError(
                        f"tenant {tenant!r} is over its token-rate quota "
                        "fleet-wide",
                        retry_after_s=max(
                            (
                                float(t.get("queue_wait_ema_s", 0.0))
                                for t in pressured
                            ),
                            default=0.0,
                        ) or 1.0,
                    )
            # fleet-level shed: every routable replica says it cannot take
            # more — the replicas' OWN exported signals, not a blind bound
            saturated = [
                s
                for s in live
                if (
                    s.beacon.get("queue_depth", 0) > 0
                    and s.beacon.get("queued", 0)
                    >= s.beacon.get("queue_depth", 0)
                )
                or float(s.beacon.get("queue_wait_ema_s", 0.0))
                >= self.shed_queue_wait_s
            ]
            if len(saturated) == len(live):
                self.shed_total += 1
                retry = min(
                    max(float(s.beacon.get("queue_wait_ema_s", 0.0)), 0.1)
                    for s in live
                )
                raise FleetShedError(
                    f"all {len(live)} routable replicas saturated",
                    retry_after_s=retry,
                )
            if self.policy == "round-robin":
                state = live[self._rr % len(live)]
                self._rr += 1
                self.routed_balanced_total += 1
                return self._decide_locked(state, "balanced", 0, session_id, now)
            # sticky: same session stays on its replica while that replica
            # stays routable (its aliased pages are live there)
            pin_session = session_id
            if session_id:
                self._prune_sticky_locked(now)
                held = self._sticky.get(session_id)
                if held is not None:
                    rid, last_used = held
                    state = self._replicas.get(rid)
                    if (
                        now - last_used <= self.sticky_ttl_s
                        and state is not None
                        and state in live
                    ):
                        self.routed_sticky_total += 1
                        return self._decide_locked(state, "sticky", 0, session_id, now)
                    if (
                        now - last_used <= self.sticky_ttl_s
                        and self._recovering_hold(state, now)
                    ):
                        # the owner is merely RECOVERING (§20): serve this
                        # request elsewhere but HOLD the pin — no pop, no
                        # repoint — so the session lands back on its owner
                        # once its post-recovery beacon readmits it
                        self.sticky_held_total += 1
                        pin_session = None
                    else:
                        # replica gone or the session idled past its TTL
                        # (its pages are likely evicted by now): fall
                        # through — the session re-routes cold to whatever
                        # wins below
                        self._sticky.pop(session_id, None)
            if self.policy == "least-loaded":
                state = min(live, key=lambda s: self._load(s.beacon))
                self.routed_balanced_total += 1
                return self._decide_locked(state, "balanced", 0, pin_session, now)
            # affinity scoring: hash the prompt once per advertised length
            # (device-resident AND hibernated advertisements both probe)
            lengths = sorted(
                {
                    n
                    for s in live
                    for src in (s.digests, s.spilled_digests)
                    for n in src.values()
                    if n <= len(tokens) - 1
                }
            )
            probe = {n: prefix_digest(tokens[:n]) for n in lengths}
            scored: list[tuple[_ReplicaState, int, bool, int]] = []
            for s in live:
                match, spilled_match = 0, 0
                for n in lengths:
                    if s.digests.get(probe[n]) == n and n > match:
                        match = n
                    if (
                        s.spilled_digests.get(probe[n]) == n
                        and n > spilled_match
                    ):
                        spilled_match = n
                # a hibernated session's KV still lives on its owner — a
                # restore beats a cold re-prefill anywhere else, so the
                # spilled match competes, discounted (tiered KV, §16)
                effective = max(
                    match, int(spilled_match * self.spill_discount)
                )
                adapter_hit = bool(adapter) and adapter in s.adapters
                # the UNDISCOUNTED depth this replica can SERVE pages for
                # (resident or hibernated — a P2P fetch reads the host
                # arena either way, §21): the owner-selection signal
                raw = max(match, spilled_match)
                scored.append((s, effective, adapter_hit, raw))
            # role-aware candidate set (disaggregated serving, §18): with
            # BOTH roles routable, a prefill-heavy admission (estimated
            # prefill = prompt minus the best warm match anywhere) lands
            # on a prefill-tagged replica — the handoff route the caller
            # migrates away from once the first token lands — and
            # everything else keeps the decode/mixed pool, so one 32k
            # prompt never stalls the steady decode streams
            disagg = False
            kind_override = None
            candidates = scored
            prefill_pool = [t for t in scored if t[0].role == "prefill"]
            decode_pool = [
                t for t in scored if t[0].role in ("decode", "mixed")
            ]
            if prefill_pool and decode_pool:
                best_anywhere = max(m for _, m, _, _ in scored)
                est_prefill = len(tokens) - best_anywhere
                if est_prefill >= self.prefill_route_threshold:
                    candidates = prefill_pool
                    kind_override = "prefill"
                    disagg = self.migrate_enabled
                    self.routed_prefill_total += 1
                else:
                    candidates = decode_pool
            # no role split (prefill-only or decode/mixed-only fleets):
            # candidates stays the full scored set
            best, best_score, best_match = None, None, 0
            best_raw = 0
            best_adapter_hit = False
            best_tenant_hit = False
            for s, effective, adapter_hit, raw in candidates:
                # tenant pressure affinity (§19): a tenant with queued
                # work on a replica scores a bonus THERE — the burster's
                # overflow concentrates where its backlog (and its sheds)
                # already live instead of spilling onto the replica
                # serving a quiet victim. A replica deep into brownout is
                # penalized one backlog-unit per ladder level.
                tenant_hit = bool(
                    tenant
                    and int(
                        s.tenants.get(tenant, {}).get("queued", 0)
                    ) > 0
                )
                score = (
                    effective
                    + (self.adapter_affinity_tokens if adapter_hit else 0.0)
                    + (self.tenant_affinity_tokens if tenant_hit else 0.0)
                    - self.lam * self._load(s.beacon)
                    - self.brownout_penalty_tokens * s.brownout_level
                )
                if best_score is None or score > best_score:
                    best, best_score, best_match = s, score, effective
                    best_raw = raw
                    best_adapter_hit = adapter_hit
                    best_tenant_hit = tenant_hit
            assert best is not None
            if best_adapter_hit:
                self.routed_adapter_total += 1
            if best_tenant_hit:
                self.routed_tenant_affinity_total += 1
            if kind_override is not None:
                kind = kind_override
            elif best_match > 0 or best_adapter_hit:
                self.routed_affinity_total += 1
                kind = "affinity"
            else:
                # nobody holds a usable prefix: least-loaded fallback (the
                # scored argmax already IS least-loaded when match==0 for
                # everyone, since score reduces to −λ·load)
                self.routed_balanced_total += 1
                kind = "balanced"
            # P2P page fetch hint (§21, ROADMAP 2a): the chosen replica's
            # trie misses (or matches shallow) while another LIVE peer
            # advertises the prefix ≥ p2p_threshold tokens deeper — pull
            # the pages from that owner over the migration wire before
            # dispatch and admit warm instead of re-prefilling. Both the
            # owner (serves /fleet/pages) and the destination (binds and,
            # when remote, runs the fetch) must advertise "p2p"; the
            # disaggregated prefill handoff keeps its own migration path.
            p2p_source, p2p_match = None, 0
            if (
                self.p2p_enabled
                and kind_override is None
                and "p2p" in best.caps
            ):
                owner, owner_raw = None, 0
                for s, _, _, raw in scored:
                    if s is best or "p2p" not in s.caps:
                        continue
                    if raw > owner_raw:
                        owner, owner_raw = s, raw
                if owner is not None and self._p2p_worth_it_locked(
                    best, owner, best_raw, owner_raw
                ):
                    p2p_source = owner.handle.replica_id
                    p2p_match = owner_raw
            return self._decide_locked(
                best, kind, best_match, pin_session, now, disagg=disagg,
                p2p_source=p2p_source, p2p_match=p2p_match,
            )

    def _p2p_worth_it_locked(
        self,
        best: _ReplicaState,
        owner: _ReplicaState,
        best_raw: int,
        owner_raw: int,
    ) -> bool:
        """Should the router pull ``owner``'s advertised prefix into
        ``best`` before dispatch? The fetch-vs-prefill cost model (§23):
        estimated wire seconds (pages moved at the observed fetch
        bandwidth) against estimated prefill seconds (the token gap at
        the destination's measured landed throughput). Falls back to the
        flat ``p2p_threshold`` when any estimate input is missing —
        legacy beacons without geometry/tps, or a router that has not
        landed a fetch yet. ``p2p_min_gap`` floors BOTH modes: a
        few-page gap never justifies a wire round-trip, whatever the
        arithmetic says (and it keeps the model from thrashing on
        near-tie advertisements). Caller holds ``_lock``."""
        gap = owner_raw - best_raw
        if gap < self.p2p_min_gap:
            return False
        tps = float(best.beacon.get("prefill_tps", 0.0) or 0.0)
        bw = self._p2p_bw_ema
        bpp = int(owner.beacon.get("bytes_per_page", 0) or 0)
        page = int(owner.beacon.get("page_size", 0) or 0)
        if tps > 0.0 and bw > 0.0 and bpp > 0 and page > 0:
            # the fetch moves the WHOLE advertised prefix (bind needs a
            # boundary-aligned entry), while prefilling only pays the gap
            # the fetch would have saved
            est_fetch_s = math.ceil(owner_raw / page) * bpp / bw
            est_prefill_s = gap / tps
            if est_fetch_s < est_prefill_s:
                self.p2p_cost_routed_total += 1
                return True
            return False
        return gap >= self.p2p_threshold

    def _decide_locked(
        self,
        state: _ReplicaState,
        kind: str,
        match: int,
        session_id: Optional[str],
        now: float,
        disagg: bool = False,
        p2p_source: Optional[str] = None,
        p2p_match: int = 0,
    ) -> RouteDecision:
        rid = state.handle.replica_id
        if session_id:
            self._sticky[session_id] = (rid, now)
        return RouteDecision(
            replica_id=rid,
            handle=state.handle,
            kind=kind,
            expected_match=match,
            score=match - self.lam * self._load(state.beacon),
            disagg=disagg,
            p2p_source=p2p_source,
            p2p_match=p2p_match,
        )

    def _prune_sticky_locked(self, now: float) -> None:
        if len(self._sticky) < 4096:
            return
        self._sticky = {
            k: v
            for k, v in self._sticky.items()
            if now - v[1] <= self.sticky_ttl_s
        }

    # -- dispatch with failover ----------------------------------------------

    @staticmethod
    def _oneshot_frames(
        handle: Any, prompt: list, opts: dict, timeout_s: float,
    ) -> Iterator[dict]:
        """Frame adapter for transports without ``generate_stream`` (test
        fakes, older peers): ONE blocking dispatch wrapped into the frame
        shapes. The blocking call runs EAGERLY so its shed/failure raises
        inside the caller's dispatch try-block."""
        return result_frames(
            handle.generate(prompt, opts, timeout_s), prompt_len=len(prompt)
        )

    # -- disaggregated handoff (docs/SERVING.md §18) --------------------------

    def _pick_decode_target(
        self, exclude: set, require_caps: tuple = (),
    ) -> Optional[RouteDecision]:
        """The decode replica a just-prefilled stream migrates to:
        least-loaded among decode-tagged routable replicas (mixed as the
        fallback pool) that advertise every capability in
        ``require_caps``. Prefix affinity is irrelevant here — the pages
        travel WITH the stream. Returns None when no survivor can decode
        (the caller decodes in place)."""
        now = time.monotonic()
        with self._lock:
            live = [
                s for rid, s in self._replicas.items()
                if rid not in exclude and self._routable(s, now)
                and all(c in s.caps for c in require_caps)
            ]
            pool = [s for s in live if s.role == "decode"] or [
                s for s in live if s.role == "mixed"
            ]
            if not pool:
                return None
            best = min(pool, key=lambda s: self._load(s.beacon))
            return self._decide_locked(best, "migrated", 0, None, now)

    def _handoff_target(
        self,
        decision: RouteDecision,
        tokens: list,
        delivered: list,
        parsed: Any,
        last_dfa_state: Optional[int],
        session_id: Optional[str],
        exclude: set,
    ) -> RouteDecision:
        """Prefill phase complete: migrate the stream's KV to a decode
        replica and return the decision the resume hop MUST use. Every
        failure path returns the PREFILL replica itself — decode-in-place,
        the fallback that is always correct (the pages are there, the
        resume is warm) — and counts/dumps the fallback."""
        prompt = tokens + delivered
        # the target must UNDERSTAND the transfer ("kvmig" — a legacy peer
        # would 404/garble the bind) and, for a constrained stream, the
        # carried DFA state ("dfa-resume" — a peer that silently dropped
        # it would restart the grammar at 0: invalid output)
        need = ("kvmig", "dfa-resume") if parsed.response_format else ("kvmig",)
        target = self._pick_decode_target(
            exclude | {decision.replica_id}, require_caps=need,
        )
        reason = None
        if target is None:
            reason = "no decode-capable replica routable"
        elif parsed.response_format and last_dfa_state is None:
            # the prefill hop's frames carried no DFA state (legacy peer):
            # migrating would strand a derivation the decode replica
            # cannot legally continue — decode where the grammar state is
            reason = "constrained stream carried no DFA state"
        if reason is None:
            state = {"sampling": {
                "temperature": parsed.temperature,
                "top-k": parsed.top_k, "top-p": parsed.top_p,
            }}
            if parsed.response_format and last_dfa_state is not None:
                state["grammar_key"] = json.dumps(
                    parsed.response_format, sort_keys=True,
                    separators=(",", ":"),
                )
                state["dfa_state"] = int(last_dfa_state)
            ack = self._migrate(decision, target, prompt, state)
            if ack is not None:
                if session_id:
                    # sticky repoint (§18): the session's KV now LIVES on
                    # the decode replica — the next turn must route there,
                    # not back to the prefill replica for a pointless
                    # second migration
                    with self._lock:
                        self._sticky[session_id] = (
                            target.replica_id, time.monotonic()
                        )
                return target
            reason = "migration failed"
        else:
            with self._lock:
                self.migrate_fallbacks_total += 1
            self._flight.dump(
                "migrate-failed",
                counters={
                    "migrate_fallbacks_total": self.migrate_fallbacks_total,
                    "delivered": len(delivered),
                },
                extra={
                    "error": reason, "src": decision.replica_id,
                    "fallback": "decode-in-place",
                },
                force=True,
            )
        log.warning(
            "disagg handoff falling back to decode-in-place on %s: %s",
            decision.replica_id, reason,
        )
        # decode-in-place: same replica, full remaining budget, no disagg
        return RouteDecision(
            replica_id=decision.replica_id, handle=decision.handle,
            kind="prefill", expected_match=len(prompt), score=decision.score,
            disagg=False,
        )

    def _has_cap(self, replica_id: str, cap: str) -> bool:
        with self._lock:
            state = self._replicas.get(replica_id)
            return state is not None and cap in state.caps

    def _migrate(
        self, src: RouteDecision, dst: RouteDecision, prompt: list,
        state: dict,
    ) -> Optional[dict]:
        """Run one KV-page migration src → dst (§18). Returns the
        receiver's ACK, or None after counting + dumping the failure —
        the sender retains its pages on every failure path, so the caller
        can always decode in place."""
        t0 = time.perf_counter()
        phases: dict[str, Any] = {}
        try:
            # wire negotiation (§21): push the binary codec only toward a
            # receiver that advertises it — everything else stays v1
            # NDJSON, byte-identical to the pre-v2 wire
            wire = "v2" if self._has_cap(dst.replica_id, "kvmig2") else "v1"
            if getattr(src.handle, "is_local", False):
                local_dst = getattr(dst.handle, "is_local", False)
                frames = migrate_mod.export_frames(
                    src.handle.engine, prompt,
                    timeout_s=self.migrate_timeout_s, state=state, phases=phases,
                    raw=not local_dst and wire == "v2",
                )
                if local_dst:
                    ack = migrate_mod.bind_frames(
                        dst.handle.engine, frames, timeout_s=self.migrate_timeout_s,
                    )
                else:
                    t1 = time.perf_counter()
                    ack = migrate_mod.push_migration(
                        str(getattr(dst.handle, "url", "")), frames,
                        self.migrate_timeout_s, wire=wire,
                    )
                    phases["transfer_ms"] = round((time.perf_counter() - t1) * 1e3, 3)
                migrate_mod._release_on_ack(src.handle.engine, prompt, ack)  # noqa: SLF001
            else:
                migrate_out = getattr(src.handle, "migrate_out", None)
                dst_url = str(getattr(dst.handle, "url", "") or "")
                if migrate_out is None or not dst_url.startswith("http"):
                    raise RuntimeError(
                        "source replica cannot push a migration to this "
                        "destination (no migrate-out transport / non-HTTP "
                        "receiver)"
                    )
                if wire == "v2":
                    try:
                        ack = migrate_out(
                            prompt, dst_url, state, self.migrate_timeout_s, wire="v2",
                        )
                    except TypeError:
                        # a pre-v2 source handle: its NDJSON push is
                        # still valid toward a v2 receiver
                        ack = migrate_out(prompt, dst_url, state, self.migrate_timeout_s)
                else:
                    ack = migrate_out(prompt, dst_url, state, self.migrate_timeout_s)
                phases.update(ack.get("phases") or {})
            ack["phases"] = phases
            took = time.perf_counter() - t0
            with self._hist_lock:
                self.migrate_hist.record(took)
            with self._lock:
                self.migrations_total += 1
                self.migrate_pages_total += int(ack.get("pages", 0))
                self.migrate_bytes_total += int(ack.get("bytes", 0))
            log.info(
                "migrated %s pages (%s bytes) %s → %s in %.1f ms",
                ack.get("pages"), ack.get("bytes"),
                src.replica_id, dst.replica_id, took * 1e3,
            )
            return ack
        except Exception as e:  # noqa: BLE001 — every failure falls back
            took = time.perf_counter() - t0
            with self._hist_lock:
                # failed migrations land in the histogram too — the panel
                # must move during incidents
                self.migrate_hist.record(took)
            with self._lock:
                self.migrate_fallbacks_total += 1
                fallbacks = self.migrate_fallbacks_total
            self._flight.dump(
                "migrate-failed",
                counters={"migrate_fallbacks_total": fallbacks},
                extra={
                    "error": str(e), "src": src.replica_id,
                    "dst": dst.replica_id,
                    "phases": phases,
                    "total_ms": round(took * 1e3, 3),
                    "fallback": "decode-in-place",
                },
                force=True,
            )
            log.warning(
                "KV migration %s → %s failed after %.1f ms (%s); sender "
                "retains, stream decodes in place",
                src.replica_id, dst.replica_id, took * 1e3, e,
            )
            return None

    def _p2p_fetch(self, decision: RouteDecision, prompt: list) -> bool:
        """Pull the pages backing ``prompt``'s prefix from the owning
        peer (``decision.p2p_source``) into the routed replica BEFORE
        dispatch (§21, ROADMAP 2a) — the owner keeps its copy (a fetch
        copies, a migration moves) and the routed replica admits warm
        instead of re-prefilling. Returns True when the prefix bound;
        EVERY failure — checksum mismatch, net-cut, deadline, owner gone,
        no transport — counts one fallback, dumps a flight record and
        returns False: the request then prefills cold exactly as if no
        owner existed (same §17 ladder shape as a failed migration)."""
        src_id = str(decision.p2p_source)
        with self._lock:
            src_state = self._replicas.get(src_id)
        t0 = time.perf_counter()
        try:
            if src_state is None:
                raise MigrationError(f"p2p owner {src_id} is not a fleet member")
            src = src_state.handle
            # codec negotiation rides the OWNER's caps here — it is the
            # sender of the page bytes
            wire = "v2" if "kvmig2" in src_state.caps else "v1"
            timeout_s = self.migrate_timeout_s
            if getattr(decision.handle, "is_local", False):
                if getattr(src, "is_local", False):
                    frames = migrate_mod.export_frames(src.engine, prompt, timeout_s=timeout_s)
                else:
                    src_url = str(getattr(src, "url", "") or "")
                    if not src_url.startswith("http"):
                        raise MigrationError(f"p2p owner {src_id} has no page-fetch transport")
                    frames = migrate_mod.fetch_pages(src_url, prompt, timeout_s, wire=wire)
                ack = migrate_mod.bind_frames(
                    decision.handle.engine, frames, timeout_s=timeout_s
                )
            else:
                fetch = getattr(decision.handle, "p2p_fetch", None)
                src_url = str(getattr(src, "url", "") or "")
                if fetch is None or not src_url.startswith("http"):
                    raise MigrationError("routed replica cannot run a p2p fetch (no transport)")
                ack = fetch(prompt, src_url, timeout_s, wire=wire)
            elapsed = time.perf_counter() - t0
            with self._lock:
                self.p2p_fetch_total += 1
                self.p2p_bytes_in_total += int(ack.get("bytes", 0))
                # feed the cost model's bandwidth EMA from LANDED fetches
                # only (a failed fetch says nothing about wire speed);
                # idempotent re-binds ack 0 bytes and are skipped
                if int(ack.get("bytes", 0)) > 0 and elapsed > 0:
                    obs_bw = int(ack["bytes"]) / elapsed
                    self._p2p_bw_ema = (
                        obs_bw
                        if self._p2p_bw_ema <= 0.0
                        else 0.8 * self._p2p_bw_ema + 0.2 * obs_bw
                    )
            log.info(
                "p2p fetched %s pages (%s bytes) %s → %s in %.1f ms",
                ack.get("pages"), ack.get("bytes"), src_id,
                decision.replica_id, (time.perf_counter() - t0) * 1e3,
            )
            return True
        except Exception as e:  # noqa: BLE001 — every failure falls back
            with self._lock:
                self.p2p_fetch_fallback_total += 1
                fallbacks = self.p2p_fetch_fallback_total
            self._flight.dump(
                "p2p-fetch-failed",
                counters={"p2p_fetch_fallback_total": fallbacks},
                extra={
                    "error": str(e), "src": src_id,
                    "dst": decision.replica_id,
                    "match": int(decision.p2p_match),
                    "total_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    "fallback": "local-cold-prefill",
                },
                force=True,
            )
            log.warning(
                "p2p page fetch %s → %s failed (%s); prefilling cold",
                src_id, decision.replica_id, e,
            )
            return False

    def prefetch(
        self,
        tokens,
        session_id: Optional[str] = None,
        adapter: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> dict:
        """Prefetch-on-hint (§23): a beacon hint — 'this session's next
        turn is coming' — warms the pages BEFORE the request routes.
        Runs the exact route() the request will run (so the sticky pin
        and the eventual dispatch agree on the replica), then fires the
        P2P/durable page fetch immediately instead of on the dispatch
        path; by the time the real request arrives, its prefix admits
        warm. Best-effort end to end: a shed, a hint nobody can improve
        on, or a failed fetch all return ``prefetched: False`` and cost
        the caller nothing — the request path is unchanged either way."""
        with self._lock:
            self.prefetch_total += 1
        try:
            decision = self.route(
                tokens, session_id=session_id, adapter=adapter,
                tenant=tenant,
            )
        except FleetShedError as e:
            return {"prefetched": False, "reason": str(e)}
        if not decision.p2p_source:
            return {
                "prefetched": False,
                "replica": decision.replica_id,
                "match": int(decision.expected_match),
                "reason": "no-deeper-owner",
            }
        ok = self._p2p_fetch(decision, list(tokens))
        if ok:
            with self._lock:
                self.prefetch_fetch_total += 1
        return {
            "prefetched": ok,
            "replica": decision.replica_id,
            "source": decision.p2p_source,
            "match": int(decision.p2p_match if ok else decision.expected_match),
        }

    def stream_generate(
        self,
        tokens,
        options: Optional[dict] = None,
        session_id: Optional[str] = None,
        timeout_s: Optional[float] = None,
    ) -> Iterator[dict]:
        """Route + STREAM one request with mid-stream warm failover
        (docs/SERVING.md §17). Yields router-sequenced frames (one
        contiguous ``seq`` across failovers — the client-facing
        no-dup/no-drop/no-reorder guarantee):

          route    before every hop: replica_id / url / local flag /
                   tokens-resumed count, plus the RouteDecision object
                   (in-process consumers only; never serialized)
          tokens   token chunks, piped through from the serving replica
          heartbeat  forwarded transport liveness (consumers may ignore
                   them; forwarding keeps this generator closeable
                   between tokens)
          end      exactly once on success: finish_reason, usage against
                   the ORIGINAL prompt, router-observed ttft_s/total_s,
                   the serving replica and the failover count

        A replica dying mid-stream (ReplicaError) is quarantined and the
        request re-dispatches to a survivor with ``prompt + delivered
        tokens`` as the new prompt — prefix reuse (and the host tier's
        spilled prefixes) makes the resume warm, and greedy resumed
        streams are token-exact vs an uninterrupted run. Each failover
        dumps a ``fleet-failover`` flight record carrying the hop's frame
        trace. Sheds exclude-and-retry as before; a bad request
        (ValueError) propagates untouched."""
        tokens = list(tokens)
        options = dict(options or {})
        # the canonical parse — NOT a re-implementation of the key chains
        # and defaults, which would silently diverge from what the
        # serving engine actually enforces
        parsed = GenerationOptions.from_dict(options)
        budget = int(parsed.max_new_tokens)
        total_s = (
            float(timeout_s) if timeout_s is not None
            else hop_timeout_s(options)
        )
        started = time.monotonic()
        first_token_at: Optional[float] = None
        delivered: list[int] = []
        out_seq = 0
        excluded: set = set()
        last_shed: Optional[FleetShedError] = None
        trace: deque = deque(maxlen=64)
        failovers = 0
        # set on a mid-stream death; counted + dumped only once route()
        # actually finds a survivor — a terminal failure is not a
        # "failover" (the metric means RESUMED, §17)
        pending_failover: Optional[dict] = None
        adapter = str(options.get("adapter") or "") or None
        tenant = getattr(parsed, "tenant", None)
        # disaggregated handoff state (§18): ``forced`` short-circuits
        # route() for the hop that must land on a SPECIFIC replica (the
        # decode target the KV just migrated to, or the prefill replica
        # decoding in place after a failed migration); ``last_dfa_state``
        # is the constrained stream's host-mirrored grammar state as
        # carried by the tokens frames — what makes a mid-derivation
        # resume legal instead of refused
        forced: Optional[RouteDecision] = None
        last_dfa_state: Optional[int] = None
        # attempt budget: one per replica, EXTENDED by one whenever a
        # prefill handoff consumes a turn (its hop ends in a migration,
        # not a failure) — a full fleet's worth of failovers still fits,
        # and the all-replicas-died exit below keeps raising ReplicaError
        # rather than letting an extra route() read as a shed
        attempts, max_attempts = 0, self.replica_count
        while attempts < max_attempts:
            attempts += 1
            prompt = tokens + delivered
            opts = dict(options)
            if delivered:
                # the resumed stream finishes the ORIGINAL budget: tokens
                # already delivered never re-generate (and never re-bill)
                opts["max-tokens"] = max(1, budget - len(delivered))
                if parsed.response_format and last_dfa_state is not None:
                    # resume the derivation FROM the carried state — the
                    # survivor's DFA must not restart at 0 (§18)
                    opts["grammar-resume-state"] = int(last_dfa_state)
            if forced is not None:
                decision, forced = forced, None
            else:
                try:
                    decision = self.route(
                        prompt, session_id=session_id, exclude=excluded,
                        adapter=adapter, tenant=tenant,
                    )
                except FleetShedError as e:
                    if delivered:
                        raise ReplicaError(
                            f"stream lost its replica after "
                            f"{len(delivered)} token(s) and no survivor "
                            f"is routable: {e}"
                        ) from e
                    raise
                if (
                    "grammar-resume-state" in opts
                    and not self._has_cap(decision.replica_id, "dfa-resume")
                ):
                    # a legacy survivor would silently DROP the resume
                    # state and restart the DFA at 0 — invalid output
                    # dressed as valid. Exclude it; another survivor may
                    # honor the state, and none at all is a loud failure
                    # (the all-attempts exit below).
                    excluded.add(decision.replica_id)
                    continue
            # P2P page fetch (§21): the route says another live peer owns
            # this prompt's prefix ≥ p2p_threshold tokens deeper than the
            # chosen replica — pull the pages over the migration wire
            # BEFORE dispatch so the prefill below starts warm. First hop
            # only (a resume's prefix already lives where it streamed),
            # and strictly best-effort: a failed fetch costs one counter
            # bump + flight dump inside _p2p_fetch, then this same hop
            # prefills cold.
            if decision.p2p_source and not delivered:
                self._p2p_fetch(decision, prompt)
            # prefill handoff (§18): run prefill + the FIRST token on the
            # prefill-tagged replica (TTFT comes from there), then migrate
            # the KV pages to a decode replica and finish the stream where
            # the steady decode pool lives
            handoff = (
                decision.disagg
                and budget - len(delivered) > 1
                and self.migrate_enabled
            )
            if handoff:
                opts["max-tokens"] = 1
            if pending_failover is not None:
                # the resume has a survivor: NOW it is a warm failover
                failovers += 1
                with self._lock:
                    self.stream_failover_total += 1
                    stream_failovers = self.stream_failover_total
                self._flight.dump(
                    "fleet-failover",
                    counters={
                        "delivered": pending_failover["delivered"],
                        "stream_failovers_total": stream_failovers,
                        "failover_total": self.failover_total,
                    },
                    extra={
                        **pending_failover,
                        "resumed_on": decision.replica_id,
                    },
                    force=True,  # every mid-stream resume is an incident
                )
                pending_failover = None
            yield {
                "v": FRAME_SCHEMA, "seq": out_seq, "kind": "route",
                "replica": decision.replica_id,
                "url": str(getattr(decision.handle, "url", "") or ""),
                "local": bool(getattr(decision.handle, "is_local", False)),
                "resumed": len(delivered),
                "disagg": bool(decision.disagg),
                "decision": decision,
            }
            out_seq += 1
            remaining = total_s - (time.monotonic() - started)
            if remaining <= 0:
                raise ReplicaError(
                    f"hop budget ({total_s:.1f}s) exhausted after "
                    f"{len(delivered)} token(s)"
                )
            stream_fn = getattr(decision.handle, "generate_stream", None)
            hop_t0 = time.perf_counter()
            handed_off = False
            try:
                frames = (
                    stream_fn(prompt, opts, timeout_s=remaining)
                    if stream_fn is not None
                    else self._oneshot_frames(
                        decision.handle, prompt, opts, remaining
                    )
                )
                for frame in frames:
                    kind = frame.get("kind")
                    trace.append({
                        "seq": frame.get("seq"), "kind": kind,
                        "n": (
                            len(frame.get("tokens") or [])
                            if kind == "tokens" else 0
                        ),
                        "t": round(time.monotonic() - started, 4),
                        "replica": decision.replica_id,
                    })
                    if kind == "tokens":
                        try:
                            toks = [
                                int(t) for t in frame.get("tokens") or []
                            ]
                        except (TypeError, ValueError) as bad:
                            # frame CONTENT from the replica, not the
                            # caller's request: this must read as a dead
                            # hop (failover), never as a bad request
                            raise ReplicaError(
                                f"replica {decision.replica_id}: corrupt "
                                f"tokens frame ({bad})"
                            ) from bad
                        if not toks:
                            continue
                        if first_token_at is None:
                            first_token_at = time.monotonic()
                        delivered.extend(toks)
                        if frame.get("dfa_state") is not None:
                            try:
                                last_dfa_state = int(frame["dfa_state"])
                            except (TypeError, ValueError):
                                last_dfa_state = None
                        yield {
                            "seq": out_seq, "kind": "tokens",
                            "tokens": toks, "replica": decision.replica_id,
                        }
                        out_seq += 1
                    elif kind == "end":
                        with self._hist_lock:
                            self.hop_hist.record(
                                time.perf_counter() - hop_t0
                            )
                        if (
                            handoff
                            and str(frame.get("finish_reason")) == "length"
                            and len(delivered) < budget
                        ):
                            # prefill phase done (our 1-token clamp, not a
                            # real completion): migrate, then resume on
                            # the decode target — or decode in place when
                            # anything about the transfer fails
                            forced = self._handoff_target(
                                decision, tokens, delivered, parsed,
                                last_dfa_state, session_id, excluded,
                            )
                            close = getattr(frames, "close", None)
                            if close is not None:
                                close()
                            handed_off = True
                            max_attempts += 1  # this turn was no failure
                            break
                        now = time.monotonic()
                        yield {
                            "seq": out_seq, "kind": "end",
                            "finish_reason": str(
                                frame.get("finish_reason", "stop")
                            ),
                            "prompt_tokens": len(tokens),
                            "completion_tokens": len(delivered),
                            "ttft_s": round(
                                (first_token_at or now) - started, 6
                            ),
                            "total_s": round(now - started, 6),
                            "engine_ttft_s": float(frame.get("ttft_s", 0.0)),
                            "failovers": failovers,
                            "replica": decision.replica_id,
                        }
                        return
                    elif kind == "heartbeat":
                        # forward (re-sequenced): the consumer may ignore
                        # them, but YIELDING here parks this generator at
                        # a resumable point between tokens — an abandoned
                        # stream's close() lands at the next heartbeat
                        # instead of waiting out an inter-token gap
                        yield {
                            "seq": out_seq, "kind": "heartbeat",
                            "replica": decision.replica_id,
                        }
                        out_seq += 1
                if handed_off:
                    continue
                raise ReplicaError(
                    f"replica {decision.replica_id}: stream ended without "
                    "terminal frame"
                )
            except GeneratorExit:
                # the CONSUMER abandoned this stream (disconnect, local
                # shortcut): close the hop so the serving replica cancels
                # its in-flight request instead of decoding to the budget
                close = getattr(frames, "close", None)
                if close is not None:
                    close()
                raise
            except FleetShedError as e:
                last_shed = e
                excluded.add(decision.replica_id)
                continue
            except ValueError:
                raise  # the REQUEST is bad — never retried across the fleet
            except ReplicaError as e:
                log.warning(
                    "replica %s failed mid-dispatch (%s); failing over "
                    "(%d token(s) delivered)",
                    decision.replica_id, e, len(delivered),
                )
                # failed/wedged hops land in the histogram too — an
                # incident is exactly when the hop-latency panel must move
                with self._hist_lock:
                    self.hop_hist.record(time.perf_counter() - hop_t0)
                self.note_failover(decision.replica_id)
                excluded.add(decision.replica_id)
                if (
                    delivered and parsed.response_format
                    and last_dfa_state is None
                ):
                    # a grammar-constrained stream whose frames carried NO
                    # DFA state (legacy peer / one-shot adapter) cannot
                    # resume mid-derivation: the survivor's DFA would
                    # restart at state 0 and append a SECOND derivation
                    # after the partial one — invalid output dressed as
                    # valid. With the state on the wire (tokens frames,
                    # §18) the resume continues the derivation instead.
                    raise ReplicaError(
                        f"constrained stream lost its replica after "
                        f"{len(delivered)} token(s) and its frames carried "
                        "no DFA state; mid-derivation resume would break "
                        "the grammar guarantee"
                    ) from e
                if delivered and len(delivered) >= budget:
                    # the replica died BETWEEN its final tokens frame and
                    # the terminal frame: the budget is fully delivered —
                    # synthesize the end instead of re-dispatching for
                    # tokens an uninterrupted run would never generate
                    now = time.monotonic()
                    yield {
                        "seq": out_seq, "kind": "end",
                        "finish_reason": "length",
                        "prompt_tokens": len(tokens),
                        "completion_tokens": len(delivered),
                        "ttft_s": round((first_token_at or now) - started, 6),
                        "total_s": round(now - started, 6),
                        "engine_ttft_s": 0.0,
                        "failovers": failovers,
                        "replica": decision.replica_id,
                    }
                    return
                if delivered:
                    pending_failover = {
                        "victim": decision.replica_id,
                        "delivered": len(delivered),
                        "resumed_prompt_len": len(tokens) + len(delivered),
                        "error": str(e),
                        "frames": list(trace),
                    }
                continue
        if last_shed is not None and not delivered:
            with self._lock:
                self.shed_total += 1
            raise last_shed
        # nobody shed — every attempt DIED. ReplicaError (not a shed) so
        # callers can tell "fleet is saturated, back off" from "fleet is
        # broken, serve locally if you can" (the completions fallback)
        raise ReplicaError(
            f"every replica failed this stream "
            f"({len(delivered)} token(s) delivered)"
        )

    def generate(
        self,
        tokens,
        options: Optional[dict] = None,
        session_id: Optional[str] = None,
        timeout_s: Optional[float] = None,
    ) -> tuple[dict[str, Any], RouteDecision]:
        """Blocking route + dispatch: drain ``stream_generate`` (same
        failover semantics, now WARM mid-stream instead of restart-cold)
        into the one-shot result shape. The decision returned is the
        replica that actually FINISHED the stream. ``timeout_s`` defaults
        to None so the deadline-derived hop budget applies here too —
        a non-None default would quietly reinstate the flat 600s."""
        delivered: list[int] = []
        decision: Optional[RouteDecision] = None
        end: Optional[dict] = None
        for frame in self.stream_generate(
            tokens, options, session_id=session_id, timeout_s=timeout_s
        ):
            kind = frame.get("kind")
            if kind == "route":
                decision = frame["decision"]
            elif kind == "tokens":
                delivered.extend(frame["tokens"])
            elif kind == "end":
                end = frame
        assert end is not None and decision is not None
        out = {
            "tokens": delivered,
            "finish_reason": end["finish_reason"],
            "prompt_tokens": end["prompt_tokens"],
            "ttft_s": end["ttft_s"],
            "total_s": end["total_s"],
        }
        return out, decision

    # -- autoscale hint -------------------------------------------------------

    def desired_replicas(
        self,
        target_queue_wait_s: float = 0.5,
        min_replicas: int = 1,
        max_replicas: int = 64,
    ) -> int:
        """The k8s planner's scale hint, from the fleet-wide queue-wait EMA:
        scale OUT proportionally when the mean routable queue wait exceeds
        the target (capped at 4× per step so one burst can't quadruple the
        fleet), scale IN one replica at a time only when queues are empty
        AND occupancy is low (conservative — killing a warm replica throws
        away its aliased pages). With no routable beacon the hint holds the
        current size: never scale on missing data.

        ``min_replicas=0`` legalizes scale-to-zero (§23), gated three
        ways: demand has been quiet for 60× the target window (the next
        route() stamp resurrects the fleet), every queue is empty with
        zero occupancy, and EVERY routable replica advertises the
        ``durable`` cap — the drain hibernates its sessions to disk, so
        going dark loses nothing. One non-durable replica in the fleet
        vetoes zero: its sessions would die with it."""
        now = time.monotonic()
        with self._lock:
            total = len(self._replicas)
            routable = [
                s for s in self._replicas.values() if self._routable(s, now)
            ]
            live = [s.beacon for s in routable]
            caps = [s.caps for s in routable]
            quiet_s = now - self._last_demand_t
        if not live:
            return max(min_replicas, min(total, max_replicas))
        n = len(live)
        ema = sum(float(b.get("queue_wait_ema_s", 0.0)) for b in live) / n
        occ = sum(
            float(b.get("active_slots", 0)) / max(1, b.get("max_batch", 1))
            for b in live
        ) / n
        busy = sum(
            int(b.get("active_slots", 0) or 0) + int(b.get("queued", 0) or 0)
            for b in live
        )
        if ema > target_queue_wait_s:
            want = math.ceil(n * min(ema / target_queue_wait_s, 4.0))
        elif ema < 0.1 * target_queue_wait_s and occ < 0.5 and n > 1:
            want = n - 1
        else:
            want = n
        if (
            min_replicas == 0
            and want <= 1
            and busy == 0
            and quiet_s > 60.0 * max(target_queue_wait_s, 0.1)
            and all("durable" in c for c in caps)
        ):
            want = 0
        return max(min_replicas, min(want, max_replicas))

    def desired_replicas_by_role(
        self,
        target_queue_wait_s: float = 0.5,
        min_replicas: int = 1,
        max_replicas: int = 64,
    ) -> dict[str, int]:
        """Role-split autoscale hint for disaggregated fleets (§18): the
        PREFILL pool scales on its own queue-wait EMA (prefill-heavy
        admissions queue there — wait is the burst-absorption signal),
        the DECODE pool on occupancy/load-score (decode replicas run a
        high-occupancy steady state by design; queue wait stays near zero
        until they are genuinely full). Pools scale independently with
        the same out-cap/in-conservatism as ``desired_replicas``; a role
        with no routable beacon holds its current count. Empty dict when
        the fleet advertises no roles (homogeneous fleets keep the scalar
        hint)."""
        now = time.monotonic()
        with self._lock:
            by_role: dict[str, list] = {}
            totals: dict[str, int] = {}
            for s in self._replicas.values():
                role = s.role
                totals[role] = totals.get(role, 0) + 1
                if self._routable(s, now):
                    by_role.setdefault(role, []).append(s.beacon)
        if set(totals) <= {"mixed"}:
            return {}
        out: dict[str, int] = {}
        for role, total in sorted(totals.items()):
            live = by_role.get(role) or []
            if not live:
                out[role] = max(min_replicas, min(total, max_replicas))
                continue
            n = len(live)
            ema = sum(
                float(b.get("queue_wait_ema_s", 0.0)) for b in live
            ) / n
            occ = sum(
                float(b.get("active_slots", 0))
                / max(1, b.get("max_batch", 1))
                for b in live
            ) / n
            load = sum(float(b.get("load_score", 0.0)) for b in live) / n
            if role == "prefill":
                if ema > target_queue_wait_s:
                    want = math.ceil(
                        n * min(ema / target_queue_wait_s, 4.0)
                    )
                elif ema < 0.1 * target_queue_wait_s and n > 1:
                    want = n - 1
                else:
                    want = n
            else:
                # decode/mixed: occupancy-first — a pool running hot
                # (≥85% slots or load past ~2, i.e. saturated occupancy +
                # page pressure) grows; a cold one (<30%) shrinks by one
                if occ >= 0.85 or load >= 2.0:
                    want = math.ceil(n * min(max(occ / 0.85, 1.0), 4.0))
                elif occ < 0.3 and ema < 0.1 * target_queue_wait_s and n > 1:
                    want = n - 1
                else:
                    want = n
            out[role] = max(min_replicas, min(want, max_replicas))
        return out

    # -- stats ----------------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            routable = sum(
                1 for s in self._replicas.values() if self._routable(s, now)
            )
            out = {
                "fleet-policy": self.policy,
                "fleet-lambda": self.lam,
                "fleet-replica-count": len(self._replicas),
                "fleet-routable-replicas": routable,
                "fleet-routed-affinity-total": self.routed_affinity_total,
                "fleet-routed-sticky-total": self.routed_sticky_total,
                "fleet-sticky-held-total": self.sticky_held_total,
                "fleet-routed-balanced-total": self.routed_balanced_total,
                "fleet-routed-adapter-total": self.routed_adapter_total,
                "fleet-routed-tenant-affinity-total": (
                    self.routed_tenant_affinity_total
                ),
                "fleet-tenant-shed-total": self.tenant_shed_total,
                "fleet-shed-total": self.shed_total,
                "fleet-failover-total": self.failover_total,
                "fleet-stream-failovers-total": self.stream_failover_total,
                "fleet-beacon-failures-total": self.beacon_failures_total,
                "fleet-circuit-open-total": self.circuit_open_total,
                "fleet-routed-prefill-total": self.routed_prefill_total,
                "fleet-migrations-total": self.migrations_total,
                "fleet-migrate-pages-total": self.migrate_pages_total,
                "fleet-migrate-bytes-total": self.migrate_bytes_total,
                "fleet-migrate-fallbacks-total": self.migrate_fallbacks_total,
                "fleet-p2p-fetch-total": self.p2p_fetch_total,
                "fleet-p2p-fetch-fallback-total": (
                    self.p2p_fetch_fallback_total
                ),
                "fleet-p2p-bytes-in-total": self.p2p_bytes_in_total,
                "fleet-p2p-cost-routed-total": self.p2p_cost_routed_total,
                "fleet-p2p-bw-ema-bytes-s": round(self._p2p_bw_ema, 1),
                "fleet-prefetch-total": self.prefetch_total,
                "fleet-prefetch-fetch-total": self.prefetch_fetch_total,
                "fleet-roles": {
                    role: sum(
                        1 for s in self._replicas.values() if s.role == role
                    )
                    for role in ("prefill", "decode", "mixed")
                },
                "fleet-circuit-open-replicas": sum(
                    1 for s in self._replicas.values() if s.circuit_open
                ),
                "fleet-sticky-sessions": len(self._sticky),
            }
        out["fleet-dispatch-p50-ms"] = round(
            self.dispatch_hist.percentile(0.50) * 1e3, 4
        )
        out["fleet-dispatch-p99-ms"] = round(
            self.dispatch_hist.percentile(0.99) * 1e3, 4
        )
        out["fleet-hop-p50-ms"] = round(
            self.hop_hist.percentile(0.50) * 1e3, 4
        )
        out["fleet-hop-p99-ms"] = round(
            self.hop_hist.percentile(0.99) * 1e3, 4
        )
        out["fleet-migrate-p50-ms"] = round(
            self.migrate_hist.percentile(0.50) * 1e3, 4
        )
        out["fleet-migrate-p99-ms"] = round(
            self.migrate_hist.percentile(0.99) * 1e3, 4
        )
        # mirrored into /metrics by the genai exporter (same load() path
        # as the engine histograms — docs/SERVING.md §12/§17)
        out["histograms"] = {
            "fleet_hop_s": self.hop_hist.snapshot(),
            "fleet_migrate_s": self.migrate_hist.snapshot(),
        }
        out["fleet-desired-replicas"] = self.desired_replicas()
        out["fleet-desired-replicas-by-role"] = (
            self.desired_replicas_by_role()
        )
        # process-wide wire byte accounting by protocol (§21): counted at
        # each SENDING site of the wire — the v1-vs-v2 overhead's raw series
        wb = wire_mod.wire_stats()
        out["fleet-wire-bytes-v1-total"] = int(wb.get("v1", 0))
        out["fleet-wire-bytes-v2-total"] = int(wb.get("v2", 0))
        return out


# ---------------------------------------------------------------------------
# Standalone replica server:
#   python -m langstream_tpu_torch.serving.fleet --config '{"model": "tiny-test"}'
# prints one JSON line {"url": ..., "replica": ...} once the engine is warm,
# serves /state + /fleet/* until stdin closes, then one JSON line of its
# engine's counters and the process's kernel counts.
# ---------------------------------------------------------------------------

# the engine counters the exit line reports (the kernels' work and the
# pool's accounting)
EXIT_STATS = (
    "admit-groups-total", "prefill-segments-total", "prefill-tokens-total",
    "prefill-tokens-saved-total", "decode-chunks-total", "decode-steps-total",
    "graph-replays-total", "cancelled-total", "engine-restarts-total",
    "migrate-pages-in-total", "migrate-bytes-in-total", "migrate-pages-out-total",
    "migrate-failures-total", "kv-pages-total", "kv-pages-in-use", "kv-pages-free",
    "kv-bytes-per-page", "prefix-pool-bytes-in-use", "active-slots",
)


def _serve(config: dict[str, Any], host: str, port: int) -> dict[str, Any]:
    """Serve one replica until stdin closes; returns the exit line."""
    import sys

    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
    from langstream_tpu_torch.runtime.http_server import RuntimeHttpServer

    # wire-level fault drills (§17): the config may carry a net-* spec for
    # THIS process's transport / handler sites — separate keys from the
    # engine's fault-injection, so a drill can cut the wire of a healthy
    # engine
    wire_spec = str(config.get("wire-fault-injection") or "").strip()
    if wire_spec:
        set_wire_injector(FaultInjector(
            wire_spec,
            seed=int(config.get("wire-fault-seed", 0)),
            stall_s=float(config.get("wire-fault-stall-s", 0.05)),
        ))
    holder = TorchCompletionsService(config)
    engine = holder.engine()  # builds, starts and registers the beacon
    replica_id = str(config.get("fleet-replica-id") or "replica-0")
    server = RuntimeHttpServer(
        metrics_text=lambda: "",
        agents_info=lambda: [{"replica": replica_id, "role": "fleet-replica"}],
        host=host, port=port,
    )
    server.start()
    # the exit line's kernel counts are this replica's serving work only
    reset_kernel_counts()
    print(json.dumps({"url": server.url, "replica": replica_id}), flush=True)
    # the parent closes our stdin to stop us (a portable subprocess lifecycle)
    sys.stdin.read()
    # teardown ORDER matters: unregister the beacon and drain the engine
    # FIRST, while the HTTP server still serves — peers stop routing here
    # within one refresh, and streams in flight finish over the open wire.
    # Only then stop the server and the engine.
    holder.begin_drain()
    stats = engine.stats()
    server.stop()
    holder.close()
    return {"replica": replica_id, "stats": {k: stats[k] for k in EXIT_STATS},
            "kernels": kernel_counts(), "wire": wire_mod.wire_stats()}


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="serve one fleet replica")
    p.add_argument("--config", required=True, help="tpu-serving config JSON")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(_serve(json.loads(args.config), args.host, args.port)), flush=True)
    return 0


if __name__ == "__main__":  # pragma: no cover — subprocess entry
    # run the imported module's main, not this ``__main__`` copy's: the HTTP
    # server reads the imported module's wire injector and registry
    from langstream_tpu_torch.serving import fleet as _fleet

    raise SystemExit(_fleet.main())
