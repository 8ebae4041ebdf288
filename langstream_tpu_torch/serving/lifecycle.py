"""Request cancellation by client session (the port's own copy of
``langstream_tpu/serving/lifecycle.py``; stdlib only).

When a chat client disconnects, the work it started should stop at the
next chunk boundary instead of decoding to ``max_new_tokens`` in a slot
nobody reads. Where both ends live in one process this registry is the
short circuit: the dispatching side registers every in-flight
``GenerationRequest`` under the client's session key (the
``langstream-client-session-id`` header the chat gateways route answers
by, or a fleet payload's ``cancel-key`` option, ``serving/fleet.py``),
the disconnect path calls ``cancel(key)``, and the engine frees the
cancelled slots at its next chunk boundary.

Across processes: when the fleet router dispatches a session's request to
a replica in another process, the dispatching side records that replica's
base URL (``register_remote``), the peer registers the request in ITS
registry under the same key (the payload's ``cancel-key``), and
``cancel(key)`` also POSTs ``/fleet/cancel`` to every recorded owner, so
the remote decode stops at its next chunk boundary instead of at its
deadline. Forwarding is best-effort, on a background thread: a dead peer
must not stall the disconnect path (its request still ends by deadline).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Protocol

log = logging.getLogger(__name__)

# the chat-gateway convention header the session key comes from
SESSION_HEADER = "langstream-client-session-id"


class Cancellable(Protocol):
    def cancel(self) -> None: ...


_lock = threading.Lock()
# every mutation of the registry holds _lock: it is written from dispatch
# threads and read from disconnect paths
_GUARDED = {"_lock": ("_by_key", "_remote_by_key")}
_by_key: dict[str, dict[int, Any]] = {}
# session → {replica base URL: refcount}: the replicas in other processes
# that hold in-flight work for the session (a session may have overlapping
# requests on one peer)
_remote_by_key: dict[str, dict[str, int]] = {}


def register_remote(key: str, base_url: str) -> None:
    """Record that session ``key`` has a request in flight on the replica at
    ``base_url``; ``cancel`` forwards there."""
    if not key or not base_url:
        return
    with _lock:
        owners = _remote_by_key.setdefault(key, {})
        owners[base_url] = owners.get(base_url, 0) + 1


def unregister_remote(key: str, base_url: str) -> None:
    if not key or not base_url:
        return
    with _lock:
        owners = _remote_by_key.get(key)
        if owners is None:
            return
        left = owners.get(base_url, 0) - 1
        if left > 0:
            owners[base_url] = left
        else:
            owners.pop(base_url, None)
        if not owners:
            _remote_by_key.pop(key, None)


def _forward_cancel(key: str, urls: list[str]) -> None:
    """POST /fleet/cancel to each owning replica, best-effort (a daemon
    thread runs it: a peer's timeout never stalls the caller)."""
    for url in urls:
        try:
            req = urllib.request.Request(
                url.rstrip("/") + "/fleet/cancel",
                data=json.dumps({"session": key}).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=2.0) as r:
                out = json.loads(r.read().decode("utf-8"))
            log.info("forwarded cancel for session %r to %s (%s cancelled there)",
                     key, url, out.get("cancelled"))
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.warning("cancel forward to %s failed for session %r: %s "
                        "(the deadline remains the backstop)", url, key, e)


def register(key: str, request: Cancellable) -> None:
    """Track ``request`` under session ``key`` until ``unregister``."""
    if not key:
        return
    with _lock:
        _by_key.setdefault(key, {})[id(request)] = request


def unregister(key: str, request: Cancellable) -> None:
    if not key:
        return
    with _lock:
        bucket = _by_key.get(key)
        if bucket is not None:
            bucket.pop(id(request), None)
            if not bucket:
                _by_key.pop(key, None)


def cancel(key: str) -> int:
    """Cancel every in-flight request registered under ``key``; returns how
    many were cancelled in THIS process. Requests stay registered until
    their owner unregisters them (the engine resolves a cancelled request,
    which ends the owner's wait). A session with work on replicas in other
    processes also gets the cancel forwarded to each (``POST
    /fleet/cancel``, on a background thread)."""
    if not key:
        return 0
    with _lock:
        requests = list(_by_key.get(key, {}).values())
        remote_urls = list(_remote_by_key.get(key, {}))
    if remote_urls:
        threading.Thread(
            target=_forward_cancel, args=(key, remote_urls), name="fleet-cancel-forward",
            daemon=True,
        ).start()
    for request in requests:
        try:
            request.cancel()
        except Exception:  # noqa: BLE001 — one bad entry must not shield the rest
            log.exception("cancel() failed for a request under key %r", key)
    if requests:
        log.info("cancelled %d in-flight request(s) for session %r", len(requests), key)
        _trace_disconnect(key, requests)
    return len(requests)


def _trace_disconnect(key: str, requests: list) -> None:
    """Mark the disconnect-driven cancellation on each request's trace —
    an incident reader asking "why did this generation end early?" finds
    the WebSocket disconnect next to the engine's cancelled span instead
    of inferring it from a counter (docs/SERVING.md §12)."""
    try:
        import uuid

        from langstream_tpu_torch.tracing import TRACER, Span

        if not TRACER.enabled:
            return
        for request in requests:
            trace_id = getattr(request, "trace_id", None)
            if not trace_id:
                continue
            TRACER.emit(Span(
                name="gateway.disconnect-cancel",
                trace_id=trace_id,
                span_id=uuid.uuid4().hex[:16],
                parent_id=None,
                start_s=time.time(),
                duration_s=0.0,
                attributes={"session": key},
            ))
    except Exception:  # noqa: BLE001 — tracing must never break teardown
        log.exception("disconnect trace emission failed")


def active_keys() -> list[str]:
    """The sessions with requests in flight (tests, debugging)."""
    with _lock:
        return [k for k, v in _by_key.items() if v]
