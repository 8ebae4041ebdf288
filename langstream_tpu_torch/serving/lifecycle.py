"""Request cancellation by client session, within one process (the port's
own copy of the local half of ``langstream_tpu/serving/lifecycle.py``;
stdlib only).

When a chat client disconnects, the work it started should stop at the
next chunk boundary instead of decoding to ``max_new_tokens`` in a slot
nobody reads. Where both ends live in one process this registry is the
short circuit: the dispatching side registers every in-flight
``GenerationRequest`` under the client's session key (the
``langstream-client-session-id`` header the chat gateways route answers
by, or a fleet payload's ``cancel-key`` option, ``serving/fleet.py``),
the disconnect path calls ``cancel(key)``, and the engine frees the
cancelled slots at its next chunk boundary.

Forwarding a cancel to a replica in another process (``register_remote``
and ``POST /fleet/cancel``) waits for the fleet's HTTP hop.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Protocol

log = logging.getLogger(__name__)

# the chat-gateway convention header the session key comes from
SESSION_HEADER = "langstream-client-session-id"


class Cancellable(Protocol):
    def cancel(self) -> None: ...


_lock = threading.Lock()
# every mutation of the registry holds _lock: it is written from dispatch
# threads and read from disconnect paths
_GUARDED = {"_lock": ("_by_key",)}
_by_key: dict[str, dict[int, Any]] = {}


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
    many. Requests stay registered until their owner unregisters them (the
    engine resolves a cancelled request, which ends the owner's wait)."""
    if not key:
        return 0
    with _lock:
        requests = list(_by_key.get(key, {}).values())
    for request in requests:
        try:
            request.cancel()
        except Exception:  # noqa: BLE001 — one bad entry must not shield the rest
            log.exception("cancel() failed for a request under key %r", key)
    if requests:
        log.info("cancelled %d in-flight request(s) for session %r", len(requests), key)
    return len(requests)


def active_keys() -> list[str]:
    """The sessions with requests in flight (tests, debugging)."""
    with _lock:
        return [k for k, v in _by_key.items() if v]
