"""Live application log streaming (the port's own copy of
``langstream_tpu/runtime/log_stream.py``).

The reference's debug loop is "follow the agent logs": its control plane
streams pod logs as an unbounded text/NDJSON Flux with per-replica
filtering (langstream-webservice ApplicationResource.java:312-330) and the
CLI tails it. The local-runtime analogue here: every application gets a
``LogHub`` — a bounded history ring plus asyncio subscriber queues — fed by
a ``logging.Handler`` capturing the framework's records (the
``langstream_tpu_torch`` logger) while the app runs. Each record is tagged
with the emitting agent replica through a ``ContextVar`` set in the runner
task, which is what makes the ``?filter=<replica>`` parameter meaningful
without OS-level pods. Records logged off the serving loop (the engine
thread, executor calls) reach a live subscriber through
``call_soon_threadsafe``.
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import logging
import time
from collections import deque
from typing import Any, Optional

LOGGER = "langstream_tpu_torch"

# which (application, agent replica) the current task is running — runner
# tasks set this; records emitted outside any runner carry app=None (ambient:
# delivered to every hub) and tag as "app"
current_app_replica: contextvars.ContextVar[tuple[Optional[str], str]] = (
    contextvars.ContextVar("langstream_app_replica", default=(None, "app"))
)


class LogHub:
    """Bounded history + fan-out for one application's log lines."""

    def __init__(self, application_id: str, maxlen: int = 2000) -> None:
        self.application_id = application_id
        self.maxlen = maxlen
        self._ring: deque[dict[str, Any]] = deque(maxlen=maxlen)
        self._subscribers: set[asyncio.Queue] = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # atomic under CPython (single bytecode step): emit() may be called
        # from agent executor threads concurrently, and a duplicated seq
        # would make the /logs follow dedupe drop a genuine line
        self._seq = itertools.count(1)
        self.closed = False

    def attach_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        """Remember the serving loop so emit() can cross threads safely
        (agent work may log from executor threads)."""
        self._loop = loop

    def emit(self, replica: str, level: str, message: str) -> None:
        entry = {
            "seq": next(self._seq),
            "timestamp": time.time(),
            "replica": replica,
            "level": level,
            "message": message,
        }
        self._ring.append(entry)
        if not self._subscribers:
            return
        self._fan_out(entry)

    def _fan_out(self, entry: Optional[dict[str, Any]]) -> None:
        loop = self._loop
        running = None
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            pass
        for q in list(self._subscribers):
            # only a put from the SERVING loop itself is safe directly — a
            # different running loop (agent library thread) still needs the
            # threadsafe hop, else the subscriber's waiting get() races
            if loop is not None and running is not loop:
                try:
                    loop.call_soon_threadsafe(self._offer, q, entry)
                except RuntimeError:  # the serving loop has closed
                    pass
            else:
                self._offer(q, entry)

    def close(self) -> None:
        """The application stopped: every follower's queue gets ``None``
        after its last line (the end of its stream), and so does a queue
        subscribed later."""
        self.closed = True
        self._fan_out(None)

    @staticmethod
    def _offer(q: asyncio.Queue, entry: Optional[dict[str, Any]]) -> None:
        """Bounded put: a follower that can't keep up loses its OLDEST
        pending lines (same contract as the history ring) instead of
        growing server memory without limit."""
        try:
            q.put_nowait(entry)
        except asyncio.QueueFull:
            try:
                q.get_nowait()
            except asyncio.QueueEmpty:
                pass
            try:
                q.put_nowait(entry)
            except asyncio.QueueFull:
                pass

    def history(self, replica: Optional[str] = None) -> list[dict[str, Any]]:
        return [
            e for e in self._ring if replica is None or e["replica"] == replica
        ]

    def subscribe(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=self.maxlen)
        self._subscribers.add(q)
        if self.closed:
            q.put_nowait(None)
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self._subscribers.discard(q)


class HubLogHandler(logging.Handler):
    """Routes ``langstream_tpu_torch`` log records into a LogHub, tagged
    with the emitting replica from the task context."""

    def __init__(self, hub: LogHub) -> None:
        super().__init__()
        self.hub = hub

    def emit(self, record: logging.LogRecord) -> None:
        try:
            app, replica = current_app_replica.get()
            # records from another application's tasks don't leak into this
            # hub; ambient records (app=None) go to every hub
            if app is not None and app != self.hub.application_id:
                return
            self.hub.emit(replica, record.levelname, self.format(record))
        except Exception:  # noqa: BLE001 — logging must never raise
            pass


# level the "langstream_tpu_torch" logger had before the FIRST hub
# installed — restoring from whichever handler detaches last would leak the
# INFO level when hubs are removed in install order
_prior_level: Optional[int] = None


def install_hub(hub: LogHub) -> HubLogHandler:
    """Attach a capture handler for the framework's records; returns it so
    the caller can remove_hub() on stop. While any hub is installed the
    ``langstream_tpu_torch`` logger runs at INFO (the effective root
    default of WARNING would drop the very lines the /logs stream exists
    for); the original level is restored when the last hub detaches."""
    global _prior_level
    handler = HubLogHandler(hub)
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    logger = logging.getLogger(LOGGER)
    if not any(isinstance(h, HubLogHandler) for h in logger.handlers):
        _prior_level = logger.level
        if logger.getEffectiveLevel() > logging.INFO:
            logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    return handler


def remove_hub(handler: HubLogHandler) -> None:
    global _prior_level
    logger = logging.getLogger(LOGGER)
    logger.removeHandler(handler)
    if not any(isinstance(h, HubLogHandler) for h in logger.handlers):
        if _prior_level is not None:
            logger.setLevel(_prior_level)
        _prior_level = None
