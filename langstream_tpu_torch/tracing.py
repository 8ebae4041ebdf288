"""Lightweight request tracing of the port: its own copy of ``Span``,
``Tracer``, ``TRACER`` and ``record_trace_id`` from
``langstream_tpu/tracing.py``.

Spans are in-process (contextvars parent propagation) and land in a
bounded ring buffer; the serving engine's request-lifecycle spans
(``serving/observability.emit_request_spans``) go to this module's
``TRACER``. A record carries its trace across agents in the
``ls-trace-id`` header. ``device_trace(log_dir)`` is the JAX package's
device profiling moved onto ``torch.profiler``: the CPU activity, and the
card's where CUDA is up, written into ``log_dir`` by
``tensorboard_trace_handler`` (a Chrome / TensorBoard trace).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

TRACE_HEADER = "ls-trace-id"

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "ls_current_span", default=None
)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float
    duration_s: float = 0.0
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "ok"

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "start": self.start_s,
            "durationMs": round(self.duration_s * 1000.0, 3),
            "attributes": self.attributes,
            "status": self.status,
        }


class Tracer:
    """Per-process tracer; finished spans land in a bounded ring buffer."""

    def __init__(self, capacity: int = 2048) -> None:
        self._finished: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.enabled = True

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        **attributes: Any,
    ) -> Iterator[Span]:
        if not self.enabled:
            yield Span(name, "", "", None, 0.0)
            return
        parent = _current_span.get()
        span = Span(
            name=name,
            trace_id=trace_id
            or (parent.trace_id if parent is not None else uuid.uuid4().hex[:16]),
            span_id=uuid.uuid4().hex[:16],
            parent_id=parent.span_id if parent is not None else None,
            start_s=time.time(),
            attributes=dict(attributes),
        )
        token = _current_span.set(span)
        started = time.monotonic()
        try:
            yield span
        except BaseException as e:
            span.status = f"error: {type(e).__name__}"
            raise
        finally:
            span.duration_s = time.monotonic() - started
            _current_span.reset(token)
            with self._lock:
                self._finished.append(span)

    def emit(self, span: Span) -> None:
        """Append an already-finished span built by hand — the serving
        engine's request-lifecycle spans are assembled from phase
        timestamps at request completion (one emission point, nothing on
        the token hot loop) rather than held open across engine-thread
        iterations, so the context-manager form cannot carry them."""
        if not self.enabled:
            return
        with self._lock:
            self._finished.append(span)

    def current_trace_id(self) -> Optional[str]:
        span = _current_span.get()
        return span.trace_id if span is not None else None

    def find(self, name: str, trace_id: Optional[str] = None) -> list[Span]:
        """Finished spans by name (and optionally trace) — tests/debugging."""
        with self._lock:
            items = list(self._finished)
        return [
            s
            for s in items
            if s.name == name and (trace_id is None or s.trace_id == trace_id)
        ]

    def spans(self, limit: int = 500) -> list[dict[str, Any]]:
        with self._lock:
            items = list(self._finished)[-limit:]
        return [s.to_dict() for s in items]

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


TRACER = Tracer()


def record_trace_id(record: Any) -> Optional[str]:
    """Extract the propagated trace id from a record's headers."""
    headers = getattr(record, "headers", ())
    for h in headers:
        if h.key == TRACE_HEADER:
            return h.value_as_string()
    return None


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    when it is available) and write the trace into ``log_dir``; view it
    with TensorBoard or a Chrome trace viewer."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
