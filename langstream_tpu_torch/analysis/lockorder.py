"""Runtime lock-order recorder for the port — the dynamic companion to the
static ``locks`` pass.

The static pass proves every guarded write holds ITS lock; it cannot
prove two locks are always taken in one order. This recorder can:
``install()`` swaps ``threading.Lock`` for a factory that wraps locks
created from ``langstream_tpu_torch`` frames, tags each with its CREATION
site (file:line — the stable identity across engine instances), and
records a directed edge ``held-site -> acquiring-site`` every time a
thread acquires one lock while holding another. A cycle in that graph is a
lock-order inversion: two threads interleaving those paths can deadlock
even though every individual acquisition is lock-correct.

It is the JAX package's recorder with the port's marker: a frame is
tagged when its file lies under ``langstream_tpu_torch/`` (never under
``langstream_tpu_torch/analysis/``, and never a ``langstream_tpu/`` frame).
Same-site edges are skipped — two INSTANCES of one class locking in
sequence (router A then router B) share a creation site, and ordering
between instances is a different discipline (address-ordered locking) the
recorder cannot judge from sites alone. A ``threading.Condition`` over a
tracked lock asks whether the lock is held through ``_is_owned``, which
reads the real lock and records nothing (the condition's default asks by
a try-acquire, which would record an edge no thread ever waits on).

Install it BEFORE any ``langstream_tpu_torch`` module is imported: a
module-level lock made before the factory is in place stays untracked.
The wrapper costs a frame lookup per lock made and a few list operations
per acquire (``acquire_cost_ns`` measures it); ``chip_smoke.py`` arms it
for its whole run, the tests through ``activate()``. Child processes (a
replica, a follower, a gRPC child) are not covered: each has its own
``threading`` module.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

_REAL_LOCK = threading.Lock

#: the package whose frames are tagged, and this package's own files
MARKER = "langstream_tpu_torch" + os.sep
SELF_PREFIX = "langstream_tpu_torch/analysis/"


def site_of(filename: str, lineno: int) -> Optional[str]:
    """``langstream_tpu_torch/...:line`` for a frame under the port, or
    None (stdlib queue / logging locks, the JAX package, this package)."""
    idx = filename.rfind(MARKER)
    if idx < 0:
        return None
    rel = filename[idx:].replace(os.sep, "/")
    if rel.startswith(SELF_PREFIX):
        return None  # never instrument ourselves
    return f"{rel}:{lineno}"


def _caller_site(depth: int = 2) -> Optional[str]:
    """``file:line`` of the frame creating the lock, repo-relative, or
    None when the creation site is outside the port."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    return site_of(frame.f_code.co_filename, frame.f_lineno)


class _TrackedLock:
    """A real lock plus edge recording. Proxy, not subclass —
    ``threading.Lock`` is a factory function, not a type."""

    __slots__ = ("_lock", "_site", "_rec")

    def __init__(self, rec: "LockOrderRecorder", site: str) -> None:
        self._lock = _REAL_LOCK()
        self._site = site
        self._rec = rec

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._rec._note_acquire(self._site)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._rec._note_held(self._site)
        return got

    def release(self) -> None:
        self._rec._note_release(self._site)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        # threading.Condition's own test, on the real lock: no edge
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class LockOrderRecorder:
    """Process-wide edge collector; one instance per run."""

    def __init__(self) -> None:
        self._edges: dict[tuple[str, str], int] = {}
        self._elock = _REAL_LOCK()
        self._tls = threading.local()
        self._installed = False
        # each thread's acquisition count, a one-element list it alone
        # bumps (summed by ``summary``)
        self._counts: list[list[int]] = []
        self._sites: set[str] = set()
        self.locks_made = 0

    # -- instrumentation hooks (called from _TrackedLock) ------------------

    def _held(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
            count = self._tls.count = [0]
            with self._elock:
                self._counts.append(count)
        return stack

    def _note_acquire(self, site: str) -> None:
        held = self._held()
        self._tls.count[0] += 1
        new_edges = [
            (h, site) for h in held if h != site
        ]
        if new_edges:
            with self._elock:
                for e in new_edges:
                    self._edges[e] = self._edges.get(e, 0) + 1

    def _note_held(self, site: str) -> None:
        self._held().append(site)

    def _note_release(self, site: str) -> None:
        held = self._held()
        # release order may not mirror acquire order; drop the LAST match
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                break

    def track(self, site: str) -> _TrackedLock:
        """A tracked lock tagged ``site`` (the factory's product)."""
        with self._elock:
            self._sites.add(site)
            self.locks_made += 1
        return _TrackedLock(self, site)

    # -- install / report --------------------------------------------------

    def install(self) -> None:
        if self._installed:
            return

        rec = self

        def _factory() -> object:
            site = _caller_site()
            if site is None:
                return _REAL_LOCK()
            return rec.track(site)

        threading.Lock = _factory  # type: ignore[assignment]
        self._installed = True

    def uninstall(self) -> None:
        if self._installed:
            threading.Lock = _REAL_LOCK  # type: ignore[assignment]
            self._installed = False

    def edges(self) -> dict[tuple[str, str], int]:
        with self._elock:
            return dict(self._edges)

    def sites(self) -> list[str]:
        with self._elock:
            return sorted(self._sites)

    def cycles(self) -> list[list[str]]:
        """Every elementary inversion witness found by DFS over the
        aggregated edge graph (usually length 2: A->B and B->A)."""
        graph: dict[str, set[str]] = {}
        for (a, b) in self.edges():
            graph.setdefault(a, set()).add(b)
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()
        for start in sorted(graph):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(graph.get(node, ())):
                    if nxt == start:
                        cyc = path + [start]
                        # canonicalize by rotation so each cycle reports once
                        body = tuple(sorted(cyc[:-1]))
                        if body not in seen_cycles:
                            seen_cycles.add(body)
                            out.append(cyc)
                    elif nxt not in path and len(path) < 8:
                        stack.append((nxt, path + [nxt]))
        return out

    def report(self) -> str:
        lines = []
        for cyc in self.cycles():
            lines.append(
                "lock-order inversion: " + " -> ".join(cyc)
            )
        return "\n".join(lines)

    def summary(self) -> dict:
        """What the run tracked: lock creation sites, locks made, distinct
        edges, acquisitions of tracked locks, and the cycles."""
        with self._elock:
            acquisitions = sum(c[0] for c in self._counts)
            sites = len(self._sites)
            edges = len(self._edges)
            made = self.locks_made
        return {
            "sites": sites,
            "locks": made,
            "edges": edges,
            "acquisitions": acquisitions,
            "cycles": len(self.cycles()),
        }


def acquire_cost_ns(n: int = 100_000) -> dict:
    """Host nanoseconds of one acquire + release of a tracked lock (holding
    one other tracked lock, so the edge is recorded) against a real lock's,
    each the mean of ``n`` in a loop, on a recorder of its own."""
    rec = LockOrderRecorder()
    outer = _TrackedLock(rec, "cost:1")
    tracked = _TrackedLock(rec, "cost:2")
    real = _REAL_LOCK()
    with outer:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tracked:
                pass
        t1 = time.perf_counter_ns()
    for _ in range(n):
        with real:
            pass
    t2 = time.perf_counter_ns()
    return {"tracked_ns": (t1 - t0) / n, "real_ns": (t2 - t1) / n, "n": n}


_ACTIVE: Optional[LockOrderRecorder] = None


def activate() -> LockOrderRecorder:
    """Install the process-wide recorder (idempotent)."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = LockOrderRecorder()
        _ACTIVE.install()
    return _ACTIVE


def deactivate() -> Optional[LockOrderRecorder]:
    """Uninstall and return the recorder (for the end-of-run cycle
    assertion)."""
    global _ACTIVE
    rec = _ACTIVE
    if rec is not None:
        rec.uninstall()
        _ACTIVE = None
    return rec
