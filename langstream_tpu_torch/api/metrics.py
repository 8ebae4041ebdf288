"""Streaming histograms of the port: its own copy of ``log_buckets`` and
``Histogram`` from ``langstream_tpu/api/metrics.py``, with the same bucket
bounds, counts, sums and percentiles (Prometheus semantics: cumulative
``_bucket{le=...}`` counts plus ``_sum`` / ``_count``). The engine's
latency distributions (``serving/observability.py``) are made of these.
The Prometheus side is the JAX module's too: ``Counter``, ``Gauge``,
``Histogram.load`` / ``exposition`` and the ``MetricsReporter`` (``with_prefix``,
``counter``, ``gauge``, ``histogram``, ``prometheus_text``) — what a runner
hands its runtime HTTP server for ``/metrics`` (a standalone replica serves
an empty text, as the JAX one does).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence


def _render_labels(labels: dict) -> str:
    """Canonical ``{k="v",...}`` rendering (sorted keys) — used both as
    the registry-key suffix and in the exposition line, so one (name,
    labels) pair is always one series."""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(
        self, name: str, help_: str = "", labels: Optional[dict] = None,
    ) -> None:
        self.name = name
        self.help = help_
        # optional Prometheus labels: one Counter object IS one labeled
        # series (``name{k="v"}``); unlabeled stays the common case
        self.labels = dict(labels) if labels else None
        self._value = 0.0
        self._lock = threading.Lock()

    def count(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("name", "help", "labels", "_value")

    def __init__(
        self, name: str, help_: str = "", labels: Optional[dict] = None,
    ) -> None:
        self.name = name
        self.help = help_
        self.labels = dict(labels) if labels else None
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        return self._value


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds from ``lo`` to (at least)
    ``hi``, ``per_decade`` buckets per decade. Fixed at construction — a
    streaming histogram must never reshape under load."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    step = 10.0 ** (1.0 / max(1, int(per_decade)))
    out: list[float] = []
    v = lo
    while v < hi * (1.0 + 1e-9):
        # round to 4 significant digits so exposition `le` labels are stable
        out.append(float(f"{v:.4g}"))
        v *= step
    if out[-1] < hi:
        out.append(float(f"{hi:.4g}"))
    return tuple(dict.fromkeys(out))


class Histogram:
    """Fixed-bucket streaming histogram (Prometheus semantics: cumulative
    ``_bucket{le=...}`` counts plus ``_sum``/``_count``). ``record`` is the
    hot-loop call: one bisect and three int/float updates."""

    __slots__ = ("name", "help", "_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(
        self, name: str, help_: str = "", buckets: Optional[Sequence[float]] = None
    ) -> None:
        self.name = name
        self.help = help_
        bounds = tuple(sorted(buckets)) if buckets else log_buckets(1e-3, 60.0)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        # lock-free on purpose: every engine histogram has exactly one
        # writer thread (the engine thread, or the fetch thread for the
        # fetch histogram), so no update is lost; readers (snapshot,
        # percentile) tolerate a value landing between their reads of
        # counts and sum, and reset() swaps whole objects (the GIL makes
        # that atomic), so the worst interleaving drops one sample.
        i = bisect.bisect_left(self._bounds, value)
        self._counts[i] += 1
        self._sum += value
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def reset(self) -> None:
        """Zero all state (bounds keep). Benches reset after their warmup
        request so compile-time TTFT outliers don't own the tail."""
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._sum = 0.0
            self._count = 0

    def _pct_from(self, counts: list, total: int, p: float) -> float:
        """p-quantile over ONE captured counts list: linear interpolation
        inside the winning bucket, the standard `histogram_quantile`
        estimator. 0.0 when empty; values past the last finite bound clamp
        to it (the +Inf bucket has no width)."""
        if total == 0:
            return 0.0
        rank = p * total
        seen = 0.0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                if i >= len(self._bounds):
                    return self._bounds[-1]
                hi = self._bounds[i]
                lo = self._bounds[i - 1] if i > 0 else 0.0
                if c == 0:
                    return hi
                frac = (rank - (seen - c)) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self._bounds[-1]

    def percentile(self, p: float) -> float:
        with self._lock:
            counts = list(self._counts)
            total = self._count
        return self._pct_from(counts, total, p)

    def snapshot(self) -> dict:
        """Plain-dict snapshot, safe to serialize: cumulative bucket counts
        keyed by upper bound, plus sum/count and derived percentiles — all
        computed from ONE captured copy, so the percentiles can never
        disagree with the buckets they ship next to."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        cum: list[list[float]] = []
        acc = 0
        for bound, c in zip(self._bounds, counts):
            acc += c
            cum.append([bound, acc])
        return {
            "buckets": cum,
            "sum": round(s, 6),
            "count": total,
            "p50": round(self._pct_from(counts, total, 0.50), 6),
            "p90": round(self._pct_from(counts, total, 0.90), 6),
            "p99": round(self._pct_from(counts, total, 0.99), 6),
        }

    def load(self, snapshot: dict) -> None:
        """Overwrite this histogram's state from a ``snapshot()`` dict with
        the SAME bucket bounds — the exporter mirror path: the engine owns
        the live histogram, the metrics reporter re-exposes it."""
        cum = snapshot.get("buckets") or []
        if len(cum) != len(self._bounds):
            raise ValueError(
                f"snapshot has {len(cum)} buckets, histogram {self.name} "
                f"has {len(self._bounds)}"
            )
        counts = []
        prev = 0
        for _, acc in cum:
            counts.append(int(acc) - prev)
            prev = int(acc)
        total = int(snapshot.get("count", prev))
        counts.append(max(0, total - prev))  # +Inf bucket
        with self._lock:
            self._counts = counts
            self._count = total
            self._sum = float(snapshot.get("sum", 0.0))

    def exposition(self, safe_name: str) -> list[str]:
        """Prometheus text lines (TYPE/HELP emitted by the reporter)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        lines = []
        acc = 0
        for bound, c in zip(self._bounds, counts):
            acc += c
            le = f"{bound:g}"
            lines.append(f'{safe_name}_bucket{{le="{le}"}} {acc}')
        lines.append(f'{safe_name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{safe_name}_sum {s}")
        lines.append(f"{safe_name}_count {total}")
        return lines


class MetricsReporter:
    """In-memory reporter; also the base class for exporters."""

    def __init__(self, prefix: str = "", registry: Optional[dict] = None) -> None:
        self._prefix = prefix
        self._registry: dict[str, Counter | Gauge | Histogram] = (
            registry if registry is not None else {}
        )

    def with_prefix(self, prefix: str) -> "MetricsReporter":
        joined = f"{self._prefix}_{prefix}" if self._prefix else prefix
        return MetricsReporter(joined, self._registry)

    def _full(self, name: str) -> str:
        return f"{self._prefix}_{name}" if self._prefix else name

    def counter(
        self, name: str, help_: str = "", labels: Optional[dict] = None,
    ) -> Counter:
        full = self._full(name)
        key = full + _render_labels(labels) if labels else full
        c = self._registry.get(key)
        if not isinstance(c, Counter):
            c = Counter(full, help_, labels)
            self._registry[key] = c
        return c

    def gauge(
        self, name: str, help_: str = "", labels: Optional[dict] = None,
    ) -> Gauge:
        full = self._full(name)
        key = full + _render_labels(labels) if labels else full
        g = self._registry.get(key)
        if not isinstance(g, Gauge):
            g = Gauge(full, help_, labels)
            self._registry[key] = g
        return g

    def histogram(
        self, name: str, help_: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        full = self._full(name)
        h = self._registry.get(full)
        if not isinstance(h, Histogram):
            h = Histogram(full, help_, buckets)
            self._registry[full] = h
        return h

    def prometheus_text(self) -> str:
        """Render all metrics in Prometheus text exposition format.
        Labeled series of one metric share a single HELP/TYPE block (the
        ``seen`` set dedupes by base name — registry keys carry the
        rendered labels, metric ``name`` attributes do not)."""
        lines: list[str] = []
        seen: set[str] = set()
        for _key, m in sorted(self._registry.items()):
            safe = m.name.replace("-", "_").replace(".", "_")
            if safe not in seen:
                seen.add(safe)
                if m.help:
                    lines.append(f"# HELP {safe} {m.help}")
                if isinstance(m, Histogram):
                    lines.append(f"# TYPE {safe} histogram")
                else:
                    kind = "counter" if isinstance(m, Counter) else "gauge"
                    lines.append(f"# TYPE {safe} {kind}")
            if isinstance(m, Histogram):
                lines.extend(m.exposition(safe))
                continue
            labels = m.labels
            if labels:
                lines.append(f"{safe}{_render_labels(labels)} {m.value}")
            else:
                lines.append(f"{safe} {m.value}")
        return "\n".join(lines) + "\n"


DISABLED = MetricsReporter()
