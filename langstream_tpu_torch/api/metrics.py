"""Streaming histograms of the port: its own copy of ``log_buckets`` and
``Histogram`` from ``langstream_tpu/api/metrics.py``, with the same bucket
bounds, counts, sums and percentiles (Prometheus semantics: cumulative
``_bucket{le=...}`` counts plus ``_sum`` / ``_count``). The engine's
latency distributions (``serving/observability.py``) are made of these.
``Counter``, ``Gauge`` and the ``MetricsReporter`` wait for the provider's
wiring into the pipeline runtime.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence


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
