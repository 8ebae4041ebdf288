"""Multi-tenant overload control of the port: its own copy of
``langstream_tpu/serving/tenancy.py`` (fair-share scheduling, per-tenant
quotas, the brownout degradation ladder).

- **TenantSpec / TenantRegistry**: per-tenant weight, hard slot cap, queue
  share and token-rate quota (a token bucket charged for prefill and
  generated tokens), and the per-tenant lifecycle counters (submitted,
  admitted, shed, deadline, cancelled, queue-wait EMA, a TTFT histogram).
  An unknown tenant gets a default spec (weight 1, no caps); past
  ``max_dynamic`` client-invented names fold into the default tenant.
- **TenantQueue**: the engine's bounded admission queue, as per-tenant
  weighted deficit round-robin with deficits in prefill tokens, so the
  iteration's prefill budget divides by weight. Priority (low | normal |
  high) breaks ties within a tenant only; ``queue_share`` caps one
  tenant's slice of the queue (a shed, never backpressure for everyone);
  ``get_nowait(skip=...)`` holds back tenants at their slot cap. With one
  tenant and default priorities it is a FIFO.
- **BrownoutController**: the ladder the engine walks under sustained load
  (the ``load_score`` of ``serving/observability.py``), one
  hysteresis-gated step per dwell in either direction:

      level 1  spec-shrink   speculative drafts halve
      level 2  spec-off      decode chunks instead of verifies
      level 3  reject-low    low-priority admissions shed at the door
      level 4  reject-quota  over-quota tenants shed at the door

  Greedy output is the same at every level: drafts never change what a
  verify emits, and a decode chunk emits what a verify would.
- ``effective_max_new_tokens``: a request's generation cap under its
  ``max_cost_tokens`` budget (prompt + generated).

Every class that reads the clock takes an injected ``now``. Host code
only: no torch import.
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from langstream_tpu_torch.api.metrics import Histogram, log_buckets

# the record header/property the gateway stamps the langstream tenant id
# into (client-supplied header wins — multi-app front doors may map their
# own identity onto serving tenants) and the completions step reads back
# into GenerationOptions.tenant
TENANT_HEADER = "langstream-tenant"

# requests that never named a tenant all share this one — tenancy must not
# be a deployment prerequisite, and "everything is one tenant" degrades to
# exactly the old FIFO behavior
DEFAULT_TENANT = "default"

PRIORITIES = ("low", "normal", "high")

# shed-reply record properties (docs/SERVING.md §19): when a service-gateway
# request/reply roundtrip hits a quota/overload shed, the completions step
# answers with a reply record carrying these instead of erroring the
# pipeline — the gateway maps them to HTTP 429 + Retry-After
SHED_PROPERTY = "ls-shed"
RETRY_AFTER_PROPERTY = "ls-retry-after-s"

# the service gateway's request/reply correlation header (the same literal
# gateway/server.py stamps — defined here too so the completions step can
# recognize a service roundtrip without importing the gateway layer)
SERVICE_REQUEST_ID_PROPERTY = "langstream-service-request-id"


class TenantShareExceeded(Exception):
    """One tenant's slice of the bounded admission queue is full (its
    configured ``queue_share``); the GLOBAL queue may still have room.
    Always a shed for that tenant — never backpressure for everyone."""

    def __init__(self, tenant: str, cap: int) -> None:
        super().__init__(
            f"tenant {tenant!r} queue share full ({cap} entries)"
        )
        self.tenant = tenant
        self.cap = cap


@dataclass
class TenantSpec:
    """One tenant's declared scheduling policy (the ``tenants:`` config
    block on tpu-serving; docs/SERVING.md §19)."""

    name: str
    # WDRR weight: tenant A at weight 2 gets twice tenant B's share of the
    # iteration prefill-token budget and the free-slot pool under
    # contention. Idle share flows to busy tenants (work-conserving).
    weight: float = 1.0
    # hard cap on concurrently active slots (never borrowed past, even
    # with the engine otherwise idle); None = bounded by fair share only
    max_slots: Optional[int] = None
    # fraction of the bounded admission queue this tenant may occupy
    # (0 < share <= 1); None = bounded by the global depth only
    queue_share: Optional[float] = None
    # sustained token-rate quota (prefill + generated tokens per second,
    # token-bucket enforced); None = unmetered. Over-quota tenants shed
    # FIRST under pressure and outright at brownout level 4.
    token_rate: Optional[float] = None
    # bucket depth in seconds of token_rate (burst headroom)
    burst_s: float = 2.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant spec needs a name")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}"
            )
        if self.max_slots is not None and int(self.max_slots) < 1:
            raise ValueError(
                f"tenant {self.name!r}: max_slots must be >= 1"
            )
        if self.queue_share is not None and not (0 < self.queue_share <= 1):
            raise ValueError(
                f"tenant {self.name!r}: queue_share must be in (0, 1], "
                f"got {self.queue_share}"
            )
        if self.token_rate is not None and self.token_rate <= 0:
            raise ValueError(
                f"tenant {self.name!r}: token_rate must be > 0"
            )

    @staticmethod
    def from_dict(d: dict) -> "TenantSpec":
        ms = d.get("max-slots", d.get("max_slots"))
        qs = d.get("queue-share", d.get("queue_share"))
        tr = d.get("token-rate", d.get("token_rate"))
        return TenantSpec(
            name=str(d.get("name") or ""),
            weight=float(d.get("weight", 1.0)),
            max_slots=int(ms) if ms is not None else None,
            queue_share=float(qs) if qs is not None else None,
            token_rate=float(tr) if tr is not None else None,
            burst_s=float(d.get("burst-s", d.get("burst_s", 2.0))),
        )


class _TokenBucket:
    """Token-rate quota enforcement. Charged AFTER the fact (prefill at
    admission, generated tokens as they deliver), so the balance may go
    negative — ``over_quota`` is ``balance <= 0`` and ``retry_after_s`` is
    the time until the refill brings it positive. Not thread-safe on its
    own; the registry lock covers it."""

    def __init__(self, rate: float, burst_s: float) -> None:
        self.rate = float(rate)
        self.burst = max(self.rate * max(burst_s, 0.1), 1.0)
        self._balance = self.burst
        self._at = time.monotonic()

    def _refill(self, now: float) -> None:
        self._balance = min(
            self.burst, self._balance + (now - self._at) * self.rate
        )
        self._at = now

    def charge(self, n: float, now: Optional[float] = None) -> None:
        self._refill(now if now is not None else time.monotonic())
        self._balance -= n

    def balance(self, now: Optional[float] = None) -> float:
        self._refill(now if now is not None else time.monotonic())
        return self._balance

    def over_quota(self, now: Optional[float] = None) -> bool:
        return self.balance(now) <= 0

    def retry_after_s(self, now: Optional[float] = None) -> float:
        deficit = -self.balance(now)
        if deficit <= 0:
            return 0.0
        return max(deficit / self.rate, 0.05)


class TenantState:
    """One tenant's live accounting. Counter mutations go through the
    registry (one lock); the TTFT histogram has exactly ONE writer (the
    engine thread), the api.metrics single-writer contract."""

    def __init__(self, spec: TenantSpec) -> None:
        self.spec = spec
        self.bucket = (
            _TokenBucket(spec.token_rate, spec.burst_s)
            if spec.token_rate is not None
            else None
        )
        self.submitted_total = 0
        self.admitted_total = 0
        self.shed_total = 0
        self.deadline_total = 0
        self.cancelled_total = 0
        self.prefill_tokens_total = 0
        self.generated_tokens_total = 0
        self.queue_wait_ema_s = 0.0
        self.ttft_hist = Histogram(
            f"tenant_ttft_s[{spec.name}]",
            "per-tenant time to first token (s)",
            log_buckets(1e-3, 120.0, 4),
        )


class TenantRegistry:
    """All tenants the engine has seen: configured ones up front, unknown
    ones lazily under a default spec. Thread-safe (submitter threads shed
    and read quota; the engine thread charges and attributes).

    ``max_dynamic`` bounds lazy creation: the tenant name arrives on a
    CLIENT-controlled header, and without a cap a scripted client sending
    a fresh name per request would grow per-tenant state (and every
    stats()/beacon walk) without bound. Past the cap, unseen names fold
    into the shared default tenant — attribution degrades gracefully,
    memory does not."""

    def __init__(
        self,
        specs: Optional[list[TenantSpec]] = None,
        max_dynamic: int = 512,
    ) -> None:
        self._lock = threading.Lock()
        self._states: dict[str, TenantState] = {}
        self.max_dynamic = max(1, int(max_dynamic))
        for spec in specs or []:
            if spec.name in self._states:
                raise ValueError(f"duplicate tenant spec {spec.name!r}")
            self._states[spec.name] = TenantState(spec)
        self._configured = len(self._states)
        self.folded_tenants_total = 0

    def state(self, name: str) -> TenantState:
        name = name or DEFAULT_TENANT
        with self._lock:
            st = self._states.get(name)
            if st is None:
                if (
                    name != DEFAULT_TENANT
                    and len(self._states) - self._configured
                    >= self.max_dynamic
                ):
                    # cap reached: fold into the default tenant instead of
                    # allocating state for a name a hostile client invented
                    self.folded_tenants_total += 1
                    st = self._states.get(DEFAULT_TENANT)
                    if st is None:
                        st = TenantState(TenantSpec(name=DEFAULT_TENANT))
                        self._states[DEFAULT_TENANT] = st
                    return st
                st = TenantState(TenantSpec(name=name))
                self._states[name] = st
            return st

    def weight(self, name: str) -> float:
        return self.state(name).spec.weight

    # -- quota ---------------------------------------------------------------

    def charge(self, name: str, tokens: float) -> None:
        st = self.state(name)
        with self._lock:
            if st.bucket is not None:
                st.bucket.charge(tokens)

    def over_quota(self, name: str) -> bool:
        st = self.state(name)
        with self._lock:
            return st.bucket is not None and st.bucket.over_quota()

    def quota_retry_after_s(self, name: str) -> float:
        st = self.state(name)
        with self._lock:
            return st.bucket.retry_after_s() if st.bucket is not None else 0.0

    # -- attribution ---------------------------------------------------------

    def note_submit(self, name: str) -> None:
        st = self.state(name)
        with self._lock:
            st.submitted_total += 1

    def note_shed(self, name: str) -> None:
        st = self.state(name)
        with self._lock:
            st.shed_total += 1

    def note_deadline(self, name: str) -> None:
        st = self.state(name)
        with self._lock:
            st.deadline_total += 1

    def note_cancelled(self, name: str) -> None:
        st = self.state(name)
        with self._lock:
            st.cancelled_total += 1

    def note_admitted(self, name: str, prefill_tokens: int) -> None:
        st = self.state(name)
        with self._lock:
            st.admitted_total += 1
            st.prefill_tokens_total += prefill_tokens
            if st.bucket is not None:
                st.bucket.charge(prefill_tokens)

    def note_generated(self, name: str, tokens: int = 1) -> None:
        st = self.state(name)
        with self._lock:
            st.generated_tokens_total += tokens
            if st.bucket is not None:
                st.bucket.charge(tokens)

    def note_queue_wait(self, name: str, wait_s: float) -> None:
        st = self.state(name)
        with self._lock:
            st.queue_wait_ema_s = (
                wait_s
                if st.queue_wait_ema_s == 0
                else 0.8 * st.queue_wait_ema_s + 0.2 * wait_s
            )

    def note_ttft(self, name: str, ttft_s: float) -> None:
        # engine thread only (Histogram single-writer contract)
        self.state(name).ttft_hist.record(ttft_s)

    def queue_wait_ema_s(self, name: str) -> float:
        st = self.state(name)
        with self._lock:
            return st.queue_wait_ema_s

    def snapshot(
        self, queued: Optional[dict[str, int]] = None,
        active: Optional[dict[str, int]] = None,
    ) -> dict[str, dict[str, Any]]:
        """Per-tenant stats block (engine stats() → beacons → Grafana).
        Plain-serializable; histograms collapse to their percentiles. ONE
        registry-lock acquisition for the whole pass — this runs on every
        metrics poll and beacon build, interleaved with the engine's
        per-token charges on the same lock; the histogram snapshots take
        their own locks outside it."""
        out: dict[str, dict[str, Any]] = {}
        hists: dict[str, Any] = {}
        with self._lock:
            for name, st in self._states.items():
                hists[name] = st.ttft_hist
                out[name] = {
                    "weight": st.spec.weight,
                    "submitted-total": st.submitted_total,
                    "admitted-total": st.admitted_total,
                    "shed-total": st.shed_total,
                    "deadline-total": st.deadline_total,
                    "cancelled-total": st.cancelled_total,
                    "prefill-tokens-total": st.prefill_tokens_total,
                    "generated-tokens-total": st.generated_tokens_total,
                    "queue-wait-ema-s": round(st.queue_wait_ema_s, 4),
                    "over-quota": (
                        st.bucket is not None and st.bucket.over_quota()
                    ),
                    "queued": int((queued or {}).get(name, 0)),
                    "active-slots": int((active or {}).get(name, 0)),
                }
        for name, h in hists.items():
            snap = h.snapshot()
            out[name]["ttft-p50-s"] = snap["p50"]
            out[name]["ttft-p99-s"] = snap["p99"]
        return out


@dataclass
class _TenantLane:
    """One tenant's slice of the admission queue: a deque per priority
    (FIFO within a priority — priority breaks ties within the tenant)."""

    lanes: dict[str, deque] = field(
        default_factory=lambda: {p: deque() for p in PRIORITIES}
    )
    deficit: float = 0.0

    def __len__(self) -> int:
        return sum(len(d) for d in self.lanes.values())

    def push(self, priority: str, request: Any) -> None:
        self.lanes[priority].append(request)

    def head(self) -> Optional[Any]:
        for p in ("high", "normal", "low"):
            if self.lanes[p]:
                return self.lanes[p][0]
        return None

    def pop(self) -> Any:
        for p in ("high", "normal", "low"):
            if self.lanes[p]:
                return self.lanes[p].popleft()
        raise _queue.Empty


class TenantQueue:
    """Bounded multi-tenant admission queue with weighted deficit
    round-robin pop. Drop-in for the engine's old ``queue.Queue`` surface
    (``maxsize`` / ``qsize()`` / ``put`` / ``put_nowait`` / ``get_nowait``
    raising ``queue.Full`` / ``queue.Empty``), plus:

    - per-tenant ``queue_share`` caps raise :class:`TenantShareExceeded`
      on put (NEVER block — one tenant's burst must not backpressure the
      shared front door);
    - ``get_nowait(skip=...)`` runs DRR over tenants with queued work,
      deficits in the caller's cost units (prefill-token buckets), so the
      iteration's prefill budget divides by weight; ``skip`` lets the
      engine hold back tenants at their slot cap while others drain.

    With one tenant and default priorities this is exactly a FIFO — the
    pre-tenancy behavior, bit for bit.
    """

    def __init__(
        self,
        maxsize: int,
        registry: TenantRegistry,
        cost_fn: Optional[Callable[[Any], float]] = None,
        tenant_fn: Optional[Callable[[Any], str]] = None,
        quantum: float = 2048.0,
    ) -> None:
        self.maxsize = int(maxsize)
        self._registry = registry
        self._cost_fn = cost_fn or (lambda _r: 1.0)
        self._tenant_fn = tenant_fn or (
            lambda r: getattr(getattr(r, "options", None), "tenant", None)
            or DEFAULT_TENANT
        )
        # base DRR quantum: one full round credits a weight-1 tenant
        # enough for one largest-bucket prompt, so weights translate
        # directly into prefill-token share per round
        self.quantum = max(1.0, float(quantum))
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._lanes: dict[str, _TenantLane] = {}
        self._order: deque[str] = deque()  # tenants with queued work, RR
        self._size = 0

    # -- queue.Queue surface --------------------------------------------------

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def depth_by_tenant(self) -> dict[str, int]:
        with self._lock:
            return {t: len(l) for t, l in self._lanes.items() if len(l)}

    def tenants_with_work(self) -> list[str]:
        with self._lock:
            return [t for t in self._order if len(self._lanes[t])]

    def _share_cap(self, tenant: str) -> Optional[int]:
        """The tenant's queue slice, or None when unconfigured (bounded by
        the global depth only — the share check must never fire for a
        tenant that declared no share, or a lone tenant could never fill
        its own queue)."""
        share = self._registry.state(tenant).spec.queue_share
        if share is None:
            return None
        return max(1, int(math.floor(share * self.maxsize)))

    def _put_locked(self, request: Any) -> None:
        tenant = self._tenant_fn(request)
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = _TenantLane()
        priority = (
            getattr(getattr(request, "options", None), "priority", None)
            or "normal"
        )
        if priority not in PRIORITIES:
            priority = "normal"
        if len(lane) == 0 and tenant not in self._order:
            self._order.append(tenant)
        lane.push(priority, request)
        self._size += 1

    def put_nowait(self, request: Any) -> None:
        with self._lock:
            tenant = self._tenant_fn(request)
            lane = self._lanes.get(tenant)
            cap = self._share_cap(tenant)
            if cap is not None and lane is not None and len(lane) >= cap:
                raise TenantShareExceeded(tenant, cap)
            if self._size >= self.maxsize:
                raise _queue.Full
            self._put_locked(request)

    def put(self, request: Any, timeout: Optional[float] = None) -> None:
        """Blocking put (shed_policy="block" backpressure) — but ONLY on
        the GLOBAL bound. A tenant at its own share cap sheds immediately
        (TenantShareExceeded): blocking the shared submitter thread on one
        tenant's self-inflicted backlog would be the exact noisy-neighbor
        coupling this queue exists to remove."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._not_full:
            tenant = self._tenant_fn(request)
            while True:
                lane = self._lanes.get(tenant)
                cap = self._share_cap(tenant)
                if cap is not None and lane is not None and len(lane) >= cap:
                    raise TenantShareExceeded(tenant, cap)
                if self._size < self.maxsize:
                    self._put_locked(request)
                    return
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise _queue.Full
                self._not_full.wait(remaining)

    def get_nowait(self, skip: Optional[set] = None) -> Any:
        """WDRR pop. Tenants with queued work hold a running DEFICIT in
        cost units (prefill-token buckets). The pop picks the first tenant
        in round-robin order whose deficit covers its head request's cost
        and rotates it to the back (per-request interleaving); when nobody
        can afford its head, every eligible tenant is credited the SAME
        number of rounds of ``quantum × weight`` — computed in closed form,
        so one call never spins regardless of weight or cost magnitudes —
        and the first affordable tenant pops. Over any busy window each
        tenant's popped cost converges to its weight share, which is
        exactly how the fused iteration's prefill-token budget divides.
        ``skip``: tenants the engine is holding back this iteration (at
        their slot cap while others wait) — their entries stay queued.
        Raises ``queue.Empty`` when nothing (outside ``skip``) is queued."""
        skip = skip or set()
        with self._not_full:
            # drop emptied lanes from the round entirely — deficits reset
            # on empty anyway (standard DRR: no hoarding), and the lane
            # dict must not grow one entry per client-invented tenant name
            while self._order and len(self._lanes[self._order[0]]) == 0:
                del self._lanes[self._order.popleft()]
            eligible = [
                t for t in self._order if len(self._lanes[t]) and t not in skip
            ]
            if not eligible:
                raise _queue.Empty

            def _cost(t: str) -> float:
                return max(1.0, float(self._cost_fn(self._lanes[t].head())))

            def _pop() -> Optional[Any]:
                for t in list(self._order):
                    if t in skip or len(self._lanes[t]) == 0:
                        continue
                    lane = self._lanes[t]
                    c = _cost(t)
                    if lane.deficit >= c:
                        request = lane.pop()
                        lane.deficit -= c
                        self._size -= 1
                        if len(lane) == 0:
                            self._order.remove(t)
                            del self._lanes[t]
                        else:
                            # rotate to the back: the next pop visits the
                            # other tenants first (interleaving)
                            self._order.remove(t)
                            self._order.append(t)
                        self._not_full.notify()
                        return request
                return None

            got = _pop()
            if got is not None:
                return got
            # nobody can afford its head: credit the minimum whole number
            # of rounds that makes SOMEONE affordable (closed form — the
            # deficits advance exactly as if the round-robin had spun)
            rounds = min(
                math.ceil(
                    (_cost(t) - self._lanes[t].deficit)
                    / (self.quantum * self._registry.weight(t))
                )
                for t in eligible
            )
            rounds = max(1, rounds)
            for t in eligible:
                self._lanes[t].deficit += (
                    rounds * self.quantum * self._registry.weight(t)
                )
            got = _pop()
            assert got is not None  # the credited minimum guarantees one
            return got


class BrownoutController:
    """The graceful-degradation ladder (docs/SERVING.md §19). The engine
    feeds it the ``load_score`` on its own thread; the controller
    answers with the current level and per-step flags. Hysteresis: a step
    ENGAGES only after ``dwell_s`` of load at/above ``enter_load`` since
    the last transition, and RELEASES only after ``dwell_s`` at/below
    ``exit_load`` — one level per dwell in either direction, so a load
    spike walks the ladder gradually and a recovery unwinds it the same
    way (fully: level 0 restores every behavior)."""

    LADDER = ("spec-shrink", "spec-off", "reject-low", "reject-quota")

    def __init__(
        self,
        enter_load: float = 2.0,
        exit_load: float = 1.0,
        dwell_s: float = 0.5,
    ) -> None:
        if exit_load > enter_load:
            raise ValueError(
                f"brownout exit_load ({exit_load}) must be <= enter_load "
                f"({enter_load}) — the hysteresis band"
            )
        self.enter_load = float(enter_load)
        self.exit_load = float(exit_load)
        self.dwell_s = max(0.0, float(dwell_s))
        self.level = 0
        self.transitions_total = 0
        self.engagements = {step: 0 for step in self.LADDER}
        self.last_load = 0.0
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None

    # -- effect flags (cheap reads on the engine hot path) --------------------

    @property
    def spec_off(self) -> bool:
        return self.level >= 2

    @property
    def reject_low(self) -> bool:
        return self.level >= 3

    @property
    def reject_quota(self) -> bool:
        return self.level >= 4

    def draft_k(self, k: int) -> int:
        """Effective speculative draft count at the current level: full k
        at level 0, halved at level 1 (spec-shrink), 0 past that. The
        dispatch SHAPE never changes (drafts are data, not shape), so no
        recompile rides a brownout transition."""
        if self.level >= 2:
            return 0
        if self.level == 1:
            return max(1, k // 2)
        return k

    def observe(self, load: float, now: Optional[float] = None):
        """Advance the ladder one step at most. Returns ``(old, new)`` on
        a transition, None otherwise."""
        now = time.monotonic() if now is None else now
        self.last_load = load
        if load >= self.enter_load:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (
                self.level < len(self.LADDER)
                and now - self._above_since >= self.dwell_s
            ):
                old = self.level
                self.level += 1
                self.transitions_total += 1
                self.engagements[self.LADDER[self.level - 1]] += 1
                self._above_since = now  # next step needs its own dwell
                return (old, self.level)
        elif load <= self.exit_load:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if self.level > 0 and now - self._below_since >= self.dwell_s:
                old = self.level
                self.level -= 1
                self.transitions_total += 1
                self._below_since = now
                return (old, self.level)
        else:
            # inside the hysteresis band: hold the level, reset both clocks
            self._above_since = None
            self._below_since = None
        return None

    def snapshot(self) -> dict[str, Any]:
        return {
            "level": self.level,
            "step": (
                self.LADDER[self.level - 1] if self.level > 0 else "none"
            ),
            "transitions-total": self.transitions_total,
            "engagements": dict(self.engagements),
            "last-load": round(self.last_load, 4),
        }


def effective_max_new_tokens(options: Any, prompt_len: int) -> int:
    """The request's generation cap with its ``max_cost_tokens`` budget
    applied: cost = prompt + generated, so the budget leaves
    ``max_cost_tokens - prompt_len`` for decode. Callers validate that the
    budget covers at least one generated token at submit."""
    max_new = int(options.max_new_tokens)
    budget = getattr(options, "max_cost_tokens", None)
    if budget is None:
        return max_new
    return max(0, min(max_new, int(budget) - prompt_len))
