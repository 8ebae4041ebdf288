"""Deterministic fault injection for the serving engine (the port's own
copy of ``langstream_tpu/serving/faultinject.py``; stdlib only).

The recovery paths of ``serving/engine.py`` (slot quarantine, loop restart
under backoff, shedding, the NaN guard) are only trustworthy if they can be
driven on demand. This module drives them: a seedable injector the engine
consults at every fault site, so chaos tests and staging drills replay the
same fault sequence on every run.

Sites the port's engine consults:
  prefill   raise before an admit group's dispatch (fails that group)
  segment   raise before a chunked-prefill segment's dispatch (fails that
            stream)
  decode    raise before a decode chunk's or a speculative verify's
            replay (crashes the engine loop: quarantine, device-state
            rebuild, graph re-capture, restart under backoff)
  nan       overwrite one active slot's fetched tokens with the NaN-guard
            sentinel (per-slot quarantine: dense rows or pages zeroed)
  verify    poison one active slot's row of a fetched verify result (its
            first emitted token the NaN-guard sentinel, accept 0): that
            slot alone is quarantined, the others deliver untouched
  page      corrupt one active slot's host page-table row (the paged
            layout's pre-dispatch integrity check must quarantine only
            that slot and free its pages through the owned list)
  fetch     stall the device-to-host fetch thread (slow-fetch drill)
  client    stall token delivery before the on_token callback (slow
            client)
  weight-load  raise WeightLoadError at a tensor read of the streamed
            checkpoint load (models/streamload.py, consulted once per
            tensor): the load cancels its readahead, drains its reader
            pool and never retries, and the provider keeps no engine and
            no params
  tenant-burst  at the top of an engine iteration, enqueue max-batch
            synthetic low-priority admissions under the "chaos-burst"
            tenant (the noisy-neighbor drill's aggressor); a full queue or
            queue share sheds them against that tenant
  adapter   bump one active slot's entry in the engine's dispatch-facing
            adapter-row array, leaving the authoritative copy intact: the
            pre-dispatch integrity check must quarantine that slot alone
  spill     flip one byte of one host-arena slot a restore is about to
            read (host-RAM rot): the slot's checksum must refuse it and
            the admission re-prefill cold
  disk-torn / disk-corrupt  consulted by the durable store right after a
            checkpoint's data file is renamed: truncate it mid-frame / flip
            one byte near its end (the manifest stays valid on purpose) —
            a later restore must read a dead entry
  disk-stall  sleep ``stall_s`` inside a checkpoint or a restore (a slow
            volume: the restore's deadline must fire)
  disk-full   raise before a checkpoint writes a byte (ENOSPC)

  migrate   flip one byte of one page payload of an in-flight KV-page
            migration (``serving/migrate.py``, v1 ``data`` and v2 ``raw``
            alike), its stamped checksum left intact: the receiver's
            per-page check must abort the bind and the sender retain
  spmd-restore  consulted by the SPMD leader at a host-tier restore: the
            announcement tells every follower to flip one byte of its
            first arena slot before it verifies, so one rank's shard fails
            its stamp — the agreed verdict must fall back on every rank (a
            counted recompute), never upload on some ranks only
  net-cut   consulted between the page frames of a migration's export
            (``serving/migrate.py``, through ``serving/fleet.py``'s wire
            injector): the stream ends mid-transfer, nothing is bound

The other sites of the grammar (``net-connect``, ``net-stall``,
``net-corrupt`` and the SPMD sites) are accepted so a spec written for the
JAX package parses, but no part of the port consults them until the HTTP
hop and the SPMD wire are ported.

Every firing is kept in a ring of the last 32 (``events_snapshot``): the
engine's flight dumps carry it, so a postmortem shows which injected fault
came before the incident.

Spec grammar (comma-separated, e.g. ``"decode@3,nan@5:4,fetch~0.1"``):
  site@N      fire exactly once, on the Nth call to that site (1-based)
  site@N+     fire on every call from the Nth on
  site@N:M    fire on call N, then every M calls after (periodic)
  site~P      fire with probability P per call (seeded RNG: deterministic
              for a given seed and call sequence)

Activation: pass a ``FaultInjector`` to ``ServingEngine(fault_injector=...)``,
or set environment variables for a drill:
  LSTPU_FAULTS="decode@40:120,nan@77"   the spec
  LSTPU_FAULT_SEED=0                     RNG seed
  LSTPU_FAULT_STALL_S=0.05               stall of the fetch / client sites
The provider forwards ``fault-injection`` / ``fault-seed`` /
``fault-stall-s`` config keys; one injector serves its load and its engine.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger(__name__)

SITES = (
    "prefill", "segment", "decode", "nan", "verify", "page", "adapter",
    "spill", "fetch", "client",
    "net-connect", "net-stall", "net-cut", "net-corrupt",
    "migrate", "tenant-burst",
    "spmd-crash", "spmd-wedge", "spmd-drop",
    "weight-load",
    "disk-torn", "disk-corrupt", "disk-stall", "disk-full",
    # the port's own site (the JAX package has no multi-rank host tier)
    "spmd-restore",
)

# the NaN-guard sentinel sampling.sample() emits for a non-finite logits
# row; the injector writes the same value into fetched tokens so the
# engine's quarantine path runs end to end without corrupting device memory
NAN_SENTINEL = -1


class InjectedFault(RuntimeError):
    """Raised at raise-type sites; stands in for a device error."""


@dataclass
class _Rule:
    """One site's firing schedule."""

    site: str
    at: int = 0  # first firing call number (1-based); 0 = probability mode
    every: int = 0  # 0 = fire once; >0 = period after `at`; -1 = every call from `at`
    prob: float = 0.0

    def fires(self, call_no: int, rng: random.Random) -> bool:
        if self.at == 0:
            return rng.random() < self.prob
        if call_no < self.at:
            return False
        if self.every == -1:
            return True
        if self.every == 0:
            return call_no == self.at
        return (call_no - self.at) % self.every == 0


def _parse_spec(spec: str) -> dict[str, _Rule]:
    rules: dict[str, _Rule] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "~" in part:
            site, _, p = part.partition("~")
            rule = _Rule(site=site.strip(), prob=float(p))
        elif "@" in part:
            site, _, sched = part.partition("@")
            site = site.strip()
            if sched.endswith("+"):
                rule = _Rule(site=site, at=int(sched[:-1]), every=-1)
            elif ":" in sched:
                n, _, m = sched.partition(":")
                rule = _Rule(site=site, at=int(n), every=max(1, int(m)))
            else:
                rule = _Rule(site=site, at=int(sched))
        else:
            raise ValueError(
                f"bad fault spec part {part!r}: expected site@N, site@N+, site@N:M, or site~P"
            )
        if rule.site not in SITES:
            raise ValueError(f"unknown fault site {rule.site!r}; known: {', '.join(SITES)}")
        rules[rule.site] = rule
    return rules


class FaultInjector:
    """Seedable, thread-safe fault schedule; one per engine.

    Call counters are per site and only advance for sites with a rule, so a
    spec targeting ``decode`` leaves every other path identical to a
    fault-free run — the survivor token-exactness the chaos tests assert."""

    def __init__(self, spec: str, seed: int = 0, stall_s: float = 0.05) -> None:
        self.spec = spec
        self.seed = seed
        self.stall_s = stall_s
        self._rules = _parse_spec(spec)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {s: 0 for s in self._rules}
        self.fired: dict[str, int] = {s: 0 for s in self._rules}
        # recent firings (site, call number, wall time) for flight dumps
        self.events: deque[dict] = deque(maxlen=32)

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["FaultInjector"]:
        spec = env.get("LSTPU_FAULTS", "").strip()
        if not spec:
            return None
        return cls(
            spec,
            seed=int(env.get("LSTPU_FAULT_SEED", "0")),
            stall_s=float(env.get("LSTPU_FAULT_STALL_S", "0.05")),
        )

    def fires(self, site: str) -> bool:
        rule = self._rules.get(site)
        if rule is None:
            return False
        with self._lock:
            self._calls[site] += 1
            hit = rule.fires(self._calls[site], self._rng)
            if hit:
                self.fired[site] += 1
                self.events.append(
                    {"site": site, "call": self._calls[site], "t": round(time.time(), 3)}
                )
                log.warning(
                    "fault injection: %s fires (call %d, total %d)",
                    site, self._calls[site], self.fired[site],
                )
            return hit

    def fire(self, site: str) -> None:
        """Raise-type sites: raise InjectedFault on schedule."""
        if self.fires(site):
            raise InjectedFault(f"injected {site} fault #{self.fired[site]} (spec {self.spec!r})")

    def stall(self, site: str) -> None:
        """Stall-type sites: sleep on schedule."""
        if self.fires(site):
            time.sleep(self.stall_s)

    def corrupt_tokens(self, host, snapshot):
        """``nan`` site: overwrite one active slot's tokens in a fetched
        [steps, B] chunk with the NaN-guard sentinel, as if sampling's
        non-finite guard had tripped on the device for that slot. The
        victim is drawn from the seeded RNG over the chunk's snapshot.
        Returns ``(host, victim)``: a writable copy when the site fires,
        the original array otherwise (victim None)."""
        import numpy as np

        if not snapshot or not self.fires("nan"):
            return host, None
        with self._lock:
            victim = snapshot[self._rng.randrange(len(snapshot))][0]
        host = np.array(host)
        host[:, victim] = NAN_SENTINEL
        return host, victim

    def corrupt_verify(self, packed, snapshot):
        """``verify`` site: corrupt one active slot's row of a fetched
        verify result (``[B, k + 2]``: emitted tokens, then the accepted
        count) so its first delivered token is the NaN-guard sentinel with
        accept 0 — what ``speculative_verify`` emits when that slot's
        logits go non-finite. The victim is drawn from the seeded RNG over
        the snapshot. Returns a writable copy when the site fires, the
        original array otherwise."""
        import numpy as np

        if not snapshot or not self.fires("verify"):
            return packed
        with self._lock:
            victim = snapshot[self._rng.randrange(len(snapshot))][0]
        packed = np.array(packed)
        packed[victim, 0] = NAN_SENTINEL
        packed[victim, -1] = 0
        return packed

    def corrupt_adapter_rows(self, rows, snapshot):
        """``adapter`` site: bump one active slot's entry of the engine's
        dispatch-facing adapter-row array ``rows`` (host numpy), leaving the
        authoritative copy intact — the host-corruption drill for the
        multi-LoRA gather index. Returns the victim slot or None."""
        if not snapshot or not self.fires("adapter"):
            return None
        with self._lock:
            victim = snapshot[self._rng.randrange(len(snapshot))][0]
            rows[victim] = rows[victim] + 1  # any mismatch will do
        return victim

    def corrupt_page_table(self, pool, snapshot):
        """``page`` site: point one active slot's first page-table entry in
        the host table at another page, leaving the allocator's owned list
        intact — the corruption the engine's pre-dispatch integrity check
        exists to catch. Returns the victim slot or None."""
        if not snapshot or not self.fires("page"):
            return None
        with self._lock:
            victim = snapshot[self._rng.randrange(len(snapshot))][0]
            pool.tables[victim, 0] = (pool.tables[victim, 0] + 1) % pool.num_pages
        return victim

    def corrupt_host_page(self, tier, slots):
        """``spill`` site: flip one byte of one arena slot the restore is
        about to read (drawn from the seeded RNG over the entry's slots) —
        the host-memory-rot drill of the host KV tier. Returns the
        corrupted slot or None."""
        if tier is None or not slots or not self.fires("spill"):
            return None
        with self._lock:
            victim = slots[self._rng.randrange(len(slots))]
        tier.corrupt(victim)
        return victim

    def corrupt_migration_frame(self, frame: dict) -> bool:
        """``migrate`` site: damage one page payload of an in-flight KV-page
        migration, its stamped checksum left INTACT, so the receiver's
        per-page verification must catch it and abort the bind. A v2 ``raw``
        payload gets its first byte flipped; a v1 ``data`` list its first
        base64 character swapped for another valid one (the payload still
        decodes, its bytes differ). Returns True when the site fired (the
        frame was changed in place)."""
        if frame.get("kind") != "page" or not self.fires("migrate"):
            return False
        raw = frame.get("raw")
        if raw:
            damaged = bytearray(raw)
            damaged[0] ^= 0xFF
            frame["raw"] = bytes(damaged)
            return True
        data = frame.get("data") or []
        if not data or not data[0]:
            return False
        first = data[0][0]
        data[0] = ("A" if first != "A" else "B") + data[0][1:]
        return True

    def events_snapshot(self) -> list[dict]:
        """A copy of the recent-firings ring, taken under the lock (the
        engine and fetch threads append to it)."""
        with self._lock:
            return list(self.events)

    def stats(self) -> dict[str, int]:
        return dict(self.fired)
