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
  decode    raise before a decode chunk's replay (crashes the engine loop:
            quarantine, device-state rebuild, graph re-capture, restart
            under backoff)
  nan       overwrite one active slot's fetched tokens with the NaN-guard
            sentinel (per-slot quarantine: dense rows or pages zeroed)
  page      corrupt one active slot's host page-table row (the paged
            layout's pre-dispatch integrity check must quarantine only
            that slot and free its pages through the owned list)
  fetch     stall the device-to-host fetch thread (slow-fetch drill)
  client    stall token delivery before the on_token callback (slow
            client)

The other sites of the grammar (verify, adapter, spill, weight-load, the
durable disk sites, the fleet-wire net sites, migrate, tenant-burst and the
SPMD sites) are accepted so a spec written for the JAX package parses, but
no part of the port consults them until their tiers are ported.

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
``fault-stall-s`` config keys.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
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

    def stats(self) -> dict[str, int]:
        return dict(self.fired)
