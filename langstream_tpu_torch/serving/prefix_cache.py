"""Automatic prefix KV-cache reuse on the dense layout: a radix index and a
device-resident pool — the port of ``langstream_tpu/serving/prefix_cache.py``.

- **Host side** (``PrefixCachePool`` and its radix trie): an index over
  token sequences keyed at prefill-bucket-aligned boundaries. Edges are
  the token runs between consecutive bucket widths, so a cached prefix is
  always a shape the engine extends with a segment it already runs: the
  suffix prefills as one ``prefill_segment`` starting at the reuse point.
- **Device side**: a KV pool in the slot cache's ``[L, B_pool, Hkv,
  T_pool, D]`` layout (model dtype, or int8 with its scales), ``T_pool``
  the widest prefill bucket, plus one sink row for dropped writes
  (``ops/kvcopy.py``). One pool row holds one cached prefix; the copies in
  and out are ``publish_prefix_rows`` and ``gather_prefix_local``.

Reuse is exact: prefix KV is a function of the prefix tokens alone (causal
attention), so a published row equals what a fresh prefill would write —
the int8 cache's codes and scales are copied untouched. Columns past a
prefix's true length carry garbage by design; the engine's masking
invariant (no column past the written frontier is read until it is
overwritten) makes that safe, as bucket padding is.

Eviction is LRU over unreferenced entries only: ``acquire`` / ``release``
pin an entry for the admission that reads it, and ``allocate`` never
evicts a pinned row. Every method runs on the engine thread; only the
advertisement (``advertised``) is read off it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.ops.kvcopy import make_prefix_pool
from langstream_tpu_torch.serving.memory import tree_bytes
from langstream_tpu_torch.serving.pagepool import prefix_digest


def pool_entries_for_fraction(
    max_batch: int, max_seq_len: int, pool_width: int, fraction: float,
    *, cap: int = 512,
) -> int:
    """Pool rows whose total token capacity ≈ ``fraction`` of the decode
    cache's (max_batch × max_seq_len tokens) — cache bytes scale linearly
    with token capacity, so this is the `prefix-cache-fraction` knob's
    arithmetic. Floored at 2 (a 1-row pool thrashes on its first eviction),
    capped so tiny-bucket configs don't index thousands of rows."""
    if fraction <= 0 or pool_width <= 0:
        return 0
    want = int(fraction * max_batch * max_seq_len) // pool_width
    return max(2, min(want, cap))


class _Node:
    """Radix-trie node; one level per bucket boundary. ``edge`` is the
    token run from the parent's boundary to this node's (kept for pruning)."""

    __slots__ = ("parent", "edge", "children", "entry")

    def __init__(self, parent: Optional["_Node"] = None, edge: tuple = ()):
        self.parent = parent
        self.edge = edge
        self.children: dict[tuple, _Node] = {}
        self.entry: Optional[PrefixEntry] = None


@dataclass
class PrefixEntry:
    row: int  # pool row holding the KV
    length: int  # bucket-aligned token count (a boundary width)
    refs: int = 0  # admissions currently reading this row
    last_used: int = 0  # LRU tick
    node: Any = field(default=None, repr=False)
    digest: str = ""  # prefix_digest(tokens[:length]) — beacon advertisement


class PrefixCachePool:
    """Radix-indexed, refcounted, LRU-evicted device KV pool."""

    def __init__(
        self,
        config: Any,
        entries: int,
        width: int,
        boundaries: tuple[int, ...],
        device: DeviceLike = "cuda",
    ) -> None:
        self.config = config
        self.entries = int(entries)
        self.width = int(width)
        self.device = resolve_device(device)
        # bucket-aligned publish/lookup lengths, ascending, bounded by the
        # pool width (a prefix wider than a pool row can't be cached)
        self.boundaries = tuple(
            sorted({int(b) for b in boundaries if 0 < b <= self.width})
        )
        if self.entries < 1 or not self.boundaries:
            raise ValueError("prefix pool needs ≥1 entry and ≥1 boundary")
        self.dev = make_prefix_pool(config, self.entries, self.width, device=self.device)
        # the real rows' bytes (the sink row takes dropped writes only)
        rows = self.entries + 1
        self.bytes_total = tree_bytes(self.dev) // rows * self.entries
        self._bytes_per_row = self.bytes_total // self.entries
        self._root = _Node()
        self._live: dict[int, PrefixEntry] = {}  # row → entry
        self._free = list(range(self.entries - 1, -1, -1))
        self._tick = 0
        # beacon advertisement: digest → [length, recency tick] — the one
        # surface read off-thread, mirroring pagepool.PrefixPageIndex
        self._ads: dict[str, list] = {}
        self._ad_lock = threading.Lock()
        # stats (cumulative since engine start)
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.evictions = 0

    def reset(self) -> None:
        """Drop every cached prefix and rebuild the device pool — the
        engine's crash-recovery path: pool rows may hold KV published from
        a poisoned cache. The old pool is released before the new one is
        allocated. Hit/eviction counters survive (they are cumulative since
        engine start); pins do not — every pinned admission was already
        failed by the recovery that called this."""
        self.dev = None
        self.dev = make_prefix_pool(self.config, self.entries, self.width, device=self.device)
        self._root = _Node()
        self._live = {}
        self._free = list(range(self.entries - 1, -1, -1))
        with self._ad_lock:
            self._ads = {}
        self._tick = 0

    # -- index ---------------------------------------------------------------

    def _walk(self, tokens, limit: int, create: bool = False) -> list[_Node]:
        """Nodes along the bucket-aligned path of ``tokens``, root excluded,
        stopping at the first missing edge (or creating edges down to the
        deepest boundary ≤ limit when ``create``)."""
        path: list[_Node] = []
        node, prev = self._root, 0
        for b in self.boundaries:
            if b > limit:
                break
            seg = tuple(tokens[prev:b])
            child = node.children.get(seg)
            if child is None:
                if not create:
                    break
                child = _Node(parent=node, edge=seg)
                node.children[seg] = child
            path.append(child)
            node, prev = child, b
        return path

    def candidates(self, tokens) -> list[tuple[int, PrefixEntry]]:
        """Usable ``(reuse_length, entry)`` pairs for this prompt, ascending
        by length. The limit is ``len(tokens) - 1``: at least one suffix
        token must prefill, since the first sampled token needs last-token
        logits. A pair may reuse only the FIRST ``reuse_length`` columns of
        a DEEPER entry (a preamble cached as part of a longer prompt still
        serves shorter prompts sharing it — the row's leading columns ARE
        that prefix's KV). No stats side effects; callers report the final
        decision through ``record_lookup``."""
        out: list[tuple[int, PrefixEntry]] = []
        path = self._walk(tokens, limit=len(tokens) - 1)
        depth = 0
        for node, b in zip(path, self.boundaries):
            if node.entry is not None:
                out.append((b, node.entry))
            depth = b
        if path and (not out or out[-1][0] < depth):
            # the deepest matched node has no entry of its own, but any
            # descendant's row carries this prefix in its leading columns
            sub = self._subtree_entry(path[-1])
            if sub is not None:
                out.append((depth, sub))
        return out

    @staticmethod
    def _subtree_entry(node: _Node) -> Optional[PrefixEntry]:
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    def record_lookup(self, used: Optional[PrefixEntry]) -> None:
        """Count one admission lookup; ``used`` is the entry the engine
        actually reused (None = miss / no usable candidate)."""
        self.lookups += 1
        if used is not None:
            self.hits += 1
            self._tick += 1
            used.last_used = self._tick
            if used.digest:
                with self._ad_lock:
                    ad = self._ads.get(used.digest)
                    if ad is not None:
                        ad[1] = self._tick

    def match_len(self, tokens) -> int:
        """Non-mutating probe: longest cached prefix length usable for
        ``tokens``, or 0. Touches neither LRU recency nor hit counters —
        see pagepool.PrefixPageIndex.match_len for why that matters."""
        cands = self.candidates(tokens)
        return cands[-1][0] if cands else 0

    def advertised(self, top_k: int = 32) -> list[tuple[str, int, str]]:
        """Most-recently-used ``top_k`` ``(digest, length, tier)`` triples
        for the fleet beacon; thread-safe. The dense pool has no host
        tier, so every entry advertises ``device`` (the paged index is
        where ``host`` hibernation appears — pagepool.advertised)."""
        with self._ad_lock:
            items = sorted(
                self._ads.items(), key=lambda kv: kv[1][1], reverse=True
            )[: max(0, top_k)]
        return [(digest, ad[0], "device") for digest, ad in items]

    def has(self, tokens, length: int) -> bool:
        path = self._walk(tokens, limit=length)
        return bool(path) and path[-1].entry is not None and (
            path[-1].entry.length == length
        )

    def publish_length(self, prompt_len: int) -> int:
        """Largest bucket-aligned prefix length coverable by a pool row for
        a prompt of ``prompt_len`` tokens, or 0 when none fits."""
        best = 0
        for b in self.boundaries:
            if b <= prompt_len:
                best = b
        return best

    # -- refcounts / eviction ------------------------------------------------

    def acquire(self, entry: PrefixEntry) -> None:
        entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        assert entry.refs > 0
        entry.refs -= 1

    def allocate(self) -> Optional[int]:
        """A free pool row, evicting the least-recently-used UNREFERENCED
        entry when full. None when every row is pinned by an in-flight
        admission — the caller skips the publish (never blocks, never
        evicts a row a dispatch is reading)."""
        if self._free:
            return self._free.pop()
        victims = [e for e in self._live.values() if e.refs == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda e: e.last_used)
        self._evict(victim)
        return self._free.pop()

    def _evict(self, entry: PrefixEntry) -> None:
        node = entry.node
        node.entry = None
        # prune entry-less leaf chains so the trie stays bounded by the pool
        while (
            node is not None
            and node.parent is not None
            and node.entry is None
            and not node.children
        ):
            parent = node.parent
            del parent.children[node.edge]
            node = parent
        del self._live[entry.row]
        self._free.append(entry.row)
        if entry.digest:
            with self._ad_lock:
                self._ads.pop(entry.digest, None)
        self.evictions += 1

    def insert(self, tokens, length: int, row: int) -> PrefixEntry:
        """Index pool row ``row`` as the prefix ``tokens[:length]`` (the
        device copy has already been dispatched; in-order streams make the
        row readable by any later gather)."""
        assert length in self.boundaries, (length, self.boundaries)
        node = self._walk(tokens, limit=length, create=True)[-1]
        self._tick += 1
        entry = PrefixEntry(
            row=row, length=length, last_used=self._tick, node=node,
            digest=prefix_digest(tokens[:length]),
        )
        node.entry = entry
        self._live[row] = entry
        with self._ad_lock:
            self._ads[entry.digest] = [entry.length, entry.last_used]
        return entry

    # -- stats ---------------------------------------------------------------

    @property
    def live_entries(self) -> int:
        return len(self._live)

    def bytes_in_use(self) -> int:
        return len(self._live) * self._bytes_per_row

    def hit_rate(self) -> float:
        return round(self.hits / self.lookups, 4) if self.lookups else 0.0
