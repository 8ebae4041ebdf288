"""Paged KV pool: ONE device-resident page pool + host allocator, and the
radix index that turns prefix reuse into page aliasing (port of
``langstream_tpu/serving/pagepool.py`` without its host-RAM tier).

- ``PagePool`` holds the device tree (``models.transformer.make_page_pool``:
  ``[L, P + 1, Hkv, page_size, D]``, model dtype or int8 + scales — the
  extra page is the write sink of the sentinel), a free-list allocator with
  refcounts (a page aliased by several slots and prefix entries is freed
  when its last holder lets go), and per-slot page tables. A slot's table
  row maps logical page ``t // page_size`` to a physical page; unmapped
  entries carry the out-of-bounds sentinel (= ``num_pages``). Pages are
  reserved in full at admission, so decode never allocates: exhaustion
  defers an admission, it never corrupts a slot.
- ``PrefixPageIndex``: a radix trie over bucket-aligned token prefixes
  whose entries alias the publishing slot's leading pages. A hit joins the
  full pages to the new slot's table by a refcount bump (zero device
  copies); only a prefix that ends mid-page costs one page copy
  (copy-on-write), and publishing is a refcount bump too. Entries are
  evicted LRU (unpinned only) when an admission cannot allocate, and every
  entry touching a quarantined slot's pages is evicted with it.

The table-row integrity check (``validate``, the ``page`` fault site's
target) and the crash-recovery ``reset`` are ported. All methods run on the
engine thread. The host-RAM spill tier and the fleet beacon's
advertisement of the JAX package are not ported yet.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from langstream_tpu_torch.device import DeviceLike


def prefix_digest(tokens) -> str:
    """Stable, process-independent digest of a token prefix (blake2b over
    the int32 byte image, 16 hex digits): what a replica advertises in
    place of the tokens themselves."""
    arr = np.asarray(list(tokens), np.int32)
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


def table_len_for(max_seq_len: int, page_size: int) -> int:
    """Per-slot worst-case page-table length."""
    return max(1, math.ceil(max_seq_len / page_size))


def pages_for_fraction(
    max_batch: int, max_seq_len: int, page_size: int, fraction: float = 0.0
) -> int:
    """Pool size in pages: every slot can reach max_seq_len, plus
    ``fraction`` headroom for the shared prefix pages the index holds."""
    base = max_batch * table_len_for(max_seq_len, page_size)
    extra = math.ceil(base * fraction) if fraction > 0 else 0
    return base + extra


class PagePool:
    """Device page pool + free-list allocator + per-slot page tables."""

    def __init__(
        self,
        config: Any,
        num_pages: int,
        page_size: int,
        max_batch: int,
        max_seq_len: int,
        device: DeviceLike = "cuda",
    ) -> None:
        from langstream_tpu_torch.models.transformer import make_page_pool

        if num_pages < 1 or page_size < 1:
            raise ValueError("page pool needs >= 1 page of >= 1 token")
        self.config = config
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_batch = int(max_batch)
        self.table_len = table_len_for(max_seq_len, page_size)
        self.oob = self.num_pages  # sentinel: writes land in the sink page
        self.device = device
        self.dev = make_page_pool(config, self.num_pages, self.page_size, device=device)
        leaves = [
            leaf
            for entry in self.dev.values()
            for leaf in (entry.values() if isinstance(entry, dict) else (entry,))
        ]
        # the sink page included; a page's bytes (every layer, head and
        # leaf) are the same for each of the P + 1
        self.bytes_total = sum(t.numel() * t.element_size() for t in leaves)
        self.bytes_per_page = self.bytes_total // (self.num_pages + 1)
        self.tables = np.full((self.max_batch, self.table_len), self.oob, np.int32)
        self._refs = np.zeros(self.num_pages, np.int64)
        self._free = list(range(self.num_pages - 1, -1, -1))
        # authoritative per-slot page lists, logical order; the table array
        # above is the device-facing derivation of them
        self._owned: dict[int, list[int]] = {}
        # cumulative reservation accounting: the alias rate is the share of
        # reserved pages that aliasing covered instead of fresh pages
        self.reserved_pages_total = 0
        self.aliased_pages_total = 0

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages a request can write: positions [0, prompt +
        max_new), capped by the table."""
        tokens = min(prompt_len + max(1, max_new_tokens), self.table_len * self.page_size)
        return min(self.table_len, math.ceil(tokens / self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one holder (slots and prefix entries)."""
        return int(np.count_nonzero(self._refs > 1))

    def incref(self, pages) -> None:
        for p in pages:
            assert self._refs[p] > 0, p  # aliasing a free page is a bug
            self._refs[p] += 1

    def decref(self, pages) -> list[int]:
        """Drop one reference per page; pages reaching zero return to the
        free list. Returns the freed pages."""
        freed = []
        for p in pages:
            assert self._refs[p] > 0, p
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def _alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def reserve(self, slot: int, n_pages: int, shared: tuple[int, ...] = ()) -> Optional[int]:
        """Bind slot ``slot``'s table: the ``shared`` pages first (aliased
        by a refcount bump), then fresh pages up to ``n_pages`` in all.
        Returns the first fresh page (the copy-on-write destination when
        the aliased prefix ends mid-page), -1 when every page is shared, or
        None — slot untouched — when the pool cannot cover the fresh
        pages."""
        if slot in self._owned or not 0 < n_pages <= self.table_len or len(shared) > n_pages:
            raise ValueError(f"slot {slot}: cannot reserve {n_pages} pages ({len(shared)} shared)")
        fresh = self._alloc(n_pages - len(shared))
        if fresh is None:
            return None
        self.reserved_pages_total += n_pages
        self.aliased_pages_total += len(shared)
        self.incref(shared)
        owned = list(shared) + fresh
        self._owned[slot] = owned
        self.tables[slot, :n_pages] = owned
        self.tables[slot, n_pages:] = self.oob
        return fresh[0] if fresh else -1

    def free_slot(self, slot: int) -> list[int]:
        """Release the slot's pages through the owned list and clear its
        table row. Returns the pages whose refcount hit zero."""
        owned = self._owned.pop(slot, None)
        self.tables[slot, :] = self.oob
        if not owned:
            return []
        return self.decref(owned)

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, ()))

    def validate(self, slot: int) -> bool:
        """Table-row integrity: the device-facing row must equal the owned
        list plus sentinel padding. A mismatch means the table was
        corrupted (the ``page`` fault site, or a bookkeeping bug) —
        dispatching it would read and write someone else's pages."""
        owned = self._owned.get(slot, ())
        row = self.tables[slot]
        n = len(owned)
        return bool(
            np.array_equal(row[:n], np.asarray(owned, np.int32)) and np.all(row[n:] == self.oob)
        )

    def reset(self) -> None:
        """Crash recovery: a fresh device pool (the old one released first,
        so both never sit on the device together) and every binding
        forgotten (the engine fails the slots that held them; the prefix
        index is reset beside it)."""
        from langstream_tpu_torch.models.transformer import make_page_pool

        self.dev = None
        self.dev = make_page_pool(self.config, self.num_pages, self.page_size, device=self.device)
        self.tables[:] = self.oob
        self._refs[:] = 0
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._owned.clear()


# -- prefix alias index -------------------------------------------------------


class _Node:
    """Radix-trie node, one level per bucket boundary."""

    __slots__ = ("parent", "edge", "children", "entry")

    def __init__(self, parent: Optional["_Node"] = None, edge: tuple = ()):
        self.parent = parent
        self.edge = edge
        self.children: dict[tuple, _Node] = {}
        self.entry: Optional[PrefixPages] = None


@dataclass
class PrefixPages:
    """One cached prefix: ``length`` tokens whose KV lives in ``pages``
    (refcounted in the pool; the last page is partial when length %
    page_size). ``pins`` guards an admission reading the entry."""

    pages: tuple[int, ...]
    length: int
    pins: int = 0
    last_used: int = 0
    node: Any = field(default=None, repr=False)
    digest: str = ""  # prefix_digest(tokens[:length])


class PrefixPageIndex:
    """Radix-indexed prefix → pages map. Aliasing keeps reuse exact: prefix
    KV is a pure function of the prefix tokens, and a page fully covered by
    a published prefix is never written again by its publisher (positions
    only grow), so an aliased page always equals what a fresh prefill would
    have written. The last, partial page is still written by the publisher
    (its own later tokens), so a reader copies that one page and overwrites
    its tail with its own suffix; the columns below the published length
    are stable by the same argument."""

    def __init__(self, boundaries: tuple[int, ...], max_entries: int = 512):
        self.boundaries = tuple(sorted({int(b) for b in boundaries if b > 0}))
        if not self.boundaries or max_entries < 1:
            raise ValueError("prefix index needs >= 1 boundary and >= 1 entry")
        self.max_entries = int(max_entries)
        self._root = _Node()
        self._live: list[PrefixPages] = []
        # distinct pages the live entries hold (page → entry count): the
        # bytes-in-use gauge is one len()
        self._page_holds: dict[int, int] = {}
        self._tick = 0
        # cumulative since the engine started (a reset keeps them)
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.evictions = 0
        self.copy_bytes_saved = 0

    # -- trie -----------------------------------------------------------------

    def _walk(self, tokens, limit: int, create: bool = False) -> list[_Node]:
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

    @staticmethod
    def _subtree_entry(node: _Node) -> Optional[PrefixPages]:
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    def candidates(self, tokens) -> list[tuple[int, PrefixPages]]:
        """Usable ``(reuse_length, entry)`` pairs, ascending by length; at
        least one suffix token must remain to prefill. A deeper entry's
        leading pages serve a shorter boundary too (the same prefix KV)."""
        out: list[tuple[int, PrefixPages]] = []
        path = self._walk(tokens, limit=len(tokens) - 1)
        depth = 0
        for node, b in zip(path, self.boundaries):
            if node.entry is not None:
                out.append((b, node.entry))
            depth = b
        if path and (not out or out[-1][0] < depth):
            sub = self._subtree_entry(path[-1])
            if sub is not None:
                out.append((depth, sub))
        return out

    def record_lookup(self, used: Optional[PrefixPages]) -> None:
        self.lookups += 1
        if used is not None:
            self.hits += 1
            self._tick += 1
            used.last_used = self._tick

    def match_len(self, tokens) -> int:
        """The longest cached prefix length usable for ``tokens``, or 0 —
        a probe that touches neither recency nor the hit counters."""
        cands = self.candidates(tokens)
        return cands[-1][0] if cands else 0

    def has(self, tokens, length: int) -> bool:
        path = self._walk(tokens, limit=length)
        return bool(path) and path[-1].entry is not None and path[-1].entry.length == length

    def publish_length(self, prompt_len: int) -> int:
        """The deepest boundary a prompt of ``prompt_len`` tokens covers."""
        best = 0
        for b in self.boundaries:
            if b <= prompt_len:
                best = b
        return best

    # -- entries --------------------------------------------------------------

    def acquire(self, entry: PrefixPages) -> None:
        entry.pins += 1

    def release(self, entry: PrefixPages) -> None:
        assert entry.pins > 0
        entry.pins -= 1

    def insert(
        self, pool: PagePool, tokens, length: int, pages: tuple[int, ...]
    ) -> Optional[PrefixPages]:
        """Publish ``tokens[:length]`` as an alias of ``pages`` (the
        publishing slot's leading table entries): a refcount bump, no
        device copy. Over the entry cap the LRU unpinned entry makes room,
        or the publish is skipped (it never blocks)."""
        assert length in self.boundaries, (length, self.boundaries)
        if len(self._live) >= self.max_entries and not self.evict_device_lru(pool):
            return None
        pool.incref(pages)
        node = self._walk(tokens, limit=length, create=True)[-1]
        self._tick += 1
        entry = PrefixPages(
            pages=tuple(pages), length=length, last_used=self._tick, node=node,
            digest=prefix_digest(tokens[:length]),
        )
        if node.entry is not None:
            self._drop(pool, node.entry)  # a re-publish of the same prefix
        node.entry = entry
        self._live.append(entry)
        for p in entry.pages:
            self._page_holds[p] = self._page_holds.get(p, 0) + 1
        return entry

    def _drop(self, pool: PagePool, entry: PrefixPages) -> None:
        node = entry.node
        if node.entry is entry:
            node.entry = None
            while (
                node is not None
                and node.parent is not None
                and node.entry is None
                and not node.children
            ):
                parent = node.parent
                del parent.children[node.edge]
                node = parent
        self._live.remove(entry)
        for p in entry.pages:
            left = self._page_holds.get(p, 0) - 1
            if left > 0:
                self._page_holds[p] = left
            else:
                self._page_holds.pop(p, None)
        pool.decref(entry.pages)
        # an evicted entry holds no pages: a caller still holding it (a
        # candidate list already taken) reads it as gone, and can never
        # alias pages the free list handed out again
        entry.pages = ()

    def evict_device_lru(self, pool: PagePool) -> bool:
        """Drop the least-recently-used unpinned entry. False when every
        entry is pinned by an admission reading it (or there is none)."""
        victims = [e for e in self._live if e.pins == 0]
        if not victims:
            return False
        self._drop(pool, min(victims, key=lambda e: e.last_used))
        self.evictions += 1
        return True

    def evict_lru(self, pool: PagePool) -> bool:
        """``evict_device_lru``: with no host tier every entry's pages are
        device pages."""
        return self.evict_device_lru(pool)

    def evict_for(self, pool: PagePool, need_pages: int) -> bool:
        """Evict LRU entries until ``need_pages`` pages are free (or nothing
        evictable remains). Eviction helps only when it drops a page's last
        reference, so progress is checked after every victim."""
        while pool.free_pages < need_pages:
            if not self.evict_device_lru(pool):
                return False
        return True

    def evict_touching(self, pool: PagePool, pages) -> int:
        """Evict every entry that references any of ``pages`` — the
        quarantine path: a poisoned slot's published prefixes must not
        outlive it."""
        touched = set(pages)
        victims = [e for e in self._live if touched.intersection(e.pages)]
        for e in victims:
            self._drop(pool, e)
            self.evictions += 1
        return len(victims)

    def reset(self) -> None:
        """Crash recovery: the pool was rebuilt, so its page references are
        gone with it and the entries just vanish; counters are
        cumulative."""
        self._root = _Node()
        self._live = []
        self._page_holds = {}
        self._tick = 0

    # -- stats ----------------------------------------------------------------

    @property
    def live_entries(self) -> int:
        return len(self._live)

    @property
    def pages_held(self) -> int:
        """Distinct pages the live entries reference."""
        return len(self._page_holds)

    def hit_rate(self) -> float:
        return round(self.hits / self.lookups, 4) if self.lookups else 0.0
