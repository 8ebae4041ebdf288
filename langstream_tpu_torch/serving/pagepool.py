"""Paged KV pool: ONE device-resident page pool + host allocator (port of
the ``PagePool`` half of ``langstream_tpu/serving/pagepool.py``).

``PagePool`` holds the device tree (``models.transformer.make_page_pool``:
``[L, P + 1, Hkv, page_size, D]``, model dtype or int8 + scales — the extra
page is the write sink of the sentinel), a free-list allocator with
refcounts (one holder per page until prefix reuse is ported), and per-slot
page tables. A slot's table row maps logical page
``t // page_size`` to a physical page; unmapped entries carry the
out-of-bounds sentinel (= ``num_pages``). Pages are reserved in full at
admission, so decode never allocates: exhaustion defers an admission, it
never corrupts a slot. All methods run on the engine thread.

The table-row integrity check (``validate``, the ``page`` fault site's
target) and the crash-recovery ``reset`` are ported; the prefix index and
the host-RAM spill tier of the JAX package are not yet.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from langstream_tpu_torch.device import DeviceLike


def table_len_for(max_seq_len: int, page_size: int) -> int:
    """Per-slot worst-case page-table length."""
    return max(1, math.ceil(max_seq_len / page_size))


def default_num_pages(max_batch: int, max_seq_len: int, page_size: int) -> int:
    """Pool size in pages at which every slot can reach max_seq_len."""
    return max_batch * table_len_for(max_seq_len, page_size)


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
        self.bytes_total = sum(t.numel() * t.element_size() for t in leaves)
        self.tables = np.full((self.max_batch, self.table_len), self.oob, np.int32)
        self._refs = np.zeros(self.num_pages, np.int64)
        self._free = list(range(self.num_pages - 1, -1, -1))
        # authoritative per-slot page lists, logical order; the table array
        # above is the device-facing derivation of them
        self._owned: dict[int, list[int]] = {}

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

    def reserve(self, slot: int, n_pages: int) -> bool:
        """Bind ``n_pages`` fresh pages to slot ``slot``'s table. False —
        slot untouched — when the pool cannot cover them."""
        if slot in self._owned or not 0 < n_pages <= self.table_len:
            raise ValueError(f"slot {slot}: cannot reserve {n_pages} pages")
        owned = self._alloc(n_pages)
        if owned is None:
            return False
        self._owned[slot] = owned
        self.tables[slot, :n_pages] = owned
        self.tables[slot, n_pages:] = self.oob
        return True

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
        forgotten (the engine fails the slots that held them)."""
        from langstream_tpu_torch.models.transformer import make_page_pool

        self.dev = None
        self.dev = make_page_pool(self.config, self.num_pages, self.page_size, device=self.device)
        self.tables[:] = self.oob
        self._refs[:] = 0
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._owned.clear()
