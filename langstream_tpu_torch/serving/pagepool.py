"""Paged KV pool: ONE device-resident page pool + host allocator, the radix
index that turns prefix reuse into page aliasing, and the host-RAM page tier
under the pool (port of ``langstream_tpu/serving/pagepool.py``).

- ``PagePool`` holds the device tree (``models.transformer.make_page_pool``:
  ``[L, P + 1, Hkv, page_size, D]``, model dtype or int8 + scales — the
  extra page is the write sink of the sentinel), a free-list allocator with
  refcounts (a page aliased by several slots and prefix entries is freed
  when its last holder lets go), and per-slot page tables. A slot's table
  row maps logical page ``t // page_size`` to a physical page; unmapped
  entries carry the out-of-bounds sentinel (= ``num_pages``). Pages are
  reserved in full at admission, so decode never allocates: exhaustion
  defers an admission, it never corrupts a slot. A page whose spill copy
  may still be reading it carries a fence (``fence``): every writer of a
  freed page runs the fence's ``wait()`` first (``wait_fences``: the
  allocator before it hands the page out again, the zeroing of a
  quarantine's freed pages) — on the card the engine stream waits on the
  copy's completion event, on the device, never a host sync.
- ``PrefixPageIndex``: a radix trie over bucket-aligned token prefixes
  whose entries alias the publishing slot's leading pages. A hit joins the
  full pages to the new slot's table by a refcount bump (zero device
  copies); only a prefix that ends mid-page costs one page copy
  (copy-on-write), and publishing is a refcount bump too. Entries are
  evicted LRU (unpinned only) when an admission cannot allocate, and every
  entry touching a quarantined slot's pages is evicted with it.
- ``HostPageTier``: a host-RAM page arena under the pool (pinned when the
  pool is on the card). Idle published prefixes spill into it off the hot
  loop, and under pool pressure the LRU eviction DEMOTES an entry to its
  host copy instead of dropping it; a radix hit on a host-only entry is a
  restore (an upload) instead of a re-prefill. ``PrefixPages`` tracks the
  tier per entry (``device`` | ``both`` | ``host``). The arena is
  slot-major, one tensor a pool leaf shaped ``[HP, L, Hkv, ps(, D)]``: one
  slot of a leaf is one contiguous block whose bytes equal the JAX arena's
  ``np.ascontiguousarray(a[:, slot])``, and an asynchronous copy has a
  contiguous pinned end. Every slot carries a blake2b checksum stamped at
  spill time and verified before a restore uploads it, so a corrupted host
  page (the ``spill`` fault site, or real RAM rot) degrades to a cold
  re-prefill, never to wrong KV.

Byte images: ``page_checksum``, ``join_page_bytes`` and
``split_page_bytes`` take a page's leaf blocks in the JAX package's
``jax.tree.leaves`` order (k before v; an int8 pool's q before s). bf16
leaves move as their 16-bit patterns (int16 views), so a page's checksum
and byte image equal the JAX package's for the same values.

The table-row integrity check (``validate``, the ``page`` fault site's
target) and the crash-recovery ``reset`` are ported. Everything but the
arena's ``write`` / ``stamp`` (the spill worker's) and the checksum map
runs on the engine thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike


def prefix_digest(tokens) -> str:
    """Stable, process-independent digest of a token prefix (blake2b over
    the int32 byte image, 16 hex digits): what a replica advertises in
    place of the tokens themselves."""
    arr = np.asarray(list(tokens), np.int32)
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


def pool_leaves(tree: Any) -> list[torch.Tensor]:
    """The leaves of a pool (or of one page's block tree) in the JAX
    package's ``jax.tree.leaves`` order: dict keys sorted (k before v, q
    before s)."""
    out: list[torch.Tensor] = []
    for key in sorted(tree):
        node = tree[key]
        out.extend(pool_leaves(node) if isinstance(node, dict) else (node,))
    return out


def np_view(block: Any) -> np.ndarray:
    """A host block as a numpy array over the same bytes: a torch tensor's
    bf16 / f16 elements as their 16-bit patterns (numpy has no bfloat16),
    any other dtype as itself."""
    if isinstance(block, torch.Tensor):
        t = block.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(block)


def page_checksum(blocks) -> bytes:
    """blake2b-16 over one page's leaf blocks (``pool_leaves`` order,
    C-contiguous): the digest the spill tier stamps and the durable tier's
    manifest carries — the JAX package's, for the same bytes."""
    h = hashlib.blake2b(digest_size=16)
    for b in blocks:
        h.update(np.ascontiguousarray(np_view(b)))
    return h.digest()


# page hashes run on a few threads (blake2b releases the GIL over large
# buffers); made at the first batch of more than one page
HASH_THREADS = max(1, min(4, os.cpu_count() or 1))
_hash_pool: Optional[ThreadPoolExecutor] = None
_hash_pool_lock = threading.Lock()


def page_checksums(pages: list) -> list[bytes]:
    """``page_checksum`` of each page's leaf blocks, the pages hashed in
    parallel on ``HASH_THREADS`` threads: every page hashed whole, the
    digests in ``pages``' order."""
    global _hash_pool
    if len(pages) < 2 or HASH_THREADS < 2:
        return [page_checksum(blocks) for blocks in pages]
    with _hash_pool_lock:
        if _hash_pool is None:
            _hash_pool = ThreadPoolExecutor(HASH_THREADS, thread_name_prefix="page-hash")
    return list(_hash_pool.map(page_checksum, pages))


def join_page_bytes(blocks) -> bytes:
    """One page's leaf blocks (``pool_leaves`` order) → the concatenated
    byte image a checkpoint stores: every leaf at its native width,
    C-contiguous, in ``page_checksum``'s update order."""
    return b"".join(np.ascontiguousarray(np_view(b)).tobytes() for b in blocks)


def split_page_bytes(raw: bytes, specs) -> list:
    """Inverse of ``join_page_bytes``: split one raw page payload into
    per-leaf numpy arrays against the pool's ``page_leaf_specs``. Raises
    ValueError on any size mismatch — a truncated or padded payload must
    abort before the checksum, never reshape garbage."""
    out = []
    off = 0
    for shape, dtype in specs:
        nb = int(math.prod(shape)) * np.dtype(dtype).itemsize
        chunk = raw[off:off + nb]
        if len(chunk) != nb:
            raise ValueError(
                f"page payload truncated at leaf {len(out)} ({len(chunk)} of {nb} bytes)"
            )
        out.append(np.frombuffer(chunk, dtype=dtype).reshape(shape))
        off += nb
    if off != len(raw):
        raise ValueError(
            f"page payload carries {len(raw) - off} trailing byte(s) past its "
            f"{off}-byte leaf layout"
        )
    return out


def page_leaf_specs(pool: Any) -> list[tuple[tuple[int, ...], np.dtype]]:
    """``(page shape, numpy dtype)`` of each leaf of one page of ``pool``
    (``[L, Hkv, ps(, D)]``; bf16 / f16 as int16, ``np_view``'s dtype)."""
    out = []
    for leaf in pool_leaves(pool):
        dtype = torch.int16 if leaf.dtype in (torch.bfloat16, torch.float16) else leaf.dtype
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        out.append(((leaf.shape[0],) + tuple(leaf.shape[2:]), np_dtype))
    return out


# -- page copies between the pool and host blocks -----------------------------


class _Memcpy2D(ctypes.Structure):
    """The driver's ``CUDA_MEMCPY2D``."""

    _fields_ = [
        ("srcXInBytes", ctypes.c_size_t), ("srcY", ctypes.c_size_t),
        ("srcMemoryType", ctypes.c_int), ("srcHost", ctypes.c_void_p),
        ("srcDevice", ctypes.c_uint64), ("srcArray", ctypes.c_void_p),
        ("srcPitch", ctypes.c_size_t),
        ("dstXInBytes", ctypes.c_size_t), ("dstY", ctypes.c_size_t),
        ("dstMemoryType", ctypes.c_int), ("dstHost", ctypes.c_void_p),
        ("dstDevice", ctypes.c_uint64), ("dstArray", ctypes.c_void_p),
        ("dstPitch", ctypes.c_size_t),
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
    ]


_MEM_HOST, _MEM_DEVICE = 1, 2  # CUmemorytype
_libcuda_handle: Any = None


def _libcuda() -> Any:
    """The CUDA driver library, loaded at the first page copy on the card."""
    global _libcuda_handle
    if _libcuda_handle is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuMemcpy2DAsync_v2.argtypes = [ctypes.POINTER(_Memcpy2D), ctypes.c_void_p]
        lib.cuCtxGetCurrent.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.cuCtxSetCurrent.argtypes = [ctypes.c_void_p]
        lib.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.cuDevicePrimaryCtxRetain.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ]
        _libcuda_handle = lib
    return _libcuda_handle


def _make_context_current(lib: Any, device: torch.device) -> None:
    """Make the device's primary context (the one torch's runtime calls use)
    current on the calling thread. A thread that has made no runtime call
    yet has none — an idle engine thread whose first work is a migration's
    bind, in a replica whose graphs were captured on another thread — and
    libcuda's copy would fail with CUDA_ERROR_INVALID_CONTEXT."""
    ctx = ctypes.c_void_p()
    if lib.cuCtxGetCurrent(ctypes.byref(ctx)) == 0 and ctx.value:
        return
    dev = ctypes.c_int()
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = lib.cuDeviceGet(ctypes.byref(dev), index)
    if err == 0:
        err = lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev.value)
    if err == 0:
        err = lib.cuCtxSetCurrent(ctx)
    if err != 0:
        raise RuntimeError(f"making the primary context current failed with CUresult {err}")


def _copy_page_leaf(leaf: torch.Tensor, page: int, block: torch.Tensor, to_host: bool) -> None:
    """One page of one pool leaf on the card (``leaf[:, page]``: ``L`` rows
    of one contiguous layer block each, ``P + 1`` blocks apart) to or from
    the contiguous host ``block`` as ONE 2-D copy on the current stream:
    the copy engine's DMA, no device temporaries and no kernel. A pinned
    block makes it asynchronous; a pageable one the CUDA driver stages."""
    if not 0 <= page < leaf.shape[1] or block.dtype != leaf.dtype or not block.is_contiguous() \
            or block.numel() * leaf.shape[1] != leaf.numel():
        raise ValueError(f"page {page}, block {tuple(block.shape)} {block.dtype}: does not "
                         f"match the pool leaf {tuple(leaf.shape)} {leaf.dtype}")
    elt = leaf.element_size()
    width = leaf[0, 0].numel() * elt
    dev_ptr = leaf.data_ptr() + page * leaf.stride(1) * elt
    m = _Memcpy2D(WidthInBytes=width, Height=leaf.shape[0])
    if to_host:
        m.srcMemoryType, m.srcDevice, m.srcPitch = _MEM_DEVICE, dev_ptr, leaf.stride(0) * elt
        m.dstMemoryType, m.dstHost, m.dstPitch = _MEM_HOST, block.data_ptr(), width
    else:
        m.srcMemoryType, m.srcHost, m.srcPitch = _MEM_HOST, block.data_ptr(), width
        m.dstMemoryType, m.dstDevice, m.dstPitch = _MEM_DEVICE, dev_ptr, leaf.stride(0) * elt
    lib = _libcuda()
    _make_context_current(lib, leaf.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(leaf.device).cuda_stream)
    err = lib.cuMemcpy2DAsync_v2(ctypes.byref(m), stream)
    if err != 0:
        raise RuntimeError(f"cuMemcpy2DAsync failed with CUresult {err}")


def page_read(pool: Any, page: int, out: list, non_blocking: bool = False) -> None:
    """Copy physical page ``page`` (every layer and kv head) of every leaf
    into ``out`` — one contiguous ``[L, Hkv, ps(, D)]`` block a leaf,
    ``pool_leaves`` order: a host arena slot's blocks. The spill's
    device-to-host copy (the JAX engine's ``_page_snapshot`` and its
    fetch), on the current stream; ``non_blocking`` with pinned ``out``.
    The pool is only read."""
    leaves = pool_leaves(pool)
    for leaf, dst in zip(leaves, out):
        if leaf.is_cuda and not dst.is_cuda:
            _copy_page_leaf(leaf, int(page), dst, to_host=True)
        else:
            dst.copy_(leaf[:, page], non_blocking=non_blocking)
    if not non_blocking and leaves[0].is_cuda:
        torch.cuda.current_stream(leaves[0].device).synchronize()


def page_write(pool: Any, page: int, blocks: list, non_blocking: bool = False) -> Any:
    """Write one page's leaf blocks (``pool_leaves`` order, ``[L, Hkv,
    ps(, D)]`` each, on the host or the device) into physical page ``page``
    of every leaf, IN PLACE — the restore (the JAX engine's
    ``_page_restore``), on the current stream; ``non_blocking`` from pinned
    blocks. The pool is never rebound: captured decode and verify graphs
    hold its addresses. A real page only: the sink page is never restored
    into."""
    leaves = pool_leaves(pool)
    sink = leaves[0].shape[1] - 1
    if not 0 <= int(page) < sink:
        raise ValueError(f"page_write into page {page}: real pages are 0..{sink - 1}")
    for leaf, src in zip(leaves, blocks):
        if leaf.is_cuda and not src.is_cuda:
            _copy_page_leaf(leaf, int(page), src, to_host=False)
        else:
            leaf[:, int(page)].copy_(src, non_blocking=non_blocking)
    if not non_blocking and leaves[0].is_cuda:
        torch.cuda.current_stream(leaves[0].device).synchronize()
    return pool


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
        leaves = pool_leaves(self.dev)
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
        # page → the fence of a spill copy that may still read it (an object
        # with ``wait()``): waited on when the allocator hands the page out
        self._fences: dict[int, Any] = {}

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

    def fence(self, pages, fence: Any) -> None:
        """Mark ``pages`` as read by an asynchronous copy whose completion
        ``fence.wait()`` orders the caller's stream after: once such a page
        is freed, every writer waits on the fence (``wait_fences``) before
        it writes the page."""
        for p in pages:
            self._fences[int(p)] = fence

    def wait_fences(self, pages) -> None:
        """Order the caller's stream after every copy that may still read
        ``pages`` (each distinct fence's ``wait()`` once) and forget their
        fences: what every writer of a freed page runs first — the
        allocator before a page's next holder writes it, and the zeroing of
        a quarantine's freed pages."""
        waited = set()
        for p in pages:
            fence = self._fences.pop(int(p), None)
            if fence is not None and id(fence) not in waited:
                waited.add(id(fence))
                fence.wait()

    def _alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.wait_fences(pages)
        return pages

    def alloc_pages(self, n: int) -> Optional[list[int]]:
        """Allocate ``n`` pages with refcount 1 held by the caller (the
        restore path: the prefix index adopts them through
        ``attach_device_pages``, as ``insert`` holds one reference). None —
        nothing allocated — when the free list cannot cover it."""
        return self._alloc(n)

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
        self._fences.clear()


# -- host-RAM page tier (spill / hibernation arena) ---------------------------


def _pinned_bytes(nbytes: int) -> tuple[torch.Tensor, Optional[Callable[[], Any]]]:
    """``nbytes`` of page-locked host memory as a uint8 tensor, and the call
    that unlocks it (None when nothing needs it): plain host memory
    registered with the CUDA driver (``cudaHostRegister``: exactly the
    bytes asked for), or the caching host allocator's pinned block when
    registering is refused."""
    buf = torch.empty(nbytes, dtype=torch.uint8)
    cudart = torch.cuda.cudart()
    ok = getattr(getattr(cudart, "cudaError", None), "success", 0)
    if nbytes and cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0) == ok:
        ptr = buf.data_ptr()
        return buf, lambda: cudart.cudaHostUnregister(ptr)
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True), None


class HostPageTier:
    """Host-RAM page arena mirroring the device pool's leaves: one tensor a
    pool leaf, slot-major ``[num_pages, L, Hkv, ps(, D)]`` (no sink slot —
    only real pages spill). Pinned when the pool is on the card, so the
    spill's device-to-host copies and the restore's uploads are
    asynchronous. int8 pools spill int8 + scales, as the device side.

    Thread contract: the free list and alloc / free are engine-thread-only;
    ``stamp`` (and ``write``) run on the spill worker, only ever against
    slots the engine allocated to an in-flight spill and will not read or
    reuse until the worker's handle drains; the checksum map takes a small
    lock because the engine reads what the worker stamped."""

    _GUARDED = {"_sum_lock": ("_sums",)}

    def __init__(self, dev_pool: Any, num_pages: int, pin: Optional[bool] = None) -> None:
        if num_pages < 1:
            raise ValueError("host page tier needs >= 1 page")
        self.num_pages = int(num_pages)
        leaves = pool_leaves(dev_pool)
        if pin is None:
            pin = leaves[0].device.type == "cuda"
        shapes = [(self.num_pages, leaf.shape[0]) + tuple(leaf.shape[2:]) for leaf in leaves]
        sizes = [math.prod(shape) * leaf.element_size() for shape, leaf in zip(shapes, leaves)]
        # each leaf starts 256-byte aligned in the one buffer
        starts = [0]
        for size in sizes[:-1]:
            starts.append(starts[-1] + -(-size // 256) * 256)
        total = starts[-1] + sizes[-1]
        t0 = time.perf_counter()
        unlock = None
        if pin:
            buf, unlock = _pinned_bytes(total)
        else:
            buf = torch.zeros(total, dtype=torch.uint8)
        # the buffer lives as long as the arena; registered memory is
        # unlocked when the arena goes (its views go with it)
        self._buf = buf
        if unlock is not None:
            weakref.finalize(self, unlock)
        # the seconds the arena took to allocate (and page-lock)
        self.alloc_s = time.perf_counter() - t0
        self.pinned = bool(pin)
        self._arrays = [
            buf[off:off + size].view(leaf.dtype).view(shape)
            for off, size, shape, leaf in zip(starts, sizes, shapes, leaves)
        ]
        # numpy views over the same bytes (bf16 as int16): hashing and the
        # byte images read these, never a copy
        self._np = [np_view(a) for a in self._arrays]
        self.bytes_per_page = sum(size // self.num_pages for size in sizes)
        self.bytes_total = self.bytes_per_page * self.num_pages
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._sums: dict[int, bytes] = {}
        self._sum_lock = threading.Lock()

    # -- allocator (engine thread) -------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def slots_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, slots) -> None:
        for s in slots:
            self._free.append(int(s))
        with self._sum_lock:
            for s in slots:
                self._sums.pop(int(s), None)

    # -- page data ------------------------------------------------------------

    def blocks(self, slot: int) -> list[torch.Tensor]:
        """Arena slot ``slot``'s leaf blocks (views, ``pool_leaves`` order):
        the destination of a spill's copies."""
        return [a[slot] for a in self._arrays]

    def stamp(self, slot: int) -> bytes:
        """Hash slot ``slot``'s bytes as they lie in the arena and stamp the
        digest (spill worker, once the slot's copies landed)."""
        d = page_checksum([a[slot] for a in self._np])
        with self._sum_lock:
            self._sums[slot] = d
        return d

    def stamp_slots(self, slots) -> None:
        """``stamp`` of every slot of one spill, the slots hashed in
        parallel (``page_checksums``)."""
        slots = [int(s) for s in slots]
        sums = page_checksums([[a[s] for a in self._np] for s in slots])
        with self._sum_lock:
            self._sums.update(zip(slots, sums))

    def write(self, slot: int, blocks: list) -> None:
        """Store one page's leaf blocks (``[L, Hkv, ps(, D)]`` each, in
        ``pool_leaves`` order; numpy or torch) into slot ``slot`` and stamp
        its checksum."""
        for a, b in zip(self._arrays, blocks):
            a[slot].copy_(b if isinstance(b, torch.Tensor) else host_block(b, a.dtype))
        self.stamp(slot)

    def read(self, slot: int) -> Optional[list[torch.Tensor]]:
        """Slot ``slot``'s leaf blocks (the restore's upload source: views
        of the arena, pinned on the card), or None when the stamped checksum
        no longer matches the bytes or nothing was stamped — a corrupted
        host page must degrade to a re-prefill, never to wrong KV. The
        bytes hashed are the bytes returned (no copy)."""
        with self._sum_lock:
            want = self._sums.get(slot)
        if want is None:
            return None
        if page_checksum([a[slot] for a in self._np]) != want:
            return None
        return [a[slot] for a in self._arrays]

    def read_slots(self, slots) -> Optional[list[list[torch.Tensor]]]:
        """``read`` of every slot of one restore, the slots hashed in
        parallel (``page_checksums``): each slot's blocks, or None when any
        slot fails its stamp (or holds none)."""
        slots = [int(s) for s in slots]
        with self._sum_lock:
            want = [self._sums.get(s) for s in slots]
        if any(w is None for w in want):
            return None
        got = page_checksums([[a[s] for a in self._np] for s in slots])
        if got != want:
            return None
        return [[a[s] for a in self._arrays] for s in slots]

    def checksum(self, slot: int) -> Optional[bytes]:
        """The digest stamped at spill time for slot ``slot`` (None when the
        slot holds no completed spill)."""
        with self._sum_lock:
            return self._sums.get(slot)

    def page_bytes(self, slot: int) -> bytes:
        """Slot ``slot``'s byte image (``join_page_bytes`` of its blocks)."""
        return b"".join(a[slot].tobytes() for a in self._np)

    def corrupt(self, slot: int) -> None:
        """Flip one byte of the slot's first leaf — the ``spill`` fault
        site's host-RAM-rot drill; ``read`` must catch it."""
        self._np[0][slot].reshape(-1).view(np.uint8)[0] ^= 0xFF

    def reset(self) -> None:
        """Crash recovery: every arena slot is forgotten (the entries that
        referenced them are gone with the index reset)."""
        self._free = list(range(self.num_pages - 1, -1, -1))
        with self._sum_lock:
            self._sums.clear()


def host_block(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A numpy block (``split_page_bytes``' output) as a host tensor of
    ``dtype``: 16-bit patterns back to bf16 / f16, a copy the caller owns."""
    t = torch.from_numpy(np.array(a))
    if dtype in (torch.bfloat16, torch.float16) and t.dtype == torch.int16:
        return t.view(dtype)
    return t.to(dtype)


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
    page_size). ``pins`` guards an admission reading the entry.

    The host tier: ``host`` holds the entry's arena slots once a spill
    completed (one per device page, same order). The tier is derived —
    device pages only = ``device``, both = ``both``, arena only (the device
    half demoted) = ``host``; a host-tier entry stays in the trie with
    ``pages == ()`` so a radix hit restores it instead of missing.
    ``spilling`` carries the in-flight spill handle; ``dropped`` lets the
    spill's drain see an entry evicted while its copy ran."""

    pages: tuple[int, ...]
    length: int
    pins: int = 0
    last_used: int = 0
    node: Any = field(default=None, repr=False)
    digest: str = ""  # prefix_digest(tokens[:length])
    host: tuple[int, ...] = ()
    spilling: Any = field(default=None, repr=False)
    dropped: bool = False
    # wall clock of the publish or the last hit: the spill-idle-s gate
    last_used_t: float = 0.0

    @property
    def tier(self) -> str:
        if self.pages:
            return "both" if self.host else "device"
        return "host"


class PrefixPageIndex:
    """Radix-indexed prefix → pages map. Aliasing keeps reuse exact: prefix
    KV is a pure function of the prefix tokens, and a page fully covered by
    a published prefix is never written again by its publisher (positions
    only grow), so an aliased page always equals what a fresh prefill would
    have written. The last, partial page is still written by the publisher
    (its own later tokens), so a reader copies that one page and overwrites
    its tail with its own suffix; the columns below the published length
    are stable by the same argument."""

    # the advertisement map is the one surface read off the engine thread
    _GUARDED = {"_ad_lock": ("_ads",)}

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
        # live entries holding device pages: the entry cap's denominator and
        # the device victims' universe (hibernated entries hold arena slots
        # only, and the arena's free list is their ceiling)
        self._dev_live: list[PrefixPages] = []
        self._tick = 0
        # digest → [length, recency tick, tier] of every live entry: what a
        # replica advertises (``advertised``), read from other threads
        self._ads: dict[str, list] = {}
        self._ad_lock = threading.Lock()
        # the host tier (set by the engine when spill is on): ``_drop`` frees
        # an entry's arena slots through it, so no path leaks host pages
        self.host_tier: Optional[HostPageTier] = None
        # cumulative since the engine started (a reset keeps them)
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.evictions = 0
        self.copy_bytes_saved = 0
        # the tier: demotions = device half dropped for the host copy (the
        # entry stays restorable); host_evictions = a host copy freed to
        # make arena room (a host-only victim is gone for good)
        self.demotions = 0
        self.host_evictions = 0

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
            used.last_used_t = time.monotonic()
            if used.digest:
                with self._ad_lock:
                    ad = self._ads.get(used.digest)
                    if ad is not None:
                        ad[1] = self._tick

    def match_len(self, tokens) -> int:
        """The longest cached prefix length usable for ``tokens``, or 0 —
        a probe that touches neither recency nor the hit counters."""
        cands = self.candidates(tokens)
        return cands[-1][0] if cands else 0

    def deepest_entry(self, tokens) -> Optional[tuple[int, PrefixPages]]:
        """The deepest live entry usable for ``tokens`` that holds pages on
        the device or the host, as ``(length, entry)``, or None: what a
        migration exports. A probe, like ``match_len``: it touches neither
        recency nor the counters."""
        for p, entry in reversed(self.candidates(tokens)):
            if not entry.dropped and (entry.pages or entry.host):
                return p, entry
        return None

    @staticmethod
    def entry_tokens(entry: PrefixPages) -> list[int]:
        """The token prefix behind ``entry``, rebuilt from its trie node's
        edges (an entry stores only its digest): what a durable checkpoint
        carries so any replica can key the restored prefix."""
        node = entry.node
        parts: list[tuple] = []
        while node is not None and node.edge:
            parts.append(node.edge)
            node = node.parent
        out: list[int] = []
        for seg in reversed(parts):
            out.extend(int(t) for t in seg)
        return out

    def advertised(self, top_k: int = 32) -> list[tuple[str, int, str]]:
        """The ``top_k`` most recently used prefixes as ``(digest, length,
        tier)``, tier ``device`` | ``both`` | ``host``. Thread-safe."""
        with self._ad_lock:
            items = sorted(self._ads.items(), key=lambda kv: kv[1][1], reverse=True)[
                : max(0, top_k)
            ]
        return [(digest, ad[0], ad[2]) for digest, ad in items]

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
        device copy. Over the entry cap the LRU unpinned device-holding
        entry makes room (demoted when its host copy is secured), or the
        publish is skipped (it never blocks). The cap bounds the
        device-resident entries only: a hibernated entry holds arena slots,
        whose free list is its ceiling."""
        assert length in self.boundaries, (length, self.boundaries)
        if len(self._dev_live) >= self.max_entries and not self.evict_device_lru(pool):
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
        entry.last_used_t = time.monotonic()
        self._live.append(entry)
        if entry.pages:
            self._dev_live.append(entry)
        for p in entry.pages:
            self._page_holds[p] = self._page_holds.get(p, 0) + 1
        with self._ad_lock:
            self._ads[entry.digest] = [entry.length, entry.last_used, "device"]
        return entry

    def _note_tier(self, entry: PrefixPages) -> None:
        """Refresh the entry's advertised tier (a spill landed, a demotion,
        a restore)."""
        if entry.digest:
            with self._ad_lock:
                ad = self._ads.get(entry.digest)
                if ad is not None:
                    ad[2] = entry.tier

    def _unhold(self, pages) -> None:
        for p in pages:
            left = self._page_holds.get(p, 0) - 1
            if left > 0:
                self._page_holds[p] = left
            else:
                self._page_holds.pop(p, None)

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
        if entry.pages:
            self._dev_live.remove(entry)
        self._unhold(entry.pages)
        if entry.digest:
            with self._ad_lock:
                self._ads.pop(entry.digest, None)
        entry.dropped = True
        if entry.spilling is not None:
            # copy in flight: the worker owns the arena slots until its
            # handle drains, and the engine frees them there (freeing now
            # would let a new spill write the same slots concurrently)
            entry.spilling.cancelled = True
            entry.spilling = None
        elif entry.host and self.host_tier is not None:
            self.host_tier.free(entry.host)
        entry.host = ()
        pool.decref(entry.pages)
        # an evicted entry holds no pages: a caller still holding it (a
        # candidate list already taken) reads it as gone, and can never
        # alias pages the free list handed out again
        entry.pages = ()

    def evict_lru(self, pool: PagePool) -> bool:
        """Drop the least-recently-used unpinned entry (any tier). False
        when every entry is pinned by an admission reading it (or there is
        none)."""
        victims = [e for e in self._live if e.pins == 0]
        if not victims:
            return False
        self._drop(pool, min(victims, key=lambda e: e.last_used))
        self.evictions += 1
        return True

    def release_device_pages(self, pool: PagePool, entry: PrefixPages) -> list[int]:
        """Demote: drop the entry's device half only, keeping its trie node,
        advertisement and host copy — it hibernates as ``host`` tier and a
        later radix hit restores it. Returns the pages whose refcount hit
        zero."""
        pages = entry.pages
        entry.pages = ()
        if pages:
            self._dev_live.remove(entry)
        self._unhold(pages)
        self._note_tier(entry)
        return pool.decref(pages)

    def attach_device_pages(self, pool: PagePool, entry: PrefixPages, pages) -> None:
        """Restore: adopt freshly allocated (refcount-1) pages as the
        entry's device half — the inverse of ``release_device_pages``; the
        index now holds the one reference, as after ``insert``. The restore
        counts as a use: without the recency bump a restored entry whose
        admission then defers would sit at the LRU minimum and be demoted
        again by the next bind's eviction."""
        assert not entry.pages and not entry.dropped
        entry.pages = tuple(int(p) for p in pages)
        self._dev_live.append(entry)
        for p in entry.pages:
            self._page_holds[p] = self._page_holds.get(p, 0) + 1
        self._tick += 1
        entry.last_used = self._tick
        entry.last_used_t = time.monotonic()
        self._note_tier(entry)

    def evict_device_lru(
        self, pool: PagePool, spill_cb: Optional[Callable[[PrefixPages], bool]] = None
    ) -> bool:
        """Free device pages by victimizing the LRU unpinned entry that
        holds any: when its host copy is secured (spilled, a spill in
        flight, or ``spill_cb(entry)`` enqueued one now) the entry DEMOTES —
        device half dropped, prefix still restorable — else it is dropped.
        False when nothing holding device pages is evictable."""
        victims = [e for e in self._dev_live if e.pins == 0]
        if not victims:
            return False
        victim = min(victims, key=lambda e: e.last_used)
        # a victim whose host copy exists (or is in flight) is always
        # demoted, spill_cb or not: the arena already paid for it
        secured = bool(victim.host) or victim.spilling is not None
        if secured or (spill_cb is not None and spill_cb(victim)):
            self.release_device_pages(pool, victim)
            self.demotions += 1
        else:
            self._drop(pool, victim)
            self.evictions += 1
        return True

    def evict_for(
        self, pool: PagePool, need_pages: int,
        spill_cb: Optional[Callable[[PrefixPages], bool]] = None,
    ) -> bool:
        """Demote or evict LRU entries until ``need_pages`` pages are free
        (or nothing evictable remains). Eviction helps only when it drops a
        page's last reference, so progress is checked after every victim.
        With ``spill_cb`` (the host tier) victims demote to their host copy
        before anything is dropped: the pool becomes a cache over host
        RAM."""
        while pool.free_pages < need_pages:
            if not self.evict_device_lru(pool, spill_cb):
                return False
        return True

    def evict_touching(self, pool: PagePool, pages) -> int:
        """Evict every entry that references any of ``pages`` — the
        quarantine path: a poisoned slot's published prefixes must not
        outlive it."""
        touched = set(pages)
        victims = [e for e in self._dev_live if touched.intersection(e.pages)]
        for e in victims:
            self._drop(pool, e)
            self.evictions += 1
        return len(victims)

    def reset(self) -> None:
        """Crash recovery: the pool was rebuilt, so its page references are
        gone with it and the entries just vanish; counters are cumulative.
        Host copies vanish with their entries (the engine resets the arena
        right after, its spill worker stopped first), and marking the
        entries dropped makes any straggler spill handle discard."""
        for e in self._live:
            e.dropped = True
            if e.spilling is not None:
                e.spilling.cancelled = True
                e.spilling = None
            e.host = ()
        self._root = _Node()
        self._live = []
        self._page_holds = {}
        self._dev_live = []
        with self._ad_lock:
            self._ads = {}
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
