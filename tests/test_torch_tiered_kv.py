"""The host KV tier of the port against the JAX package, on the CPU
(tiny-test, f32; int8 KV runs the reference attention on both sides).

- Byte identity: for the same page values, the port's ``page_checksum``
  and ``join_page_bytes`` (bf16 as 16-bit patterns, int8 with its scales)
  and its arena's stamps and slot images equal the JAX package's.
- The host half: ``HostPageTier`` and the index's tier side
  (``release_device_pages`` / ``attach_device_pages``, demote-before-drop
  eviction, the entry cap over device-resident entries, a drop mid-spill)
  take the same operations as the JAX ones and agree after each.
- The engine: a session published, spilled, demoted by another session's
  admission and restored on its next turn gives the JAX tiered engine's
  tokens and restore stats (f32 plain, int8 KV with speculation); a
  constrained slot restores as it prefilled; the ``spill`` fault site
  degrades to a cold prefill with the right tokens; churn leaves both free
  lists full; the internal rules (the failed-spill zombie, the sweep's
  rotation, once-per-request gauges, a dropped candidate, the wedged
  worker, a restart) hold as in JAX's tests.
- The memory plan's host term and the provider's tier keys.
"""

import dataclasses
import functools
import logging
import math
import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.models.transformer import make_page_pool as jax_make_page_pool
from langstream_tpu.serving import pagepool as jpp
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.memory import plan_serving_memory as jax_plan
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving import pagepool as tpp
from langstream_tpu_torch.serving.engine import (
    GenerationRequest,
    ServingEngine,
    _Spill,
    _SpillWorker,
)
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.memory import plan_serving_memory
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

WAIT = 120.0
V = MODEL_PRESETS["tiny-test"].vocab_size
GREEDY = dict(max_new_tokens=10, temperature=0.0)
# two 45-token sessions over a 16/32/64 ladder at page 16: each publishes a
# 32-token (2-page) prefix, and 5 pages cannot hold both sessions, so B's
# admission demotes A's hibernated prefix — the churn the tier exists for
PROMPT_A = [(7 + 3 * i) % V for i in range(45)]
PROMPT_B = [(5 + 11 * i) % V for i in range(45)]
# the restore stats, with the JAX engine's meaning
RESTORE_KEYS = (
    "restored-hits-total", "restore-pages-total", "restore-failures-total",
    "recompute-fallbacks-total", "restore-bytes-total",
)


@functools.lru_cache(maxsize=None)
def configs(kv: str = "model"):
    """(JAX, port) tiny-test configs in f32; int8 KV on the reference
    attention on both sides."""
    fields = dict(dtype="float32", kv_cache_dtype=kv)
    if kv == "int8":
        fields["attention_impl"] = "jnp"
    return (
        dataclasses.replace(JAX_PRESETS["tiny-test"], **fields),
        dataclasses.replace(MODEL_PRESETS["tiny-test"], **fields),
    )


@functools.lru_cache(maxsize=None)
def weights():
    jp = jax_init_params(configs()[0], jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), configs()[1], device="cpu")


def engine_kw(tier: bool = True, **kw) -> dict:
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("page_size", 16)
    if tier:
        kw.setdefault("kv_pages", 5)
        kw.setdefault("host_kv_fraction", 2.0)
        kw.setdefault("spill_idle_s", 0.0)  # hibernate as soon as idle
        kw.setdefault("prefix_cache", "auto")
        kw.setdefault("prefix_cache_entries", 8)
    else:
        kw.setdefault("prefix_cache", "off")
        kw.setdefault("host_kv_fraction", 0.0)
    return kw


def port_engine(kv: str = "model", tier: bool = True, start: bool = True, **kw):
    engine = ServingEngine(configs(kv)[1], weights()[1], device="cpu", **engine_kw(tier, **kw))
    if start:
        engine.start()
    return engine


def wait_spilled(engine, pages: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if engine.stats()["spill-pages-total"] >= pages:
            return
        time.sleep(0.01)
    got = engine.stats()["spill-pages-total"]
    raise AssertionError(f"spill never reached {pages} pages: {got}")


def session_turns(engine, jax_side: bool) -> tuple[list, dict]:
    """A's turn, A hibernates, B's turn (demotes A), A's next turn."""
    opts = (JaxOptions if jax_side else GenerationOptions)(**GREEDY)
    a1 = engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens
    wait_spilled(engine, 2)
    b1 = engine.generate(list(PROMPT_B), opts, timeout=WAIT).tokens
    tiers = {e.tier for e in engine._prefix_index._live}
    demoted = engine.stats()["host-demotions-total"]
    a2 = engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens
    stats = engine.stats()
    return [a1, b1, a2], {**{k: stats[k] for k in RESTORE_KEYS}, "tiers": tiers,
                          "demoted": demoted}


@functools.lru_cache(maxsize=None)
def jax_turns(kv: str, spec: bool):
    """The JAX tiered engine's tokens and restore stats (one run each)."""
    engine = JaxEngine(
        configs(kv)[0], weights()[0], kv_layout="paged",
        speculation="auto" if spec else "off", speculation_tokens=3, **engine_kw(),
    )
    engine.start()
    try:
        return session_turns(engine, jax_side=True)
    finally:
        engine.stop()


def assert_leak_free(engine) -> None:
    """Dropping every surviving entry returns both free lists — device
    pages and arena slots — to full."""
    pool, index, tier = engine._pagepool, engine._prefix_index, engine._host_tier
    engine._drain_spills()
    for entry in list(index._live):
        index._drop(pool, entry)
    assert pool.free_pages == pool.num_pages, f"{pool.num_pages - pool.free_pages} pages leaked"
    if tier is not None:
        assert tier.free_slots == tier.num_pages, f"{tier.num_pages - tier.free_slots} slots leaked"


# -- byte identity ---------------------------------------------------------------


def _page_values(cfg, seed: int):
    """One page's leaf values ([L, Hkv, ps, D] and int8 scales [L, Hkv,
    ps]) as numpy, in JAX leaf order."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.n_kv_heads, 16, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        q = lambda: rng.integers(-127, 128, shape, dtype=np.int8)  # noqa: E731
        s = lambda: rng.random(shape[:-1], dtype=np.float32)  # noqa: E731
        return [q(), s(), q(), s()]
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_page_checksum_and_bytes_equal_jax(kv):
    """bf16 leaves as their 16-bit patterns, int8 leaves with their f32
    scales: the port's checksum and byte image of a page equal JAX's, and
    ``split_page_bytes`` inverts the image against the pool's specs."""
    jcfg, tcfg = configs("int8" if kv == "int8" else "model")
    if kv == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    vals = _page_values(tcfg, seed=3)
    if kv == "bf16":
        jax_blocks = [np.asarray(jax.numpy.asarray(v, jax.numpy.bfloat16)) for v in vals]
        port_blocks = [torch.from_numpy(v).to(torch.bfloat16) for v in vals]
    else:
        jax_blocks = vals
        port_blocks = [torch.from_numpy(v) for v in vals]
    assert tpp.page_checksum(port_blocks) == jpp.page_checksum(jax_blocks)
    raw = tpp.join_page_bytes(port_blocks)
    assert raw == jpp.join_page_bytes(jax_blocks)
    # the arenas: the same page written into the same slot of each stamps
    # the same digest and holds the same image
    pool = tpp.PagePool(tcfg, num_pages=4, page_size=16, max_batch=2, max_seq_len=64,
                        device="cpu")
    jpool = jax_make_page_pool(jcfg, 4, 16)
    tier, jtier = tpp.HostPageTier(pool.dev, 3), jpp.HostPageTier(jpool, 3)
    assert tier.bytes_per_page == jtier.bytes_per_page == pool.bytes_per_page
    tier.write(1, port_blocks)
    jtier.write(1, jax_blocks)
    assert tier.checksum(1) == jtier.checksum(1)
    assert tier.page_bytes(1) == jpp.join_page_bytes(jax.tree.leaves(jtier.read(1)))
    back = tpp.split_page_bytes(raw, tpp.page_leaf_specs(pool.dev))
    assert tpp.page_checksum(back) == tier.checksum(1)
    with pytest.raises(ValueError, match="truncated"):
        tpp.split_page_bytes(raw[:-1], tpp.page_leaf_specs(pool.dev))


# -- the host half, operation by operation ---------------------------------------


def _pools(num_pages: int = 6):
    jcfg, tcfg = configs()
    return (
        jpp.PagePool(jcfg, num_pages=num_pages, page_size=16, max_batch=2, max_seq_len=64),
        tpp.PagePool(tcfg, num_pages=num_pages, page_size=16, max_batch=2, max_seq_len=64,
                     device="cpu"),
    )


def _index_state(index, pool, tier) -> dict:
    return {
        "live": sorted((e.length, e.tier, e.pages, e.host, e.dropped) for e in index._live),
        "dev_live": sorted(e.pages for e in index._dev_live),
        "free_pages": pool.free_pages,
        "free_slots": tier.free_slots if tier is not None else None,
        "demotions": index.demotions,
        "evictions": index.evictions,
        "ads": sorted((length, t) for _, length, t in index.advertised(16)),
    }


def test_host_tier_write_read_checksum_roundtrip():
    _, pool = _pools()
    tier = tpp.HostPageTier(pool.dev, 3)
    assert tier.free_slots == 3 and tier.slots_in_use == 0 and not tier.pinned
    assert tier.bytes_total == 3 * tier.bytes_per_page == 3 * pool.bytes_per_page
    slots = tier.alloc(2)
    assert len(slots) == 2 and tier.free_slots == 1
    assert tier.alloc(2) is None, "over-allocation must fail, not wrap"
    blocks = [torch.from_numpy(v) for v in _page_values(configs()[1], seed=0)]
    tier.write(slots[0], blocks)
    got = tier.read(slots[0])
    assert got is not None
    for want, back in zip(blocks, got):
        assert torch.equal(want, back)
    assert tier.read(slots[1]) is None, "a slot never stamped is unreadable"
    tier.corrupt(slots[0])
    assert tier.read(slots[0]) is None, "a corrupted page served as valid"
    tier.free(slots)
    assert tier.free_slots == 3
    assert tier.read(tier.alloc(1)[0]) is None, "a recycled slot serves no stale stamp"
    tier.reset()
    assert tier.free_slots == 3


def test_host_tier_parallel_stamp_and_read_match_one_by_one():
    """``stamp_slots`` / ``read_slots`` (the slots hashed in parallel) give
    ``stamp`` / ``read``'s digests and blocks, and one corrupted or
    unstamped slot fails the whole batch."""
    _, pool = _pools()
    tier = tpp.HostPageTier(pool.dev, 4)
    slots = tier.alloc(3)
    for i, slot in enumerate(slots):
        for a, b in zip(tier.blocks(slot), _page_values(configs()[1], seed=i)):
            a.copy_(torch.from_numpy(b))
    tier.stamp_slots(slots)
    sums = [tier.checksum(s) for s in slots]
    assert sums == [tier.stamp(s) for s in slots] and len(set(sums)) == 3
    assert tpp.page_checksums([tier.blocks(s) for s in slots]) == sums
    got = tier.read_slots(slots)
    assert got is not None and len(got) == 3
    for slot, blocks in zip(slots, got):
        assert all(torch.equal(a, b) for a, b in zip(blocks, tier.read(slot)))
    assert tier.read_slots(slots + tier.alloc(1)) is None, "an unstamped slot passed"
    tier.corrupt(slots[2])
    assert tier.read_slots(slots) is None, "a corrupted slot passed the batch"
    assert tier.read_slots(slots[:2]) is not None


def test_page_dma_refuses_bad_page_or_block():
    """The card's page copy checks its page index and host block before
    the driver sees a pointer: out of range, a wrong dtype or size, or a
    strided block raise."""
    _, pool = _pools()
    leaf = tpp.pool_leaves(pool.dev)[0]
    block = torch.empty((leaf.shape[0],) + tuple(leaf.shape[2:]), dtype=leaf.dtype)
    for page, bad in ((leaf.shape[1], block), (-1, block), (0, block.to(torch.float64)),
                      (0, block[:, :1]), (0, block.transpose(0, 1))):
        with pytest.raises(ValueError, match="does not match"):
            tpp._copy_page_leaf(leaf, page, bad, to_host=True)


def test_index_demote_restore_semantics():
    """release / attach are exact inverses, the tier tracks them, and
    ``evict_device_lru`` demotes a victim whose host copy is secured and
    drops one whose copy cannot be — the same state as JAX's after every
    operation."""
    states = []
    for lib, pool in zip((jpp, tpp), _pools()):
        index = lib.PrefixPageIndex((16, 32, 64), max_entries=4)
        tier = lib.HostPageTier(pool.dev, 4)
        index.host_tier = tier
        tok = [3 + i % 40 for i in range(40)]
        log = []
        owned = pool._alloc(2)
        entry = index.insert(pool, tok, 32, tuple(owned))
        pool.decref(owned)
        log.append(_index_state(index, pool, tier))
        entry.host = tuple(tier.alloc(2))  # a completed spill
        index._note_tier(entry)
        log.append(_index_state(index, pool, tier))
        freed = index.release_device_pages(pool, entry)
        log.append((sorted(freed), _index_state(index, pool, tier)))
        log.append([(n, e.length) for n, e in index.candidates(tok + [1])])
        index.attach_device_pages(pool, entry, pool.alloc_pages(2))
        log.append(_index_state(index, pool, tier))
        log.append(index.evict_device_lru(pool, spill_cb=lambda e: bool(e.host)))
        log.append(_index_state(index, pool, tier))
        log.append(index.evict_device_lru(pool, spill_cb=lambda e: False))
        index._drop(pool, entry)
        log.append(_index_state(index, pool, tier))
        states.append(log)
    assert states[0] == states[1]
    assert states[1][2][1]["live"][0][1] == "host"
    assert states[1][-1]["free_slots"] == 4 and states[1][-1]["free_pages"] == 6


def test_drop_mid_spill_defers_slot_free_to_drain():
    """An entry dropped while its copy is in flight does not free its arena
    slots (the worker still owns them): the handle is cancelled and the
    engine's drain frees them."""
    _, pool = _pools()
    index = tpp.PrefixPageIndex((16, 32), max_entries=2)
    tier = tpp.HostPageTier(pool.dev, 2)
    index.host_tier = tier

    class _Handle:
        cancelled = False

    tok = [5 + i % 30 for i in range(34)]
    entry = index.insert(pool, tok, 32, tuple(pool._alloc(2)))
    slots = tier.alloc(2)
    handle = entry.spilling = _Handle()
    index._drop(pool, entry)
    assert handle.cancelled and entry.dropped
    assert tier.free_slots == 0, "slots freed while the worker owned them"
    tier.free(slots)
    assert tier.free_slots == 2


@pytest.mark.parametrize("case", ["hibernated-survive-cap", "spilled-victim-demotes"])
def test_cap_eviction_never_drops_a_hibernated_session(case):
    """The entry cap bounds device-resident entries only: a publish over it
    victimizes the device LRU (demoting it when its host copy exists) and
    never drops a hibernated session — the same state as JAX's."""
    states = []
    for lib, pool in zip((jpp, tpp), _pools()):
        if case == "hibernated-survive-cap":
            index = lib.PrefixPageIndex((16, 32), max_entries=2)
            tier = lib.HostPageTier(pool.dev, 4)
            index.host_tier = tier
            for i in range(2):
                owned = pool._alloc(2)
                entry = index.insert(pool, [i + 1 + j % 20 for j in range(34)], 32, tuple(owned))
                pool.decref(owned)
                entry.host = tuple(tier.alloc(2))
                index.release_device_pages(pool, entry)
            for i in range(3):  # one past the cap
                owned = pool._alloc(2)
                entry = index.insert(pool, [50 + i + j % 20 for j in range(34)], 32, tuple(owned))
                assert entry is not None, "publish blocked by hibernated entries"
                pool.decref(owned)
        else:
            index = lib.PrefixPageIndex((16, 32), max_entries=1)
            tier = lib.HostPageTier(pool.dev, 2)
            index.host_tier = tier
            owned = pool._alloc(2)
            spilled = index.insert(pool, [1 + j % 20 for j in range(34)], 32, tuple(owned))
            pool.decref(owned)
            spilled.host = tuple(tier.alloc(2))
            owned = pool._alloc(2)
            assert index.insert(pool, [77 + j % 20 for j in range(34)], 32, tuple(owned))
            pool.decref(owned)
        states.append(_index_state(index, pool, tier))
        assert sorted(map(id, index._dev_live)) == sorted(id(e) for e in index._live if e.pages)
    assert states[0] == states[1]
    hibernated = [e for e in states[1]["live"] if e[1] == "host"]
    assert len(hibernated) == 2 if case == "hibernated-survive-cap" else 1
    assert all(not e[4] for e in states[1]["live"])


# -- engine internals ----------------------------------------------------------------


def test_failed_spill_of_demoted_entry_drops_zombie():
    """An entry demoted on the strength of an in-flight spill whose copy
    then fails holds neither device nor host pages: the drain drops it; a
    zero-page entry is never "restored"."""
    engine = port_engine(start=False)
    pool, index, tier = engine._pagepool, engine._prefix_index, engine._host_tier
    tok = [9 + i % 30 for i in range(34)]
    owned = pool._alloc(2)
    entry = index.insert(pool, tok, 32, tuple(owned))
    pool.decref(owned)
    handle = _Spill(entry, tier.alloc(2), None, engine._spill_gen)
    entry.spilling = handle
    index.release_device_pages(pool, entry)  # demoted mid-spill
    handle.error = RuntimeError("copy failed")
    engine._spill_done.put(handle)
    engine._drain_spills()
    assert entry.dropped and index.live_entries == 0
    assert index.candidates(tok + [1]) == [], "the zombie survived the drain"
    assert tier.free_slots == tier.num_pages and pool.free_pages == pool.num_pages
    assert engine.stats()["spill-failures-total"] == 1
    owned = pool._alloc(2)
    entry2 = index.insert(pool, tok, 32, tuple(owned))
    pool.decref(owned)
    index.release_device_pages(pool, entry2)  # a host=() zombie by hand
    assert not engine._restore_entry(entry2, 32)
    assert entry2.dropped and engine.stats()["restore-failures-total"] == 1


def test_idle_sweep_rotates_past_hot_head():
    """The spill deque is publish-ordered: a hot entry at its head rotates
    to the back instead of blocking the idle entries behind it."""
    engine = port_engine(start=False, spill_idle_s=60.0)
    pool, index = engine._pagepool, engine._prefix_index
    entries = []
    for tok in ([1 + i % 20 for i in range(34)], [2 + i % 25 for i in range(34)]):
        owned = pool._alloc(2)
        entries.append(index.insert(pool, tok, 32, tuple(owned)))
        pool.decref(owned)
    hot, idle = entries
    hot.last_used_t = time.monotonic()
    idle.last_used_t = time.monotonic() - 120.0
    engine._spill_candidates.clear()
    engine._spill_candidates.extend([hot, idle])
    engine._spill_tick()
    assert idle.spilling is not None, "the idle entry starved behind the hot head"
    assert hot.spilling is None and hot in engine._spill_candidates
    # the worker is not running: stamp the copy here and fold it in
    engine._spill_worker.start()
    try:
        assert idle.spilling.event.wait(10.0)
        engine._drain_spills()
    finally:
        engine._spill_worker.stop()
    assert idle.tier == "both" and engine.stats()["spill-pages-total"] == 2


def test_spill_needs_prefix_index_and_paged_layout(caplog):
    """host-kv-fraction is an explicit ask: without its prerequisites the
    engine says so, loudly; an unknown spill value raises."""
    with caplog.at_level(logging.WARNING):
        engine = port_engine(tier=False, host_kv_fraction=2.0, prefix_cache="off", start=False)
    assert not engine._spill_on and engine._host_tier is None
    assert engine.stats()["host-tier"] is False
    assert any("prefix index" in r.message for r in caplog.records)
    dense = port_engine(tier=False, host_kv_fraction=2.0, prefix_cache="auto",
                        kv_layout="dense", start=False)
    assert not dense._spill_on and dense._host_tier is None
    with pytest.raises(ValueError, match="spill"):
        port_engine(spill="sometimes", start=False)


def test_plan_host_spill_term():
    """The plan's host arena term is host RAM: reported, outside the
    device total, ceil(pages x fraction) of the pool's page bytes — JAX's
    number for the same config; int8 KV halves it. The tier adds nothing
    to the device total (its page copies are DMA, no temporaries)."""
    jcfg, tcfg = configs()
    base = plan_serving_memory(tcfg, 4, 128, kv_layout="paged", page_size=16, kv_pages=8)
    tiered = plan_serving_memory(tcfg, 4, 128, kv_layout="paged", page_size=16, kv_pages=8,
                                 host_kv_fraction=4.0)
    page = base.page_pool_bytes // 9  # the sink page included
    assert base.host_spill_bytes == 0
    assert tiered.host_spill_bytes == 32 * page
    assert tiered.host_spill_bytes == jax_plan(
        jcfg, 4, 128, kv_layout="paged", page_size=16, kv_pages=8, host_kv_fraction=4.0
    ).host_spill_bytes
    assert tiered.total_bytes == base.total_bytes
    assert "host KV tier" in tiered.summary() and "host KV tier" not in base.summary()
    int8 = plan_serving_memory(configs("int8")[1], 4, 128, kv_layout="paged", page_size=16,
                               kv_pages=8, host_kv_fraction=4.0)
    assert int8.host_spill_bytes < tiered.host_spill_bytes
    engine = port_engine(start=False)
    assert engine.memory_plan.host_spill_bytes == engine._host_tier.bytes_total


def test_quarantine_zeroing_waits_on_in_flight_spill():
    """A page freed while a spill copy may still read it is zeroed only
    after the copy's fence: entry E's spill is in flight (the worker not
    running), E is demoted while slot 0 aliases its pages, slot 0 is
    NaN-quarantined (E is host-only, so the quarantine does not drop it and
    the slot's free hands back E's pages), and the zeroing at the next
    iteration top waits on the fence first — once per fence, with the
    pages' bytes untouched at the wait."""
    engine = port_engine(start=False)
    pool, index = engine._pagepool, engine._prefix_index

    class _Fence:
        def __init__(self):
            self.untouched_at_wait = []

        def wait(self):
            self.untouched_at_wait.append(
                all(bool(torch.all(leaf[:, shared] == 1.0)) for leaf in tpp.pool_leaves(pool.dev))
            )

        def synchronize(self):  # the worker's wait; the worker never runs here
            raise AssertionError("the spill worker ran")

    fence = _Fence()
    copy = engine._spill_copy

    def fenced_copy(pages, slots):
        copy(pages, slots)
        pool.fence(pages, fence)
        return fence

    engine._spill_copy = fenced_copy
    shared = pool._alloc(2)
    for leaf in tpp.pool_leaves(pool.dev):
        leaf[:, shared] = 1.0
    entry = index.insert(pool, PROMPT_A, 32, tuple(shared))
    pool.decref(shared)
    assert pool.reserve(0, 3, shared=tuple(shared)) is not None  # slot 0 aliases E
    assert index.evict_device_lru(pool, spill_cb=engine._ensure_spilled)
    assert entry.tier == "host" and entry.spilling is not None, "E not demoted mid-spill"
    assert pool.free_pages == pool.num_pages - 3, "slot 0 holds E's pages"
    engine._quarantine_pages(0)
    assert not entry.dropped and set(shared) <= set(engine._pending_page_zero)
    engine._flush_page_zeros()
    assert fence.untouched_at_wait == [True], "the zeroing did not wait on the spill's fence"
    assert all(bool(torch.all(leaf[:, shared] == 0)) for leaf in tpp.pool_leaves(pool.dev))
    assert not set(shared) & set(pool._fences), "a waited fence left on the page"


def test_spill_worker_stop_reports_wedged_thread():
    """stop() returns False — alive() staying truthful — when the worker
    cannot drain in time: a restart then abandons the arena instead of
    resetting it under a thread that may still write into it."""
    gate, entered = threading.Event(), threading.Event()

    class _StuckTier:
        def stamp_slots(self, slots):
            entered.set()
            gate.wait()

    worker = _SpillWorker(_StuckTier(), queue.SimpleQueue())
    worker.start()
    worker.submit(_Spill(object(), [0], None, 0))
    assert entered.wait(10.0)
    assert worker.stop(timeout=0.2) is False, "a wedged join reported clean"
    assert worker.alive()
    gate.set()
    assert worker.stop(timeout=10.0) is True and not worker.alive()


def test_paged_bind_skips_candidate_dropped_mid_loop():
    """A candidate dropped after the admission's list was taken reads as a
    cold miss, never as a hit on pages the free list re-issued."""
    engine = port_engine(start=False)
    pool, index = engine._pagepool, engine._prefix_index
    owned = pool._alloc(2)
    entry = index.insert(pool, PROMPT_A, 32, tuple(owned))
    pool.decref(owned)
    stale = entry.pages
    index._drop(pool, entry)
    assert entry.dropped and entry.pages == ()
    assert engine._restore_entry(entry, 32) is False
    assert engine.stats()["restore-failures-total"] == 0
    entry.pages = stale
    index.candidates = lambda prompt: [(32, entry)]
    req = GenerationRequest(prompt_tokens=list(PROMPT_A), options=GenerationOptions(**GREEDY))
    assert engine._paged_bind(0, req) == 0, "a dropped candidate served as a warm hit"
    entry.pages = ()
    pool.free_slot(0)
    assert pool.free_pages == pool.num_pages


def test_deferred_retry_counts_tier_fallback_once():
    """A page-deferred admission re-binds every iteration: its failed
    restores count once, and its cold bind counts one recompute fallback —
    never both sides of the health gauge."""
    engine = port_engine(start=False)
    pool, index, tier = engine._pagepool, engine._prefix_index, engine._host_tier
    owned = pool._alloc(2)
    entry = index.insert(pool, PROMPT_A, 32, tuple(owned))
    pool.decref(owned)
    entry.host = tuple(tier.alloc(2))  # no stamps: a restore fails at read
    index.release_device_pages(pool, entry)
    grabbed = pool._alloc(pool.free_pages)  # a full pool, nothing evictable
    req = GenerationRequest(prompt_tokens=list(PROMPT_A), options=GenerationOptions(**GREEDY))
    assert engine._paged_bind(0, req) is None
    assert engine.stats()["restore-failures-total"] == 1
    assert engine.stats()["recompute-fallbacks-total"] == 0 and req._tier_fallback_counted
    for _ in range(25):
        assert engine._paged_bind(0, req) is None
    assert engine.stats()["restore-failures-total"] == 1, "retries inflated the gauge"
    pool.decref(grabbed)
    assert engine._paged_bind(0, req) == 0
    assert engine.stats()["recompute-fallbacks-total"] == 1
    assert engine.stats()["restored-hits-total"] == 0
    pool.free_slot(0)


def test_spill_stall_dump_reason_and_schema():
    """``spill-stall`` is a flight reason; its dumps carry the restore
    timings and each iteration's arena occupancy, token-content-free."""
    from langstream_tpu_torch.serving.observability import DUMP_REASONS, validate_flight_dump

    assert "spill-stall" in DUMP_REASONS
    engine = port_engine()
    try:
        engine.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT)
        dump = engine._flight_dump(
            "spill-stall", extra={"restore-ms": 1234.5, "restore-pages": 2, "reuse-tokens": 32}
        )
        assert dump is not None and validate_flight_dump(dump)
        assert dump["iterations"] and all("host_pages" in it for it in dump["iterations"])
        with pytest.raises(ValueError):
            validate_flight_dump({**dump, "extra": {"tokens": [1, 2, 3]}})
    finally:
        engine.stop()


# -- the engine against JAX --------------------------------------------------------


@pytest.mark.parametrize(
    "kv, spec", [("model", False), ("int8", True)], ids=["float-plain", "int8kv-spec"]
)
def test_hibernate_restore_token_exact(kv, spec):
    """A publishes, hibernates, is demoted by B's admission and restores on
    its next turn: the tokens and the restore stats equal the JAX tiered
    engine's on the same weights, the restore moved the pool dtype's page
    bytes, and both free lists end full."""
    want_tokens, want = jax_turns(kv, spec)
    engine = port_engine(kv, speculation="auto" if spec else "off", speculation_tokens=3)
    try:
        tokens, got = session_turns(engine, jax_side=False)
        stats = engine.stats()
    finally:
        engine.stop()
    assert tokens == want_tokens
    assert "host" in got["tiers"] and got["demoted"] >= 1
    assert {k: got[k] for k in RESTORE_KEYS} == {k: want[k] for k in RESTORE_KEYS}
    assert got["restored-hits-total"] == 1 and got["recompute-fallbacks-total"] == 0
    tier = engine._host_tier
    assert stats["restore-bytes-total"] == 2 * tier.bytes_per_page
    assert stats["spill-bytes-total"] >= 2 * tier.bytes_per_page
    assert stats["histograms"]["engine_restore_s"]["count"] >= 1
    assert stats["histograms"]["engine_spill_s"]["count"] >= 1
    assert_leak_free(engine)


def test_constrained_slot_hibernate_restore_exact():
    """A session decoding under a JSON-schema grammar, hibernated, demoted
    and restored, matches the tier-off constrained run token for token (the
    DFA is slot state; hibernation moves KV pages only)."""
    tok = ByteTokenizer()
    rf = {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": {"name": {"type": "string", "maxLength": 8}},
    }}}
    opts = GenerationOptions(max_new_tokens=24, temperature=0.0, response_format=rf)
    prompt = tok.encode("Return the JSON object for the user named Ada now")
    assert len(prompt) >= 33  # past the 32-token publish boundary
    kw = dict(grammar_tokenizer=tok, eos_token_id=tok.eos_token_id)
    cold = port_engine(tier=False, **kw)
    try:
        want = cold.generate(list(prompt), opts, timeout=WAIT).tokens
        want_b = cold.generate(list(PROMPT_B), GenerationOptions(**GREEDY), timeout=WAIT).tokens
    finally:
        cold.stop()
    engine = port_engine(**kw)
    try:
        first = engine.generate(list(prompt), opts, timeout=WAIT).tokens
        wait_spilled(engine, 2)
        b = engine.generate(list(PROMPT_B), GenerationOptions(**GREEDY), timeout=WAIT).tokens
        again = engine.generate(list(prompt), opts, timeout=WAIT).tokens
        stats = engine.stats()
    finally:
        engine.stop()
    assert first == want and again == want and b == want_b
    assert stats["restored-hits-total"] >= 1
    assert_leak_free(engine)


def test_spill_fault_degrades_to_cold_prefill():
    """``spill@1`` flips a byte of the first restore's arena page: the
    checksum refuses it, the admission re-prefills cold with the JAX
    engine's tokens, the entry is dropped; B's session then restores
    cleanly, and the engine never restarts."""
    (want_a, want_b, _), _ = jax_turns("model", False)
    engine = port_engine(fault_injector=FaultInjector("spill@1", seed=0))
    try:
        opts = GenerationOptions(**GREEDY)
        a1 = engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens
        wait_spilled(engine, 2)
        b1 = engine.generate(list(PROMPT_B), opts, timeout=WAIT).tokens
        wait_spilled(engine, 4)  # B hibernates too
        a2 = engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens
        stats = engine.stats()
        assert a2 == want_a, "the fallback diverged — poisoned KV?"
        assert stats["restore-failures-total"] == 1
        assert stats["recompute-fallbacks-total"] >= 1
        assert stats["restored-hits-total"] == 0
        assert engine._injector.fired["spill"] == 1
        b2 = engine.generate(list(PROMPT_B), opts, timeout=WAIT).tokens
        stats = engine.stats()
    finally:
        engine.stop()
    assert a1 == want_a and b1 == want_b and b2 == want_b
    assert stats["restored-hits-total"] == 1 and stats["restore-failures-total"] == 1
    assert stats["engine-restarts-total"] == 0
    assert_leak_free(engine)


def test_hibernation_churn_leak_free():
    """Both sessions cycling through hibernation three times: the JAX
    engine's tokens every turn, and both free lists full at the end."""
    (want_a, want_b, _), _ = jax_turns("model", False)
    engine = port_engine()
    try:
        opts = GenerationOptions(**GREEDY)
        assert engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens == want_a
        wait_spilled(engine, 2)
        assert engine.generate(list(PROMPT_B), opts, timeout=WAIT).tokens == want_b
        for turn in range(3):
            for prompt, want in ((PROMPT_A, want_a), (PROMPT_B, want_b)):
                got = engine.generate(list(prompt), opts, timeout=WAIT).tokens
                assert got == want, f"turn {turn} diverged"
        stats = engine.stats()
    finally:
        engine.stop()
    assert stats["restored-hits-total"] >= 2 and stats["spill-failures-total"] == 0
    assert stats["host-pages-in-use"] == sum(len(e.host) for e in engine._prefix_index._live)
    assert_leak_free(engine)


def test_restart_resets_the_tier():
    """A decode crash restarts the loop: the spill worker is stopped before
    the pool resets and the graphs are captured again, the arena is reset
    (every slot free), the worker runs again, and a later session
    hibernates and restores with the JAX engine's tokens."""
    (want_a, want_b, _), _ = jax_turns("model", False)
    engine = port_engine(fault_injector=FaultInjector("decode@2", seed=0))
    try:
        opts = GenerationOptions(**GREEDY)
        with pytest.raises(Exception):
            engine.generate(list(PROMPT_A), opts, timeout=WAIT)
        # the request fails before the rebuild: wait for the loop to run again
        deadline = time.monotonic() + WAIT
        while engine.stats()["recovering"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.stats()["engine-restarts-total"] == 1
        assert engine._host_tier.free_slots == engine._host_tier.num_pages
        assert engine._spill_worker.alive()
        assert engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens == want_a
        wait_spilled(engine, 2)
        assert engine.generate(list(PROMPT_B), opts, timeout=WAIT).tokens == want_b
        assert engine.generate(list(PROMPT_A), opts, timeout=WAIT).tokens == want_a
        assert engine.stats()["restored-hits-total"] == 1
    finally:
        engine.stop()
    assert_leak_free(engine)


def test_provider_serves_tier_keys():
    """``host-kv-fraction`` / ``spill`` / ``spill-idle-s`` /
    ``restore-stall-dump-s`` reach the engine; the arena is sized from the
    pool."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "max-batch": 2, "page-size": 16,
        "max-seq-len": 128, "prefix-cache": "auto", "host-kv-fraction": 1.5,
        "spill-idle-s": 3.0, "restore-stall-dump-s": 0.5,
    })
    try:
        engine = svc.engine()
        assert engine._spill_on and engine.spill_idle_s == 3.0 and engine._restore_stall_s == 0.5
        pages = engine._pagepool.num_pages
        assert engine._host_tier.num_pages == math.ceil(pages * 1.5)
        assert engine.stats()["host-tier-bytes-total"] == engine.memory_plan.host_spill_bytes
    finally:
        svc.close()
    off = TorchCompletionsService({"model": "tiny-test", "device": "cpu", "prefix-cache": "auto",
                                   "host-kv-fraction": 1.5, "spill": "off"})
    assert off.spill == "off"
    with pytest.raises(ValueError, match="host-kv-fraction"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "host-kv-fraction": -1})
