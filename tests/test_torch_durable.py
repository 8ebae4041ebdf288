"""The durable session tier of the port against the JAX package, on the
CPU (tiny-test, f32).

- The store (``serving/durable.py``, the port's own copy): checkpoint /
  restore round trip, the data file as a ``lstpu-kvmig-v2`` body the
  port's codec decodes, rehydrate with crash debris, a foreign hibernation
  schema, the crash-phase matrix (every write phase a SIGKILL can cut reads
  as restore or a clean cold start), torn / corrupt / stale manifests as
  dead entries, the LRU disk cap, ``invalidate`` and the tier-off stats.
- Byte identity across packages: a directory written by the JAX
  ``DurableStore`` reads in the port's store to the same bytes and stamps,
  and the reverse.
- The engine: a session checkpointed by one engine and restored by a new
  engine on the same directory gives the JAX engine's tokens (replica
  death and resurrection); ``hibernate`` checkpoints every live session;
  the ``disk-corrupt`` / ``disk-stall`` / ``disk-full`` drills end in a cold
  prefill (or an unaffected serve) with the right tokens, the
  ``durable-restore-failed`` dump and both free lists full; the plan's disk
  term; the provider's durable keys and its hibernating ``close()``.
"""

import dataclasses
import functools
import hashlib
import json
import os
import time

import jax
import numpy as np
import pytest

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving import durable as jdur
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving import wire
from langstream_tpu_torch.serving.durable import (
    DATA_SUFFIX,
    HIBERNATE_NAME,
    MANIFEST_SUFFIX,
    DurableError,
    DurableStore,
)
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.memory import plan_serving_memory
from langstream_tpu_torch.serving.pagepool import prefix_digest

WAIT = 120.0
V = MODEL_PRESETS["tiny-test"].vocab_size
GREEDY = dict(max_new_tokens=10, temperature=0.0)
# 45-token sessions over the 16/32/64 ladder at page 16: each publishes a
# 32-token (2-page) prefix — the unit the tier checkpoints
PROMPT_A = [(7 + 3 * i) % V for i in range(45)]
PROMPT_B = [(5 + 11 * i) % V for i in range(45)]


@functools.lru_cache(maxsize=None)
def configs():
    return (
        dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32"),
        dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32"),
    )


@functools.lru_cache(maxsize=None)
def weights():
    jp = jax_init_params(configs()[0], jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), configs()[1], device="cpu")


@functools.lru_cache(maxsize=None)
def jax_tokens() -> tuple:
    """The JAX engine's greedy tokens for A and B (one tier-off run)."""
    engine = JaxEngine(configs()[0], weights()[0], kv_layout="paged", **engine_kw(tier=False))
    engine.start()
    try:
        opts = JaxOptions(**GREEDY)
        return tuple(engine.generate(list(p), opts, timeout=WAIT).tokens
                     for p in (PROMPT_A, PROMPT_B))
    finally:
        engine.stop()


def engine_kw(durable_dir=None, tier: bool = True, **kw) -> dict:
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("page_size", 16)
    if tier:
        kw.setdefault("kv_pages", 12)
        kw.setdefault("host_kv_fraction", 2.0)
        kw.setdefault("spill_idle_s", 0.0)
        kw.setdefault("prefix_cache", "auto")
        kw.setdefault("prefix_cache_entries", 8)
    else:
        kw.setdefault("prefix_cache", "off")
        kw.setdefault("host_kv_fraction", 0.0)
    if durable_dir is not None:
        kw.setdefault("durable", "on")
        kw["durable_dir"] = str(durable_dir)
    return kw


def port_engine(durable_dir=None, tier: bool = True, **kw) -> ServingEngine:
    engine = ServingEngine(configs()[1], weights()[1], device="cpu",
                           **engine_kw(durable_dir, tier, **kw))
    engine.start()
    return engine


def wait_stat(engine, key: str, want: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if engine.stats()[key] >= want:
            return
        time.sleep(0.01)
    raise AssertionError(f"{key} never reached {want}: {engine.stats()[key]}")


def assert_leak_free(engine) -> None:
    pool, index, tier = engine._pagepool, engine._prefix_index, engine._host_tier
    engine._drain_spills()
    for entry in list(index._live):
        index._drop(pool, entry)
    assert pool.free_pages == pool.num_pages, f"{pool.num_pages - pool.free_pages} pages leaked"
    if tier is not None:
        assert tier.free_slots == tier.num_pages, f"{tier.num_pages - tier.free_slots} slots leaked"


def _raw_pages(n: int = 2, nbytes: int = 96, seed: int = 0):
    pages = [bytes((seed + 13 * i + j) % 256 for j in range(nbytes)) for i in range(n)]
    return pages, [hashlib.blake2b(p, digest_size=16).hexdigest() for p in pages]


def _write_checkpoint(store, digest: str = "aa" * 8, n: int = 2, length: int = 32, seed: int = 0):
    pages, sums = _raw_pages(n=n, seed=seed)
    nbytes = store.checkpoint(digest, length, list(range(length)), pages, sums,
                              page_size=16, bytes_per_page=len(pages[0]))
    return digest, pages, sums, nbytes


# -- the store -------------------------------------------------------------------


def test_checkpoint_restore_roundtrip(tmp_path):
    store = DurableStore(str(tmp_path))
    digest, pages, sums, nbytes = _write_checkpoint(store)
    assert nbytes > 0 and store.contains(digest) and len(store) == 1
    assert store.entries() == [(digest, 32)] and store.bytes_on_disk() == nbytes
    rec = store.restore(digest)
    assert rec["length"] == 32 and rec["tokens"] == list(range(32))
    assert rec["pages"] == pages and rec["checksums"] == sums
    assert rec["page_size"] == 16 and rec["bytes_per_page"] == len(pages[0])
    s = store.stats()
    assert s["durable-checkpoints-total"] == 1 and s["durable-checkpoint-bytes-total"] == nbytes
    assert s["durable-restores-total"] == 1
    assert s["durable-restore-bytes-total"] == sum(len(p) for p in pages)
    assert s["durable-restore-failures-total"] == 0 and s["durable-dead-entries-total"] == 0


def test_disk_format_is_the_wire_codec(tmp_path):
    """The data file is a ``lstpu-kvmig-v2`` body: the codec parses it."""
    store = DurableStore(str(tmp_path))
    digest, pages, sums, _ = _write_checkpoint(store)
    with open(os.path.join(str(tmp_path), digest + DATA_SUFFIX), "rb") as f:
        assert f.read(len(wire.KVMIG2_PREAMBLE)) == wire.KVMIG2_PREAMBLE
        frames = list(wire.decode_mig_frames(f.read, 1 << 20))
    assert [fr["kind"] for fr in frames] == ["begin", "page", "page", "commit"]
    assert frames[0]["digest"] == digest and frames[0]["prompt_tokens"] == list(range(32))
    assert [fr["raw"] for fr in frames[1:3]] == pages
    assert [fr["checksum"] for fr in frames[1:3]] == sums


def test_rehydrate_rebuilds_index_and_reclaims_debris(tmp_path):
    root = str(tmp_path)
    store = DurableStore(root)
    d1, p1, _, _ = _write_checkpoint(store, digest="11" * 8, seed=1)
    d2, _, _, _ = _write_checkpoint(store, digest="22" * 8, seed=2)
    store.write_hibernation("replica-a", [d1, d2], compile_cache_dir="/cc")
    with open(os.path.join(root, "33" * 8 + DATA_SUFFIX), "wb") as f:
        f.write(b"aborted")
    orphan = {
        "schema": "lstpu-kvdur-v1", "digest": "44" * 8, "length": 32, "pages": 1,
        "page_size": 16, "bytes_per_page": 96, "bytes": 96, "checksums": ["00" * 16],
        "created": 0.0,
    }
    with open(os.path.join(root, "44" * 8 + MANIFEST_SUFFIX), "w") as f:
        json.dump(orphan, f)
    with open(os.path.join(root, "55" * 8 + DATA_SUFFIX + ".tmp"), "wb") as f:
        f.write(b"torn tmp")
    fresh = DurableStore(root)
    assert fresh.rehydrate() == 2
    assert fresh.contains(d1) and fresh.contains(d2) and not fresh.contains("44" * 8)
    assert fresh.stats()["durable-dead-entries-total"] == 1
    assert not os.path.exists(os.path.join(root, "33" * 8 + DATA_SUFFIX))
    assert not os.path.exists(os.path.join(root, "44" * 8 + MANIFEST_SUFFIX))
    assert fresh.restore(d1)["pages"] == p1
    doc = fresh.read_hibernation()
    assert doc["replica"] == "replica-a" and doc["digests"] == sorted([d1, d2])
    assert doc["compile_cache_dir"] == "/cc"


def test_hibernation_record_rejects_foreign_schema(tmp_path):
    store = DurableStore(str(tmp_path))
    assert store.read_hibernation() is None
    with open(os.path.join(str(tmp_path), HIBERNATE_NAME), "w") as f:
        json.dump({"schema": "something-else", "replica": "x"}, f)
    assert store.read_hibernation() is None


@pytest.mark.parametrize(
    "phase", ["pre-temp", "mid-frame", "pre-rename", "post-rename-data", "mid-manifest",
              "committed"],
)
def test_sigkill_matrix_every_phase_restores_or_cold_starts(tmp_path, phase):
    """Every write phase a kill can cut leaves a directory that rehydrates
    to a restorable entry (committed) or a clean cold start."""
    staging = DurableStore(str(tmp_path / "staging"))
    digest, _, _, _ = _write_checkpoint(staging)
    pages = staging.restore(digest)["pages"]
    with open(str(tmp_path / "staging" / (digest + DATA_SUFFIX)), "rb") as f:
        body = f.read()
    with open(str(tmp_path / "staging" / (digest + MANIFEST_SUFFIX)), "rb") as f:
        manifest = f.read()
    root = tmp_path / phase
    root.mkdir()
    data = str(root / (digest + DATA_SUFFIX))
    mpath = str(root / (digest + MANIFEST_SUFFIX))
    writes = {
        "pre-temp": [],
        "mid-frame": [(data + ".tmp", body[: len(body) * 2 // 3])],
        "pre-rename": [(data + ".tmp", body)],
        "post-rename-data": [(data, body)],
        "mid-manifest": [(data, body), (mpath + ".tmp", manifest[: len(manifest) // 2])],
        "committed": [(data, body), (mpath, manifest)],
    }[phase]
    for path, content in writes:
        with open(path, "wb") as f:
            f.write(content)
    store = DurableStore(str(root))
    live = store.rehydrate()
    if phase == "committed":
        assert live == 1 and store.restore(digest)["pages"] == pages
    else:
        assert live == 0 and not store.contains(digest)
        assert not os.path.exists(data)


def test_torn_corrupt_and_stale_manifest_read_as_dead(tmp_path):
    root = str(tmp_path)
    store = DurableStore(root)
    digest, _, _, nbytes = _write_checkpoint(store)
    data = os.path.join(root, digest + DATA_SUFFIX)
    with open(data, "r+b") as f:
        f.truncate(nbytes * 2 // 3)
    with pytest.raises(DurableError):
        store.restore(digest)
    assert not store.contains(digest) and not os.path.exists(data)
    assert store.stats()["durable-restore-failures-total"] == 1
    # one payload byte flipped under a valid manifest
    digest2, pages2, _, _ = _write_checkpoint(store, digest="bb" * 8, seed=3)
    data2 = os.path.join(root, digest2 + DATA_SUFFIX)
    with open(data2, "r+b") as f:
        body = f.read()
        at = body.index(pages2[0]) + len(pages2[0]) // 2
        f.seek(at)
        f.write(bytes([body[at] ^ 0xFF]))
    with pytest.raises(DurableError):
        store.restore(digest2)
    assert not store.contains(digest2)
    # a stale manifest: valid JSON whose stamps do not match the frames
    digest3, _, sums3, _ = _write_checkpoint(store, digest="cc" * 8, seed=4)
    mpath = os.path.join(root, digest3 + MANIFEST_SUFFIX)
    with open(mpath) as f:
        doc = json.load(f)
    doc["checksums"] = list(reversed(sums3))
    with open(mpath, "w") as f:
        json.dump(doc, f)
    fresh = DurableStore(root)
    fresh.rehydrate()
    with pytest.raises(DurableError):
        fresh.restore(digest3)
    assert not fresh.contains(digest3)


def test_eviction_holds_the_disk_cap_lru(tmp_path):
    store = DurableStore(str(tmp_path))
    d1, _, _, nbytes = _write_checkpoint(store, digest="11" * 8, seed=1)
    store.max_bytes = nbytes + nbytes // 2  # room for one entry
    time.sleep(0.005)  # distinct created stamps
    d2, _, _, _ = _write_checkpoint(store, digest="22" * 8, seed=2)
    assert not store.contains(d1) and store.contains(d2)
    assert store.stats()["durable-evictions-total"] == 1
    assert store.bytes_on_disk() <= store.max_bytes
    for suffix in (DATA_SUFFIX, MANIFEST_SUFFIX):
        assert not os.path.exists(os.path.join(str(tmp_path), d1 + suffix))


def test_invalidate_counts_and_empty_stats_parity(tmp_path):
    store = DurableStore(str(tmp_path))
    digest, _, _, _ = _write_checkpoint(store)
    store.invalidate(digest, "caller proved a page bad")
    assert not store.contains(digest)
    s = store.stats()
    assert s["durable-restore-failures-total"] == 1 and s["durable-dead-entries-total"] == 1
    empty = DurableStore.empty_stats()
    assert set(empty) == set(s) == set(jdur.DurableStore.empty_stats())
    assert all(v == 0 for v in empty.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_reads_the_same_in_both_stores(tmp_path, writer):
    """A directory written by one package's store rehydrates in the other's
    to the same entries, page bytes and stamps; the data files and the
    manifests' commit fields are byte-for-byte the same format."""
    pages, sums = _raw_pages(n=3, nbytes=512, seed=7)
    dirs = {}
    for name, cls in (("jax", jdur.DurableStore), ("port", DurableStore)):
        dirs[name] = str(tmp_path / name)
        cls(dirs[name]).checkpoint("ab" * 8, 48, list(range(48)), pages, sums, 16, 512)
    with open(os.path.join(dirs["jax"], "ab" * 8 + DATA_SUFFIX), "rb") as f:
        jax_body = f.read()
    with open(os.path.join(dirs["port"], "ab" * 8 + DATA_SUFFIX), "rb") as f:
        assert f.read() == jax_body
    reader_cls = DurableStore if writer == "jax" else jdur.DurableStore
    reader = reader_cls(dirs[writer])
    assert reader.rehydrate() == 1
    rec = reader.restore("ab" * 8)
    assert rec["pages"] == pages and rec["checksums"] == sums
    assert rec["tokens"] == list(range(48)) and rec["length"] == 48
    manifests = []
    for name in ("jax", "port"):
        with open(os.path.join(dirs[name], "ab" * 8 + MANIFEST_SUFFIX)) as f:
            doc = json.load(f)
        doc.pop("created")
        manifests.append(doc)
    assert manifests[0] == manifests[1]


# -- the engine --------------------------------------------------------------------


def test_replica_death_resurrection_token_exact(tmp_path):
    """A's prefix checkpoints on one engine (spill, then the durable
    worker), that engine dies without a drain, and a new engine on the same
    directory rehydrates it and serves A's next turn from disk with the JAX
    engine's tokens."""
    want_a, _ = jax_tokens()
    a = port_engine(durable_dir=tmp_path)
    try:
        assert a.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens == want_a
        wait_stat(a, "durable-checkpoints-total", 1)
        assert a.stats()["durable-entries"] >= 1
    finally:
        a.stop()  # no hibernate(): the checkpoint already landed
    b = port_engine(durable_dir=tmp_path)
    try:
        stats0 = b.stats()
        assert stats0["durable-tier"] is True and stats0["durable-entries"] >= 1
        assert b._durable.contains(prefix_digest(PROMPT_A[:32]))
        got = b.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens
        stats = b.stats()
    finally:
        b.stop()
    assert got == want_a, "the resurrected session diverged"
    assert stats["durable-restored-hits-total"] == 1 and stats["durable-restores-total"] == 1
    assert stats["durable-restore-bytes-total"] > 0
    assert stats["durable-restore-failures-total"] == 0 and stats["engine-restarts-total"] == 0
    assert stats["histograms"]["engine_durable_restore_s"]["count"] == 1
    assert_leak_free(b)


def test_hibernate_checkpoints_every_live_session(tmp_path):
    """hibernate() flushes the worker, checkpoints every live entry (device
    ones included) and writes the hibernation record."""
    engine = port_engine(durable_dir=tmp_path, kv_pages=16, host_kv_fraction=0.0,
                         durable="auto")
    try:
        assert not engine._spill_on  # device entries only: no spill triggers
        for prompt in (PROMPT_A, PROMPT_B):
            engine.generate(list(prompt), GenerationOptions(**GREEDY), timeout=WAIT)
        ledger = engine.hibernate("replica-a")
        live = {e.digest for e in engine._prefix_index._live if e.digest and not e.dropped}
        assert ledger == {"entries": len(live), "bytes": ledger["bytes"], "failures": 0}
        assert ledger["bytes"] > 0 and len(live) == 2
        assert all(engine._durable.contains(d) for d in live)
    finally:
        engine.stop()
    store = DurableStore(str(tmp_path))
    assert store.rehydrate() == 2
    doc = store.read_hibernation()
    assert doc is not None and doc["replica"] == "replica-a"
    assert set(doc["digests"]) == live


def test_disk_corrupt_drill_degrades_to_cold_prefill_with_dump(tmp_path):
    """Bit rot under a valid manifest: the new engine's restore trips the
    frame CRC, the entry dies, the request prefills cold with the JAX
    engine's tokens, one durable-restore-failed dump, no restart, and the
    dead entry is not retried."""
    from langstream_tpu_torch.serving.observability import validate_flight_dump

    want_a, _ = jax_tokens()
    a = port_engine(durable_dir=tmp_path, fault_injector=FaultInjector("disk-corrupt@1", seed=0))
    try:
        a.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT)
        wait_stat(a, "durable-checkpoints-total", 1)
        assert a._injector.fired["disk-corrupt"] == 1
    finally:
        a.stop()
    b = port_engine(durable_dir=tmp_path)
    try:
        assert b.stats()["durable-entries"] >= 1  # the manifest is valid
        got = b.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens
        stats = b.stats()
        dump = b._obs.flight.last_dump
        again = b.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens
        after = b.stats()
    finally:
        b.stop()
    assert got == want_a and again == want_a, "the cold fallback diverged — poisoned KV?"
    assert stats["durable-restored-hits-total"] == 0
    assert stats["durable-restore-failures-total"] >= 1 and stats["durable-dead-entries-total"] >= 1
    assert stats["engine-restarts-total"] == 0
    assert dump is not None and dump["reason"] == "durable-restore-failed"
    assert validate_flight_dump(dump) and dump["extra"]["fallback"] == "local-cold-prefill"
    assert "tokens" not in dump["extra"]
    assert after["durable-restore-failures-total"] == stats["durable-restore-failures-total"]
    assert_leak_free(b)


def test_durable_bind_refusal_retries_only_for_room(tmp_path):
    """A checkpoint the bind refuses for its shape (a page count that does
    not match its length) fails the request's restore for good; a bind
    refused for room (the pool exhausted) is retried and binds once pages
    come back."""
    engine = ServingEngine(configs()[1], weights()[1], device="cpu",
                           **engine_kw(tmp_path, host_kv_fraction=0.0))
    pool, store = engine._pagepool, engine._durable
    rng = np.random.default_rng(0)
    for prompt, n in ((PROMPT_A, 1), (PROMPT_B, 2)):  # A: 1 page for 32 tokens
        pages = [rng.integers(0, 256, pool.bytes_per_page, np.uint8).tobytes()
                 for _ in range(n)]
        store.checkpoint(prefix_digest(prompt[:32]), 32, prompt[:32], pages,
                         [hashlib.blake2b(p, digest_size=16).hexdigest() for p in pages],
                         page_size=16, bytes_per_page=pool.bytes_per_page)
    bad = GenerationRequest(prompt_tokens=list(PROMPT_A), options=GenerationOptions(**GREEDY))
    assert engine._durable_admit(bad, list(PROMPT_A)) is None
    assert bad._durable_failed
    held = pool.alloc_pages(pool.free_pages)
    req = GenerationRequest(prompt_tokens=list(PROMPT_B), options=GenerationOptions(**GREEDY))
    assert engine._durable_admit(req, list(PROMPT_B)) is None
    assert not req._durable_failed  # retryable
    pool.decref(held)
    hit = engine._durable_admit(req, list(PROMPT_B))
    assert hit is not None and hit[0] == 32 and len(hit[1].pages) == 2
    assert engine.stats()["durable-restored-hits-total"] == 1


def test_disk_stall_deadline_fires_never_hangs(tmp_path):
    """A stalled volume (stall past durable-timeout-s) is a missed deadline
    inside the admission: a cold prefill with the dump, never a wedged
    engine thread."""
    want_a, _ = jax_tokens()
    a = port_engine(durable_dir=tmp_path)
    try:
        a.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT)
        wait_stat(a, "durable-checkpoints-total", 1)
    finally:
        a.stop()
    b = port_engine(durable_dir=tmp_path, durable_timeout_s=0.1,
                    fault_injector=FaultInjector("disk-stall@1:1", seed=0, stall_s=0.4))
    try:
        t0 = time.monotonic()
        got = b.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens
        took = time.monotonic() - t0
        stats = b.stats()
        dump = b._obs.flight.last_dump
    finally:
        b.stop()
    assert got == want_a
    assert stats["durable-restored-hits-total"] == 0 and stats["durable-restore-failures-total"] >= 1
    assert stats["engine-restarts-total"] == 0
    assert dump is not None and dump["reason"] == "durable-restore-failed"
    assert "deadline" in dump["extra"]["error"]
    assert took < 60.0
    assert_leak_free(b)


def test_disk_full_checkpoint_fails_cleanly_serving_unaffected(tmp_path):
    """ENOSPC on the worker: the checkpoint fails counted, no manifest is
    left, and the serving path never notices."""
    want_a, _ = jax_tokens()
    engine = port_engine(durable_dir=tmp_path, fault_injector=FaultInjector("disk-full@1", seed=0))
    try:
        assert engine.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens \
            == want_a
        wait_stat(engine, "durable-checkpoint-failures-total", 1)
        stats = engine.stats()
        manifests = [n for n in os.listdir(str(tmp_path))
                     if n.endswith(MANIFEST_SUFFIX) and n != HIBERNATE_NAME]
        assert stats["durable-entries"] == len(manifests)
        assert engine.generate(list(PROMPT_A), GenerationOptions(**GREEDY), timeout=WAIT).tokens \
            == want_a
        assert stats["engine-restarts-total"] == 0
    finally:
        engine.stop()
    assert_leak_free(engine)


def test_stats_block_present_with_tier_off():
    engine = port_engine()  # no durable_dir: the tier is off
    try:
        stats = engine.stats()
        assert stats["durable-tier"] is False and stats["durable-entries"] == 0
        assert stats["durable-restored-hits-total"] == 0
        assert stats["durable-checkpoints-total"] == 0
        assert not engine.restoring and engine.hibernate() == {}
    finally:
        engine.stop()


def test_memory_plan_reports_durable_disk_budget():
    plan = plan_serving_memory(configs()[1], 2, 128, kv_layout="paged", page_size=16,
                               kv_pages=12, durable_max_bytes=2 << 30)
    flat = plan_serving_memory(configs()[1], 2, 128, kv_layout="paged", page_size=16,
                               kv_pages=12)
    assert plan.durable_disk_bytes == 2 << 30 and flat.durable_disk_bytes == 0
    assert "durable KV tier" in plan.summary() and "disk" in plan.summary()
    assert "durable" not in flat.summary()
    assert plan.total_bytes == flat.total_bytes, "the disk cap is not device memory"


def test_provider_serves_durable_keys_and_hibernates_on_close(tmp_path):
    """``durable`` (auto: on with ``durable-dir``), ``durable-dir``,
    ``durable-max-bytes`` and ``durable-timeout-s`` reach the engine, and
    ``close()`` hibernates every live session after the drain."""
    import asyncio

    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    base = {"model": "tiny-test", "device": "cpu", "max-batch": 2, "page-size": 16,
            "max-seq-len": 128, "prefix-cache": "auto"}
    svc = TorchCompletionsService({**base, "durable-dir": str(tmp_path),
                                   "durable-max-bytes": 1 << 30, "durable-timeout-s": 2.0})
    engine = svc.engine()
    assert engine._durable is not None and engine.durable_timeout_s == 2.0
    assert engine._durable.max_bytes == 1 << 30 and not engine._spill_on
    asyncio.run(svc.get_text_completions(["hello there, " * 4], {"max-tokens": 3}))
    svc.close()
    store = DurableStore(str(tmp_path))
    assert store.rehydrate() >= 1 and store.read_hibernation() is not None
    off = TorchCompletionsService({**base, "durable": "off", "durable-dir": str(tmp_path)})
    assert off.durable == "off"
    engine = off.engine()
    assert engine._durable is None
    off.close()
    with pytest.raises(ValueError, match="durable"):
        TorchCompletionsService({**base, "durable": "sometimes"})
