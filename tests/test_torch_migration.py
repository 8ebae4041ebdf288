"""KV-page migration and the disaggregated handoff of the port against the
JAX package, on the CPU (tiny-test, f32, page 16; int8 through the
reference attention, "jnp", as the other int8 engine tests).

- The migration wire between two port engines: a transfer's receiver
  serves the migrated prefix warm with the JAX engine's tokens and the
  sender releases on ACK; the ``migrate@1`` (v1 and v2 payloads) and
  ``net-cut@1`` drills leave the receiver's free list as it was, the
  sender retaining, both pools leak-free; a wedged engine fails the
  transfer within its deadline; a page-count mismatch, a payload outside
  the base64 alphabet and a missing prefix abort cleanly; a hibernated
  session ships from the host arena (its receiver's pages bit-equal to the
  arena's); int8 KV with speculation
  round-trips; ``engine_migrate_out`` to a replica registered in this
  process; the cancel registry behind ``cancel-key``.
- The router over in-process engines: the disaggregated handoff (prefill
  and first token on "pre", the pages migrated, the rest decoded warm on
  "dec") gives the JAX engine's unmigrated greedy tokens, repoints the
  sticky session, and both drills decode in place with a valid
  ``migrate-failed`` dump; a P2P fetch copies an owner's pages and the
  routed engine admits warm, and a fetch that fails (a corrupt page, a cut
  wire, a vanished owner) falls back to a cold prefill with its counter
  and its dump; a constrained stream resumes mid-derivation
  from the DFA state its frames carried, and is refused without one.
- Across packages: frames a JAX engine exports (v1 ``data`` and v2
  ``raw``) bind into a port engine, and the port's into a JAX engine; each
  receiver then serves the JAX engine's unmigrated tokens, and both
  packages' ``page_checksum`` agree on every page.
"""

import base64
import dataclasses
import functools
import re
import time

import jax
import numpy as np
import pytest

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving import migrate as jmig
from langstream_tpu.serving import pagepool as jpp
from langstream_tpu.serving import fleet as jfleet
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving import fleet, lifecycle
from langstream_tpu_torch.serving import migrate as mig
from langstream_tpu_torch.serving.engine import ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.fleet import (
    FleetRouter,
    InProcessReplica,
    ReplicaError,
    RouteDecision,
    set_wire_injector,
)
from langstream_tpu_torch.serving.memory import plan_serving_memory
from langstream_tpu_torch.serving.migrate import MigrationError
from langstream_tpu_torch.serving.observability import recent_dumps, validate_flight_dump
from langstream_tpu_torch.serving.pagepool import (
    np_view,
    page_checksum,
    pool_leaves,
    prefix_digest,
)
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

WAIT = 60.0
NEW = 6
KW = dict(max_batch=2, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32, 64),
          page_size=16)
TOK = ByteTokenizer()


def prompt_for(base: int, n: int = 40) -> list:
    return [base + (3 * i) % 50 for i in range(n)]


@functools.lru_cache(maxsize=None)
def configs(kv: str = "model", impl: str = "auto"):
    fields = dict(dtype="float32", kv_cache_dtype=kv, attention_impl=impl)
    return (dataclasses.replace(JAX_PRESETS["tiny-test"], **fields),
            dataclasses.replace(MODEL_PRESETS["tiny-test"], **fields))


@functools.lru_cache(maxsize=None)
def weights():
    jp = jax_init_params(configs()[0], jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), configs()[1], device="cpu")


def port_engine(kv: str = "model", impl: str = "auto", **kw) -> ServingEngine:
    for k, v in dict(KW, prefix_cache="auto").items():
        kw.setdefault(k, v)
    engine = ServingEngine(configs(kv, impl)[1], weights()[1], device="cpu", **kw)
    engine.start()
    return engine


def jax_engine(kv: str = "model", impl: str = "auto", **kw) -> JaxEngine:
    for k, v in KW.items():
        kw.setdefault(k, v)
    engine = JaxEngine(configs(kv, impl)[0], weights()[0], kv_layout="paged", **kw)
    engine.start()
    return engine


def jax_reference(prompt, opts: dict, **kw) -> list[int]:
    """The JAX engine's tokens for ``prompt`` served alone, without
    migration (prefix reuse off), on an engine built with ``kw``."""
    engine = jax_engine(prefix_cache="off", **kw)
    try:
        return engine.generate(list(prompt), JaxOptions.from_dict(opts), timeout=WAIT).tokens
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def jax_pair():
    """Two JAX engines: ``ref`` (prefix reuse off) gives a prompt's
    unmigrated greedy tokens admitted alone; ``pub`` (reuse on) exports and
    binds frames across packages."""
    ref, pub = jax_engine(prefix_cache="off"), jax_engine(prefix_cache="auto")
    yield ref, pub
    ref.stop()
    pub.stop()


@functools.lru_cache(maxsize=None)
def _solo_cache():
    return {}


def jax_solo(jax_pair, prompt, new: int = NEW) -> list[int]:
    key = (tuple(prompt), new)
    cache = _solo_cache()
    if key not in cache:
        cache[key] = jax_pair[0].generate(
            list(prompt), JaxOptions(max_new_tokens=new), timeout=WAIT
        ).tokens
    return cache[key]


def leak_assert(engine) -> None:
    """Every page in use is held by the prefix index or an active slot."""
    pool = engine._pagepool
    slot_pages = sum(len(pool.slot_pages(i)) for i in range(engine.max_batch))
    assert pool.pages_in_use <= engine._prefix_index.pages_held + slot_pages
    assert pool.free_pages + pool.pages_in_use == pool.num_pages


def page_image(engine, pages) -> list[np.ndarray]:
    return [np.stack([np_view(leaf[:, p]) for p in pages])
            for leaf in pool_leaves(engine._pagepool.dev)]


def greedy(n: int = NEW) -> GenerationOptions:
    return GenerationOptions(max_new_tokens=n, temperature=0.0)


@pytest.fixture(autouse=True)
def _clean_wire_injector():
    set_wire_injector(None)
    yield
    set_wire_injector(None)


@pytest.fixture(scope="module")
def pair():
    a, b = port_engine(), port_engine()
    yield a, b
    a.stop()
    b.stop()


# -- the migration wire between two port engines ----------------------------


def test_transfer_roundtrip_exact_and_sender_releases_on_ack(pair, jax_pair):
    a, b = pair
    prompt = prompt_for(9)
    base = a.generate(prompt, greedy(), timeout=WAIT)
    assert base.tokens == jax_solo(jax_pair, prompt)
    length, entry = a._prefix_index.deepest_entry(prompt)
    sent = page_image(a, entry.pages)
    free_b = b._pagepool.free_pages
    phases = {}
    ack = mig.transfer(a, b, prompt, phases=phases)
    assert ack["ok"] and ack["pages"] == length // 16 and ack["bytes"] > 0
    assert phases["tier"] == "device" and {"snapshot_ms", "checksum_ms", "encode_ms"} <= set(phases)
    # released on the ACK, and only then
    assert a._prefix_index.deepest_entry(prompt) is None
    pages_out = a.stats()["migrate-pages-out-total"]
    assert pages_out == b.stats()["migrate-pages-in-total"] == ack["pages"]
    assert b._pagepool.free_pages == free_b - ack["pages"]
    _, got = b._prefix_index.deepest_entry(prompt)
    assert all(np.array_equal(x, y) for x, y in zip(page_image(b, got.pages), sent))
    saved0 = b.stats()["prefill-tokens-saved-total"]
    assert b.generate(prompt, greedy(), timeout=WAIT).tokens == base.tokens
    assert b.stats()["prefill-tokens-saved-total"] > saved0
    # a second bind of a resident prefix is idempotent
    frames = mig.export_frames(b, prompt)
    assert mig.bind_frames(b, frames)["already"]
    leak_assert(a)
    leak_assert(b)


@pytest.mark.parametrize("spec,raw", [("migrate@1", False), ("migrate@1", True),
                                      ("net-cut@1", False)])
def test_drills_receiver_frees_sender_retains(pair, spec, raw):
    a, b = pair
    prompt = prompt_for(10 + raw)
    a.generate(prompt, greedy(4), timeout=WAIT)
    free_b = b._pagepool.free_pages
    in_b = b.stats()["migrate-pages-in-total"]
    set_wire_injector(FaultInjector(spec, seed=0))
    want = "checksum" if spec.startswith("migrate") else "net-cut"
    with pytest.raises(MigrationError, match=want):
        mig.bind_frames(b, mig.export_frames(a, prompt, raw=raw))
    set_wire_injector(None)
    assert b._pagepool.free_pages == free_b
    assert b.stats()["migrate-pages-in-total"] == in_b
    assert a._prefix_index.deepest_entry(prompt) is not None
    # the clean wire carries the same transfer
    assert mig.transfer(a, b, prompt)["ok"]
    leak_assert(a)
    leak_assert(b)


def test_migrate_is_deadline_bounded(pair):
    a, _ = pair
    prompt = prompt_for(12)
    a.generate(prompt, greedy(4), timeout=WAIT)
    real = a._migrate_cmd

    def wedged(kind, payload):
        time.sleep(1.0)
        return real(kind, payload)

    a._migrate_cmd = wedged
    try:
        t0 = time.monotonic()
        with pytest.raises(MigrationError, match="within"):
            a.migrate_snapshot(prompt, timeout_s=0.2)
        assert time.monotonic() - t0 < 0.8
    finally:
        del a._migrate_cmd
        time.sleep(1.1)  # let the wedged command drain off the loop


class _InFlight:
    """A stand-in for a snapshot's copy-completion event: the copies are in
    flight until ``land()``, and a caller that waits on them raises — it
    drops the reply mid-copy."""

    def __init__(self) -> None:
        self.landed = False

    def query(self) -> bool:
        return self.landed

    def synchronize(self) -> None:
        raise RuntimeError("caller dropped the snapshot mid-copy")

    def land(self) -> None:
        self.landed = True


def wait_until(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.01)


def snapshot_matches_pool(engine, prompt, snap) -> bool:
    _, entry = engine._prefix_index.deepest_entry(prompt)
    image = page_image(engine, entry.pages[: len(snap["blocks"])])
    return all(np.array_equal(img[i], np_view(blk))
               for i, page in enumerate(snap["blocks"]) for img, blk in zip(image, page))


@pytest.mark.parametrize("drop", ["raise", "timeout"])
def test_dropped_snapshot_holds_its_staging_until_the_copies_land(pair, drop):
    """A caller that raises before the copies landed, or times out before
    the engine served it: the snapshot's staging slots stay held while its
    copies may still write them, a later snapshot gets other slots and the
    right bytes, and the slots come back once the copies land."""
    a, _ = pair
    prompt = prompt_for(26)
    a.generate(prompt, greedy(4), timeout=WAIT)
    real_copies, real_cmd = a._page_copies, a._migrate_cmd
    ev = _InFlight()
    a._page_copies = lambda pages, outs: (real_copies(pages, outs), ev)[1]
    try:
        if drop == "raise":
            with pytest.raises(RuntimeError, match="mid-copy"):
                a.migrate_snapshot(prompt)
        else:
            def slow(kind, payload):
                time.sleep(0.5)
                return real_cmd(kind, payload)

            a._migrate_cmd = slow
            with pytest.raises(MigrationError, match="within"):
                a.migrate_snapshot(prompt, timeout_s=0.1)
        wait_until(lambda: a._mig_stage is not None and a._mig_stage.arena.slots_in_use == 2)
        del a._page_copies
        a.__dict__.pop("_migrate_cmd", None)
        time.sleep(0.1)  # iterations pass: the slots stay held
        assert a._mig_stage.arena.slots_in_use == 2
        snap = a.migrate_snapshot(prompt)
        assert snapshot_matches_pool(a, prompt, snap)
        assert snap["checksums"] == [page_checksum(page) for page in snap["blocks"]]
        wait_until(lambda: a._mig_stage.arena.slots_in_use == 2)
        ev.land()
        wait_until(lambda: a._mig_stage.arena.slots_in_use == 0)
    finally:
        a.__dict__.pop("_page_copies", None)
        a.__dict__.pop("_migrate_cmd", None)
        ev.land()


def test_snapshot_waits_for_staging_slots(pair):
    """A full staging holds a snapshot back — it waits, in order, until its
    caller's deadline — and serves it once slots come back."""
    a, _ = pair
    prompt = prompt_for(27)
    a.generate(prompt, greedy(4), timeout=WAIT)
    real_copies = a._page_copies
    ev = _InFlight()
    a._page_copies = lambda pages, outs: (real_copies(pages, outs), ev)[1]
    try:
        pages = a._staging().arena.num_pages
        for _ in range(pages // 2):  # 2-page snapshots fill the staging
            with pytest.raises(RuntimeError, match="mid-copy"):
                a.migrate_snapshot(prompt)
        assert a._mig_stage.arena.slots_in_use == pages
        del a._page_copies
        with pytest.raises(MigrationError, match="within"):
            a.migrate_snapshot(prompt, timeout_s=0.2)
        ev.land()
        snap = a.migrate_snapshot(prompt)
        assert snapshot_matches_pool(a, prompt, snap)
        wait_until(lambda: a._mig_stage.arena.slots_in_use == 0)
        assert not a._migrate_waiting  # the abandoned command was dropped
    finally:
        a.__dict__.pop("_page_copies", None)
        ev.land()


def test_bind_refuses_bad_frames_and_missing_prefix(pair):
    a, b = pair
    prompt = prompt_for(13)
    a.generate(prompt, greedy(4), timeout=WAIT)
    cut = [f for f in mig.export_frames(a, prompt) if f["kind"] != "page"]
    for seq, f in enumerate(cut):
        f["seq"] = seq
    free_b = b._pagepool.free_pages
    with pytest.raises(MigrationError, match="count"):
        mig.bind_frames(b, iter(cut))
    assert b._pagepool.free_pages == free_b
    assert a._prefix_index.deepest_entry(prompt) is not None
    # a page payload outside the base64 alphabet is refused before any bind
    bad = list(mig.export_frames(a, prompt))
    bad[1]["data"][0] = "!" + bad[1]["data"][0][1:]
    with pytest.raises(MigrationError, match="undecodable"):
        mig.bind_frames(b, iter(bad))
    assert b._pagepool.free_pages == free_b
    with pytest.raises(MigrationError, match="no published prefix"):
        mig.transfer(a, b, [1, 2, 3, 4])
    # not a boundary of the receiver: refused before anything is allocated
    with pytest.raises(MigrationError, match="boundary"):
        b.migrate_bind(prompt, 24, [])
    assert b._pagepool.free_pages == free_b


def test_dense_engine_refuses_migration():
    engine = ServingEngine(configs()[1], weights()[1], device="cpu", kv_layout="dense", **KW)
    with pytest.raises(MigrationError, match="paged"):
        engine.migrate_snapshot(prompt_for(3))
    assert engine.migrate_limits() == {}


def test_hibernated_session_migrates_from_host_arena(pair, jax_pair):
    _, b = pair
    a = port_engine(host_kv_fraction=2.0, spill_idle_s=0.0)
    try:
        prompt = prompt_for(16)
        a.generate(prompt, greedy(), timeout=WAIT)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            hit = a._prefix_index.deepest_entry(prompt)
            if hit is not None and hit[1].host and hit[1].spilling is None:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the prefix never spilled to the host arena")
        entry = hit[1]
        arena = [np.stack([np_view(blk) for blk in blocks]) for blocks in zip(
            *[a._host_tier.blocks(s) for s in entry.host])]
        restores0 = a.stats()["restore-pages-total"]
        phases = {}
        ack = mig.transfer(a, b, prompt, phases=phases)
        assert ack["ok"] and phases["tier"] == "host"
        assert a.stats()["restore-pages-total"] == restores0
        _, got = b._prefix_index.deepest_entry(prompt)
        assert all(np.array_equal(x, y) for x, y in zip(page_image(b, got.pages), arena))
        assert b.generate(prompt, greedy(), timeout=WAIT).tokens == jax_solo(jax_pair, prompt)
        leak_assert(b)
    finally:
        a.stop()


def test_int8_speculative_roundtrip():
    kw = dict(kv="int8", impl="jnp", speculation="auto", speculation_tokens=4)
    prompt = prompt_for(17)
    want = jax_reference(prompt, {"max-tokens": NEW, "temperature": 0.0}, **kw)
    a, b = port_engine(**kw), port_engine(**kw)
    try:
        base = a.generate(prompt, greedy(), timeout=WAIT)
        assert base.tokens == want
        _, entry = a._prefix_index.deepest_entry(prompt)
        sent = page_image(a, entry.pages)
        ack = mig.transfer(a, b, prompt)
        assert ack["ok"] and ack["bytes"] == ack["pages"] * a._pagepool.bytes_per_page
        _, got = b._prefix_index.deepest_entry(prompt)
        assert all(np.array_equal(x, y) for x, y in zip(page_image(b, got.pages), sent))
        saved0 = b.stats()["prefill-tokens-saved-total"]
        assert b.generate(prompt, greedy(), timeout=WAIT).tokens == want
        assert b.stats()["prefill-tokens-saved-total"] > saved0
        assert b.stats()["spec-verify-dispatches-total"] > 0
        leak_assert(a)
        leak_assert(b)
    finally:
        a.stop()
        b.stop()


def test_engine_migrate_out_to_a_local_replica(pair):
    a, b = pair
    prompt = prompt_for(20)
    a.generate(prompt, greedy(4), timeout=WAIT)
    fleet.register_local(
        "b", lambda: {}, migrate_bind_fn=lambda frames, t: fleet.engine_migrate_bind(b, frames, t))
    try:
        # a receiver in another process is pushed to over HTTP: nothing
        # listens here, so the push fails and the sender keeps its copy
        with pytest.raises(MigrationError, match="migration push to http://127.0.0.1:9"):
            fleet.engine_migrate_out(a, {"prompt_tokens": prompt, "dest": "http://127.0.0.1:9"})
        assert a._prefix_index.deepest_entry(prompt) is not None
        ack = fleet.engine_migrate_out(a, {"prompt_tokens": prompt, "dest": "local:b"})
        assert ack["ok"] and "snapshot_ms" in ack["phases"]
        assert a._prefix_index.deepest_entry(prompt) is None
        assert b._prefix_index.deepest_entry(prompt) is not None
    finally:
        fleet.unregister_local("b")


# -- the process registry, held against the JAX package's -------------------


def _outcome(fn, *args):
    """What one call gives: its value, or its error's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("err", type(e).__name__, str(e))


def _untimed(x):
    """``x`` without the keys that carry wall time."""
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items()
                if k not in ("at", "ttft_s", "total_s") and not k.endswith("_ms")}
    if isinstance(x, (list, tuple)):
        return type(x)(_untimed(v) for v in x)
    return x


def _register_engine(mod, rid, eng, **over):
    fns = dict(
        beacon_fn=lambda: fleet.beacon_from_engine(rid, eng, url=f"local:{rid}"),
        generate_fn=lambda p: fleet.engine_generate(eng, p),
        generate_stream_fn=lambda p: fleet.engine_generate_stream(eng, p),
        migrate_bind_fn=lambda frames, t: fleet.engine_migrate_bind(eng, frames, t),
        migrate_out_fn=lambda p: fleet.engine_migrate_out(eng, p),
        recovering_fn=lambda: eng.recovering,
        migrate_pages_fn=lambda p: fleet.engine_migrate_pages(eng, p),
        migrate_limits_fn=eng.migrate_limits,
        restoring_fn=lambda: eng.restoring,
    )
    fns.update(over)
    mod.register_local(rid, **fns)


def _digest_checked(ack: dict, prompt) -> dict:
    """``ack`` with its digest (of a prompt a run of its own) checked."""
    return dict(ack, digest=ack["digest"] == prefix_digest(prompt[: ack["length"]]))


def _boom():
    raise RuntimeError("probe failed")


class _StubRouter:
    def prefetch(self, tokens, session_id=None, adapter=None, tenant=None):
        return {"tokens": list(tokens), "session": session_id, "adapter": adapter,
                "tenant": tenant}


def _case_recovering(mod, a, b, k):
    out = [mod.local_recovering()]
    mod.register_local("c", dict, recovering_fn=_boom)
    out.append(mod.local_recovering())
    mod.register_local("d", dict, recovering_fn=lambda: True)
    return out + [mod.local_recovering()]


def _case_restoring(mod, a, b, k):
    out = [mod.local_restoring()]
    mod.register_local("c", dict, restoring_fn=_boom)
    out.append(mod.local_restoring())
    mod.register_local("d", dict, restoring_fn=lambda: True)
    return out + [mod.local_restoring()]


def _case_state(mod, a, b, k):
    mod.register_local("c", _boom)
    return _untimed(mod.local_state())


GEN = {"prompt_tokens": prompt_for(41), "options": {"max-tokens": 4, "temperature": 0.0}}


def _case_generate(mod, a, b, k):
    out = [_untimed(_outcome(mod.local_generate, GEN))]
    out.append(_outcome(mod.local_generate, {"options": {}}))
    mod.unregister_local("a")
    mod.unregister_local("b")
    out.append(_outcome(mod.local_generate, GEN))
    mod.register_local("c", dict)
    return out + [_outcome(mod.local_generate, GEN)]


def _case_generate_stream(mod, a, b, k):
    out = [_untimed(list(mod.local_generate_stream(GEN)))]
    mod.unregister_local("a")
    mod.unregister_local("b")
    out.append(_outcome(mod.local_generate_stream, GEN))
    mod.register_local("c", dict, generate_fn=lambda p: fleet.engine_generate(a, p))
    out.append(_untimed(list(mod.local_generate_stream(GEN))))  # one result, as frames
    mod.register_local("c", dict)
    return out + [_outcome(mod.local_generate_stream, GEN)]


def _case_migrate_bind(mod, a, b, k):
    prompt = prompt_for(42 + k)  # a prompt a run of its own
    a.generate(prompt, greedy(2), timeout=WAIT)
    mod.unregister_local("a")  # "b" answers
    ack = mod.local_migrate_bind(mig.export_frames(a, prompt))
    out = [_untimed(_digest_checked(ack, prompt)), b._prefix_index.deepest_entry(prompt)[0]]
    mod.unregister_local("b")
    out.append(_outcome(mod.local_migrate_bind, iter(())))
    mod.register_local("c", dict)
    return out + [_outcome(mod.local_migrate_bind, iter(()))]


def _case_migrate_out(mod, a, b, k):
    prompt = prompt_for(44 + k)
    a.generate(prompt, greedy(2), timeout=WAIT)
    out = [_outcome(mod.local_migrate_out, {"prompt_tokens": prompt, "dest": "http://peer:1"})]
    ack = mod.local_migrate_out({"prompt_tokens": prompt, "dest": "local:b"})
    out += [_untimed(_digest_checked(ack, prompt)), a._prefix_index.deepest_entry(prompt),
            b._prefix_index.deepest_entry(prompt)[0]]
    mod.unregister_local("a")
    mod.unregister_local("b")
    mod.register_local("c", dict)
    return out + [_outcome(mod.local_migrate_out, {"prompt_tokens": prompt})]


def _case_migrate_pages(mod, a, b, k):
    prompt = prompt_for(46)
    a.generate(prompt, greedy(2), timeout=WAIT)
    out = [list(mod.local_migrate_pages({"prompt_tokens": prompt, "wire": wire}))
           for wire in ("v1", "v2")]
    out.append(_outcome(mod.local_migrate_pages, {"prompt_tokens": [1, 2, 3]}))
    out.append(a._prefix_index.deepest_entry(prompt)[0])  # a fetch copies
    mod.unregister_local("a")
    mod.unregister_local("b")
    mod.register_local("c", dict)
    return out + [_outcome(mod.local_migrate_pages, {"prompt_tokens": prompt})]


def _case_p2p_fetch(mod, a, b, k):
    mod.register_local("a", dict, p2p_fetch_fn=lambda p: {"ok": True, "payload": p})
    out = [mod.local_p2p_fetch({"source": "b", "prompt_tokens": [1, 2]})]
    mod.register_local("a", dict)
    out.append(_outcome(mod.local_p2p_fetch, {}))
    mod.unregister_local("a")
    mod.unregister_local("b")
    return out + [_outcome(mod.local_p2p_fetch, {})]


def _case_prefetch(mod, a, b, k):
    out = [_outcome(mod.local_prefetch, {"prompt_tokens": [1]})]
    mod.register_local_router(_StubRouter())
    out.append(mod.local_prefetch({"prompt_tokens": [1, 2], "session": "s", "tenant": "t"}))
    out.append(mod.local_prefetch({"prompt_tokens": [3], "adapter": "x", "session": ""}))
    out.append(_outcome(mod.local_prefetch, {"prompt_tokens": ["1"]}))
    out.append(_outcome(mod.local_prefetch, {}))
    mod.unregister_local_router()
    return out + [_outcome(mod.local_prefetch, {"prompt_tokens": [1]})]


def _case_migrate_limits(mod, a, b, k):
    out = [mod.local_migrate_limits()]
    mod.unregister_local("a")
    mod.unregister_local("b")
    mod.register_local("c", dict, migrate_limits_fn=_boom)
    out.append(mod.local_migrate_limits())
    mod.register_local("c", dict)
    out.append(mod.local_migrate_limits())
    mod.unregister_local("c")
    return out + [mod.local_migrate_limits()]


def _case_reset(mod, a, b, k):
    calls = []
    mod.register_local("a", dict, reset_fn=lambda: calls.append("a"))
    mod.register_local("c", dict, reset_fn=lambda: calls.append("c"))
    mod.local_reset()
    return calls


REGISTRY_CASES = {
    "local_recovering": _case_recovering,
    "local_restoring": _case_restoring,
    "local_state": _case_state,
    "local_generate": _case_generate,
    "local_generate_stream": _case_generate_stream,
    "local_migrate_bind": _case_migrate_bind,
    "local_migrate_out": _case_migrate_out,
    "local_migrate_pages": _case_migrate_pages,
    "local_p2p_fetch": _case_p2p_fetch,
    "local_prefetch": _case_prefetch,
    "local_migrate_limits": _case_migrate_limits,
    "local_reset": _case_reset,
}


@pytest.mark.parametrize("name", sorted(REGISTRY_CASES))
def test_process_registry_matches_jax(pair, monkeypatch, name):
    """Each of the process registry's calls — what a runtime server's
    ``/state`` and ``/fleet/*`` handlers read — gives what the JAX
    package's gives with the same port engines registered: the same values,
    the same errors, the same fallbacks."""
    a, b = pair
    got = []
    for k, mod in enumerate((fleet, jfleet)):
        # engine_migrate_out finds its destination in the port's registry
        for m in (fleet, mod):
            monkeypatch.setattr(m, "_LOCAL", {})
            monkeypatch.setattr(m, "_LOCAL_ROUTER", None)
        for m in {fleet, mod}:
            _register_engine(m, "a", a)
            _register_engine(m, "b", b)
        got.append(REGISTRY_CASES[name](mod, a, b, k))
    assert got[0] == got[1]
    leak_assert(a)
    leak_assert(b)


def test_cancel_key_cancels_through_the_registry(pair):
    a, _ = pair
    frames = fleet.engine_generate_stream(
        a, {"prompt_tokens": prompt_for(21), "options": {"max-tokens": 120, "cancel-key": "s1"}})
    assert lifecycle.active_keys() == ["s1"]
    assert lifecycle.cancel("s1") == 1
    got = list(frames)
    assert got[-1]["kind"] == "end" and got[-1]["finish_reason"] == "cancelled"
    assert lifecycle.active_keys() == []


def test_memory_plan_migrate_staging_term():
    cfg = configs()[1]
    base = plan_serving_memory(cfg, 2, 128, kv_layout="paged", page_size=16)
    plan = plan_serving_memory(cfg, 2, 128, kv_layout="paged", page_size=16, migrate_staging=True)
    page = base.page_pool_bytes // (2 * 8 + 1)  # 2 slots x 8 pages and the sink
    assert plan.migrate_staging_bytes == 8 * page  # one slot's 128 / 16 pages
    assert plan.total_bytes == base.total_bytes  # host RAM, outside the device total
    assert "migrate staging" in plan.summary()


# -- the router over in-process engines ---------------------------------------


@pytest.fixture(scope="module")
def roles():
    pe, de = port_engine(migrate_staging=True), port_engine()
    yield pe, de
    pe.stop()
    de.stop()


def role_router(pe, de, **kw):
    kw.setdefault("prefill_route_threshold", 8)
    kw.setdefault("refresh_interval_s", 3600.0)
    router = FleetRouter(
        [InProcessReplica("pre", pe, role="prefill"), InProcessReplica("dec", de, role="decode")],
        **kw,
    )
    router.refresh_all()
    return router


def drain(router, prompt, opts, session_id=None):
    frames = list(router.stream_generate(prompt, opts, session_id=session_id))
    toks = [t for f in frames if f["kind"] == "tokens" for t in f["tokens"]]
    assert [f["seq"] for f in frames] == list(range(len(frames)))
    assert frames[-1]["kind"] == "end"
    return frames, toks, frames[-1]


def test_disagg_handoff_token_exact_against_jax(roles, jax_pair):
    pe, de = roles
    prompt = prompt_for(14)
    router = role_router(pe, de)
    opts = {"max-tokens": 8, "temperature": 0.0}
    frames, toks, end = drain(router, prompt, opts, session_id="sess")
    assert toks == jax_solo(jax_pair, prompt, 8)
    assert {f["replica"] for f in frames if f["kind"] == "tokens"} == {"pre", "dec"}
    assert end["replica"] == "dec" and end["failovers"] == 0
    st = router.stats()
    assert st["fleet-migrations-total"] == 1 and st["fleet-migrate-fallbacks-total"] == 0
    assert st["fleet-routed-prefill-total"] == 1 and st["fleet-migrate-pages-total"] == 2
    assert st["histograms"]["fleet_migrate_s"]["count"] == 1
    # the sticky repoint: the next turn routes to where the KV now lives
    d = router.route(prompt + toks, session_id="sess")
    assert d.replica_id == "dec" and d.kind == "sticky"
    assert pe.stats()["migrate-pages-out-total"] == de.stats()["migrate-pages-in-total"] == 2
    assert pe._prefix_index.deepest_entry(prompt) is None
    assert de.stats()["prefill-tokens-saved-total"] > 0
    assert pe.stats()["engine-restarts-total"] == de.stats()["engine-restarts-total"] == 0
    leak_assert(pe)
    leak_assert(de)
    # the prefill replica's plan carries one slot's staging, host RAM
    assert pe.memory_plan.migrate_staging_bytes == 8 * pe._pagepool.bytes_per_page
    assert de.memory_plan.migrate_staging_bytes == 0


@pytest.mark.parametrize("spec", ["migrate@1", "net-cut@1"])
def test_disagg_drills_decode_in_place(roles, jax_pair, spec):
    pe, de = roles
    prompt = prompt_for(15 if spec == "migrate@1" else 19)
    router = role_router(pe, de)
    dumps0 = len([d for d in recent_dumps() if d.get("reason") == "migrate-failed"])
    free_de = de._pagepool.free_pages
    in_de = de.stats()["migrate-pages-in-total"]
    set_wire_injector(FaultInjector(spec, seed=0))
    frames, toks, _ = drain(router, prompt, {"max-tokens": 8, "temperature": 0.0})
    set_wire_injector(None)
    assert toks == jax_solo(jax_pair, prompt, 8)
    assert {f["replica"] for f in frames if f["kind"] == "tokens"} == {"pre"}
    st = router.stats()
    assert st["fleet-migrations-total"] == 0 and st["fleet-migrate-fallbacks-total"] == 1
    assert de._pagepool.free_pages == free_de
    assert de.stats()["migrate-pages-in-total"] == in_de
    assert pe._prefix_index.deepest_entry(prompt) is not None
    leak_assert(pe)
    leak_assert(de)
    dumps = [d for d in recent_dumps() if d.get("reason") == "migrate-failed"]
    assert len(dumps) == dumps0 + 1
    assert validate_flight_dump(dumps[-1])
    assert dumps[-1]["extra"]["fallback"] == "decode-in-place"


def test_p2p_fetch_admits_warm_and_the_owner_keeps_its_pages(pair, jax_pair):
    a, b = pair
    preamble = prompt_for(30, 32)
    a.generate(preamble + [7, 8, 9], greedy(2), timeout=WAIT)
    prompt = preamble + [11, 12, 13, 14, 15]
    router = FleetRouter([InProcessReplica("a", a), InProcessReplica("b", b)],
                         refresh_interval_s=3600.0, p2p_threshold=16, lam=256.0)
    router.refresh_all()
    # "a" holds the preamble but is made the worse route by its load: one
    # unit above "b"'s (32 tokens of affinity are worth 32 / 256 of it)
    with router._lock:
        other = router._replicas["b"].beacon["load_score"]
        router._replicas["a"].beacon["load_score"] = other + 1.0
    saved0 = b.stats()["prefill-tokens-saved-total"]
    frames, toks, end = drain(router, prompt, {"max-tokens": NEW, "temperature": 0.0})
    assert end["replica"] == "b"
    assert toks == jax_solo(jax_pair, prompt)
    st = router.stats()
    assert st["fleet-p2p-fetch-total"] == 1 and st["fleet-p2p-fetch-fallback-total"] == 0
    assert st["fleet-p2p-bytes-in-total"] == 2 * a._pagepool.bytes_per_page
    assert b.stats()["prefill-tokens-saved-total"] - saved0 == 32
    assert a._prefix_index.deepest_entry(prompt) is not None  # a fetch copies
    leak_assert(a)
    leak_assert(b)


def test_p2p_fetch_failures_fall_back_to_a_cold_prefill(pair, jax_pair):
    """Every failed P2P fetch — a page corrupted on the wire (``migrate@1``:
    its checksum fails), the wire cut mid-fetch (``net-cut@1``), an owner
    that left the fleet between route and fetch — counts one fallback and
    dumps ``p2p-fetch-failed`` (a valid dump, no token content), and the
    request prefills cold with the JAX engine's tokens; no restart, no page
    leaked on either side (JAX's ``tests/test_wire_v2.py`` drill)."""
    a, b = pair
    restarts0 = (a.stats()["engine-restarts-total"], b.stats()["engine-restarts-total"])
    router = FleetRouter([InProcessReplica("a", a), InProcessReplica("b", b)],
                         refresh_interval_s=3600.0, p2p_threshold=16, lam=256.0,
                         fail_cooldown_s=3600.0)

    def reroute(prompt):
        # "a" publishes the prefix, then reads as loaded: the route lands
        # on "b", the miss replica, with "a" as the page source
        router.refresh_all()
        with router._lock:
            other = router._replicas["b"].beacon["load_score"]
            router._replicas["a"].beacon["load_score"] = other + 1.0
        d = router.route(prompt)
        assert (d.replica_id, d.p2p_source) == ("b", "a"), d

    for n, (spec, error) in enumerate((("migrate@1", "checksum"), ("net-cut@1", "net-cut")),
                                      start=1):
        preamble = prompt_for(70 + n, 32)  # a preamble no other test serves
        prompt = preamble + [11, 12, 13, 14, 15]
        a.generate(preamble + [7, 8, 9], greedy(2), timeout=WAIT)
        reroute(prompt)
        saved0 = b.stats()["prefill-tokens-saved-total"]
        set_wire_injector(FaultInjector(spec, seed=0))
        try:
            frames, toks, end = drain(router, prompt, {"max-tokens": NEW, "temperature": 0.0})
        finally:
            set_wire_injector(None)
        assert end["replica"] == "b"
        assert toks == jax_solo(jax_pair, prompt), f"{spec}: the cold fallback diverged"
        assert b.stats()["prefill-tokens-saved-total"] == saved0  # cold, not warm
        assert router.p2p_fetch_fallback_total == n and router.p2p_fetch_total == 0
        dump = router._flight.last_dump
        assert dump is not None and dump["reason"] == "p2p-fetch-failed"
        assert validate_flight_dump(dump)
        assert error in dump["extra"]["error"], dump["extra"]
        assert dump["extra"]["fallback"] == "local-cold-prefill"
        assert (dump["extra"]["src"], dump["extra"]["dst"]) == ("a", "b")
        assert "tokens" not in dump["extra"]
        assert a._prefix_index.deepest_entry(prompt) is not None  # the owner keeps its pages
    decision = RouteDecision(
        replica_id="b", handle=router._replicas["b"].handle, kind="balanced",
        expected_match=0, score=0.0, p2p_source="ghost", p2p_match=32,
    )
    assert router._p2p_fetch(decision, prompt) is False
    assert router.p2p_fetch_fallback_total == 3
    assert "ghost" in router._flight.last_dump["extra"]["error"]
    st = router.stats()
    assert st["fleet-p2p-fetch-fallback-total"] == 3 and st["fleet-p2p-fetch-total"] == 0
    assert (a.stats()["engine-restarts-total"], b.stats()["engine-restarts-total"]) == restarts0
    leak_assert(a)
    leak_assert(b)


class _DiesAfterFrames(InProcessReplica):
    """A replica whose stream dies at the first frame boundary once
    ``fail_after`` tokens flowed (``strip_state``: its frames carry no DFA
    state, as a legacy peer's)."""

    def __init__(self, *a, fail_after=3, strip_state=False, **k):
        super().__init__(*a, **k)
        self.fail_after = fail_after
        self.strip_state = strip_state

    def generate_stream(self, tokens, options=None, timeout_s=None):
        inner = super().generate_stream(tokens, options, timeout_s)

        def wrap():
            n = 0
            try:
                for f in inner:
                    if f.get("kind") == "tokens":
                        n += len(f["tokens"])
                        if self.strip_state:
                            f = {k: v for k, v in f.items() if k != "dfa_state"}
                    yield f
                    if n >= self.fail_after:
                        raise ReplicaError("injected mid-stream death")
            finally:
                inner.close()

        return wrap()


RF = {"type": "regex", "regex": "[ab]{6}x"}


def constrained_engine() -> ServingEngine:
    return port_engine(grammar_tokenizer=TOK, eos_token_id=TOK.eos_token_id, decode_chunk=2)


@pytest.fixture(scope="module")
def constrained():
    engines = [constrained_engine() for _ in range(2)]
    yield engines
    for e in engines:
        e.stop()


def test_constrained_stream_resumes_mid_derivation(constrained):
    a, b = constrained
    opts = {"max-tokens": 16, "temperature": 0.0, "response-format": RF}
    want = jax_reference(prompt_for(18), opts, grammar_tokenizer=JaxByteTokenizer(),
                         eos_token_id=TOK.eos_token_id, decode_chunk=2)
    # this run also publishes the prompt's prefix on "a", which the route
    # then prefers: the stream starts there and dies. The route scores
    # affinity alone (lam 0): with the default weight of the measured load,
    # a queue-wait p90 of 0.125 s or more on "a" from this run (a loaded
    # host) outweighs the 32-token prefix match and the stream starts on
    # "b", which never dies
    base = a.generate(prompt_for(18), GenerationOptions.from_dict(opts), timeout=WAIT)
    assert base.tokens == want
    router = FleetRouter([_DiesAfterFrames("a", a, fail_after=3), InProcessReplica("b", b)],
                         refresh_interval_s=3600.0, lam=0.0)
    router.refresh_all()
    frames, toks, end = drain(router, prompt_for(18), opts)
    assert toks == want
    assert end["finish_reason"] == "stop" and end["failovers"] == 1
    served = [f["replica"] for f in frames if f["kind"] == "tokens"]
    assert served[0] == "a" and served[-1] == "b"
    assert re.fullmatch(RF["regex"], TOK.decode(toks))


def test_constrained_stream_refuses_without_state(constrained):
    a, b = constrained
    # no replica holds this prompt's prefix, so an affinity route would
    # balance on the replicas' measured queue waits: round-robin starts the
    # stream on "a", the replica that dies, every time
    router = FleetRouter(
        [_DiesAfterFrames("a", a, fail_after=3, strip_state=True), InProcessReplica("b", b)],
        refresh_interval_s=3600.0, policy="round-robin",
    )
    router.refresh_all()
    opts = {"max-tokens": 16, "temperature": 0.0, "response-format": RF}
    with pytest.raises(ReplicaError, match="no DFA state"):
        list(router.stream_generate(prompt_for(19), opts))


# -- across packages ----------------------------------------------------------


def _checksums_agree(frames: list) -> None:
    """Both packages' ``page_checksum`` of each page frame's blocks equal
    the frame's stamp."""
    for f in frames:
        if f["kind"] != "page":
            continue
        if f.get("raw") is not None:
            blocks = [np.frombuffer(f["raw"], np.uint8)]
        else:
            blocks = [np.frombuffer(base64.b64decode(d), np.uint8) for d in f["data"]]
        assert jpp.page_checksum(blocks).hex() == page_checksum(blocks).hex() == f["checksum"]


@pytest.mark.parametrize("raw", [False, True], ids=["v1", "v2"])
def test_jax_frames_bind_into_a_port_engine(pair, jax_pair, raw):
    _, b = pair
    pub = jax_pair[1]
    prompt = prompt_for(22 + raw)
    want = jax_solo(jax_pair, prompt)
    assert pub.generate(prompt, JaxOptions(max_new_tokens=NEW), timeout=WAIT).tokens == want
    frames = list(jmig.export_frames(pub, prompt, raw=raw))
    _checksums_agree(frames)
    ack = mig.bind_frames(b, iter(frames))
    assert ack["ok"] and ack["pages"] == 2
    saved0 = b.stats()["prefill-tokens-saved-total"]
    assert b.generate(prompt, greedy(), timeout=WAIT).tokens == want
    assert b.stats()["prefill-tokens-saved-total"] - saved0 == 32
    leak_assert(b)


@pytest.mark.parametrize("raw", [False, True], ids=["v1", "v2"])
def test_port_frames_bind_into_a_jax_engine(pair, jax_pair, raw):
    a, _ = pair
    pub = jax_pair[1]
    prompt = prompt_for(24 + raw)
    want = jax_solo(jax_pair, prompt)
    assert a.generate(prompt, greedy(), timeout=WAIT).tokens == want
    frames = list(mig.export_frames(a, prompt, raw=raw))
    _checksums_agree(frames)
    ack = jmig.bind_frames(pub, iter(frames))
    assert ack["ok"] and ack["pages"] == 2
    saved0 = pub.stats()["prefill-tokens-saved-total"]
    assert pub.generate(prompt, JaxOptions(max_new_tokens=NEW), timeout=WAIT).tokens == want
    assert pub.stats()["prefill-tokens-saved-total"] - saved0 == 32
