"""Prefix KV reuse on the port's paged pool against the JAX package, on the
CPU (tiny-test, f32 unless stated).

- The host half: ``PagePool`` and ``PrefixPageIndex`` of the port and of
  ``langstream_tpu/serving/pagepool.py`` take the same operations (publish,
  alias, free the publisher, evict pinned and unpinned, ``evict_for`` under
  pressure, ``evict_touching``, ``reset``) and must agree on every table,
  refcount, free list, live entry and counter after each one; ``page_copy``
  equals the JAX engine's ``_page_copy`` on both KV dtypes.
- The engine: the port's paged ``ServingEngine`` and the JAX paged engine,
  both with ``prefix_cache="auto"``, serve the same prompts on the same
  weights (through ``bridge``): greedy tokens equal to JAX's and to the
  port's own reuse-off run, and the prefix stats equal JAX's — short path
  with pure-alias hits (page 16) and copy-on-write hits (page 64), int8 KV
  (prompts of 16 tokens or fewer, "jnp" on both sides, page 8 so both
  hits occur), the long path, pool pressure, and tiny-moe-test (every
  request submitted before ``start()``); the short path with speculation
  on both engines (spec stats equal too).
- Quarantine and restart: a publisher hit by the ``nan`` or ``page`` fault
  site loses its entries and a later request with its preamble is admitted
  cold; a decode crash leaves the index empty with cumulative counters.
- The provider's ``prefix-cache`` keys.
"""

import asyncio
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.models.transformer import make_page_pool as jax_make_page_pool
from langstream_tpu.serving import pagepool as jpp
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.engine import _page_copy as jax_page_copy
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
from langstream_tpu_torch.serving import pagepool as tpp
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault

WAIT = 120.0
V = MODEL_PRESETS["tiny-test"].vocab_size
# the prefix stats both engines report, with the JAX engine's meaning
PREFIX_KEYS = (
    "prefix-cache", "prefix-cache-hit-rate", "prefill-tokens-saved-total",
    "prefix-copy-bytes-saved-total", "prefix-pool-bytes-in-use",
    "prefix-cache-evictions-total", "prefix-cache-entries", "kv-page-alias-rate",
    "kv-bytes-per-page", "kv-pages-total", "kv-pages-in-use",
)


@functools.lru_cache(maxsize=None)
def configs(preset: str = "tiny-test", kv: str = "model"):
    """(JAX, port) configs in f32; int8 KV runs the reference attention on
    both sides (the JAX package's CPU "auto" path quantizes q and p)."""
    fields = dict(dtype="float32", kv_cache_dtype=kv)
    if kv == "int8":
        fields["attention_impl"] = "jnp"
    return (
        dataclasses.replace(JAX_PRESETS[preset], **fields),
        dataclasses.replace(MODEL_PRESETS[preset], **fields),
    )


@functools.lru_cache(maxsize=None)
def weights(preset: str = "tiny-test"):
    jcfg, tcfg = configs(preset)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def ramp(n: int, a: int = 7, b: int = 3) -> list[int]:
    return [(a + b * i) % V for i in range(n)]


def jax_engine(preset="tiny-test", kv="model", prefix="auto", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    return JaxEngine(configs(preset, kv)[0], weights(preset)[0], kv_layout="paged",
                     prefix_cache=prefix, **kw)


def port_engine(preset="tiny-test", kv="model", prefix="auto", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    return ServingEngine(configs(preset, kv)[1], weights(preset)[1], device="cpu",
                         prefix_cache=prefix, **kw)


def serve_in_turn(engine, prompts, new: int, jax_side: bool):
    """Each prompt generated to its end before the next is submitted."""
    opts = (JaxOptions if jax_side else GenerationOptions)(max_new_tokens=new, temperature=0.0)
    engine.start()
    try:
        tokens = [engine.generate(list(p), opts, timeout=WAIT).tokens for p in prompts]
        stats = engine.stats()
    finally:
        engine.stop()
    return tokens, stats


def prefix_stats(stats: dict) -> dict:
    return {k: stats[k] for k in PREFIX_KEYS}


# -- the host half -------------------------------------------------------------


def _snapshot(pool, index) -> dict:
    return {
        "tables": pool.tables.tolist(),
        "refs": pool._refs.tolist(),
        "free": list(pool._free),
        "shared": pool.shared_pages,
        "aliased": (pool.reserved_pages_total, pool.aliased_pages_total),
        "live": sorted((e.length, e.pages, e.pins) for e in index._live),
        "held": index.pages_held,
        "counters": (index.lookups, index.hits, index.evictions, index.hit_rate()),
    }


def _alias_ops(m, pool, index, log):
    """test_pagepool.py::test_alias_refcount_semantics, step by step, then a
    copy-on-write candidate."""
    toks = list(range(40))
    log("reserve", pool.reserve(0, 3))
    entry = index.insert(pool, toks, 32, tuple(pool.slot_pages(0)[:2]))
    log("insert", entry.pages)
    log("free publisher", sorted(pool.free_slot(0)))
    cands = index.candidates(toks)
    log("candidates", [(p, e.pages) for p, e in cands])
    log("alias", pool.reserve(1, 3, shared=tuple(entry.pages)))
    index.record_lookup(entry)
    index.acquire(entry)
    log("evict pinned", index.evict_lru(pool))
    index.release(entry)
    log("evict unpinned", index.evict_lru(pool))
    log("free reader", sorted(pool.free_slot(1)))
    # a 24-token prefix on 16-token pages: one page aliased, one copied
    log("reserve 2", pool.reserve(2, 2))
    entry = index.insert(pool, toks[:30], 16, tuple(pool.slot_pages(2)[:1]))
    log("match", (index.match_len(toks[:30]), index.match_len(toks[:10]), index.has(toks, 16)))
    log("cow", pool.reserve(3, 3, shared=()))
    index.record_lookup(None)


def _pressure_ops(m, pool, index, log):
    """The entry cap, ``evict_for`` under pressure, ``evict_touching`` and
    ``reset``."""
    prompts = [[k * 50 + i for i in range(20)] for k in range(4)]
    for slot, toks in enumerate(prompts[:3]):
        got = pool.reserve(slot, 2)
        entry = index.insert(pool, toks, 16, tuple(pool.slot_pages(slot)[:2]))
        log(f"publish {slot}", (got, entry.pages if entry else None))
        pool.free_slot(slot)
    log("cap evicted", index.evictions)
    log("evict_for 5", index.evict_for(pool, 5))
    log("evict_for 9", index.evict_for(pool, 9))
    pool.reserve(0, 2)
    a = index.insert(pool, prompts[3], 16, tuple(pool.slot_pages(0)))
    b = index.insert(pool, prompts[3], 8, tuple(pool.slot_pages(0)[:1]))
    pool.reserve(1, 3, shared=a.pages[:1])
    index.record_lookup(b)
    log("touching", index.evict_touching(pool, pool.slot_pages(1)))
    pool.free_slot(1)
    pool.reserve(1, 2)
    index.insert(pool, prompts[0], 16, tuple(pool.slot_pages(1)))
    index.reset()
    pool.reset()
    log("reset", (index.live_entries, index.pages_held, pool.free_pages))


@pytest.mark.parametrize("ops,pool_kw,index_kw", [
    (_alias_ops, dict(num_pages=8, page_size=16, max_batch=4, max_seq_len=64),
     dict(boundaries=(16, 32), max_entries=4)),
    (_pressure_ops, dict(num_pages=8, page_size=8, max_batch=4, max_seq_len=32),
     dict(boundaries=(8, 16), max_entries=2)),
], ids=["alias-refcount-cow", "cap-evict-for-touching-reset"])
def test_pool_and_index_match_jax(ops, pool_kw, index_kw):
    jcfg, tcfg = configs()
    logs = {}
    for side, m, cfg, extra in (("jax", jpp, jcfg, {}), ("port", tpp, tcfg, {"device": "cpu"})):
        pool = m.PagePool(cfg, **pool_kw, **extra)
        index = m.PrefixPageIndex(**index_kw)
        out = []

        def log(what, value, pool=pool, index=index, out=out):
            out.append((what, value, _snapshot(pool, index)))

        ops(m, pool, index, log)
        logs[side] = out
    assert len(logs["port"]) == len(logs["jax"])
    for got, want in zip(logs["port"], logs["jax"]):
        assert got == want, got[0]


def test_pages_for_fraction_and_digest_match_jax():
    for args in ((4, 128, 64), (4, 128, 64, 0.25), (3, 100, 16, 0.1)):
        assert tpp.pages_for_fraction(*args) == jpp.pages_for_fraction(*args)
    toks = ramp(40)
    assert tpp.prefix_digest(toks) == jpp.prefix_digest(toks)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_page_copy_matches_jax(kv):
    """One page across every layer, head and leaf, in place; a destination
    at the sentinel copies into the sink only (JAX drops it)."""
    jcfg, tcfg = configs(kv=kv)
    pages, ps = 5, 8
    jpool = jax_make_page_pool(jcfg, pages, ps)
    tpool = ttf.make_page_pool(tcfg, pages, ps, device="cpu")
    rng = np.random.default_rng(1)

    def fill(j, t):
        if isinstance(t, dict):
            return {k: fill(j[k], t[k]) for k in t}
        a = np.asarray(j)
        a = (rng.integers(-127, 128, a.shape) if a.dtype == np.int8
             else rng.standard_normal(a.shape)).astype(a.dtype)
        t[:, :pages] = torch.from_numpy(a)
        t[:, pages] = torch.from_numpy(a[:, 2])  # the sink holds another page
        return jnp.asarray(a)

    jpool = {name: fill(jpool[name], tpool[name]) for name in ("k", "v")}
    for src, dst in ((3, 1), (0, pages)):
        jpool = jax_page_copy(jpool, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32))
        ttf.page_copy(tpool, src, dst)
        got = jax.tree.map(lambda a: a[:, :pages].numpy(), tpool)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jpool)):
            np.testing.assert_array_equal(g, np.asarray(w))
    sink = jax.tree.leaves(jax.tree.map(lambda a: a[:, pages].numpy(), tpool))
    real0 = jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a)[:, 0], jpool))
    for s, w in zip(sink, real0):
        np.testing.assert_array_equal(s, w)


# -- the engine: short path ----------------------------------------------------

SHORT_PROMPT = ramp(45)
SHORT_OTHER = SHORT_PROMPT[:40] + ramp(5, 1, 3)
INT8_PROMPT = ramp(14)
INT8_OTHER = INT8_PROMPT[:6] + ramp(6, 1, 3)


@pytest.mark.parametrize("kv,page_size,buckets,prompts,copies", [
    # the 32-boundary prefix is two whole pages: aliased, never copied
    ("model", 16, (16, 32, 64), (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER), 0),
    # the same prefix ends mid-page: one copy-on-write page per hit
    ("model", 64, (16, 32, 64), (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER), 2),
    # int8 pages, prompts of 16 tokens or fewer: the second request aliases
    # the 8-prefix's whole page, the third shares only 6 tokens and takes
    # the 4-boundary through the deeper entry's partial page (one copy)
    ("int8", 8, (4, 8, 16), (INT8_PROMPT, INT8_PROMPT, INT8_OTHER), 1),
], ids=["f32-alias", "f32-cow", "int8-alias-and-cow"])
def test_warm_short_path_matches_jax(kv, page_size, buckets, prompts, copies):
    kw = dict(page_size=page_size, prefill_buckets=buckets)
    want, jstats = serve_in_turn(jax_engine(kv=kv, **kw), prompts, 10, jax_side=True)
    reset_kernel_counts()
    engine = port_engine(kv=kv, **kw)
    got, stats = serve_in_turn(engine, prompts, 10, jax_side=False)
    segments = kernel_counts()["flash_segment"]["cpu_calls"]
    cold, _ = serve_in_turn(port_engine(kv=kv, prefix="off", **kw), prompts, 10, jax_side=False)
    assert got == want == cold
    assert prefix_stats(stats) == prefix_stats(jstats)
    assert stats["prefix-cache-hit-rate"] > 0 and stats["warm-admissions-total"] == 2
    assert stats["page-copies-total"] == copies
    if copies == 0:
        assert stats["prefix-copy-bytes-saved-total"] > 0
    # a warm admission prefills only its suffix: one segment launch a layer
    saved = stats["prefill-tokens-saved-total"]
    assert stats["prefill-tokens-total"] == sum(map(len, prompts)) - saved
    if kv == "model":
        assert segments == engine.config.n_layers * stats["warm-admissions-total"]
    # after stop(): no pin left, and only the index holds pages
    assert engine._pagepool.pages_in_use == engine._prefix_index.pages_held
    assert all(e.pins == 0 for e in engine._prefix_index._live)


SPEC_KEYS = (
    "speculation", "speculation-tokens", "spec-acceptance-rate",
    "spec-accepted-tokens-per-step", "spec-draft-hit-rate", "spec-draft-tokens-total",
    "spec-accepted-tokens-total", "spec-verify-dispatches-total",
)


@pytest.mark.parametrize("kv,page_size,buckets,prompts", [
    ("model", 16, (16, 32, 64), (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER)),
    ("model", 64, (16, 32, 64), (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER)),
    ("int8", 8, (4, 8, 16), (INT8_PROMPT, INT8_PROMPT, INT8_OTHER)),
], ids=["f32-alias", "f32-cow", "int8-alias-and-cow"])
def test_warm_short_path_with_speculation_matches_jax(kv, page_size, buckets, prompts):
    """The speculation cases of test_pagepool.py's
    ``test_warm_prefix_exact_short_path`` (k = 3): warm admissions seed the
    draft index with the whole prompt and publish only prompt rows, so
    tokens, prefix stats and spec stats all equal the JAX paged engine's
    with speculation, and the tokens equal a cold run without either."""
    kw = dict(page_size=page_size, prefill_buckets=buckets)
    spec = dict(speculation="auto", speculation_tokens=3)
    want, jstats = serve_in_turn(jax_engine(kv=kv, **kw, **spec), prompts, 16, jax_side=True)
    got, stats = serve_in_turn(port_engine(kv=kv, **kw, **spec), prompts, 16, jax_side=False)
    cold, _ = serve_in_turn(port_engine(kv=kv, prefix="off", **kw), prompts, 16, jax_side=False)
    assert got == want == cold
    assert prefix_stats(stats) == prefix_stats(jstats)
    assert {k: stats[k] for k in SPEC_KEYS} == {k: jstats[k] for k in SPEC_KEYS}
    assert stats["warm-admissions-total"] == 2 and stats["spec-verify-dispatches-total"] > 0


def test_warm_tail_reads_nothing_past_its_frontier():
    """NaN planted in the copy-on-write source page's columns at and past
    the publish boundary (and in the sink page) before a warm admission:
    the copy carries the NaN, the suffix segment overwrites its own columns,
    and the tokens still equal the cold run's."""
    kw = dict(page_size=64, prefill_buckets=(16, 32, 64))
    cold, _ = serve_in_turn(port_engine(prefix="off", **kw), [SHORT_OTHER], 10, jax_side=False)
    engine = port_engine(**kw)
    engine.start()
    try:
        opts = GenerationOptions(max_new_tokens=10, temperature=0.0)
        engine.generate(SHORT_PROMPT, opts, timeout=WAIT)
        (entry,) = engine._prefix_index._live
        pool = engine._pagepool.dev
        for leaf in (pool["k"], pool["v"]):
            leaf[:, entry.pages[0], :, entry.length:] = float("nan")
            leaf[:, -1] = float("nan")
        warm = engine.generate(SHORT_OTHER, opts, timeout=WAIT).tokens
        assert engine.stats()["page-copies-total"] == 1
    finally:
        engine.stop()
    assert warm == cold[0]


# -- the engine: long path -----------------------------------------------------


@pytest.mark.parametrize("kv,kw,prompt,head,segments", [
    # a 60-token admission publishes 32; the 150-token prompt's segments
    # start there: [32, 96), [96, 160) — 2 segments instead of 3
    ("model", dict(max_seq_len=256, page_size=64, prefill_buckets=(16, 32, 64)),
     ramp(150, 5, 2), 60, 2),
    # int8 at 14 tokens: a 7-token admission publishes 4 (one whole page);
    # the segments start at 4: [4, 12), [12, 20)
    ("int8", dict(max_seq_len=32, page_size=4, prefill_buckets=(4, 8)),
     ramp(14, 5, 2), 7, 2),
], ids=["f32", "int8"])
def test_warm_long_path_matches_jax(kv, kw, prompt, head, segments):
    want, jstats = serve_in_turn(jax_engine(kv=kv, **kw), [prompt[:head], prompt], 10, True)
    got, stats = serve_in_turn(port_engine(kv=kv, **kw), [prompt[:head], prompt], 10, False)
    cold, _ = serve_in_turn(port_engine(kv=kv, prefix="off", **kw), [prompt], 10, False)
    assert got == want and got[1] == cold[0]
    assert prefix_stats(stats) == prefix_stats(jstats)
    assert stats["prefill-tokens-saved-total"] > 0
    assert stats["prefill-segments-total"] == segments


# -- the engine: pool pressure -------------------------------------------------


def _pressure_run(engine, jax_side: bool):
    """Every request submitted before ``start()`` on a 6-page pool (page
    16): A and B (3 pages each) fill it and publish their 32-prefixes. C
    (A's preamble) aliases A's two pages and takes one fresh; D (5 pages)
    evicts B's entry and A's (whose pages C still holds) and still cannot
    fit: it waits until C ends. E (4 pages) then evicts D's entry, which
    frees nothing while D runs, and waits for D. F can never fit: shed."""
    req_cls, opt_cls = (JaxRequest, JaxOptions) if jax_side else (GenerationRequest,
                                                                  GenerationOptions)
    a, b, d = ramp(40), ramp(40, 11, 5), ramp(40, 2, 7)
    e = ramp(40, 3, 11)
    c = a[:36] + ramp(4, 1, 3)
    plan = [(a, 8), (b, 8), (c, 8), (d, 30), (e, 20), (ramp(10, 4, 4), 200)]
    reqs = [
        engine.submit(req_cls(prompt_tokens=p, options=opt_cls(max_new_tokens=n, temperature=0.0)))
        for p, n in plan
    ]
    engine.start()
    try:
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout=WAIT).tokens)
            except Exception as err:  # noqa: BLE001 — ShedError, of either package
                out.append(type(err).__name__)
        stats = engine.stats()
    finally:
        engine.stop()
    return out, stats


def test_pool_pressure_evicts_defers_and_sheds_like_jax():
    kw = dict(page_size=16, kv_pages=6, prefill_buckets=(16, 32, 64))
    want, jstats = _pressure_run(jax_engine(**kw), jax_side=True)
    got, stats = _pressure_run(port_engine(**kw), jax_side=False)
    assert got == want
    assert got[-1] == "ShedError"
    assert prefix_stats(stats) == prefix_stats(jstats)
    assert stats["prefix-cache-evictions-total"] == 3
    assert stats["prefix-cache-hit-rate"] == 0.2  # C, of A to E


# -- quarantine and restart ----------------------------------------------------


def _reference(prompt, new):
    tokens, _ = serve_in_turn(port_engine(prefix="off", page_size=16), [prompt], new, False)
    return tokens[0]


@pytest.mark.parametrize("site", ["nan@1", "page@1"])
def test_quarantined_publisher_loses_its_entries(site):
    """The fault hits the only active slot, which published its prefix at
    admission: the entry is evicted with it and its pages are zeroed; the
    same prompt is then admitted cold, token-exact."""
    engine = port_engine(page_size=16, fault_injector=FaultInjector(site, seed=0))
    engine.start()
    try:
        opts = GenerationOptions(max_new_tokens=10, temperature=0.0)
        req = engine.submit(GenerationRequest(prompt_tokens=SHORT_PROMPT, options=opts))
        with pytest.raises(Exception):
            req.result(timeout=WAIT)
        stats = engine.stats()
        assert stats["quarantined-slots-total"] == 1
        assert stats["prefix-cache-entries"] == 0 and stats["prefix-cache-evictions-total"] == 1
        again = engine.generate(SHORT_PROMPT, opts, timeout=WAIT).tokens
        stats = engine.stats()
    finally:
        engine.stop()
    assert again == _reference(SHORT_PROMPT, 10)
    assert stats["prefix-cache-hit-rate"] == 0.0  # two lookups, no hit
    assert stats["prefix-cache-entries"] == 1


def test_decode_crash_resets_the_index_and_keeps_its_counters():
    """Two one-token requests publish and hit without a decode chunk; the
    third hits and crashes on its third chunk. The restart rebuilds the
    pool with an empty index, the counters stay, and the prompt is then
    admitted cold with the fault-free tokens."""
    engine = port_engine(page_size=16, max_batch=1,
                         fault_injector=FaultInjector("decode@3", seed=0),
                         restart_backoff_s=0.02)
    engine.start()
    try:
        one = GenerationOptions(max_new_tokens=1, temperature=0.0)
        engine.generate(SHORT_PROMPT, one, timeout=WAIT)
        engine.generate(SHORT_PROMPT, one, timeout=WAIT)
        with pytest.raises(InjectedFault):
            engine.generate(
                SHORT_PROMPT, GenerationOptions(max_new_tokens=100, temperature=0.0), timeout=WAIT
            )
        # the request fails before the device state is rebuilt: wait for
        # the restart to finish
        deadline = time.monotonic() + WAIT
        while engine.stats()["recovering"] and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = engine.stats()
        assert stats["engine-restarts-total"] == 1
        assert stats["prefix-cache-entries"] == 0 and stats["kv-pages-in-use"] == 0
        assert stats["prefix-cache-hit-rate"] == round(2 / 3, 4)
        assert stats["prefill-tokens-saved-total"] == 2 * 32
        again = engine.generate(
            SHORT_PROMPT, GenerationOptions(max_new_tokens=10, temperature=0.0), timeout=WAIT
        )
        stats = engine.stats()
    finally:
        engine.stop()
    assert again.tokens == _reference(SHORT_PROMPT, 10)
    assert stats["prefix-cache-hit-rate"] == 0.5 and stats["prefix-cache-entries"] == 1


# -- MoE -----------------------------------------------------------------------


def _moe_run(engine, jax_side: bool):
    req_cls, opt_cls = (JaxRequest, JaxOptions) if jax_side else (GenerationRequest,
                                                                  GenerationOptions)
    opts = opt_cls(max_new_tokens=8, temperature=0.0)
    reqs = [engine.submit(req_cls(prompt_tokens=p, options=opts))
            for p in (SHORT_PROMPT, SHORT_OTHER)]
    engine.start()
    try:
        tokens = [r.result(timeout=WAIT).tokens for r in reqs]
        stats = engine.stats()
    finally:
        engine.stop()
    return tokens, stats


def test_moe_warm_suffix_matches_jax():
    """One slot: the first request is a cold group (padded to the JAX
    engine's PREFILL_BATCH rows), the second a batch-1 warm suffix segment
    with no pad rows, as JAX runs it — the experts' capacity is shared by
    the rows, so any other batch would change the tokens."""
    kw = dict(max_batch=1, page_size=16, prefill_buckets=(16, 32, 64))
    want, jstats = _moe_run(jax_engine("tiny-moe-test", **kw), jax_side=True)
    got, stats = _moe_run(port_engine("tiny-moe-test", **kw), jax_side=False)
    assert got == want
    assert stats["warm-admissions-total"] == 1
    assert prefix_stats(stats) == prefix_stats(jstats)


# -- the provider --------------------------------------------------------------


def test_provider_prefix_keys():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    base = {"model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
            "page-size": 16, "max-seq-len": 128}
    svc = TorchCompletionsService({**base, "prefix-cache": "auto",
                                   "prefix-cache-fraction": 0.5, "prefix-cache-entries": 7})
    try:
        engine = svc.engine()
        assert engine._prefix_index.max_entries == 7
        assert engine._pagepool.num_pages == tpp.pages_for_fraction(2, 128, 16, 0.5)
        prompt = ["hello there, " * 4]  # past the 32-token boundary
        first = asyncio.run(svc.get_text_completions(prompt, {"max-tokens": 3}))
        second = asyncio.run(svc.get_text_completions(prompt, {"max-tokens": 3}))
        assert first.content == second.content
        assert svc.engine_stats()["prefix-cache-hit-rate"] > 0
    finally:
        svc.close()
    off = TorchCompletionsService({**base, "prefix-cache": "off"})
    assert off.prefix_cache == "off"
    with pytest.raises(ValueError, match="prefix-cache"):
        TorchCompletionsService({**base, "prefix-cache": "sometimes"})
    # the dense layout's prefix pool is served since it was ported
    dense = TorchCompletionsService({**base, "prefix-cache": "auto", "kv-layout": "dense",
                                     "prefix-cache-entries": 7})
    assert dense.prefix_cache == "auto" and dense.kv_layout == "dense"
    engine = ServingEngine(configs()[1], weights()[1], device="cpu", kv_layout="dense",
                           prefix_cache="auto", prefix_cache_entries=7, max_seq_len=128)
    assert engine._prefix_pool.entries == 7 and engine._prefix_index is None
    engine.stop()
    # the host KV tier is served since it was ported: the arena is planned
    # (host RAM, outside the device total) and built
    tiered = TorchCompletionsService({**base, "prefix-cache": "auto", "host-kv-fraction": 2.0})
    try:
        engine = tiered.engine()
        plan = engine.memory_plan
        assert plan.host_spill_bytes == 2 * engine._pagepool.num_pages * engine._pagepool.bytes_per_page
        assert engine._host_tier.bytes_total == plan.host_spill_bytes
    finally:
        tiered.close()
    with pytest.raises(ValueError, match="spill"):
        TorchCompletionsService({**base, "spill": "sometimes"})
