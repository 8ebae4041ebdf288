"""The dense layout's prefix pool in the port against the JAX package, on the
CPU (tiny-test and tiny-moe-test, f32; int8 KV runs the reference
attention "jnp" on both sides).

- The host half: the port's ``PrefixCachePool`` and the JAX one take the
  same operations (insert, candidates at every depth, publish lengths,
  dedupe, LRU eviction that skips pinned rows, refusal when every row is
  pinned, reset) and agree on every row, entry and counter;
  ``pool_entries_for_fraction`` agrees on a grid; the memory plan charges
  the pool (its rows and the sink row) and the engine's plan carries it.
- ``publish_prefix_rows`` and ``gather_prefix_local`` equal JAX's on both
  KV dtypes, widths narrower and wider than the pool; an out-of-range pool
  row writes only the sink row (JAX drops the write).
- The engine: the port's dense engine and the JAX dense engine, both with
  ``prefix_cache="auto"``, on the same weights: greedy tokens equal to
  JAX's and to the port's reuse-off run, the prefix stats equal — the
  short path (warm suffix segments), the long path (a full segment width
  reused), a deeper entry serving a shorter prompt, a shared-preamble
  burst, LRU pressure, speculation on top, int8 KV and tiny-moe-test.
  Adapter requests neither reuse nor publish; a restart resets the pool.
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.ops import kvcopy as jkv
from langstream_tpu.serving import prefix_cache as jpc
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.memory import plan_serving_memory as jax_plan
from langstream_tpu_torch.ai.provider import ChatMessage
from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops import kvcopy as tkv
from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
from langstream_tpu_torch.serving import prefix_cache as tpc
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault
from langstream_tpu_torch.serving.memory import plan_serving_memory

WAIT = 120.0
V = MODEL_PRESETS["tiny-test"].vocab_size
# the prefix stats both engines report, with the JAX engine's meaning
PREFIX_KEYS = (
    "prefix-cache", "prefix-cache-hit-rate", "prefill-tokens-saved-total",
    "prefix-copy-bytes-saved-total", "prefix-pool-bytes-in-use",
    "prefix-cache-evictions-total", "prefix-cache-entries",
)
SPEC_KEYS = (
    "spec-acceptance-rate", "spec-draft-tokens-total", "spec-accepted-tokens-total",
    "spec-verify-dispatches-total",
)


@functools.lru_cache(maxsize=None)
def configs(preset: str = "tiny-test", kv: str = "model"):
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
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def ramp(n: int, a: int = 7, b: int = 3) -> list[int]:
    return [(a + b * i) % V for i in range(n)]


# -- the host half -------------------------------------------------------------


def _pools(entries: int, width: int, boundaries: tuple):
    jcfg, tcfg = configs()
    return (jpc.PrefixCachePool(jcfg, entries, width, boundaries),
            tpc.PrefixCachePool(tcfg, entries, width, boundaries, device="cpu"))


def _same(te, je) -> bool:
    if te is None or je is None:
        return te is None and je is None
    return (te.row, te.length, te.refs, te.last_used, te.digest) == (
        je.row, je.length, je.refs, je.last_used, je.digest)


def _assert_pools_agree(tp, jp):
    assert sorted(tp._live) == sorted(jp._live)
    for row, te in tp._live.items():
        assert _same(te, jp._live[row])
    assert tp._free == jp._free
    assert (tp.lookups, tp.hits, tp.tokens_saved, tp.evictions, tp._tick) == (
        jp.lookups, jp.hits, jp.tokens_saved, jp.evictions, jp._tick)
    assert tp.bytes_in_use() == jp.bytes_in_use() and tp.live_entries == jp.live_entries
    assert tp.hit_rate() == jp.hit_rate() and tp.advertised() == jp.advertised()


def test_radix_candidates_and_publish_dedupe_match_jax():
    jp, tp = _pools(4, 32, (8, 16, 32))
    tokens = list(range(40))
    divergent = tokens[:16] + [500] * 16
    assert tp.candidates(tokens) == [] == jp.candidates(tokens)
    for n in (40, 20, 4, 8, 31):
        assert tp.publish_length(n) == jp.publish_length(n)
    te, je = tp.insert(tokens, 32, tp.allocate()), jp.insert(tokens, 32, jp.allocate())
    assert _same(te, je) and tp.has(tokens, 32) and jp.has(tokens, 32)
    for probe in (tokens + [99], divergent, tokens[:32], tokens[:8], tokens[:17]):
        got, want = tp.candidates(probe), jp.candidates(probe)
        assert [(p, e.row) for p, e in got] == [(p, e.row) for p, e in want]
        assert tp.match_len(probe) == jp.match_len(probe)
    te2, je2 = tp.insert(divergent, 16, tp.allocate()), jp.insert(divergent, 16, jp.allocate())
    assert _same(te2, je2)
    for used_t, used_j in ((te, je), (None, None), (te2, je2)):
        tp.record_lookup(used_t)
        jp.record_lookup(used_j)
    _assert_pools_agree(tp, jp)


def test_lru_eviction_skips_pinned_rows_as_jax():
    jp, tp = _pools(2, 32, (16, 32))
    a, b, c = (list(range(s, s + 32)) for s in (100, 200, 300))
    ents = {}
    for name, toks in (("a", a), ("b", b)):
        ents[name] = (tp.insert(toks, 32, tp.allocate()), jp.insert(toks, 32, jp.allocate()))
    tp.record_lookup(ents["a"][0])
    jp.record_lookup(ents["a"][1])
    tp.acquire(ents["b"][0])
    jp.acquire(ents["b"][1])
    row_t, row_j = tp.allocate(), jp.allocate()
    assert row_t == row_j == ents["a"][0].row  # the LRU unpinned row
    ec = (tp.insert(c, 32, row_t), jp.insert(c, 32, row_j))
    tp.acquire(ec[0])
    jp.acquire(ec[1])
    assert tp.allocate() is None and jp.allocate() is None  # every row pinned
    tp.release(ents["b"][0])
    jp.release(ents["b"][1])
    assert tp.allocate() == jp.allocate() == ents["b"][0].row
    _assert_pools_agree(tp, jp)
    tp.reset()
    jp.reset()
    _assert_pools_agree(tp, jp)  # counters survive, entries do not
    assert tp.evictions == 2 and tp.live_entries == 0


def test_pool_sizing_fraction_matches_jax():
    for args in ((8, 2048, 2048, 0.0), (8, 2048, 2048, 0.25), (192, 512, 64, 0.25),
                 (192, 512, 1, 1.0), (2, 128, 32, 0.25), (8, 8192, 2048, 0.25)):
        assert tpc.pool_entries_for_fraction(*args) == jpc.pool_entries_for_fraction(*args)


def test_memory_plan_accounts_prefix_pool():
    """The plan's prefix term is the pool the engine allocates (its rows
    and the sink row): JAX's rows' bytes plus one row; the engine carries
    it in its plan, and its pool holds exactly the term's bytes."""
    jcfg, tcfg = configs()
    base = plan_serving_memory(tcfg, 4, 256)
    with_pool = plan_serving_memory(tcfg, 4, 256, prefix_pool_entries=4, prefix_pool_width=64)
    want = jax_plan(jcfg, 4, 256, prefix_pool_entries=4, prefix_pool_width=64).prefix_pool_bytes
    assert with_pool.prefix_pool_bytes == want * 5 // 4
    assert with_pool.total_bytes == base.total_bytes + with_pool.prefix_pool_bytes
    assert "prefix-pool" in with_pool.summary()
    engine = ServingEngine(tcfg, weights()[1], max_batch=2, max_seq_len=128,
                           prefill_buckets=(16, 32), prefix_cache="auto",
                           prefix_cache_entries=3, kv_layout="dense", device="cpu")
    pool_bytes = sum(t.numel() * t.element_size() for t in jax.tree.leaves(
        engine._prefix_pool.dev, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert engine.memory_plan.prefix_pool_bytes == pool_bytes > 0
    engine.stop()
    paged = ServingEngine(tcfg, weights()[1], max_batch=2, max_seq_len=128,
                          prefill_buckets=(16, 32), prefix_cache="auto", device="cpu")
    assert paged.memory_plan.prefix_pool_bytes == 0 and paged._prefix_pool is None
    paged.stop()


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_kvcopy_matches_jax(kv):
    """Publish slot rows of a random big cache into pool rows and gather
    them back into local caches narrower and wider than the pool: every
    leaf equals JAX's; an out-of-range pool row leaves the real rows as
    JAX's dropped write does and lands in the sink row."""
    jcfg, tcfg = configs(kv=kv)
    rng = np.random.default_rng(4)
    jcache = jtf.make_kv_cache(jcfg, 3, 40)

    def fill(a):
        a = np.asarray(a)
        return (rng.integers(-127, 128, a.shape) if a.dtype == np.int8
                else rng.uniform(0.5, 1.5, a.shape) if a.ndim == 4
                else rng.standard_normal(a.shape)).astype(a.dtype)

    jcache = jax.tree.map(lambda a: jnp.asarray(fill(a)), jcache)
    tcache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    jpool = jtf.make_kv_cache(jcfg, 2, 32)
    tpool = tkv.make_prefix_pool(tcfg, 2, 32, device="cpu")
    for slot, row in ((2, 0), (0, 1), (1, 5)):
        jpool = jkv.publish_prefix_rows(jpool, jcache, jnp.asarray(slot, jnp.int32),
                                        jnp.asarray(row, jnp.int32))
        tkv.publish_prefix_rows(tpool, tcache, slot, row)
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda a: a[:, :2].numpy(), tpool)),
                        jax.tree.leaves(jpool)):
            np.testing.assert_array_equal(g, np.asarray(w))
    # the dropped write (row 5) landed in the sink row: slot 1's columns
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda a: a[:, 2].numpy(), tpool)),
                    jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a)[:, 1, :, :32],
                                                 jcache))):
        np.testing.assert_array_equal(g, w)
    for row, width in ((0, 16), (1, 32), (1, 48), (7, 24)):
        want = jkv.gather_prefix_local(jpool, jnp.asarray(row, jnp.int32), jcfg, width)
        got = tkv.gather_prefix_local(tpool, row, tcfg, width, device="cpu")
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the engine ----------------------------------------------------------------


def jax_engine(preset="tiny-test", kv="model", prefix="auto", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("prefix_cache_entries", 4)
    return JaxEngine(configs(preset, kv)[0], weights(preset)[0], kv_layout="dense",
                     prefix_cache=prefix, **kw)


def port_engine(preset="tiny-test", kv="model", prefix="auto", **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("prefix_cache_entries", 4)
    return ServingEngine(configs(preset, kv)[1], weights(preset)[1], device="cpu",
                         kv_layout="dense", prefix_cache=prefix, **kw)


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


def _three_ways(prompts, new=10, **kw):
    """(port tokens, port stats, JAX stats) after asserting the port's
    tokens equal JAX's and the port's reuse-off run's, and the prefix
    stats equal JAX's."""
    want, jstats = serve_in_turn(jax_engine(**kw), prompts, new, jax_side=True)
    got, stats = serve_in_turn(port_engine(**kw), prompts, new, jax_side=False)
    cold, _ = serve_in_turn(port_engine(prefix="off", **kw), prompts, new, jax_side=False)
    assert got == want == cold
    assert prefix_stats(stats) == prefix_stats(jstats)
    return got, stats, jstats


SHORT_PROMPT = ramp(45)
SHORT_OTHER = SHORT_PROMPT[:40] + ramp(5, 1, 3)
INT8_PROMPT = ramp(14)
INT8_OTHER = INT8_PROMPT[:6] + ramp(6, 1, 3)


@pytest.mark.parametrize("kv,buckets,prompts,saved", [
    ("model", (16, 32, 64), (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER), 64),
    ("int8", (4, 8, 16), (INT8_PROMPT, INT8_PROMPT, INT8_OTHER), 12),
], ids=["f32", "int8"])
def test_dense_warm_short_path_matches_jax(kv, buckets, prompts, saved):
    reset_kernel_counts()
    got, stats, _ = _three_ways(prompts, kv=kv, prefill_buckets=buckets)
    assert stats["warm-admissions-total"] == 2
    assert stats["prefill-tokens-saved-total"] == saved
    assert stats["prefix-cache-hit-rate"] == round(2 / 3, 4)
    assert stats["prefill-tokens-total"] == sum(map(len, prompts)) - saved


def test_dense_warm_suffix_is_one_segment_a_layer():
    """A warm admission prefills only its suffix: one segment-kernel call a
    layer (the plain version on the CPU) per warm admission."""
    engine = port_engine()
    reset_kernel_counts()
    serve_in_turn(engine, (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER), 6, jax_side=False)
    assert kernel_counts()["flash_segment"]["cpu_calls"] == engine.config.n_layers * 2
    assert engine._prefix_pool.live_entries == 1  # the other prompt shares its 32
    assert all(e.refs == 0 for e in engine._prefix_pool._live.values())


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_dense_warm_long_path_matches_jax(kv):
    """A prompt wider than the widest bucket reuses a full segment width:
    its stream starts from a copy of the pool row at the reuse offset."""
    prompt = [(3 + 5 * i) % V for i in range(70)]  # 3 segments of 32
    _, stats, _ = _three_ways([prompt, prompt], kv=kv, max_seq_len=256,
                              prefill_buckets=(16, 32))
    assert stats["prefill-tokens-saved-total"] == 32


def test_deeper_entry_and_shared_preamble_burst_match_jax():
    """A preamble published inside a longer prompt serves a shorter one;
    then a burst of chats sharing the preamble, all hits."""
    preamble = [(9 + i) % V for i in range(32)]
    prompts = [preamble + [(5 * i) % V for i in range(20)], preamble + [7, 8, 9]]
    prompts += [preamble + [(i + 1) % V, (2 * i + 3) % V] for i in range(4)]
    _, stats, _ = _three_ways(prompts, max_batch=4, new=8)
    assert stats["prefix-cache-hit-rate"] == round(5 / 6, 4)


def test_dense_eviction_pressure_matches_jax():
    prompts = [[(seed + 7 * i) % V for i in range(40)] for seed in (1, 2, 3)] * 2
    _, stats, _ = _three_ways(prompts, prefill_buckets=(16, 32), prefix_cache_entries=2)
    assert stats["prefix-cache-evictions-total"] > 0


def test_dense_prefix_with_speculation_matches_jax():
    """Reuse and speculation together: warm admissions seed the draft
    index with the whole prompt; the prefix and spec stats equal JAX's."""
    kw = dict(speculation="auto", speculation_tokens=3)
    prompts = ([5, 9, 11, 7] * 12, [5, 9, 11, 7] * 12, [5, 9, 11, 7] * 10 + [1, 2, 3])
    _, stats, jstats = _three_ways(prompts, new=16, **kw)
    assert {k: stats[k] for k in SPEC_KEYS} == {k: jstats[k] for k in SPEC_KEYS}
    assert stats["warm-admissions-total"] == 2 and stats["spec-verify-dispatches-total"] > 0


def test_moe_dense_prefix_matches_jax():
    """tiny-moe-test, served one at a time: cold groups are padded to the
    admit batch and a warm suffix is a batch-1 segment, on both engines."""
    prompts = (SHORT_PROMPT, SHORT_PROMPT, SHORT_OTHER)
    _, stats, _ = _three_ways(prompts, preset="tiny-moe-test")
    assert stats["warm-admissions-total"] == 2


def test_adapter_requests_never_touch_the_dense_pool():
    adapters = [{"name": "t", "rank": 2, "scale": 1.0, "seed": 3}]
    engine = port_engine(adapters=adapters, adapter_pool_rows=2)
    opts = GenerationOptions(max_new_tokens=4, adapter="t")
    engine.start()
    try:
        for _ in range(2):
            engine.generate(list(SHORT_PROMPT), opts, timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert stats["prefix-cache-entries"] == 0 and stats["prefix-cache-hit-rate"] == 0.0
    assert engine._prefix_pool.lookups == 0 and stats["warm-admissions-total"] == 0


def test_restart_resets_the_pool_and_keeps_the_counters():
    """A decode crash restarts the engine: the pool is rebuilt empty, so
    the same prompt after the restart is a cold admission (a miss that
    publishes again), and the lookup counters are cumulative."""
    engine = port_engine(fault_injector=FaultInjector("decode@3"), restart_backoff_s=0.01)
    opts = GenerationOptions(max_new_tokens=12)
    engine.start()
    try:
        engine.generate(list(SHORT_PROMPT), GenerationOptions(max_new_tokens=2), timeout=WAIT)
        with pytest.raises(InjectedFault):
            engine.generate(list(SHORT_PROMPT), opts, timeout=WAIT)  # a hit, then the crash
        warm = engine.stats()["warm-admissions-total"]
        after = engine.generate(list(SHORT_PROMPT), opts, timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert stats["engine-restarts-total"] == 1 and after.finish_reason == "length"
    assert warm == 1 and stats["warm-admissions-total"] == 1  # the third: cold
    assert engine._prefix_pool.lookups == 3 and engine._prefix_pool.hits == 1
    assert stats["prefix-cache-entries"] == 1  # published again after the reset


def test_provider_serves_dense_prefix_cache():
    """``prefix-cache: auto`` on ``kv-layout: dense`` is served (no longer
    refused); ``prefix-cache-entries`` sizes the pool."""
    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "kv-layout": "dense", "prefix-cache": "auto",
        "prefix-cache-entries": 3, "max-seq-len": 128, "max-batch": 2, "decode-chunk": 4,
        "prefill-buckets": [16, 32, 64],
    })
    preamble = "You are a helpful assistant. Answer briefly and politely."
    try:
        for q in ("what is two plus two?", "name a color"):
            asyncio.run(svc.get_chat_completions(
                [ChatMessage("system", preamble), ChatMessage("user", q)], {"max-tokens": 4}))
        stats = svc.engine_stats()
    finally:
        svc.close()
    assert stats["prefix-cache"] is True and stats["kv-layout"] == "dense"
    assert stats["prefix-cache-hit-rate"] > 0 and stats["prefill-tokens-saved-total"] > 0
