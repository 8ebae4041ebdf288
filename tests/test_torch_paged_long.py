"""Chunked prefill on the port's paged layout against the JAX package, on
the CPU (tiny-test): ``paged_prefill_segment_inplace`` logits and pool
contents against the JAX entry point at offsets 0, mid-page and on a page
boundary (a row's padded tail also runs past its reserved pages, into the
sink); the paged ``ServingEngine`` serving prompts wider than its widest
bucket with the JAX paged engine's greedy tokens; and the page bookkeeping
of a long prompt's stream (release, cancel, wait, shed).

Tolerances (f32): logits 1e-4, K/V 1e-5 absolute (the two frameworks sum
in different orders). int8 KV: codes within one step, logits 1e-3; the
port's reference path is held against JAX's reference path, and its
kernel path against JAX's dense ``prefill_segment`` with the Pallas int8
segment kernel in interpret mode over the same cache contents — never
against JAX "auto" at int8, whose CPU path quantizes q and p (ROADMAP §3).
Segments stay at 8 tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine, ShedError

torch.backends.cuda.matmul.allow_tf32 = False

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
INT8_LOGIT_TOL = 1e-3


def cfgs(kv="model", impl="auto"):
    """(JAX config, port config) of tiny-test in f32; the port's kernel path
    is "auto", JAX's Pallas path "pallas"."""
    j = dataclasses.replace(
        JAX_PRESETS["tiny-test"], dtype="float32", kv_cache_dtype=kv,
        attention_impl="pallas" if impl == "pallas" else impl,
    )
    t = dataclasses.replace(
        MODEL_PRESETS["tiny-test"], dtype="float32", kv_cache_dtype=kv,
        attention_impl="auto" if impl == "pallas" else impl,
    )
    return j, t


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfgs()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def to_np(entry):
    if isinstance(entry, dict):
        return {k: to_np(v) for k, v in entry.items()}
    return entry.numpy() if isinstance(entry, torch.Tensor) else np.asarray(entry)


def assert_kv(got, ref, int8):
    if int8:
        q, rq = got["q"].astype(np.int32), ref["q"].astype(np.int32)
        assert np.abs(q - rq).max() <= 1
        assert (q != rq).mean() < 1e-3
        np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-5, atol=1e-12)
    else:
        np.testing.assert_allclose(got, ref, atol=KV_TOL)


# -- the model entry point ----------------------------------------------------

PS, NUM_PAGES, W = 8, 8, 8
# row 0 (14 tokens) reserves two pages, row 1 (8 tokens) one: row 1's
# last segment pads past it, into the sentinel (JAX drops those writes,
# the port lands them in its sink page)
TABLE = np.array([[3, 1, 7, NUM_PAGES], [5, NUM_PAGES, NUM_PAGES, NUM_PAGES]], np.int32)
PROMPT_LENS = (14, 8)
# (offsets, true tokens) of each call: offsets 0; 8 on a page boundary; 4
# mid-page. (Two calls: an int8 code that lands on a rounding boundary
# flips one step between the frameworks, and each layer and call it feeds
# widens the logits' gap.)
SEGMENTS = (((0, 0), (8, 4)), ((8, 4), (6, 4)))


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 500, n).astype(np.int32) for n in PROMPT_LENS]


def _segment(prompts, offsets, lens):
    seg = np.zeros((2, W), np.int32)
    for r, (o, n) in enumerate(zip(offsets, lens)):
        seg[r, :n] = prompts[r][o:o + n]
    return seg, np.array(offsets, np.int32), np.array(lens, np.int32)


@pytest.mark.parametrize(
    "kv,impl", [("model", "auto"), ("model", "jnp"), ("int8", "jnp")]
)
def test_paged_prefill_segment_matches_jax(weights, kv, impl):
    """Logits after every segment and the real pages at the end equal the
    JAX package's ``paged_prefill_segment_inplace`` on the same table (the
    port's kernel path runs the segment kernel's plain version over the
    gathered pages; its reference path reads the gathered table, as JAX
    does)."""
    jparams, tparams = weights
    jcfg, tcfg = cfgs(kv, impl)
    tol = INT8_LOGIT_TOL if kv == "int8" else LOGIT_TOL
    jpool = jtf.make_page_pool(jcfg, NUM_PAGES, PS)
    tpool = ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu")
    prompts = _prompts()
    reset_kernel_counts()
    for offsets, lens in SEGMENTS:
        seg, offs, seg_len = _segment(prompts, offsets, lens)
        jl, jpool = jtf.paged_prefill_segment_inplace(
            jparams, jnp.asarray(seg), jnp.asarray(offs), jnp.asarray(seg_len), jpool,
            jnp.asarray(TABLE), jcfg, PS,
        )
        tl, _ = ttf.paged_prefill_segment_inplace(
            tparams, t(seg), t(offs), t(seg_len), tpool, t(TABLE), tcfg, PS
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    for name in ("k", "v"):
        got = ttf._map(lambda a: a[:, :NUM_PAGES], tpool[name])
        assert_kv(to_np(got), to_np(jpool[name]), kv == "int8")
    segments = kernel_counts()["flash_segment"]["cpu_calls"]
    assert segments == (tcfg.n_layers * len(SEGMENTS) if impl == "auto" else 0)


def test_int8_paged_kernel_path_matches_the_pallas_segment_kernel(weights):
    """int8 pages on the port's kernel path (the int8 segment kernel's plain
    version over the gathered pages) against JAX's dense
    ``prefill_segment`` running the Pallas int8 segment kernel in interpret
    mode over a dense cache that holds the same rows."""
    jparams, tparams = weights
    jcfg, _ = cfgs("int8", "pallas")
    _, tcfg = cfgs("int8", "auto")
    tp = TABLE.shape[1]
    jcache = jtf.make_kv_cache(jcfg, 2, tp * PS)
    tpool = ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu")
    prompts = _prompts()
    reset_kernel_counts()
    for offsets, lens in SEGMENTS:
        seg, offs, seg_len = _segment(prompts, offsets, lens)
        jl, jcache = jtf.prefill_segment(
            jparams, jnp.asarray(seg), jnp.asarray(offs), jnp.asarray(seg_len), jcache, jcfg
        )
        tl, _ = ttf.paged_prefill_segment_inplace(
            tparams, t(seg), t(offs), t(seg_len), tpool, t(TABLE), tcfg, PS
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=INT8_LOGIT_TOL)
    counts = kernel_counts()
    assert counts["flash_segment_int8"]["cpu_calls"] == tcfg.n_layers * len(SEGMENTS)
    assert counts["flash_segment"]["cpu_calls"] == 0
    # the pages hold the dense cache's rows of each row's reserved pages
    for name in ("k", "v"):
        dense = to_np(jcache[name])
        gathered = to_np(ttf._paged_gather_entry(
            ttf._map(lambda a: a[0], tpool[name]), t(TABLE), PS
        ))
        for r, n in enumerate(PROMPT_LENS):
            assert np.abs(gathered["q"][r, :, :n].astype(int)
                          - dense["q"][0, r, :, :n].astype(int)).max() <= 1
            np.testing.assert_allclose(gathered["s"][r, :, :n], dense["s"][0, r, :, :n],
                                       rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_page_gather_equals_the_reference_view(kv):
    """The kernel path's gather of the first n pages of each row (one
    ``index_select`` of pool rows) holds exactly the reference path's
    gathered view of those columns, values and int8 scales alike."""
    _, tcfg = cfgs(kv)
    pool = ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu")
    entry = ttf._map(lambda a: a[0], pool["k"])
    g = torch.Generator().manual_seed(4)
    for leaf in (entry.values() if kv == "int8" else (entry,)):
        if leaf.dtype == torch.int8:
            leaf.random_(-127, 128, generator=g)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    table = t(np.array([[3, 1, 7, 2], [6, 0, 4, 5]], np.int32))
    n = 3
    got = ttf._gather_pages(entry, ttf._page_rows(table[:, :n], tcfg.n_kv_heads), 2)
    ref = ttf._map(lambda a: a[:, :, : n * PS], ttf._paged_gather_entry(entry, table, PS))
    jax.tree.map(np.testing.assert_array_equal, to_np(got), to_np(ref))


def test_kernel_path_reads_only_below_the_frontier(weights):
    """NaN in the slot's pages past the segment's frontier and in the sink
    page leaves the kernel path's segment logits bit-equal: the gather takes
    only the pages below ``offset + W`` and the segment kernel reads them
    through a ``[..., :offset + W]`` view."""
    _, tparams = weights
    _, tcfg = cfgs()
    table = np.array([[3, 1, 7, 2]], np.int32)  # 32 reserved columns
    prompt = np.random.default_rng(8).integers(1, 500, 12).astype(np.int32)
    outs = []
    for plant in (False, True):
        pool = ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu")
        first = np.zeros((1, W), np.int32)
        first[0] = prompt[:W]
        ttf.paged_prefill_segment_inplace(
            tparams, t(first), t(np.array([0])), t(np.array([W])), pool, t(table), tcfg, PS
        )
        if plant:
            # the segment at offset 4 writes [4, 12): columns 12..31 and the
            # sink stay unread
            for name in ("k", "v"):
                pool[name][:, 1, :, 4:] = float("nan")
                pool[name][:, 7] = float("nan")
                pool[name][:, 2] = float("nan")
                pool[name][:, NUM_PAGES] = float("nan")
        seg = prompt[4:12][None]
        logits, _ = ttf.paged_prefill_segment_inplace(
            tparams, t(seg), t(np.array([4])), t(np.array([W])), pool, t(table), tcfg, PS,
            kv_bound=4 + W,
        )
        outs.append(logits)
    assert torch.equal(outs[0], outs[1]) and bool(torch.isfinite(outs[0]).all())


# -- the paged engine ---------------------------------------------------------

ENGINE_KW = dict(max_batch=4, max_seq_len=512, decode_chunk=4, prefill_buckets=(32, 64, 128))
# the 150- and 300-token prompts are wider than the widest bucket: 2 and 3
# segments of 128 straight into their pages
ENGINE_LENS = (3, 40, 100, 150, 300)
NEW_TOKENS = 12


def engine_prompts(lens=ENGINE_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def jax_tokens(weights):
    jcfg, _ = cfgs()
    engine = JaxEngine(jcfg, weights[0], kv_layout="paged", **ENGINE_KW)
    engine.start()
    try:
        opts = JaxOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
        reqs = [engine.submit(JaxRequest(prompt_tokens=p, options=opts))
                for p in engine_prompts()]
        return [r.result(timeout=600).tokens for r in reqs]
    finally:
        engine.stop()


def run_port(tparams, cfg, plist=None, **kw):
    engine = ServingEngine(cfg, tparams, device="cpu", **{**ENGINE_KW, **kw})
    engine.start()
    try:
        opts = GenerationOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
        reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts))
                for p in (plist or engine_prompts())]
        results = [r.result(timeout=600) for r in reqs]
        return results, engine.stats(), engine
    finally:
        engine.stop()


@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_paged_engine_serves_wide_prompts_with_jax_tokens(weights, jax_tokens, impl):
    """Short prompts through admit groups, the 150- and 300-token ones
    through paged chunked prefill: the kernel path (plain versions on the
    CPU) and the reference path both give the JAX paged engine's greedy
    tokens, and every page comes back."""
    _, tcfg = cfgs(impl=impl)
    reset_kernel_counts()
    results, stats, engine = run_port(weights[1], tcfg)
    assert [r.finish_reason for r in results] == ["length"] * len(ENGINE_LENS)
    assert [r.tokens for r in results] == jax_tokens
    assert stats["kv-layout"] == "paged"
    assert stats["prefill-segments-total"] == 2 + 3
    assert stats["long-prefill-queued"] == stats["long-prefill-streams"] == 0
    assert stats["kv-pages-in-use"] == 0 and engine._pagepool.pages_in_use == 0
    kernels = stats["kernels"]
    if impl == "auto":
        assert kernels["flash_segment"]["cpu_calls"] == tcfg.n_layers * 5
        assert kernels["paged_decode"]["cpu_calls"] >= tcfg.n_layers * stats["decode-steps-total"]
    else:
        assert kernels["flash_segment"]["cpu_calls"] == 0
    assert kernels["dense_decode"]["cpu_calls"] == 0
    assert all(k["launches"] == 0 for k in kernels.values())


def test_int8_paged_engine_runs_the_int8_segment_kernel(weights):
    _, tcfg = cfgs("int8")
    reset_kernel_counts()
    results, stats, engine = run_port(weights[1], tcfg, plist=engine_prompts((20, 150)))
    assert [len(r.tokens) for r in results] == [NEW_TOKENS] * 2
    assert all(0 <= tok < tcfg.vocab_size for r in results for tok in r.tokens)
    kernels = stats["kernels"]
    assert kernels["flash_segment_int8"]["cpu_calls"] == tcfg.n_layers * 2
    assert kernels["flash_segment"]["cpu_calls"] == 0
    assert engine._pagepool.pages_in_use == 0


def test_stream_cancelled_mid_prefill_frees_its_pages(weights):
    _, tcfg = cfgs()
    engine = ServingEngine(tcfg, weights[1], device="cpu", **ENGINE_KW)
    req = engine.submit(GenerationRequest(
        prompt_tokens=engine_prompts((300,))[0], options=GenerationOptions(max_new_tokens=4)
    ))
    with torch.no_grad():
        assert engine._admit(engine.prefill_token_budget) == []  # to the long queue
        engine._long_step(engine.prefill_token_budget)  # the stream starts: segment 1 of 3
        pool = engine._pagepool
        assert pool.pages_in_use == pool.pages_needed(300, 4) == 5
        assert engine.stats()["long-prefill-streams"] == 1
        req.cancel()
        engine._long_step(engine.prefill_token_budget)
    assert req.result(timeout=1).finish_reason == "cancelled"
    assert pool.pages_in_use == 0 and engine.stats()["prefill-segments-total"] == 1
    assert engine.stats()["cancelled-total"] == 1


def test_stream_waits_for_pages_then_runs(weights, jax_tokens):
    """A pool of 5 pages: the 150-token stream holds 3, so the 300-token
    one (5 pages) waits at the front of the long queue and runs once they
    come back — both with the JAX engine's tokens."""
    _, tcfg = cfgs()
    plist = engine_prompts()[3:]
    results, stats, engine = run_port(weights[1], tcfg, plist=plist, kv_pages=5)
    assert [r.tokens for r in results] == jax_tokens[3:]
    assert stats["prefill-segments-total"] == 2 + 3
    assert engine._pagepool.pages_in_use == 0


def test_reservation_that_can_never_fit_is_shed(weights):
    _, tcfg = cfgs()
    engine = ServingEngine(tcfg, weights[1], device="cpu", kv_pages=4, **ENGINE_KW)
    engine.start()
    try:
        with pytest.raises(ShedError, match="KV pages"):
            engine.generate(engine_prompts((300,))[0], GenerationOptions(max_new_tokens=4))
        assert len(engine.generate([5] * 140, GenerationOptions(max_new_tokens=4)).tokens) == 4
    finally:
        engine.stop()
    assert engine._pagepool.pages_in_use == 0
    assert engine.stats()["prefill-segments-total"] == 2
