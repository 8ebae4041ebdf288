"""Self-speculative decoding in the port against the JAX package, on the CPU
(tiny-test and tiny-moe-test, f32; int8 KV runs the reference attention
"jnp" on both sides, since the JAX package's CPU "auto" path quantizes q
and p where the port's kernel path does not).

- ``NGramIndex``: the port's copy and the JAX one take the same appends and
  give the same proposals, gram maps and errors, operation by operation.
- ``speculative_verify``: greedy ``out`` / ``accept`` equal to JAX's, the
  NaN row sentinel, and rejection sampling that keeps the target marginal
  (a frequency test: 6000 draws, within 0.03 of the analytic softmax in
  every bucket, the JAX test's band), with and without top-k / top-p.
- ``paged_verify_step_inplace``: logits within 1e-4 of JAX's (f32 and int8
  KV) and the pool's written columns equal; NaN planted past every row's
  frontier and in the sink leaves the logits bit-equal. The kernel path's
  flattening (``verify_queries``) through the plain paged decode version
  on the CPU matches the masked read within 1e-5: a query that read one
  column more would read a stale draft.
- The engine: the port's paged engine and the JAX paged engine, both with
  ``speculation="auto"``, on the same weights (through ``bridge``): greedy
  tokens equal to JAX's and to the port's own non-speculative engine, and
  the ``spec-*`` stats equal to JAX's, on the repetitive and the plain
  prompts of ``test_speculation.py``, f32 and int8; a mixed sampled and
  greedy batch; tiny-moe-test; a request that runs to ``max_seq_len``.
- Lifecycle and graphs: deadline and cancel mid-verify, the ``verify``
  fault site, the verify graphs captured in ``start()`` instead of the
  decode graphs (replays = verify dispatches, paged decode launches =
  layers x verify dispatches), and captured again after a restart.
- The provider's ``speculation`` and ``speculation-tokens`` keys.
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
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.sampling import speculative_verify as jax_verify
from langstream_tpu.serving.speculation import NGramIndex as JaxIndex
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
from langstream_tpu_torch.serving.engine import (
    GenerationRequest,
    LogitsNaNError,
    ServingEngine,
)
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault
from langstream_tpu_torch.serving.sampling import _apply_filters, speculative_verify
from langstream_tpu_torch.serving.speculation import NGramIndex
from test_torch_graphs import ReplayGraph

WAIT = 120.0
K = 4
# greedy decode on tiny-test's random weights enters a cycle on this prompt
# (drafts hit); the second is not repetitive (drafts mostly miss)
REPETITIVE = ([5, 9, 11, 7] * 10)[:40]
PLAIN = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
SPEC_KEYS = (
    "speculation", "speculation-tokens", "spec-acceptance-rate",
    "spec-accepted-tokens-per-step", "spec-draft-hit-rate", "spec-draft-tokens-total",
    "spec-accepted-tokens-total", "spec-verify-dispatches-total",
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


def jax_engine(preset="tiny-test", kv="model", spec=True, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("speculation_tokens", K)
    return JaxEngine(configs(preset, kv)[0], weights(preset)[0], kv_layout="paged",
                     speculation="auto" if spec else "off", **kw)


def port_engine(preset="tiny-test", kv="model", spec=True, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("speculation_tokens", K)
    return ServingEngine(configs(preset, kv)[1], weights(preset)[1], device="cpu",
                         speculation="auto" if spec else "off", **kw)


def serve_in_turn(engine, prompts, new: int, jax_side: bool):
    """Each prompt generated to its end before the next is submitted →
    (tokens per prompt, stats after each prompt)."""
    opts = (JaxOptions if jax_side else GenerationOptions)(max_new_tokens=new, temperature=0.0)
    engine.start()
    try:
        tokens, stats = [], []
        for p in prompts:
            tokens.append(engine.generate(list(p), opts, timeout=WAIT).tokens)
            stats.append(engine.stats())
    finally:
        engine.stop()
    return tokens, stats


def spec_stats(stats: dict) -> dict:
    return {k: stats[k] for k in SPEC_KEYS}


# -- the n-gram index ----------------------------------------------------------


def _streams():
    rng = np.random.default_rng(3)
    return {
        "random-v4": rng.integers(0, 4, 60).tolist(),
        "random-v9": rng.integers(0, 9, 80).tolist(),
        "period-3": [1, 2, 3] * 8,
        "constant": [7] * 12,
        "period-tail": [9, 8, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2],
        "period-5-noise": ([4, 1, 4, 2, 6] * 5)[:23] + [0, 4, 1],
    }


@pytest.mark.parametrize("bounds", [(3, 1), (1, 1), (2, 2), (4, 2)], ids=str)
@pytest.mark.parametrize("name", sorted(_streams()))
def test_ngram_index_matches_jax(name, bounds):
    max_n, min_n = bounds
    port, ref = NGramIndex(max_n, min_n), JaxIndex(max_n, min_n)
    for t in _streams()[name]:
        port.append(t)
        ref.append(t)
        assert len(port) == len(ref) and port.tokens == ref.tokens
        assert port._maps == ref._maps
        for k in (1, 2, 5, 9):
            assert port.propose(k) == ref.propose(k)
    port.extend([1, 2, 1])
    ref.extend([1, 2, 1])
    assert port.propose(6) == ref.propose(6)


@pytest.mark.parametrize("bounds", [(1, 0), (1, 2), (0, 0)], ids=str)
def test_ngram_index_refuses_bad_ranges_like_jax(bounds):
    with pytest.raises(ValueError):
        JaxIndex(*bounds)
    with pytest.raises(ValueError, match="bad n-gram range"):
        NGramIndex(*bounds)


# -- speculative_verify --------------------------------------------------------


def _verify_inputs(b=6, k=K, v=32, seed=0):
    """Logits [B, K+1, V] and drafts [B, K] where row i matches the argmax
    chain for its first min(i, K) drafts, then misses."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    chain = logits.argmax(-1)
    drafts = rng.integers(0, v, (b, k))
    for i in range(b):
        n = min(i, k)
        drafts[i, :n] = chain[i, :n]
        if n < k:
            drafts[i, n] = (chain[i, n] + 1) % v
    return logits, drafts


def _both(logits, drafts, temp, top_k, top_p, seed=0):
    """(port out, accept), (JAX out, accept) as numpy."""
    g = torch.Generator().manual_seed(seed)
    out, acc = speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts), g, torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
    )
    jout, jacc = jax_verify(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32), jax.random.PRNGKey(seed),
        jnp.asarray(temp), jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p),
    )
    return (out.numpy(), acc.numpy()), (np.asarray(jout), np.asarray(jacc))


def test_verify_greedy_equals_jax():
    logits, drafts = _verify_inputs()
    b = logits.shape[0]
    temp, top_k, top_p = np.zeros(b, np.float32), np.zeros(b, np.int64), np.ones(b, np.float32)
    (out, acc), (jout, jacc) = _both(logits, drafts, temp, top_k, top_p)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(out, jout)
    assert acc.tolist() == [0, 1, 2, 3, 4, 4]
    # the bonus token of a fully accepted row is the last position's argmax
    assert out[5, K] == logits[5, K].argmax()


def test_verify_greedy_rows_of_a_mixed_batch_equal_jax():
    """Sampled rows draw (their bits differ from JAX's); the greedy rows of
    the same call stay exact, and every sampled row emits its accepted
    drafts then a token of the vocabulary."""
    logits, drafts = _verify_inputs(seed=1)
    b = logits.shape[0]
    temp = np.array([0, 0.8, 0, 1.2, 0, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 0, 0, 0], np.int64)
    top_p = np.array([1, 1, 1, 0.9, 1, 1], np.float32)
    (out, acc), (jout, jacc) = _both(logits, drafts, temp, top_k, top_p)
    greedy = temp <= 0
    np.testing.assert_array_equal(acc[greedy], jacc[greedy])
    np.testing.assert_array_equal(out[greedy], jout[greedy])
    for i in np.flatnonzero(~greedy):
        n = acc[i]
        assert 0 <= n <= K and out[i, :n].tolist() == drafts[i, :n].tolist()
        assert 0 <= out[i, n] < logits.shape[-1]


def test_verify_nan_row_emits_sentinel_with_zero_accept():
    logits, drafts = _verify_inputs()
    logits[1, 2, :] = np.nan
    logits[4, K, 3] = np.inf
    b = logits.shape[0]
    temp, top_k, top_p = np.zeros(b, np.float32), np.zeros(b, np.int64), np.ones(b, np.float32)
    (out, acc), (jout, jacc) = _both(logits, drafts, temp, top_k, top_p)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(out, jout)
    for row in (1, 4):
        assert acc[row] == 0 and (out[row] == -1).all()
    assert acc[3] == 3


@pytest.mark.parametrize("filt", ["none", "top_k", "top_p"])
def test_verify_rejection_sampling_preserves_marginal(filt):
    """The lossless-speculation identity (test_speculation.py's frequency
    test): with a point-mass draft, P(first emitted token = t) equals the
    target p(t) for every t — the filtered softmax when a filter is on. One
    call verifies 6000 copies of the same row, each drawing its own
    numbers; every bucket within 0.03 of the target (a 4-sigma band at
    n = 6000 for p <= 0.5)."""
    v, n = 8, 6000
    rng = np.random.default_rng(7)
    row = rng.normal(size=(1, 3, v)).astype(np.float32) * 2.0
    logits = torch.from_numpy(np.repeat(row, n, axis=0))
    drafts = torch.tensor([[5, 1]]).expand(n, 2).contiguous()
    temp = torch.full((n,), 0.7)
    top_k = torch.full((n,), 3 if filt == "top_k" else 0, dtype=torch.long)
    top_p = torch.full((n,), 0.8 if filt == "top_p" else 1.0)
    out, acc = speculative_verify(
        logits, drafts, torch.Generator().manual_seed(1), temp, top_k, top_p,
    )
    counts = np.bincount(out[:, 0].numpy(), minlength=v) / n
    scaled = logits[:1, 0] / 0.7
    if filt != "none":
        scaled = _apply_filters(scaled, top_k[:1], top_p[:1])
    target = torch.softmax(scaled, dim=-1)[0].numpy()
    np.testing.assert_allclose(counts, target, atol=0.03)
    # an accepted draft is emitted as itself
    assert (out[acc >= 1, 0] == 5).all()


# -- paged_verify_step_inplace -------------------------------------------------

PS, PAGES = 8, 12
# row 0: pages 0..3 (32 columns), row 1: pages 5..7; Tp = 6
TABLE = np.array([[0, 1, 2, 3, PAGES, PAGES], [5, 6, 7, PAGES, PAGES, PAGES]], np.int32)
POSITIONS = np.array([13, 19], np.int64)
TOKENS = np.array([[2, 40, 41, 42, 43], [5, 7, 9, 11, 13]], np.int64)


def _random_pool(cfg, kv: str, seed=0):
    """A JAX page pool of random finite values ([L, P, Hkv, ps, D]; int8:
    codes and positive scales) → (JAX pool, port pool with a sink page)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, PAGES, cfg.n_kv_heads, PS, cfg.resolved_head_dim)

    def leaf():
        if kv == "int8":
            return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                    "s": rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32)}
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    jpool = {"k": leaf(), "v": leaf()}

    def with_sink(a):
        sink = np.zeros((a.shape[0], 1) + a.shape[2:], a.dtype)
        return torch.from_numpy(np.concatenate([a, sink], axis=1))

    tpool = jax.tree.map(with_sink, jpool)
    return jax.tree.map(jnp.asarray, jpool), tpool


def _port_verify(pool, cfg, tokens=TOKENS, positions=POSITIONS, table=TABLE):
    return ttf.paged_verify_step_inplace(
        weights()[1], torch.from_numpy(tokens), torch.from_numpy(positions), pool,
        torch.from_numpy(table), cfg, PS,
    )[0]


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_paged_verify_step_matches_jax(kv):
    jcfg, tcfg = configs(kv=kv)
    jcfg = dataclasses.replace(jcfg, attention_impl="jnp")
    tcfg = dataclasses.replace(tcfg, attention_impl="jnp")
    jpool, tpool = _random_pool(tcfg, kv)
    want, jpool = jtf.paged_verify_step_inplace(
        weights()[0], jnp.asarray(TOKENS, jnp.int32), jnp.asarray(POSITIONS, jnp.int32),
        jpool, jnp.asarray(TABLE), jcfg, PS,
    )
    got = _port_verify(tpool, tcfg)
    assert got.shape == (2, K + 1, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the K/V written at [pos, pos + K] through the table, every other page untouched
    for g, w in zip(jax.tree.leaves(tpool), jax.tree.leaves(jpool)):
        np.testing.assert_allclose(g[:, :PAGES].numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_paged_verify_reads_nothing_past_the_frontier(kv):
    """NaN in every pool column past each row's frontier (position + K),
    in every page no row maps and in the sink (the V scales of an int8
    pool; its codes cannot hold NaN) leaves the logits bit-equal."""
    _, tcfg = configs(kv=kv)
    tcfg = dataclasses.replace(tcfg, attention_impl="jnp")
    _, tpool = _random_pool(tcfg, kv)
    planted = jax.tree.map(lambda a: a.clone(), tpool)
    clean = _port_verify(tpool, tcfg)
    mapped = set()
    for row, pos in zip(TABLE, POSITIONS):
        frontier = pos + K
        for lp, page in enumerate(row):
            if page == PAGES:
                continue
            mapped.add(int(page))
            first = max(0, frontier + 1 - lp * PS)
            for name in ("k", "v"):
                leaf = planted[name]["s"] if kv == "int8" else planted[name]
                leaf[:, page, :, first:] = float("nan")
    for name in ("k", "v"):
        leaf = planted[name]["s"] if kv == "int8" else planted[name]
        for page in set(range(PAGES + 1)) - mapped:
            leaf[:, page] = float("nan")
    got = _port_verify(planted, tcfg)
    assert torch.isfinite(clean).all()
    assert torch.equal(got, clean)


def test_verify_queries_lengths_and_tables():
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    flat, lengths = ttf.verify_queries(table, torch.tensor([5, 10]), 4, 4)
    # query j of row b reads b's table up to position b + j; capped at Tp*ps = 12
    assert lengths.tolist() == [6, 7, 8, 9, 11, 12, 12, 12]
    assert lengths.dtype == torch.int32 and flat.dtype == torch.int32
    assert flat.tolist() == [[0, 1, 2]] * 4 + [[3, 4, 5]] * 4


@pytest.mark.parametrize("positions", [[13, 19], [27, 45]], ids=["inside", "past-the-table"])
def test_flattened_verify_matches_the_masked_read(positions):
    """The kernel path's flattening, run through the paged decode kernel's
    plain version on the CPU (one call a layer), against the gathered
    masked read; a row whose queries reach past the table (positions 45..49
    of 48 columns) reads what the masked read shows it."""
    _, tcfg = configs()  # attention_impl "auto": the kernel path
    table = TABLE.copy()
    table[1, 3:] = [8, 9, 10]  # row 1 maps all 6 logical pages
    pos = np.array(positions, np.int64)
    _, pool_a = _random_pool(tcfg, "model")
    pool_b = jax.tree.map(lambda a: a.clone(), pool_a)
    reset_kernel_counts()
    flat = _port_verify(pool_a, tcfg, positions=pos, table=table)
    assert kernel_counts()["paged_decode"]["cpu_calls"] == tcfg.n_layers
    masked = _port_verify(pool_b, dataclasses.replace(tcfg, attention_impl="jnp"),
                          positions=pos, table=table)
    np.testing.assert_allclose(flat.numpy(), masked.numpy(), rtol=1e-5, atol=1e-5)
    # layer 0's K/V are the same bits; deeper layers' follow the attention
    for a, b in zip(jax.tree.leaves(pool_a), jax.tree.leaves(pool_b)):
        assert torch.equal(a[0], b[0])
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_verify_rows_keep_full_capacity():
    """A verify sends B*(K+1) tokens through ``moe_ffn``: the capacity
    floor keeps C = T up to 64 tokens (mixtral-8x7b at max batch 8, K 4:
    40), so no verify token is dropped."""
    assert ttf.moe_capacity(8 * (K + 1), MODEL_PRESETS["mixtral-8x7b"]) == 40
    assert ttf.moe_capacity(2 * (K + 1), MODEL_PRESETS["tiny-moe-test"]) == 10


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_greedy_speculation_matches_jax(kv):
    """Token-exact against the JAX paged engine with speculation and against
    the port's own engine without; the spec stats equal JAX's after each
    prompt, and on the repetitive prompt drafts hit and more than one token
    rides a verify."""
    prompts = (REPETITIVE, PLAIN)
    want, jstats = serve_in_turn(jax_engine(kv=kv), prompts, 24, jax_side=True)
    got, stats = serve_in_turn(port_engine(kv=kv), prompts, 24, jax_side=False)
    plain, off = serve_in_turn(port_engine(kv=kv, spec=False), prompts, 24, jax_side=False)
    assert got == want == plain
    assert [spec_stats(s) for s in stats] == [spec_stats(s) for s in jstats]
    first = stats[0]
    assert first["spec-verify-dispatches-total"] > 0
    assert first["spec-accepted-tokens-per-step"] > 1.0
    assert 0 < first["spec-acceptance-rate"] <= 1.0 and first["spec-draft-hit-rate"] > 0
    # speculation replaces the decode chunks; off, the spec stats are zero
    assert stats[-1]["decode-chunks-total"] == 0
    assert spec_stats(off[-1]) == {**{k: 0 for k in SPEC_KEYS}, "speculation": False,
                                   "spec-acceptance-rate": 0.0,
                                   "spec-accepted-tokens-per-step": 0.0,
                                   "spec-draft-hit-rate": 0.0}


def test_sampled_and_greedy_slots_share_a_verify():
    """A mixed batch: the sampled slot ends with its 20 tokens, the greedy
    slot's tokens equal the JAX engine's."""
    want, _ = serve_in_turn(jax_engine(spec=False), [PLAIN], 24, jax_side=True)
    engine = port_engine()
    engine.start()
    try:
        sampled = engine.submit(GenerationRequest(
            prompt_tokens=REPETITIVE,
            options=GenerationOptions(max_new_tokens=20, temperature=0.8, top_k=16),
        ))
        greedy = engine.submit(GenerationRequest(
            prompt_tokens=PLAIN, options=GenerationOptions(max_new_tokens=24),
        ))
        s, g = sampled.result(timeout=WAIT), greedy.result(timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert len(s.tokens) == 20 and s.finish_reason == "length"
    assert all(0 <= t < MODEL_PRESETS["tiny-test"].vocab_size for t in s.tokens)
    assert g.tokens == want[0]
    assert stats["spec-verify-dispatches-total"] > 0


def _submit_all_then_start(engine, prompts, new, jax_side):
    req_cls, opt_cls = (JaxRequest, JaxOptions) if jax_side else (GenerationRequest,
                                                                   GenerationOptions)
    opts = opt_cls(max_new_tokens=new, temperature=0.0)
    reqs = [engine.submit(req_cls(prompt_tokens=list(p), options=opts)) for p in prompts]
    engine.start()
    try:
        tokens = [r.result(timeout=WAIT).tokens for r in reqs]
        stats = engine.stats()
    finally:
        engine.stop()
    return tokens, stats


def test_moe_speculation_matches_jax():
    """tiny-moe-test, every request submitted before ``start()`` on both
    engines (the same admit groups); verify rows of 4 x 5 tokens stay
    within the experts' capacity. Every request fits the batch: a queued
    admission's iteration depends on whether a verify's fetch has landed
    when the iteration ends (timing, on both engines), and so would the
    count of verify dispatches."""
    prompts = [REPETITIVE[:24], PLAIN, [1, 2, 3, 1, 2, 3, 1, 2]]
    kw = dict(max_batch=4)
    want, jstats = _submit_all_then_start(jax_engine("tiny-moe-test", **kw), prompts, 16, True)
    got, stats = _submit_all_then_start(port_engine("tiny-moe-test", **kw), prompts, 16, False)
    plain, _ = _submit_all_then_start(port_engine("tiny-moe-test", spec=False, **kw), prompts,
                                      16, False)
    assert got == want == plain
    assert spec_stats(stats) == spec_stats(jstats)
    assert stats["spec-verify-dispatches-total"] > 0


def test_request_running_to_max_seq_len_matches_jax():
    """A request that stops at ``max_seq_len``: its last verifies write
    columns past the table (into the sink) and its queries there read the
    whole table; tokens, finish and spec stats equal JAX's."""
    kw = dict(max_seq_len=64, page_size=16)
    opts_new = 60
    want, jstats = serve_in_turn(jax_engine(**kw), [REPETITIVE, PLAIN], opts_new, True)
    engine = port_engine(**kw)
    got, stats = serve_in_turn(engine, [REPETITIVE, PLAIN], opts_new, False)
    plain, _ = serve_in_turn(port_engine(spec=False, **kw), [REPETITIVE, PLAIN], opts_new, False)
    assert got == want == plain
    assert len(got[0]) == 64 - 1 - len(REPETITIVE) + 1
    assert [spec_stats(s) for s in stats] == [spec_stats(s) for s in jstats]
    assert engine._pagepool.pages_in_use == 0


# -- lifecycle and graphs ------------------------------------------------------


def _reference(prompt, new):
    return serve_in_turn(port_engine(spec=False), [prompt], new, False)[0][0]


def test_deadline_mid_verify_returns_partial_tokens():
    engine = port_engine(
        max_batch=1, max_seq_len=256,
        fault_injector=FaultInjector("client@1+", stall_s=0.02),
    )
    engine.start()
    try:
        req = engine.submit(GenerationRequest(
            prompt_tokens=REPETITIVE,
            options=GenerationOptions(max_new_tokens=200, deadline_s=0.6),
        ))
        res = req.result(timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert res.finish_reason == "deadline" and 0 < len(res.tokens) < 200
    assert stats["deadline-decode-total"] == 1
    assert res.tokens == _reference(REPETITIVE, len(res.tokens))


def test_cancel_mid_verify_keeps_the_tokens_before_it():
    engine = port_engine(max_batch=1)
    box = {}

    def on_token(_t):
        box["n"] = box.get("n", 0) + 1
        if box["n"] == 6:
            box["req"].cancel()

    engine.start()
    try:
        box["req"] = GenerationRequest(
            prompt_tokens=REPETITIVE, options=GenerationOptions(max_new_tokens=60),
            on_token=on_token,
        )
        engine.submit(box["req"])
        res = box["req"].result(timeout=WAIT)
        after = engine.generate(PLAIN, GenerationOptions(max_new_tokens=8), timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    # the token after the cancel is dropped, even inside the same verify
    assert res.finish_reason == "cancelled" and res.tokens == _reference(REPETITIVE, 6)
    assert after.tokens == _reference(PLAIN, 8)
    assert stats["cancelled-total"] == 1 and engine._pagepool.pages_in_use == 0


def test_verify_fault_site_quarantines_only_its_victim():
    injector = FaultInjector("verify@3", seed=0)
    engine = port_engine(fault_injector=injector)
    opts = GenerationOptions(max_new_tokens=16)
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts))
            for p in (REPETITIVE, PLAIN)]
    engine.start()
    try:
        for r in reqs:
            r._done.wait(WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    failed = [r for r in reqs if isinstance(r._result.error, LogitsNaNError)]
    survivors = [(p, r) for p, r in zip((REPETITIVE, PLAIN), reqs) if r not in failed]
    assert len(failed) == 1 and len(survivors) == 1
    prompt, survivor = survivors[0]
    assert survivor._result.tokens == _reference(prompt, 16)
    assert stats["quarantined-slots-total"] == 1 and stats["nan-guard-total"] == 1
    assert stats["fault-injection"] == {"verify": 1}
    assert engine._pagepool.pages_in_use == 0


def test_verify_graphs_replace_decode_graphs():
    """With a stand-in graph and the kernel path's flattening, ``start()``
    captures the verify once per sampling branch (with brownout off, the
    decode chunk never: no ladder level can serve it), every verify is one
    replay, the paged decode kernel's plain version counts one call a
    layer a verify, and the tokens equal the JAX engine's."""
    prompts = (REPETITIVE, PLAIN)
    want, _ = serve_in_turn(jax_engine(), prompts, 24, jax_side=True)
    engine = port_engine(brownout="off")
    engine._graph_factory = ReplayGraph
    decode_calls = []
    engine._decode_chunk = lambda *a, **k: decode_calls.append(a)
    reset_kernel_counts()
    engine.start()
    captured = engine.stats()
    try:
        got = [engine.generate(p, GenerationOptions(max_new_tokens=24), timeout=WAIT).tokens
               for p in prompts]
        stats = engine.stats()
    finally:
        engine.stop()
    assert got == want and not decode_calls
    assert captured["graph-captures-total"] == 3 and captured["compiled_programs"] == 3
    verifies = stats["spec-verify-dispatches-total"]
    assert verifies > 0 and stats["graph-replays-total"] == verifies
    assert stats["decode-chunks-total"] == 0
    calls = kernel_counts()["paged_decode"]["cpu_calls"]
    assert calls == engine.config.n_layers * verifies


def test_restart_captures_the_verify_graphs_again():
    """``decode@3`` under speculation (brownout off: the verify set only):
    the request in flight fails, the loop restarts with the verify graphs
    captured again (6 captures), and the request queued behind it is
    served token-exact."""
    engine = port_engine(max_batch=1, fault_injector=FaultInjector("decode@3"),
                         restart_backoff_s=0.02, brownout="off")
    engine._graph_factory = ReplayGraph
    opts = GenerationOptions(max_new_tokens=20)
    first = engine.submit(GenerationRequest(prompt_tokens=REPETITIVE, options=opts))
    second = engine.submit(GenerationRequest(prompt_tokens=PLAIN, options=opts))
    engine.start()
    try:
        with pytest.raises(InjectedFault):
            first.result(timeout=WAIT)
        res = second.result(timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert res.tokens == _reference(PLAIN, 20)
    assert stats["engine-restarts-total"] == 1 and stats["graph-captures-total"] == 6
    assert stats["compiled_programs"] == 3
    assert stats["graph-replays-total"] == stats["spec-verify-dispatches-total"]


def test_dense_speculation_is_refused():
    """Refused until the dense verify was ported; now served: a dense engine
    with speculation builds its verify buffers (tests/test_torch_dense_verify.py
    holds it against the JAX dense engine)."""
    dense = port_engine(kv_layout="dense")
    assert dense._spec_enabled and dense.spec_tokens == K and dense._drafts_dev.shape == (2, K)
    dense.stop()
    assert port_engine(speculation_tokens=0).spec_tokens == 1


def test_provider_speculation_keys():
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    base = {"model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4}
    assert TorchCompletionsService(
        {**base, "kv-layout": "dense", "speculation": "auto"}).speculation == "auto"
    with pytest.raises(ValueError, match="unknown speculation"):
        TorchCompletionsService({**base, "speculation": "eager"})
    with pytest.raises(ValueError, match="speculation-tokens must be >= 1"):
        TorchCompletionsService({**base, "speculation": "auto", "speculation-tokens": 0})
    assert TorchCompletionsService({**base, "kv-layout": "dense"}).speculation == "off"
    svc = TorchCompletionsService({**base, "speculation": "auto", "speculation-tokens": 3})
    try:
        result = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="abcabcabcabc")], {"max-tokens": 12},
        ))
        stats = svc.engine_stats()
    finally:
        svc.close()
    assert result.completion_tokens == 12 or result.finish_reason == "stop"
    assert stats["speculation"] is True and stats["speculation-tokens"] == 3
    assert stats["spec-verify-dispatches-total"] > 0
