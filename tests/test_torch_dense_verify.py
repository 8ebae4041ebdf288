"""The dense layout's speculative verify in the port against the JAX package,
on the CPU (tiny-test and tiny-moe-test, f32; int8 KV runs the reference
attention "jnp" on both sides, since the JAX package's CPU "auto" path
quantizes q and p where the port's kernel path does not).

- The dense decode kernel's queries-per-row divisor: the plain version
  with k + 1 query rows a cache row equals the same queries over each
  row repeated k + 1 times, and ``decode_launch_plan`` agrees with the
  launch (query rows = cache rows x qpr; a paged launch refuses qpr > 1).
- ``verify_step_inplace``: logits at all K+1 positions within the f32
  tolerance of JAX's ("jnp" both sides; bf16-free: f32 and int8 KV), with
  adapter rows, and the cache's written columns equal. The kernel path's
  flattening (``dense_verify_queries``, the dense decode kernel's plain
  version, qpr = K+1) equals the masked read within 1e-5, a view narrower
  than the queries' reach included; NaN planted past every row's frontier
  and in the sink column leaves its logits bit-equal.
- The dense engine with ``speculation="auto"`` against the JAX dense
  engine on the same weights (through ``bridge``): greedy tokens equal to
  JAX's and to the port's own non-speculative dense engine, the spec stats
  equal after each prompt (f32 and int8); tiny-moe-test with every request
  submitted before ``start()``; a constrained request parses; the verify
  graphs replayed through a stand-in graph count one dense decode launch a
  layer a verify; the provider serves ``speculation: auto`` on ``kv-layout:
  dense``.
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
from langstream_tpu.serving import adapters as jad
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
from langstream_tpu_torch.ai.provider import ChatMessage
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops.attention import (
    decode_launch_plan,
    kernel_counts,
    ragged_decode_attention,
    ragged_decode_reference,
    reset_kernel_counts,
)
from langstream_tpu_torch.serving import adapters as tad
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from test_torch_constrain import assert_in_grammar, assert_same, run_all, spec_items
from test_torch_constrain import jax_engine as constrain_jax_engine
from test_torch_constrain import port_engine as constrain_port_engine
from test_torch_graphs import ReplayGraph

WAIT = 120.0
K = 4
# f32 logits through the model; int8 KV ("jnp" both sides); int8 rows with
# an adapter: the f32 LoRA delta's summation order differs from XLA's by
# ~1e-6, which moves a few int8 codes by one step (test_torch_adapters.py)
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
INT8_ADAPTER_LOGIT_TOL = 3e-2
# greedy decode on tiny-test's random weights enters a cycle on this prompt
# (drafts hit); the second is not repetitive (drafts mostly miss)
REPETITIVE = ([5, 9, 11, 7] * 10)[:40]
PLAIN = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
SPEC_KEYS = (
    "speculation", "speculation-tokens", "spec-acceptance-rate",
    "spec-accepted-tokens-per-step", "spec-draft-hit-rate", "spec-draft-tokens-total",
    "spec-accepted-tokens-total", "spec-verify-dispatches-total",
)
ADAPTERS = [
    {"name": "tenant-a", "rank": 4, "scale": 2.0, "seed": 11},
    {"name": "tenant-b", "rank": 2, "scale": 0.5, "seed": 22},
]


@functools.lru_cache(maxsize=None)
def configs(preset: str = "tiny-test", kv: str = "model", impl: str = "auto"):
    fields = dict(dtype="float32", kv_cache_dtype=kv)
    if kv == "int8":
        impl = "jnp"
    return (
        dataclasses.replace(JAX_PRESETS[preset], attention_impl=impl, **fields),
        dataclasses.replace(MODEL_PRESETS[preset], attention_impl=impl, **fields),
    )


@functools.lru_cache(maxsize=None)
def weights(preset: str = "tiny-test"):
    jcfg, tcfg = configs(preset)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


# -- the kernel's queries-per-row divisor --------------------------------------


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("qpr", [1, 3, 5])
def test_decode_reference_queries_per_row_equals_repeated_rows(kv, qpr):
    """qpr query rows a cache row against the same queries over each cache
    row repeated qpr times (within 1e-6: the products run at other shapes);
    the wrapper on CPU tensors takes the plain version with the divisor."""
    cfg = configs(kv=kv)[1]
    rng = np.random.default_rng(qpr)
    rows, t, hkv, d = 3, 40, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.from_numpy(rng.normal(size=(rows * qpr, cfg.n_heads, d)).astype(np.float32))
    if kv == "int8":
        k, v = ({"q": torch.from_numpy(rng.integers(-127, 128, (rows, hkv, t, d)).astype(np.int8)),
                 "s": torch.from_numpy(rng.uniform(0.01, 0.02, (rows, hkv, t)).astype(np.float32))}
                for _ in range(2))
        rep = {n: (lambda e: {f: a.repeat_interleave(qpr, 0) for f, a in e.items()})
               for n in ("k", "v")}
        k_rep, v_rep = rep["k"](k), rep["v"](v)
    else:
        k, v = (torch.from_numpy(rng.normal(size=(rows, hkv, t, d)).astype(np.float32))
                for _ in range(2))
        k_rep, v_rep = k.repeat_interleave(qpr, 0), v.repeat_interleave(qpr, 0)
    lengths = torch.from_numpy(rng.integers(1, t + 1, rows * qpr).astype(np.int32))
    got = ragged_decode_reference(q, k, v, lengths, cfg, qpr)
    want = ragged_decode_reference(q, k_rep, v_rep, lengths, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    reset_kernel_counts()
    wrapped = ragged_decode_attention(q, k, v, lengths, cfg, queries_per_row=qpr) \
        if kv == "model" else None
    if wrapped is not None:
        assert torch.equal(wrapped, got)
        assert kernel_counts()["dense_decode"] == {"launches": 0, "cpu_calls": 1}


def test_decode_launch_plan_agrees_with_the_divisor():
    """The plan of a flattened verify (8 cache rows x 5 queries) is the
    decode step's plan with 40 query rows; a cache whose rows do not match
    the queries / qpr, and a paged launch with qpr > 1, are refused."""
    shape, strides = (8, 8, 2048, 128), (8 * 8193 * 128, 8193 * 128, 128, 1)
    plan = decode_launch_plan((40, 32, 128), shape, strides, torch.bfloat16, "dense",
                              queries_per_row=5)
    one = decode_launch_plan((8, 32, 128), shape, strides, torch.bfloat16, "dense")
    assert plan["queries_per_row"] == 5 and one["queries_per_row"] == 1
    assert plan["grid"] == (8, 40, one["cluster"])
    assert {k: v for k, v in plan.items() if k not in ("grid", "queries_per_row")} == {
        k: v for k, v in one.items() if k not in ("grid", "queries_per_row")}
    with pytest.raises(ValueError, match="a cache row"):
        decode_launch_plan((40, 32, 128), (7,) + shape[1:], strides, torch.bfloat16, "dense",
                           queries_per_row=5)
    with pytest.raises(ValueError, match="a cache row"):
        decode_launch_plan((40, 32, 128), shape, strides, torch.bfloat16, "dense",
                           queries_per_row=4)
    with pytest.raises(ValueError, match="queries a cache row"):
        decode_launch_plan((40, 32, 128), (10, 8, 64, 128), (65536, 8192, 128, 1),
                           torch.bfloat16, "paged", table_width=4, queries_per_row=5)


def test_dense_verify_queries_lengths():
    lengths = ttf.dense_verify_queries(torch.tensor([5, 10]), 4, 12)
    # query j of row b reads up to position b + j, capped at the 12 columns
    assert lengths.tolist() == [6, 7, 8, 9, 11, 12, 12, 12]
    assert lengths.dtype == torch.int32


# -- verify_step_inplace -------------------------------------------------------

T = 32
POSITIONS = np.array([13, 19, 26], np.int64)
TOKENS = np.array([[2, 40, 41, 42, 43], [5, 7, 9, 11, 13], [1, 8, 8, 8, 8]], np.int64)
ROWS = np.array([1, 0, 2], np.int32)


def _random_cache(cfg, kv: str, seed=0):
    """A JAX dense cache of random finite values ([L, 3, Hkv, T, D]; int8:
    codes and positive scales) → (JAX cache, port cache with a sink column
    of zeros)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 3, cfg.n_kv_heads, T, cfg.resolved_head_dim)

    def leaf():
        if kv == "int8":
            return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                    "s": rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32)}
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    jcache = {"k": leaf(), "v": leaf()}

    def with_sink(a):
        sink = np.zeros(a.shape[:3] + (1,) + a.shape[4:], a.dtype)
        return torch.from_numpy(np.concatenate([a, sink], axis=3))

    tcache = jax.tree.map(with_sink, jcache)
    return jax.tree.map(jnp.asarray, jcache), tcache


def _pools():
    """The JAX and the port adapter pools with both adapters resident."""
    jcfg, tcfg = configs()
    jreg, treg = jad.AdapterRegistry(jcfg, 3, 4), tad.AdapterRegistry(tcfg, 3, 4, device="cpu")
    for spec in ADAPTERS:
        jreg.register(dict(spec))
        treg.register(dict(spec))
    for spec in ADAPTERS:
        assert treg.acquire(spec["name"]) == jreg.acquire(spec["name"])
    return jreg.pool, treg.pool


def _port_verify(cache, cfg, positions=POSITIONS, kv_bound=None, lora=None):
    rows = torch.from_numpy(ROWS).long() if lora is not None else None
    return ttf.verify_step_inplace(
        weights()[1], torch.from_numpy(TOKENS), torch.from_numpy(positions), cache, cfg,
        kv_bound, lora=lora, adapter_rows=rows,
    )[0]


@pytest.mark.parametrize("adapters", [False, True], ids=["base", "adapters"])
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_verify_step_matches_jax(kv, adapters):
    """Logits [B, K+1, V] within the tolerance of JAX's at every position
    ("jnp" both sides; int8 rows with an adapter within
    INT8_ADAPTER_LOGIT_TOL), and the cache's K/V written at [pos, pos + K],
    every other column untouched."""
    jcfg, tcfg = configs(kv=kv, impl="jnp")
    jcache, tcache = _random_cache(tcfg, kv)
    jl = tl = None
    if adapters:
        jl, tl = _pools()
    want, jcache = jtf.verify_step_inplace(
        weights()[0], jnp.asarray(TOKENS, jnp.int32), jnp.asarray(POSITIONS, jnp.int32),
        jcache, jcfg, lora=jl, adapter_rows=jnp.asarray(ROWS) if adapters else None,
    )
    got = _port_verify(tcache, tcfg, lora=tl)
    assert got.shape == (3, K + 1, tcfg.vocab_size)
    got, want = got.numpy(), np.asarray(want)
    if kv == "int8":
        base = ROWS == 0 if adapters else np.ones(3, bool)
        np.testing.assert_allclose(got[base], want[base], atol=INT8_LOGIT_TOL)
        np.testing.assert_allclose(got, want, atol=INT8_ADAPTER_LOGIT_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        # the written K/V: 1e-6, or 1e-5 with adapters (the f32 delta's
        # summation order differs from XLA's by ~1e-6)
        atol = 1e-5 if adapters else 1e-6
        for g, w in zip(jax.tree.leaves(tcache), jax.tree.leaves(jcache)):
            np.testing.assert_allclose(g[:, :, :, :T].numpy(), np.asarray(w), rtol=1e-5,
                                       atol=atol)


@pytest.mark.parametrize("case", ["inside", "past-the-view"])
def test_flattened_dense_verify_matches_the_masked_read(case):
    """The kernel path's flattening, run through the dense decode kernel's
    plain version on the CPU (one call a layer, K+1 queries a cache row),
    against the masked read (``"jnp"``); a view narrower than the last
    row's reach (positions 26..30 of a 28-column view) caps its lengths at
    the view, which is what the masked read shows it."""
    _, tcfg = configs()
    bound = None if case == "inside" else 28
    _, cache_a = _random_cache(tcfg, "model")
    cache_b = jax.tree.map(lambda a: a.clone(), cache_a)
    reset_kernel_counts()
    flat = _port_verify(cache_a, tcfg, kv_bound=bound)
    assert kernel_counts()["dense_decode"]["cpu_calls"] == tcfg.n_layers
    masked = _port_verify(cache_b, dataclasses.replace(tcfg, attention_impl="jnp"),
                          kv_bound=bound)
    np.testing.assert_allclose(flat.numpy(), masked.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(cache_a), jax.tree.leaves(cache_b)):
        assert torch.equal(a[0], b[0])
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_flattened_dense_verify_reads_nothing_past_the_frontier(kv):
    """NaN in every cache column past each row's frontier (position + K)
    and in the sink column (an int8 cache's scales; its codes cannot hold
    NaN) leaves the kernel path's logits bit-equal."""
    _, tcfg = configs(kv=kv)
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    _, cache = _random_cache(tcfg, kv)
    planted = jax.tree.map(lambda a: a.clone(), cache)
    clean = _port_verify(cache, tcfg)
    for row, pos in enumerate(POSITIONS):
        for name in ("k", "v"):
            leaf = planted[name]["s"] if kv == "int8" else planted[name]
            leaf[:, row, :, pos + K + 1:] = float("nan")
    got = _port_verify(planted, tcfg)
    assert torch.isfinite(clean).all()
    assert torch.equal(got, clean)


# -- the engine ----------------------------------------------------------------


def jax_engine(preset="tiny-test", kv="model", spec=True, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("speculation_tokens", K)
    return JaxEngine(configs(preset, kv)[0], weights(preset)[0], kv_layout="dense",
                     speculation="auto" if spec else "off", **kw)


def port_engine(preset="tiny-test", kv="model", spec=True, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("speculation_tokens", K)
    return ServingEngine(configs(preset, kv)[1], weights(preset)[1], device="cpu",
                         kv_layout="dense", speculation="auto" if spec else "off", **kw)


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


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_greedy_dense_speculation_matches_jax(kv):
    """Token-exact against the JAX dense engine with speculation and
    against the port's own dense engine without; the spec stats equal
    JAX's after each prompt; on the repetitive prompt drafts hit and more
    than one token rides a verify. (f32: the port's verify runs the
    flattened kernel path; int8: "jnp" both sides.)"""
    prompts = (REPETITIVE, PLAIN)
    want, jstats = serve_in_turn(jax_engine(kv=kv), prompts, 24, jax_side=True)
    got, stats = serve_in_turn(port_engine(kv=kv), prompts, 24, jax_side=False)
    plain, _ = serve_in_turn(port_engine(kv=kv, spec=False), prompts, 24, jax_side=False)
    assert got == want == plain
    assert [spec_stats(s) for s in stats] == [spec_stats(s) for s in jstats]
    assert stats[0]["spec-verify-dispatches-total"] > 0
    assert stats[0]["spec-accepted-tokens-per-step"] > 1.0


def test_dense_speculation_to_max_seq_len_matches_jax():
    """A request that runs to max_seq_len: verifies near the end write past
    the cache (the port's sink column, JAX's dropped writes) and read no
    column past max_seq_len; tokens equal JAX's."""
    prompt = REPETITIVE[:30]
    kw = dict(max_seq_len=48)
    want, _ = serve_in_turn(jax_engine(**kw), [prompt], 40, jax_side=True)
    got, _ = serve_in_turn(port_engine(**kw), [prompt], 40, jax_side=False)
    assert got == want and len(got[0]) == 48 - len(prompt)


def test_moe_dense_speculation_matches_jax():
    """tiny-moe-test with every request submitted before ``start()`` on both
    engines (MoE rows share the experts' capacity, so the admit groups
    must be the same): tokens and spec stats equal."""
    prompts = [REPETITIVE, PLAIN]

    def run(engine, jax_side):
        opts = (JaxOptions if jax_side else GenerationOptions)(max_new_tokens=16)
        request = JaxRequest if jax_side else GenerationRequest
        reqs = [engine.submit(request(prompt_tokens=list(p), options=opts)) for p in prompts]
        engine.start()
        try:
            out = [r.result(timeout=WAIT).tokens for r in reqs]
            return out, engine.stats()
        finally:
            engine.stop()

    want, jstats = run(jax_engine("tiny-moe-test"), True)
    got, stats = run(port_engine("tiny-moe-test"), False)
    assert got == want
    assert spec_stats(stats) == spec_stats(jstats)


def test_constrained_dense_speculation_matches_jax_and_parses():
    """The agentic tier rides the dense verify: grammar states at every
    verify position. Tokens, finish reasons and the spec counters equal the
    JAX dense engine's; every constrained output parses."""
    kw = dict(speculation="auto", speculation_tokens=4, kv_layout="dense")
    want, jstats = run_all(constrain_jax_engine(**kw), spec_items(), True)
    got, stats = run_all(constrain_port_engine(**kw), spec_items(), False)
    assert_same(want, got)
    keys = ("spec-draft-tokens-total", "spec-accepted-tokens-total",
            "spec-verify-dispatches-total", "constrained-requests-total")
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["spec-accepted-tokens-total"] > 0
    for (_, o), r in zip(spec_items(), got):
        if "response_format" in o:
            assert_in_grammar(r, o["response_format"])


@pytest.mark.parametrize("brownout", ["off", "auto"])
def test_dense_verify_replays_count_one_launch_a_layer(brownout):
    """With a stand-in graph the dense engine captures the verify set (and
    with brownout on the decode set beside it): every verify is one replay,
    and each replay counts one dense decode call a layer — the flattened
    queries — exactly as a direct call; tokens equal the direct calls'."""
    engine = port_engine(brownout=brownout)
    engine._graph_factory = ReplayGraph
    reset_kernel_counts()
    got, stats = serve_in_turn(engine, [REPETITIVE], 24, jax_side=False)
    direct, _ = serve_in_turn(port_engine(brownout=brownout), [REPETITIVE], 24, jax_side=False)
    s = stats[-1]
    assert got == direct
    assert s["compiled_programs"] == (3 if brownout == "off" else 6)
    verifies = s["spec-verify-dispatches-total"]
    assert verifies > 0 and s["graph-replays-by-kind"]["verify"] == verifies
    layers = engine.config.n_layers
    # admissions prefill without the decode kernel; only replays count here
    assert kernel_counts()["dense_decode"]["cpu_calls"] >= layers * verifies


def test_provider_serves_dense_speculation():
    """``speculation: auto`` on ``kv-layout: dense`` is served (no longer
    refused): a completion runs through the dense engine's verifies."""
    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "kv-layout": "dense", "speculation": "auto",
        "max-seq-len": 128, "max-batch": 2, "decode-chunk": 4,
    })
    try:
        res = asyncio.run(svc.get_chat_completions(
            [ChatMessage("user", "abcabcabcabcabcabc")], {"max-tokens": 12}
        ))
        stats = svc.engine_stats()
    finally:
        svc.close()
    assert res.completion_tokens > 0
    assert stats["speculation"] is True and stats["spec-verify-dispatches-total"] > 0
    assert stats["kv-layout"] == "dense"
