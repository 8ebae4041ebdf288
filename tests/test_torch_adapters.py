"""Multi-LoRA in the PyTorch port (``serving/adapters.py``, the gathered
adapter delta of ``models/transformer.py``, ``models/loader.
load_lora_params``, the engine's adapter rows), held against the JAX
package on the CPU (tiny-test and tiny-moe-test, f32):

- the registry: ``init_random_lora`` by seed, the pool rows after the same
  swaps and LRU evictions, the pool arithmetic, bit-equal;
- ``load_lora_params`` of a peft directory the test writes (the port's own
  writer), bit-equal;
- ``_lora_delta`` and the prefill / decode / verify / segment logits with
  adapters, paged and dense, f32 and int8 KV, within the stated f32
  tolerance (int8 runs "jnp" on both sides, prompts of at most 16 tokens);
- the engines token-exact against the JAX engine with every request
  submitted before ``start()`` (the admit groups then match): a mixed batch
  of base + 2 adapters + constrained requests on both layouts, an adapter
  swap under pool pressure, tiny-moe-test with attention-only adapters —
  and the agentic stats equal where JAX reports them;
- behaviour: adapter requests never touch the prefix index, a pool pinned
  full sheds with a retry-after, the ``adapter`` fault site quarantines its
  victim alone, and the provider serves the adapter keys.
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
from langstream_tpu.models.loader import load_lora_params as jax_load_lora
from langstream_tpu.serving import adapters as jad
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.memory import plan_serving_memory as jax_plan
from langstream_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.models.loader import _LORA_PROJ_HF, load_lora_params, write_safetensors
from langstream_tpu_torch.serving import adapters as tad
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine, ShedError
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.memory import plan_serving_memory
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

torch.backends.cuda.matmul.allow_tf32 = False

WAIT = 300.0
# f32 tolerances: the low-rank delta alone, and logits through the model
DELTA_TOL = 1e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
# int8 KV rows WITH an adapter: the f32 delta's summation order differs
# from XLA's einsum by ~1e-6 (2e-7 of the K/V values), which moves a few
# int8 codes at a rounding boundary by one step; through the hoisted-scale
# int8 attention a moved code shifts tiny-test's logits by up to ~1.2e-2.
# Base rows (adapter row 0) still hold INT8_LOGIT_TOL.
INT8_ADAPTER_LOGIT_TOL = 3e-2

ADAPTERS = [
    {"name": "tenant-a", "rank": 4, "scale": 2.0, "seed": 11},
    {"name": "tenant-b", "rank": 2, "scale": 0.5, "seed": 22},
]
SCHEMA = {"type": "object", "properties": {"name": {"type": "string", "maxLength": 8},
                                           "n": {"type": "integer"}}}
RF = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
RX = {"type": "regex", "regex": "(yes|no)-[0-9]{2,4}"}
AGENTIC_KEYS = (
    "adapters", "adapters-registered", "adapters-resident", "adapter-pool-rows",
    "adapter-swaps-total", "adapter-pool-bytes", "constrained-decoding",
    "constrained-requests-total", "grammars-resident", "grammar-swaps-total",
    "grammar-pool-bytes",
)


@functools.lru_cache(maxsize=None)
def configs(preset: str = "tiny-test", kv: str = "model", impl: str = "auto"):
    fields = dict(dtype="float32", kv_cache_dtype=kv)
    jimpl = "pallas" if impl == "auto" else impl
    return (
        dataclasses.replace(JAX_PRESETS[preset], attention_impl=jimpl, **fields),
        dataclasses.replace(MODEL_PRESETS[preset], attention_impl=impl, **fields),
    )


@functools.lru_cache(maxsize=None)
def weights(preset: str = "tiny-test"):
    jcfg, tcfg = configs(preset)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def registries(preset="tiny-test", rows=3, rank=4, adapters=ADAPTERS):
    """A JAX and a port registry with the same adapters registered."""
    jcfg, tcfg = configs(preset)
    jreg = jad.AdapterRegistry(jcfg, rows, rank)
    treg = tad.AdapterRegistry(tcfg, rows, rank, device="cpu")
    for spec in adapters:
        jreg.register(dict(spec))
        treg.register(dict(spec))
    return jreg, treg


def assert_pools_equal(jpool, tpool):
    assert set(jpool) == set(tpool)
    for proj, entry in jpool.items():
        if proj == "scale":
            np.testing.assert_array_equal(tpool["scale"].numpy(), np.asarray(entry))
            continue
        for factor in ("a", "b"):
            np.testing.assert_array_equal(tpool[proj][factor].numpy(), np.asarray(entry[factor]))


# -- the registry ------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-moe-test"])
@pytest.mark.parametrize("seed", [0, 11])
def test_init_random_lora_matches_jax_by_seed(preset, seed):
    jcfg, tcfg = configs(preset)
    want = jad.init_random_lora(jcfg, 4, seed)
    got = tad.init_random_lora(tcfg, 4, seed)
    assert set(got) == set(want)
    for proj in want:
        for factor in ("a", "b"):
            np.testing.assert_array_equal(got[proj][factor], want[proj][factor])
    # MoE: attention-only adapters
    assert set(got) == ({"wq", "wk", "wv", "wo"} if tcfg.is_moe else set(ttf.LORA_PROJS))


def test_registry_rows_match_jax_after_swaps_and_lru():
    """Three adapters through a pool of 2 usable rows: acquire, release,
    swap in under pressure (LRU), re-register a resident one — the pool
    equals JAX's bit for bit after every step, as do rows and stats."""
    three = ADAPTERS + [{"name": "tenant-c", "rank": 3, "scale": 1.5, "seed": 33}]
    jreg, treg = registries(adapters=three)
    steps = [("acquire", "tenant-a"), ("acquire", "tenant-b"), ("release", "tenant-a"),
             ("acquire", "tenant-c"), ("release", "tenant-b"), ("release", "tenant-c"),
             ("acquire", "tenant-a"), ("release", "tenant-a"),
             ("register", {"name": "tenant-c", "rank": 4, "scale": 3.0, "seed": 44}),
             ("acquire", "tenant-c")]
    for op, arg in steps:
        if op == "register":
            jreg.register(dict(arg))
            treg.register(dict(arg))
            continue
        got = getattr(treg, op)(arg)
        want = getattr(jreg, op)(arg)
        assert got == want, (op, arg)
        assert_pools_equal(jreg.pool, treg.pool)
        assert treg.stats() == jreg.stats()
        assert treg.advertised() == jreg.advertised()


def test_registry_refusals_match_jax():
    jcfg, tcfg = configs()
    jreg, treg = registries(rows=2)
    with pytest.raises(KeyError):
        treg.acquire("ghost")
    with pytest.raises(ValueError, match="exceeds the pool rank"):
        treg.register({"name": "big", "rank": 8, "seed": 1})
    with pytest.raises(ValueError):
        tad.AdapterRegistry(tcfg, 1, 4, device="cpu")
    # one usable row, pinned: the second adapter cannot swap in
    assert treg.acquire("tenant-a") == jreg.acquire("tenant-a") == 1
    with pytest.raises(tad.AdapterPoolExhausted):
        treg.acquire("tenant-b")
    with pytest.raises(jad.AdapterPoolExhausted):
        jreg.acquire("tenant-b")
    with pytest.raises(ValueError, match="active request"):
        treg.unregister("tenant-a")


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-moe-test", "llama-3-8b"])
def test_pool_arithmetic_matches_jax(preset):
    jcfg = JAX_PRESETS[preset]
    tcfg = MODEL_PRESETS[preset]
    for rows, rank in ((2, 4), (3, 16), (0, 8)):
        assert tad.lora_pool_bytes(tcfg, rows, rank) == jad.lora_pool_bytes(jcfg, rows, rank)
    for fraction, registered in ((0.1, 0), (0.0, 3), (1.0, 1), (50.0, 0)):
        assert tad.rows_for_fraction(tcfg, 16, 10 ** 9, fraction, registered) == \
            jad.rows_for_fraction(jcfg, 16, 10 ** 9, fraction, registered)


def test_pool_is_allocated_once_and_written_in_place():
    _, treg = registries()
    ptrs = {(p, f): treg.pool[p][f].data_ptr() for p in treg.pool if p != "scale"
            for f in ("a", "b")}
    treg.acquire("tenant-a")
    treg.acquire("tenant-b")
    assert ptrs == {(p, f): treg.pool[p][f].data_ptr() for p in treg.pool if p != "scale"
                    for f in ("a", "b")}


def test_memory_plan_adapter_and_grammar_terms_match_jax():
    jcfg, tcfg = JAX_PRESETS["llama-3-8b"], MODEL_PRESETS["llama-3-8b"]
    kw = dict(adapter_pool_rows=3, adapter_rank=16, grammar_slots=64, grammar_states=128,
              grammar_exceptions=65536)
    want = jax_plan(jcfg, 8, 2048, **kw)
    got = plan_serving_memory(tcfg, 8, 2048, workspace_bytes=0, **kw)
    assert got.adapter_pool_bytes == want.adapter_pool_bytes > 0
    assert got.grammar_pool_bytes == want.grammar_pool_bytes > 0
    off = plan_serving_memory(tcfg, 8, 2048, workspace_bytes=0)
    assert off.adapter_pool_bytes == off.grammar_pool_bytes == 0
    assert got.total_bytes - off.total_bytes == got.adapter_pool_bytes + got.grammar_pool_bytes
    assert "adapter-pool" in got.summary() and "grammar-pool" in got.summary()


# -- load_lora_params -------------------------------------------------------


def save_lora_hf(factors, config, path, dtype=torch.float32, prefix="base_model.model.model."):
    """Factor trees ([L, din, r] / [L, r, dout]) as one peft-layout
    ``adapter_model.safetensors`` (``lora_A`` [r, in], ``lora_B`` [out, r])
    under ``path``, through the port's own safetensors writer."""
    items = []
    for proj, ab in factors.items():
        for i in range(config.n_layers):
            for factor, arr in (("lora_A", ab["a"][i]), ("lora_B", ab["b"][i])):
                tensor = torch.from_numpy(np.ascontiguousarray(arr.T)).to(dtype)
                items.append((f"{prefix}layers.{i}.{_LORA_PROJ_HF[proj]}.{factor}.weight",
                              dtype, tuple(tensor.shape), lambda t=tensor: t))
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(path / "adapter_model.safetensors", items)


@pytest.mark.parametrize("preset", ["tiny-test", "tiny-moe-test"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_load_lora_params_matches_jax(tmp_path, preset, dtype):
    """A peft directory written with the port's writer (rank 3, a q/v-only
    projection subset beside full ones) loads bit-equal in both packages,
    padded to rank 4, absent projections zero."""
    jcfg, tcfg = configs(preset)
    factors = tad.init_random_lora(tcfg, 3, 5)
    if not tcfg.is_moe:
        factors = {k: v for k, v in factors.items() if k not in ("wk", "w_up")}
    save_lora_hf(factors, tcfg, tmp_path, dtype=dtype)
    got = load_lora_params(tmp_path, tcfg, 4)
    want = jax_load_lora(tmp_path, jcfg, 4)
    assert set(got) == set(want)
    for proj in want:
        for factor in ("a", "b"):
            assert got[proj][factor].dtype == np.float32
            np.testing.assert_array_equal(got[proj][factor], want[proj][factor])
    if not tcfg.is_moe:
        assert not got["wk"]["a"].any() and not got["w_up"]["b"].any()
    # an adapter registered from the directory lands in the pool as JAX's
    jreg = jad.AdapterRegistry(jcfg, 2, 4)
    treg = tad.AdapterRegistry(tcfg, 2, 4, device="cpu")
    spec = {"name": "peft", "rank": 4, "scale": 2.0, "path": str(tmp_path)}
    jreg.register(spec)
    treg.register(spec)
    assert treg.acquire("peft") == jreg.acquire("peft")
    assert_pools_equal(jreg.pool, treg.pool)


def test_load_lora_params_refusals_match_jax(tmp_path):
    jcfg, tcfg = configs()
    factors = tad.init_random_lora(tcfg, 2, 1)
    save_lora_hf({"wq": factors["wq"]}, tcfg, tmp_path / "one", prefix="a.model.")
    save_lora_hf({"wq": factors["wq"]}, tcfg, tmp_path / "two", prefix="b.model.")
    (tmp_path / "two" / "adapter_model.safetensors").rename(
        tmp_path / "one" / "second.safetensors"
    )
    with pytest.raises(ValueError, match="ambiguous") as got:
        load_lora_params(tmp_path / "one", tcfg, 4)
    with pytest.raises(ValueError, match="ambiguous"):
        jax_load_lora(tmp_path / "one", jcfg, 4)
    save_lora_hf({"wq": factors["wq"]}, tcfg, tmp_path / "rank")
    with pytest.raises(ValueError, match="exceeds the requested rank"):
        load_lora_params(tmp_path / "rank", tcfg, 1)
    assert "ambiguous" in str(got.value)


# -- the adapter delta and the model paths -----------------------------------


def test_lora_delta_matches_jax():
    rng = np.random.default_rng(0)
    jreg, treg = registries()
    treg.acquire("tenant-a"), jreg.acquire("tenant-a")
    treg.acquire("tenant-b"), jreg.acquire("tenant-b")
    rows = np.array([0, 2, 1, 2], np.int32)
    for proj in ("wq", "w_down"):
        din = treg.pool[proj]["a"].shape[2]
        x = rng.normal(size=(4, 3, din)).astype(np.float32)
        want = jtf._lora_delta(
            jnp.asarray(x), {k: v[1] for k, v in jreg.pool[proj].items()},
            jreg.pool["scale"], jnp.asarray(rows),
        )
        got = ttf._lora_delta(
            torch.from_numpy(x), {k: v[1] for k, v in treg.pool[proj].items()},
            treg.pool["scale"], torch.from_numpy(rows).long(),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DELTA_TOL, atol=DELTA_TOL)
        assert not got[0].any()  # the base row adds exactly nothing


def _pools(preset="tiny-test"):
    jreg, treg = registries(preset)
    for name in ("tenant-a", "tenant-b"):
        assert treg.acquire(name) == jreg.acquire(name)
    return jreg.pool, treg.pool


def assert_logits(got, want, kv: str) -> None:
    """Logits [B, ...] with adapter rows ``ROWS``: every row within the
    tolerance of its KV dtype; int8 rows with an adapter within
    INT8_ADAPTER_LOGIT_TOL, base rows within INT8_LOGIT_TOL."""
    got, want = got.numpy(), np.asarray(want)
    if kv != "int8":
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
        return
    base = ROWS == 0
    np.testing.assert_allclose(got[base], want[base], atol=INT8_LOGIT_TOL)
    np.testing.assert_allclose(got, want, atol=INT8_ADAPTER_LOGIT_TOL)


PS, PAGES = 8, 12
TABLE = np.array([[0, 1, 2, PAGES], [4, 5, 6, PAGES], [8, 9, 10, PAGES]], np.int32)
ROWS = np.array([1, 0, 2], np.int32)


def _prompts(width=16):
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 256, (3, width)).astype(np.int32)
    lengths = np.array([width, width - 5, width - 9], np.int32)
    return tokens, lengths


# (KV dtype, attention path): int8 KV runs the reference path on both sides
KV_PATHS = [("model", "auto"), ("model", "jnp"), ("int8", "jnp")]


@pytest.mark.parametrize("kv, impl", KV_PATHS)
@pytest.mark.parametrize("preset", ["tiny-test", "tiny-moe-test"])
def test_paged_prefill_decode_verify_with_adapters_match_jax(preset, kv, impl):
    """Adapter rows [1, 0, 2] through the admit group's prefill, its page
    insert, two decode steps and a verify of 3 positions: logits within
    the f32 tolerance of JAX's, and the adapter changes the logits."""
    jcfg, tcfg = configs(preset, kv, impl)
    jp, tp = weights(preset)
    jpool_l, tpool_l = _pools(preset)
    tokens, lengths = _prompts()
    rows_j, rows_t = jnp.asarray(ROWS), torch.from_numpy(ROWS).long()
    jl, jcache = jtf.prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths),
                             jtf.make_kv_cache(jcfg, 3, 16), jcfg, lora=jpool_l,
                             adapter_rows=rows_j)
    tl, tcache = ttf.prefill(tp, torch.from_numpy(tokens), torch.from_numpy(lengths),
                             ttf.make_kv_cache(tcfg, 3, 16, device="cpu"), tcfg, lora=tpool_l,
                             adapter_rows=rows_t)
    assert_logits(tl, jl, kv)
    base, _ = ttf.prefill(tp, torch.from_numpy(tokens), torch.from_numpy(lengths),
                          ttf.make_kv_cache(tcfg, 3, 16, device="cpu"), tcfg)
    assert (base[1] == tl[1]).all() and not torch.allclose(base[0], tl[0], atol=1e-3)
    jpool = jtf.paged_insert_cache(jtf.make_page_pool(jcfg, PAGES, PS), jcache,
                                   jnp.asarray(TABLE), PS)
    tpool = ttf.paged_insert_cache(ttf.make_page_pool(tcfg, PAGES, PS, device="cpu"), tcache,
                                   torch.from_numpy(TABLE), PS)
    step = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    positions = lengths.copy()
    for _ in range(2):
        jl, jpool = jtf.paged_decode_step_inplace(
            jp, jnp.asarray(step), jnp.asarray(positions), jpool, jnp.asarray(TABLE), jcfg, PS,
            lora=jpool_l, adapter_rows=rows_j,
        )
        tl, tpool = ttf.paged_decode_step_inplace(
            tp, torch.from_numpy(step), torch.from_numpy(positions), tpool,
            torch.from_numpy(TABLE), tcfg, PS, lora=tpool_l, adapter_rows=rows_t,
        )
        assert_logits(tl, jl, kv)
        step = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        positions = positions + 1
    drafts = np.stack([step, (step + 3) % 256, (step + 7) % 256], axis=1).astype(np.int32)
    jl, _ = jtf.paged_verify_step_inplace(
        jp, jnp.asarray(drafts), jnp.asarray(positions), jpool, jnp.asarray(TABLE), jcfg, PS,
        lora=jpool_l, adapter_rows=rows_j,
    )
    tl, _ = ttf.paged_verify_step_inplace(
        tp, torch.from_numpy(drafts), torch.from_numpy(positions), tpool,
        torch.from_numpy(TABLE), tcfg, PS, lora=tpool_l, adapter_rows=rows_t,
    )
    assert_logits(tl, jl, kv)


@pytest.mark.parametrize("kv, impl", KV_PATHS)
def test_dense_decode_and_segments_with_adapters_match_jax(kv, impl):
    """The dense layout's chunked prefill — two segments of 8 into a local
    cache, the second at offset 8 — then a decode step over that cache,
    and the same two segments straight into pages; each with adapter rows
    [1, 0, 2], within tolerance."""
    jcfg, tcfg = configs("tiny-test", kv, impl)
    jp, tp = weights()
    jpool_l, tpool_l = _pools()
    tokens = np.random.default_rng(2).integers(1, 256, (3, 16)).astype(np.int32)
    segments = [(np.zeros(3, np.int32), np.full(3, 8, np.int32)),
                (np.full(3, 8, np.int32), np.array([8, 4, 2], np.int32))]
    rows_j, rows_t = jnp.asarray(ROWS), torch.from_numpy(ROWS).long()
    jcache, tcache = jtf.make_kv_cache(jcfg, 3, 32), ttf.make_kv_cache(tcfg, 3, 33, device="cpu")
    jpool, tpool = jtf.make_page_pool(jcfg, PAGES, PS), ttf.make_page_pool(tcfg, PAGES, PS,
                                                                          device="cpu")
    for i, (offsets, lengths) in enumerate(segments):
        seg = tokens[:, 8 * i: 8 * (i + 1)]
        jl, jcache = jtf.prefill_segment(
            jp, jnp.asarray(seg), jnp.asarray(offsets), jnp.asarray(lengths), jcache, jcfg, 16,
            lora=jpool_l, adapter_rows=rows_j,
        )
        tl, tcache = ttf.prefill_segment(
            tp, torch.from_numpy(seg), torch.from_numpy(offsets), torch.from_numpy(lengths),
            tcache, tcfg, kv_bound=16, lora=tpool_l, adapter_rows=rows_t,
        )
        assert_logits(tl, jl, kv)
        jpl, jpool = jtf.paged_prefill_segment_inplace(
            jp, jnp.asarray(seg), jnp.asarray(offsets), jnp.asarray(lengths), jpool,
            jnp.asarray(TABLE), jcfg, PS, lora=jpool_l, adapter_rows=rows_j,
        )
        tpl, tpool = ttf.paged_prefill_segment_inplace(
            tp, torch.from_numpy(seg), torch.from_numpy(offsets), torch.from_numpy(lengths),
            tpool, torch.from_numpy(TABLE), tcfg, PS, lora=tpool_l, adapter_rows=rows_t,
        )
        assert_logits(tpl, jpl, kv)
    # one decode step over the dense cache
    step = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    positions = (offsets + lengths).astype(np.int32)
    jl, _ = jtf.decode_step_inplace(jp, jnp.asarray(step), jnp.asarray(positions), jcache, jcfg,
                                    lora=jpool_l, adapter_rows=rows_j)
    tl, _ = ttf.decode_step_inplace(tp, torch.from_numpy(step), torch.from_numpy(positions),
                                    tcache, tcfg, kv_bound=32, lora=tpool_l, adapter_rows=rows_t)
    assert_logits(tl, jl, kv)


# -- the engines against JAX's -------------------------------------------------


def _engine_kw(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("adapters", ADAPTERS)
    kw.setdefault("brownout", "off")
    kw.setdefault("eos_token_id", ByteTokenizer.eos_token_id)
    return kw


def jax_engine(preset="tiny-test", kv="model", impl="auto", **kw):
    return JaxEngine(configs(preset, kv, impl)[0], weights(preset)[0],
                     grammar_tokenizer=JaxByteTokenizer(), **_engine_kw(**kw))


def port_engine(preset="tiny-test", kv="model", impl="auto", **kw):
    return ServingEngine(configs(preset, kv, impl)[1], weights(preset)[1], device="cpu",
                         grammar_tokenizer=ByteTokenizer(), **_engine_kw(**kw))


def run_all(engine, items, jax_side: bool):
    """Submit every item before ``start()``, wait for all → (results or the
    errors they raised, stats)."""
    options, request = (JaxOptions, JaxRequest) if jax_side else (GenerationOptions,
                                                                   GenerationRequest)
    reqs = [engine.submit(request(prompt_tokens=list(p), options=options(**o)))
            for p, o in items]
    engine.start()
    try:
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout=WAIT))
            except Exception as e:  # noqa: BLE001 — compared by type
                out.append(e)
        return out, engine.stats()
    finally:
        engine.stop()


def assert_same(jax_out, port_out):
    for want, got in zip(jax_out, port_out):
        if isinstance(want, Exception):
            assert type(got).__name__ == type(want).__name__, (want, got)
            continue
        assert got.tokens == want.tokens
        assert got.finish_reason == want.finish_reason


def mixed_items():
    rng = np.random.default_rng(4)
    p = [rng.integers(1, 250, int(n)).tolist() for n in (5, 9, 3, 12, 7, 4, 40)]
    return [
        (p[0], dict(max_new_tokens=12)),
        (p[1], dict(max_new_tokens=12, adapter="tenant-a")),
        (p[2], dict(max_new_tokens=40, response_format=RF)),
        (p[3], dict(max_new_tokens=20, adapter="tenant-b", response_format=RX)),
        (p[4], dict(max_new_tokens=10, adapter="tenant-b")),
        (p[5], dict(max_new_tokens=30, adapter="tenant-a", response_format=RF)),
        # wider than the widest bucket: the chunked-prefill path
        (p[6], dict(max_new_tokens=10, adapter="tenant-a")),
    ]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mixed_base_adapter_constrained_batch_matches_jax(layout):
    kw = dict(kv_layout=layout, prefill_buckets=(16, 32))
    want, jstats = run_all(jax_engine(**kw), mixed_items(), True)
    got, tstats = run_all(port_engine(**kw), mixed_items(), False)
    assert_same(want, got)
    assert {k: tstats[k] for k in AGENTIC_KEYS} == {k: jstats[k] for k in AGENTIC_KEYS}
    assert tstats["constrained-requests-total"] == 3
    assert got[1].tokens != got[0].tokens  # an adapter changes the output


def test_adapter_swap_under_pool_pressure_matches_jax():
    """Three adapters over one usable row, the requests queued before
    start: each swap waits for the row's holder to finish; tokens and swap
    counts equal JAX's."""
    three = ADAPTERS + [{"name": "tenant-c", "rank": 4, "scale": 1.0, "seed": 3}]
    items = [([5, 6, 7, 8], dict(max_new_tokens=6, adapter=name))
             for name in ("tenant-a", "tenant-b", "tenant-c", "tenant-a")]
    kw = dict(adapters=three, adapter_pool_rows=2, max_batch=1)
    want, jstats = run_all(jax_engine(**kw), items, True)
    got, tstats = run_all(port_engine(**kw), items, False)
    assert_same(want, got)
    assert {k: tstats[k] for k in AGENTIC_KEYS} == {k: jstats[k] for k in AGENTIC_KEYS}
    assert tstats["adapter-swaps-total"] == 4


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_moe_attention_only_adapters_match_jax(layout):
    items = [(p, o) for p, o in mixed_items()[:6]]
    kw = dict(kv_layout=layout)
    want, jstats = run_all(jax_engine("tiny-moe-test", **kw), items, True)
    got, tstats = run_all(port_engine("tiny-moe-test", **kw), items, False)
    assert_same(want, got)
    assert {k: tstats[k] for k in AGENTIC_KEYS} == {k: jstats[k] for k in AGENTIC_KEYS}


def test_int8_kv_adapters_match_jax():
    items = [(p, o) for p, o in mixed_items()[:6]]
    want, _ = run_all(jax_engine(kv="int8", impl="jnp"), items, True)
    got, _ = run_all(port_engine(kv="int8", impl="jnp"), items, False)
    assert_same(want, got)


def test_adapter_requests_never_touch_the_prefix_index():
    preamble = list(range(3, 3 + 70))  # crosses the 64 bucket boundary
    greedy = GenerationOptions(max_new_tokens=6)
    engine = port_engine(prefix_cache="auto", max_seq_len=256, max_batch=2)
    engine.start()
    try:
        base1 = engine.generate(preamble + [9], greedy, timeout=WAIT)
        saved0 = engine.stats()["prefill-tokens-saved-total"]
        entries0 = engine.stats()["prefix-cache-entries"]
        tenant = engine.generate(preamble + [9], dataclasses.replace(greedy, adapter="tenant-a"),
                                 timeout=WAIT)
        # neither reused nor published
        assert engine.stats()["prefill-tokens-saved-total"] == saved0
        assert engine.stats()["prefix-cache-entries"] == entries0
        base2 = engine.generate(preamble + [11], greedy, timeout=WAIT)
        assert engine.stats()["prefill-tokens-saved-total"] > saved0
        assert base1.tokens and tenant.tokens != base1.tokens and base2.tokens
    finally:
        engine.stop()


def test_pinned_full_pool_sheds_with_retry_after_then_serves():
    three = ADAPTERS + [{"name": "tenant-c", "rank": 4, "scale": 1.0, "seed": 3}]
    engine = port_engine(adapters=three, adapter_pool_rows=3)
    engine.start()
    try:
        held = [engine.submit(GenerationRequest(
            prompt_tokens=[5, 6, 7], options=GenerationOptions(max_new_tokens=100, adapter=n),
        )) for n in ("tenant-a", "tenant-b")]
        with pytest.raises(ShedError) as exc:
            engine.generate([5, 6, 7], GenerationOptions(max_new_tokens=4, adapter="tenant-c"),
                            timeout=WAIT)
        assert exc.value.retry_after_s > 0
        assert engine.stats()["shed-total"] == 1
        for r in held:
            r.cancel()
        for r in held:
            r.result(timeout=WAIT)
        ok = engine.generate([5, 6, 7], GenerationOptions(max_new_tokens=4, adapter="tenant-c"),
                             timeout=WAIT)
        assert len(ok.tokens) == 4
        # every row released: nothing pinned once the engine is idle
        assert all(s.refs == 0 for s in engine._adapters._by_name.values())
    finally:
        engine.stop()


def test_unknown_adapter_fails_the_request_and_no_registry_refuses_at_submit():
    engine = port_engine()
    engine.start()
    try:
        with pytest.raises(KeyError):
            engine.generate([5, 6], GenerationOptions(max_new_tokens=2, adapter="ghost"),
                            timeout=WAIT)
        assert engine.generate([5, 6], GenerationOptions(max_new_tokens=2), timeout=WAIT).tokens
    finally:
        engine.stop()
    bare = port_engine(adapters=None)
    try:
        with pytest.raises(ValueError, match="no adapter registry"):
            bare.submit(GenerationRequest(
                prompt_tokens=[5], options=GenerationOptions(adapter="tenant-a")))
    finally:
        bare.stop()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_adapter_fault_site_quarantines_its_victim_alone(layout):
    """``adapter@2`` corrupts one active slot's dispatch-facing row at the
    second decode dispatch: that request fails, the other's tokens equal a
    fault-free run's, and one ``adapter-quarantine`` dump names the slot."""
    items = [([72, 101, 108, 108, 111], dict(max_new_tokens=12, adapter=n))
             for n in ("tenant-a", "tenant-b")]
    clean, _ = run_all(port_engine(kv_layout=layout), items, False)
    engine = port_engine(kv_layout=layout, fault_injector=FaultInjector("adapter@2", seed=0))
    got, stats = run_all(engine, items, False)
    victims = [i for i, r in enumerate(got) if isinstance(r, Exception)]
    assert len(victims) == 1, got
    assert "adapter-row corruption" in str(got[victims[0]])
    survivor = 1 - victims[0]
    assert got[survivor].tokens == clean[survivor].tokens
    assert stats["quarantined-slots-total"] == 1 and stats["engine-restarts-total"] == 0
    dump = engine._obs.flight.last_dump
    assert dump["reason"] == "adapter-quarantine"
    assert dump["extra"]["slot"] in range(engine.max_batch)


def test_provider_serves_the_adapter_keys():
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
        "max-seq-len": 128, "adapters": ADAPTERS, "adapter-rank": 8, "adapter-pool-rows": 3,
        "adapter-pool-fraction": 0.2, "constrained-decoding": "off",
    })
    try:
        out = {}
        for name in (None, "tenant-a"):
            opts = {"max-tokens": 6}
            if name:
                opts["adapter"] = name
            out[name] = asyncio.run(svc.get_chat_completions(
                [ChatMessage(role="user", content="hello")], opts))
        engine = svc.engine()
        stats = engine.stats()
        assert stats["adapters"] and stats["adapters-registered"] == 2
        assert stats["adapter-pool-rows"] == 2 and engine._adapters.rank == 8
        assert not stats["constrained-decoding"]
        assert out[None].completion_tokens == out["tenant-a"].completion_tokens == 6
        assert engine.adapter_advertisement() == ("tenant-a",)
        assert engine.memory_plan.adapter_pool_bytes == stats["adapter-pool-bytes"]
    finally:
        svc.close()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_restart_with_the_tier_on_keeps_the_pools_and_releases_the_rows(layout):
    """``decode@3`` on a one-slot engine with adapters and a grammar, every
    decode a stand-in replay: the request in flight fails, the loop
    restarts (graphs captured again, per-slot buffers fresh, DFA states
    zero), the pools keep their addresses and contents, the failed
    request's rows are released, and the constrained adapter request
    queued behind it equals a fault-free engine's."""
    from langstream_tpu_torch.serving.faultinject import InjectedFault
    from test_torch_graphs import ReplayGraph

    opts = [GenerationOptions(max_new_tokens=12, adapter="tenant-a"),
            GenerationOptions(max_new_tokens=20, adapter="tenant-b", response_format=RX)]
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    clean = port_engine(kv_layout=layout, max_batch=1)
    clean._graph_factory = ReplayGraph
    want = [r.tokens for r in run_all(clean, [(p, dataclasses.asdict(o))
                                               for p, o in zip(prompts, opts)], False)[0]]
    engine = port_engine(kv_layout=layout, max_batch=1, restart_backoff_s=0.01,
                         fault_injector=FaultInjector("decode@3"))
    engine._graph_factory = ReplayGraph
    pools = [engine._adapters.pool["wq"]["a"], *engine._constrain_reg.pool]
    ptrs = [t.data_ptr() for t in pools]
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=o))
            for p, o in zip(prompts, opts)]
    engine.start()
    try:
        with pytest.raises(InjectedFault):
            reqs[0].result(timeout=WAIT)
        second = reqs[1].result(timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert second.tokens == want[1] and second.finish_reason == "stop"
    assert stats["engine-restarts-total"] == 1 and stats["graph-captures-total"] == 6
    assert [t.data_ptr() for t in pools] == ptrs
    assert stats["adapters-resident"] == 2 and stats["adapter-swaps-total"] == 2
    assert all(s.refs == 0 for s in engine._adapters._by_name.values())
    assert all(s.refs == 0 for s in engine._constrain_reg._by_key.values())
