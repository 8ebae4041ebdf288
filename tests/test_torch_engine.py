"""The port's ServingEngine on the CPU (tiny-test, f32) against the JAX
ServingEngine on the same weights: a mixed-length greedy batch through a
paged pool, crossing page boundaries — the greedy tokens must be equal.
Also: no page leaks once the batch drains, stats() counts kernel calls,
and the engine's request contract (stops, cancellation, limits)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import init_params, params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine, ShedError

torch.backends.cuda.matmul.allow_tf32 = False

JCFG = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
CFG = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
ENGINE_KW = dict(max_batch=4, max_seq_len=256, decode_chunk=4, prefill_buckets=(32, 64, 128))
# six prompts over three buckets; with 24 new tokens the 63- and 100-token
# prompts cross the 64- and 128-token page boundaries while decoding
PROMPT_LENS = (3, 17, 40, 63, 70, 100)
NEW_TOKENS = 24


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, CFG.vocab_size, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(params):
    engine = JaxEngine(JCFG, params[0], **ENGINE_KW)
    engine.start()
    try:
        opts = JaxOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
        reqs = [engine.submit(JaxRequest(prompt_tokens=p, options=opts)) for p in prompts()]
        return [r.result(timeout=300).tokens for r in reqs]
    finally:
        engine.stop()


def run_port(tparams, cfg=CFG, **kw):
    engine = ServingEngine(cfg, tparams, device="cpu", **{**ENGINE_KW, **kw})
    engine.start()
    try:
        opts = GenerationOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
        reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts()]
        results = [r.result(timeout=300) for r in reqs]
        return results, engine.stats(), engine
    finally:
        engine.stop()


@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_greedy_tokens_equal_jax_engine(params, jax_tokens, impl):
    """The kernel path (plain versions on the CPU) and the reference path
    both reproduce the JAX engine's greedy tokens exactly."""
    cfg = dataclasses.replace(CFG, attention_impl=impl)
    results, _, _ = run_port(params[1], cfg)
    assert [r.finish_reason for r in results] == ["length"] * len(PROMPT_LENS)
    assert [r.tokens for r in results] == jax_tokens


def test_pages_released_and_kernels_counted(params):
    from langstream_tpu_torch.ops.attention import reset_kernel_counts

    reset_kernel_counts()
    results, stats, engine = run_port(params[1])
    assert all(len(r.tokens) == NEW_TOKENS for r in results)
    assert engine._pagepool.pages_in_use == 0
    assert stats["kv-pages-in-use"] == 0 and stats["kv-pages-free"] == stats["kv-pages-total"]
    assert stats["total-requests"] == len(PROMPT_LENS)
    assert stats["total-generated-tokens"] == len(PROMPT_LENS) * NEW_TOKENS
    kernels = stats["kernels"]
    # on the CPU every call is the plain version: no CUDA launches
    assert all(k["launches"] == 0 for k in kernels.values())
    assert kernels["flash_prefill"]["cpu_calls"] >= CFG.n_layers * stats["admit-groups-total"]
    assert kernels["paged_decode"]["cpu_calls"] >= CFG.n_layers * stats["decode-steps-total"]
    assert kernels["paged_decode_int8"]["cpu_calls"] == 0


def test_int8_kv_engine_runs_the_int8_kernel(params):
    from langstream_tpu_torch.ops.attention import reset_kernel_counts

    reset_kernel_counts()
    cfg = dataclasses.replace(CFG, kv_cache_dtype="int8")
    results, stats, engine = run_port(params[1], cfg)
    assert all(len(r.tokens) == NEW_TOKENS for r in results)
    assert all(0 <= t < CFG.vocab_size for r in results for t in r.tokens)
    assert stats["kernels"]["paged_decode_int8"]["cpu_calls"] >= (
        CFG.n_layers * stats["decode-steps-total"]
    )
    assert engine._pagepool.pages_in_use == 0


def test_admission_budget_floors_at_one_group(params):
    """An iteration admits prompt tokens up to the widest bucket, floored at
    one full admit group: a burst of 12 short prompts admits 8, then 4, and
    every request still completes with no page left behind."""
    engine = ServingEngine(CFG, params[1], device="cpu", **{**ENGINE_KW, "max_batch": 12})
    opts = GenerationOptions(max_new_tokens=5)
    reqs = [
        engine.submit(GenerationRequest(prompt_tokens=[1 + i, 2, 3], options=opts))
        for i in range(12)
    ]
    assert engine.prefill_token_budget == 128 < 8 * 32
    with torch.no_grad():
        first = engine._admit(engine.prefill_token_budget)
        stats = engine.stats()
        assert (stats["active-slots"], stats["queued"], stats["admit-groups-total"]) == (8, 4, 1)
        second = engine._admit(engine.prefill_token_budget)
        stats = engine.stats()
        assert (stats["active-slots"], stats["queued"], stats["admit-groups-total"]) == (12, 0, 2)
        for entry in first + second:
            engine._process_entry(entry)
    engine.start()
    try:
        results = [r.result(timeout=300) for r in reqs]
    finally:
        engine.stop()
    assert [len(r.tokens) for r in results] == [5] * 12
    assert engine._pagepool.pages_in_use == 0


def _first_new(tokens, start):
    """Index of the first token at or after ``start`` not seen before it."""
    return next(i for i in range(start, len(tokens)) if tokens[i] not in tokens[:i])


def test_eos_and_stop_tokens_finish_with_stop(params, jax_tokens):
    i = _first_new(jax_tokens[0], 3)
    j = _first_new(jax_tokens[1], 2)
    engine = ServingEngine(CFG, params[1], eos_token_id=jax_tokens[0][i], device="cpu", **ENGINE_KW)
    engine.start()
    try:
        p = prompts()
        res = engine.generate(p[0], GenerationOptions(max_new_tokens=NEW_TOKENS))
        assert res.finish_reason == "stop" and res.tokens == jax_tokens[0][:i]
        stop = jax_tokens[1][j]
        res = engine.generate(p[1], GenerationOptions(max_new_tokens=NEW_TOKENS, stop_tokens=(stop,)))
        assert res.finish_reason == "stop" and res.tokens == jax_tokens[1][:j]
    finally:
        engine.stop()


def test_streaming_callback_sees_every_token(params, jax_tokens):
    engine = ServingEngine(CFG, params[1], device="cpu", **ENGINE_KW)
    engine.start()
    seen = []
    try:
        res = engine.generate(prompts()[2], GenerationOptions(max_new_tokens=7), on_token=seen.append)
    finally:
        engine.stop()
    assert seen == res.tokens == jax_tokens[2][:7]


def test_cancel_and_limits(params):
    engine = ServingEngine(CFG, params[1], device="cpu", kv_pages=1, **ENGINE_KW)
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.submit(GenerationRequest(prompt_tokens=[1] * 256, options=GenerationOptions()))
    engine.start()
    try:
        # 60 + 10 tokens need two pages of 64; the whole pool holds one
        with pytest.raises(ShedError, match="KV pages"):
            engine.generate([1] * 60, GenerationOptions(max_new_tokens=10))
        assert len(engine.generate([1] * 30, GenerationOptions(max_new_tokens=10)).tokens) == 10
    finally:
        engine.stop()
    with pytest.raises(RuntimeError):
        engine.submit(GenerationRequest(prompt_tokens=[1, 2], options=GenerationOptions()))

    engine = ServingEngine(CFG, params[1], device="cpu", **ENGINE_KW)
    req = GenerationRequest(prompt_tokens=[3, 4], options=GenerationOptions(max_new_tokens=200))
    req.cancel()
    engine.start()
    try:
        engine.submit(req)
        assert req.result(timeout=60).finish_reason == "cancelled"
        # a prompt wider than the largest bucket (128) is served, in
        # segments straight into its pages
        res = engine.generate([1] * 129, GenerationOptions(max_new_tokens=4))
        assert res.finish_reason == "length" and len(res.tokens) == 4
        assert engine.stats()["prefill-segments-total"] == 2
    finally:
        engine.stop()
    assert engine._pagepool.pages_in_use == 0


def test_sampled_requests_run(params):
    engine = ServingEngine(CFG, params[1], device="cpu", rng_seed=3, **ENGINE_KW)
    engine.start()
    try:
        res = engine.generate(
            [5, 6, 7], GenerationOptions(max_new_tokens=10, temperature=0.9, top_k=20, top_p=0.9)
        )
    finally:
        engine.stop()
    assert len(res.tokens) == 10 and all(0 <= t < CFG.vocab_size for t in res.tokens)


def test_pool_exhaustion_defers_instead_of_failing(params, jax_tokens):
    """A pool too small for every admission at once defers the rest; all
    requests still complete with the JAX engine's tokens, none leak."""
    results, _, engine = run_port(params[1], kv_pages=4)
    assert [r.tokens for r in results] == jax_tokens
    assert engine._pagepool.pages_in_use == 0


def test_random_init_engine_runs():
    tparams = init_params(CFG, torch.Generator().manual_seed(1), device="cpu")
    engine = ServingEngine(CFG, tparams, device="cpu", **ENGINE_KW)
    engine.start()
    try:
        res = engine.generate([1, 2, 3], GenerationOptions(max_new_tokens=5))
    finally:
        engine.stop()
    assert len(res.tokens) == 5


def test_non_bf16_kernel_path_on_cuda_is_refused_at_build(params, monkeypatch):
    """The CUDA kernels take bf16 models only: a float32 kernel-path config
    on a CUDA device (here an sm_90 card is pretended) raises when the
    engine or the provider is built, before any request, and names the way
    out; attention_impl="jnp" is let through."""
    from langstream_tpu_torch.ai import torch_serving
    from langstream_tpu_torch.ops.attention import kernel_path_ok

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    with pytest.raises(ValueError, match="'float32'.*attention_impl=\"jnp\""):
        ServingEngine(CFG, params[1], device="cuda", **ENGINE_KW)
    monkeypatch.setitem(torch_serving.MODEL_PRESETS, "tiny-test-f32", CFG)
    with pytest.raises(ValueError, match="'float32'.*attention_impl=\"jnp\""):
        torch_serving.TorchCompletionsService({"model": "tiny-test-f32", "device": "cuda"})
    assert not kernel_path_ok(dataclasses.replace(CFG, attention_impl="jnp"), torch.device("cuda"))
