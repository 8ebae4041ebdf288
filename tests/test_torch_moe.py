"""Mixtral-style MoE in the port against the JAX package, on the CPU
(tiny-moe-test, f32): ``moe_ffn`` (tokens dropped past capacity, the
lossless ``factor <= 0`` case, int8 experts), the model entry points
(forward, prefill, paged decode, a paged segment), the parameter bridge and
the random int8 init, the MoE engine's greedy tokens on both KV layouts
(a prompt wider than the widest bucket included) and the provider's
``quantization`` key.

Tolerances (f32): ``moe_ffn`` 1e-5 (int8 experts 1e-4: the port applies the
scale after the product), logits 1e-4 absolute — the two frameworks sum in
different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import quant as jquant
from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models import quant as tquant
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import init_params, params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine

torch.backends.cuda.matmul.allow_tf32 = False

MOE_TOL = 1e-5
MOE_INT8_TOL = 1e-4
LOGIT_TOL = 1e-4


def cfgs(impl="auto", **fields):
    """(JAX config, port config) of tiny-moe-test in f32; the port's "auto"
    is the kernel path (plain versions on the CPU), JAX's "auto" is its
    reference path on the CPU."""
    j = dataclasses.replace(
        JAX_PRESETS["tiny-moe-test"], dtype="float32", attention_impl=impl, **fields
    )
    t = dataclasses.replace(
        MODEL_PRESETS["tiny-moe-test"], dtype="float32", attention_impl=impl, **fields
    )
    return j, t


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfgs()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return params, params_from_numpy(np_tree(params), tcfg, device="cpu")


# -- moe_ffn ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dropping", "lossless", "int8"])
def test_moe_ffn_matches_jax(weights, case):
    """factor 0.25 at T = 1024 gives C = 64 rows an expert against ~256
    routed (token, slot)s each: most are dropped and add 0. factor 0 is
    lossless (C = T). int8 experts quantized as the JAX package does."""
    factor, tokens, tol = {
        "dropping": (0.25, 1024, MOE_TOL),
        "lossless": (0.0, 96, MOE_TOL),
        "int8": (2.0, 256, MOE_INT8_TOL),
    }[case]
    jcfg, tcfg = cfgs(moe_capacity_factor=factor)
    jparams, tparams = weights
    if case == "int8":
        jparams = jquant.quantize_params(jparams, jcfg)
        tparams = params_from_numpy(np_tree(jparams), tcfg, device="cpu")
    x = np.random.default_rng(1).standard_normal((4, tokens // 4, tcfg.d_model)).astype(np.float32)
    for layer in range(tcfg.n_layers):
        jlp = jax.tree.map(lambda a: a[layer], jparams["layers"])
        ref = np.asarray(jtf.moe_ffn(jnp.asarray(x), jlp, jcfg))
        out = ttf.moe_ffn(t(x), ttf._layer_params(tparams["layers"], layer), tcfg).numpy()
        np.testing.assert_allclose(out, ref, atol=tol)
        dropped = (np.abs(ref).sum(-1) == 0).mean()
        if case == "dropping":
            assert ttf.moe_capacity(tokens, tcfg) == 64
            assert dropped > 0.3  # tokens whose every slot was dropped
        else:
            assert dropped == 0
    if case == "lossless":
        assert ttf.moe_capacity(tokens, tcfg) == tokens


def test_moe_capacity_floor_keeps_decode_batches_whole():
    _, tcfg = cfgs()
    # t <= 64: the floor min(t, 64) makes C = t, so no decode row is dropped
    assert [ttf.moe_capacity(n, tcfg) for n in (1, 8, 64)] == [1, 8, 64]
    assert ttf.moe_capacity(1000, tcfg) == 500  # ceil(1000 * 2 * 2 / 8)


# -- the model entry points -----------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_forward_prefill_and_paged_decode_match_jax(weights, impl):
    jparams, tparams = weights
    jcfg, tcfg = cfgs(impl)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    np.testing.assert_allclose(
        ttf.forward(tparams, t(tokens), tcfg).numpy(),
        np.asarray(jtf.forward(jparams, jnp.asarray(tokens), jcfg)), atol=LOGIT_TOL,
    )
    lengths = np.array([24, 17], np.int32)
    jl, jcache = jtf.prefill(jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                             jtf.make_kv_cache(jcfg, 2, 24), jcfg)
    tl, tcache = ttf.prefill(tparams, t(tokens), t(lengths),
                             ttf.make_kv_cache(tcfg, 2, 24, device="cpu"), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    ps, pages = 8, 10
    table = np.array([[4, 1, 7, 9, 3], [0, 2, 8, 5, pages]], np.int32)
    jpool = jtf.paged_insert_cache(jtf.make_page_pool(jcfg, pages, ps), jcache,
                                   jnp.asarray(table), ps)
    tpool = ttf.paged_insert_cache(ttf.make_page_pool(tcfg, pages, ps, device="cpu"), tcache,
                                   t(table), ps)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    pos = lengths.copy()
    for _ in range(4):
        jl, jpool = jtf.paged_decode_step_inplace(
            jparams, jnp.asarray(tok), jnp.asarray(pos), jpool, jnp.asarray(table), jcfg, ps
        )
        tl, _ = ttf.paged_decode_step_inplace(tparams, t(tok), t(pos), tpool, t(table), tcfg, ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        pos = pos + 1
    # a segment at a mid-page offset straight into the pages, through moe_ffn
    seg = rng.integers(0, 512, (2, 8)).astype(np.int32)
    offs, seg_len = pos.astype(np.int32), np.array([8, 5], np.int32)
    jl, _ = jtf.paged_prefill_segment_inplace(
        jparams, jnp.asarray(seg), jnp.asarray(offs), jnp.asarray(seg_len), jpool,
        jnp.asarray(table), jcfg, ps,
    )
    tl, _ = ttf.paged_prefill_segment_inplace(
        tparams, t(seg), t(offs), t(seg_len), tpool, t(table), tcfg, ps
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)


# -- parameters -----------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_params_from_numpy_carries_moe_trees(quantized):
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-moe-test"], dtype="bfloat16")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    if quantized:
        params = jquant.quantize_params(params, jcfg)
    out = params_from_numpy(np_tree(params), MODEL_PRESETS["tiny-moe-test"], device="cpu")
    layers, ref = out["layers"], params["layers"]
    assert set(layers) == set(ref)
    router = layers["router"]
    assert router.dtype == torch.bfloat16 and tuple(router.shape) == (2, 64, 8)
    np.testing.assert_array_equal(router.view(torch.int16).numpy(),
                                  np.asarray(ref["router"]).view(np.int16))
    for name in ("w_gate", "w_up", "w_down"):
        if quantized:
            assert tquant.is_quantized(layers[name])
            np.testing.assert_array_equal(layers[name]["q"].numpy(), np.asarray(ref[name]["q"]))
            np.testing.assert_array_equal(layers[name]["s"].numpy(), np.asarray(ref[name]["s"]))
            assert layers[name]["s"].shape[-2] == 1 and layers[name]["s"].dim() == 4
        else:
            np.testing.assert_array_equal(layers[name].view(torch.int16).numpy(),
                                          np.asarray(ref[name]).view(np.int16))


def test_quantize_params_covers_the_experts_bit_exact(weights):
    jparams, tparams = weights
    _, tcfg = cfgs()
    jq = jquant.quantize_params(jparams, cfgs()[0])
    tq = tquant.quantize_params(tparams, tcfg)
    assert not tquant.is_quantized(tq["layers"]["router"])
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tq["layers"][name]["q"].numpy(),
                                      np.asarray(jq["layers"][name]["q"]))
        np.testing.assert_array_equal(tq["layers"][name]["s"].numpy(),
                                      np.asarray(jq["layers"][name]["s"]))


@pytest.mark.parametrize("name", ["tiny-test", "tiny-moe-test"])
def test_random_quantized_params_have_the_quantized_tree_shape(name):
    cfg = MODEL_PRESETS[name]
    ref = tquant.quantize_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                                 cfg)
    got = tquant.init_random_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), tree.dtype

    assert layout(got) == layout(ref)
    wq = got["layers"]["wq"]
    assert int(wq["q"].min()) >= -127 and int(wq["q"].max()) <= 127
    assert torch.all(wq["s"] == cfg.d_model ** -0.5 / 127.0)
    # the same generator seed draws the same tree
    again = tquant.init_random_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["w_down"]["q"], got["layers"]["w_down"]["q"])
    logits = ttf.forward(got, torch.tensor([[1, 2, 3]]), cfg)
    assert bool(torch.isfinite(logits).all())


# -- the engine -----------------------------------------------------------------

ENGINE_KW = dict(max_batch=4, max_seq_len=256, decode_chunk=4, prefill_buckets=(32, 64, 128))
# two buckets' admit groups and one prompt wider than the widest bucket
# (2 segments of 128)
PROMPT_LENS = (3, 20, 40, 100, 150)
NEW_TOKENS = 8


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]


def _jax_run(params, layout):
    """Every request submitted before the engine starts, so the admit
    groups (whose rows share the experts' capacity) are the same in both
    engines."""
    jcfg, _ = cfgs()
    engine = JaxEngine(jcfg, params, kv_layout=layout, **ENGINE_KW)
    opts = JaxOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
    reqs = [engine.submit(JaxRequest(prompt_tokens=p, options=opts)) for p in prompts()]
    engine.start()
    try:
        return [r.result(timeout=600).tokens for r in reqs]
    finally:
        engine.stop()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_moe_engine_greedy_tokens_equal_jax(weights, layout):
    jparams, tparams = weights
    ref = _jax_run(jparams, layout)
    _, tcfg = cfgs()
    engine = ServingEngine(tcfg, tparams, device="cpu", kv_layout=layout, **ENGINE_KW)
    opts = GenerationOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts()]
    engine.start()
    try:
        results = [r.result(timeout=600) for r in reqs]
    finally:
        engine.stop()
    assert [r.tokens for r in results] == ref
    assert [len(r.tokens) for r in results] == [NEW_TOKENS] * len(PROMPT_LENS)
    stats = engine.stats()
    assert stats["prefill-segments-total"] == 2
    if layout == "paged":
        assert engine._pagepool.pages_in_use == 0


def test_moe_admit_groups_are_padded_as_in_jax(weights):
    """An MoE group of one request prefills PREFILL_BATCH rows (the pad
    rows share the experts' capacity, as in the JAX engine); the pad rows'
    K/V land nowhere: the pool's real pages outside the request's stay 0."""
    _, tparams = weights
    _, tcfg = cfgs()
    engine = ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    seen = []
    real_prefill = ttf.prefill

    def spy(params, tokens, *args, **kw):
        seen.append(tuple(tokens.shape))
        return real_prefill(params, tokens, *args, **kw)

    import langstream_tpu_torch.serving.engine as engine_mod

    engine_mod.prefill = spy
    try:
        engine.submit(GenerationRequest(prompt_tokens=[5, 6, 7],
                                        options=GenerationOptions(max_new_tokens=2)))
        with torch.no_grad():
            entries = engine._admit(engine.prefill_token_budget)
    finally:
        engine_mod.prefill = real_prefill
    assert seen == [(ServingEngine.PREFILL_BATCH, 32)]
    owned = set(engine._pagepool._owned[0])
    pool_k = engine._pagepool.dev["k"]
    touched = {int(p) for p in torch.nonzero(pool_k.abs().sum(dim=(0, 2, 3, 4)) > 0)}
    assert touched - {engine._pagepool.num_pages} <= owned
    for entry in entries:
        engine._process_entry(entry)


# -- the provider ----------------------------------------------------------------


def test_provider_builds_with_int8_weights():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-moe-test", "device": "cpu", "quantization": "int8", "max-batch": 2,
        "decode-chunk": 4, "max-seq-len": 128, "prefill-buckets": [16, 32],
    })
    try:
        engine = svc.engine()
        assert tquant.is_quantized(engine.params["layers"]["w_gate"])
        assert engine.params["layers"]["w_gate"]["q"].dim() == 4
        res = engine.generate([1] * 40, GenerationOptions(max_new_tokens=3), timeout=300)
        assert len(res.tokens) == 3
        assert engine.stats()["prefill-segments-total"] == 2
    finally:
        svc.close()
    plain = TorchCompletionsService({"model": "tiny-moe-test", "device": "cpu",
                                     "quantization": "none"})
    assert not plain.quantize
    with pytest.raises(ValueError, match="quantization"):
        TorchCompletionsService({"model": "tiny-moe-test", "device": "cpu",
                                 "quantization": "int4"})
