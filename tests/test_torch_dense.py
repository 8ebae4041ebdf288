"""The port's dense KV layout against the JAX package, on the CPU: the four
dense-layout kernels (segment and dense decode, model dtype and int8)
through their plain versions against the Pallas kernels in interpret mode;
the same plain versions reading a strided ``[..., :bound]`` view of a wider
cache; ``prefill_segment`` + ``decode_step_inplace`` against the JAX entry
points; the dense ``ServingEngine`` with chunked prefill against the JAX
dense engine; the int8 dense engine's kernel calls; the sink column; and
the provider's ``kv-layout: dense``.

Tolerances (f32 throughout): kernels 1e-5 (the two sides sum in different
orders); model logits 1e-4, int8 KV 1e-3 (tests/test_torch_model.py: an
int8 code can land one step apart, so int8 prompts stay short there too).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.configs import ModelConfig as JaxModelConfig
from langstream_tpu.ops import attention as jax_attn
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions, ModelConfig
from langstream_tpu_torch.ops import attention as port_attn
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_TOL = 1e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3

FIELDS = dict(
    name="k", vocab_size=128, d_model=64, n_layers=1, n_heads=8, n_kv_heads=4,
    d_ff=64, head_dim=16, dtype="float32",
)


def kernel_configs(softcap):
    return (
        JaxModelConfig(**FIELDS, attn_logit_softcap=softcap),
        ModelConfig(**FIELDS, attn_logit_softcap=softcap),
    )


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def to(entry, conv):
    return {k: conv(v) for k, v in entry.items()} if isinstance(entry, dict) else conv(entry)


def cache_entry(rng, int8, b, hkv, width, d):
    if int8:
        return {
            "q": rng.integers(-127, 128, (b, hkv, width, d)).astype(np.int8),
            "s": (rng.random((b, hkv, width)) * 0.05 + 0.01).astype(np.float32),
        }
    return rand(rng, b, hkv, width, d)


# -- kernels: plain versions vs the Pallas kernels in interpret mode ------------

B, H, HKV, D = 3, 8, 4, 16
SEG, T = 16, 64
OFFSETS = np.array([0, 24, 45], np.int32)  # 0, a block multiple, neither
LENGTHS = np.array([0, 1, 37, 64], np.int32)  # a zero-length row, a full row


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("int8", [False, True])
def test_flash_segment_plain_matches_pallas(int8, softcap):
    rng = np.random.default_rng(20 + int8)
    q = rand(rng, B, SEG, H, D)
    k, v = (cache_entry(rng, int8, B, HKV, T, D) for _ in range(2))
    jcfg, pcfg = kernel_configs(softcap)
    jax_fn = jax_attn.flash_segment_attention_int8 if int8 else jax_attn.flash_segment_attention
    port_fn = port_attn.flash_segment_attention_int8 if int8 else port_attn.flash_segment_attention
    ref = jax_fn(
        jnp.asarray(q), to(k, jnp.asarray), to(v, jnp.asarray), jnp.asarray(OFFSETS), jcfg,
        block_q=8, block_k=16, interpret=True,
    )
    before = (port_fn.cpu_calls, port_fn.launches)
    out = port_fn(t(q), to(k, t), to(v, t), t(OFFSETS), pcfg)
    assert (port_fn.cpu_calls, port_fn.launches) == (before[0] + 1, before[1])
    assert out.shape == (B, SEG, H * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_decode_plain_matches_pallas(int8, softcap):
    rng = np.random.default_rng(30 + int8)
    b = len(LENGTHS)
    q = rand(rng, b, H, D)
    k, v = (cache_entry(rng, int8, b, HKV, T, D) for _ in range(2))
    jcfg, pcfg = kernel_configs(softcap)
    jax_fn = jax_attn.ragged_decode_attention_int8 if int8 else jax_attn.ragged_decode_attention
    port_fn = port_attn.ragged_decode_attention_int8 if int8 else port_attn.ragged_decode_attention
    ref = jax_fn(
        jnp.asarray(q), to(k, jnp.asarray), to(v, jnp.asarray), jnp.asarray(LENGTHS), jcfg,
        block_k=16, interpret=True,
    )
    before = (port_fn.cpu_calls, port_fn.launches)
    out = port_fn(t(q), to(k, t), to(v, t), t(LENGTHS), pcfg)
    assert (port_fn.cpu_calls, port_fn.launches) == (before[0] + 1, before[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert np.all(out.numpy()[0] == 0.0)  # the zero-length row is 0, not NaN


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", ["segment", "decode"])
def test_plain_versions_read_strided_views_like_copies(kind, int8):
    """A [..., :bound] view of a wider cache (the engine's kv_bound read)
    gives exactly what a contiguous copy of it gives; lengths past the view
    are clamped to it."""
    rng = np.random.default_rng(40 + int8)
    _, pcfg = kernel_configs(None)
    bound = 40
    k, v = (to(cache_entry(rng, int8, B, HKV, T + 1, D), t) for _ in range(2))
    kv_view = [to(e, lambda a: a[:, :, :bound]) for e in (k, v)]
    kv_copy = [to(e, lambda a: a.contiguous()) for e in kv_view]
    assert not (kv_view[0]["q"] if int8 else kv_view[0]).is_contiguous()
    if kind == "segment":
        fn = port_attn.flash_segment_attention_int8 if int8 else port_attn.flash_segment_attention
        q = t(rand(rng, B, 8, H, D))
        extra = t(np.array([0, 20, 32], np.int32))
    else:
        fn = port_attn.ragged_decode_attention_int8 if int8 else port_attn.ragged_decode_attention
        q = t(rand(rng, B, H, D))
        extra = t(np.array([5, bound, 3 * T], np.int32))  # the last one runs past the view
    a = fn(q, *kv_view, extra, pcfg)
    b = fn(q, *kv_copy, extra, pcfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert np.isfinite(a.numpy()).all()


# -- model entry points -------------------------------------------------------


def cfgs(kv="model", impl="pallas"):
    """(JAX config, port config) of tiny-test; JAX's "pallas" ↔ the port's
    kernel path "auto"."""
    j = dataclasses.replace(
        JAX_PRESETS["tiny-test"], dtype="float32", kv_cache_dtype=kv, attention_impl=impl
    )
    p = dataclasses.replace(
        MODEL_PRESETS["tiny-test"], dtype="float32", kv_cache_dtype=kv,
        attention_impl="auto" if impl == "pallas" else impl,
    )
    return j, p


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfgs()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_prefill_segment_and_dense_decode_match_jax(weights, kv, impl):
    """A 13- and a 16-token prompt in two 8-token segments (the engine's
    kv_bound rule: 8, then 16), then 4 decode steps over a 32-column cache
    read through a 32-column bound; the port's cache has one extra sink
    column."""
    jparams, tparams = weights
    jcfg, tcfg = cfgs(kv, impl)
    tol = INT8_LOGIT_TOL if kv == "int8" else LOGIT_TOL
    width, cols = 8, 32
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, 500, (2, 16)).astype(np.int32)
    lens = np.array([13, 16])
    jcache = jtf.make_kv_cache(jcfg, 2, cols)
    tcache = ttf.make_kv_cache(tcfg, 2, cols + 1, device="cpu")
    for s0, bound in ((0, 8), (8, 16)):
        seg = np.zeros((2, width), np.int32)
        seg_len = np.clip(lens - s0, 0, width).astype(np.int32)
        for r in range(2):
            seg[r, : seg_len[r]] = prompts[r, s0 : s0 + seg_len[r]]
        offs = np.full(2, s0, np.int32)
        jl, jcache = jtf.prefill_segment(
            jparams, jnp.asarray(seg), jnp.asarray(offs), jnp.asarray(seg_len), jcache, jcfg,
            kv_bound=bound,
        )
        tl, _ = ttf.prefill_segment(
            tparams, t(seg), t(offs), t(seg_len), tcache, tcfg, kv_bound=bound
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    tokens = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    positions = lens.astype(np.int32)
    for _ in range(4):
        jl, jcache = jtf.decode_step_inplace(
            jparams, jnp.asarray(tokens), jnp.asarray(positions), jcache, jcfg, kv_bound=cols
        )
        tl, _ = ttf.decode_step_inplace(
            tparams, t(tokens), t(positions), tcache, tcfg, kv_bound=cols
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
        tokens = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        positions = positions + 1
    for name in ("k", "v"):
        got = ttf._map(lambda a: a[:, :, :, :cols].numpy(), tcache[name])
        ref = jax.tree.map(np.asarray, jcache[name])
        if kv == "int8":
            assert np.abs(got["q"].astype(int) - ref["q"].astype(int)).max() <= 1
            np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-5, atol=1e-12)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5)


def test_decode_step_is_decode_step_inplace_unbounded(weights):
    _, tparams = weights
    _, tcfg = cfgs()
    caches = [ttf.make_kv_cache(tcfg, 2, 16, device="cpu") for _ in range(2)]
    tokens, positions = torch.tensor([3, 7]), torch.tensor([0, 0])
    a, _ = ttf.decode_step(tparams, tokens, positions, caches[0], tcfg)
    b, _ = ttf.decode_step_inplace(tparams, tokens, positions, caches[1], tcfg)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(caches[0]["k"].numpy(), caches[1]["k"].numpy())


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_dense_scatter_past_the_end_lands_in_the_sink_column(kv):
    """Positions past the cache clamp into its last column (JAX drops them):
    every other column is what JAX writes, bit for bit."""
    jcfg, tcfg = cfgs(kv=kv)
    cols = 8
    rng = np.random.default_rng(9)
    positions = np.array([[6, 7, 8, 11], [0, 3, 9, 30]])
    vals = rng.standard_normal((2, tcfg.n_kv_heads, 4, tcfg.resolved_head_dim)).astype(np.float32)
    jentry = jax.tree.map(lambda a: a[0], jtf.make_kv_cache(jcfg, 2, cols)["k"])
    bidx = jnp.arange(2)[:, None, None]
    hidx = jnp.arange(tcfg.n_kv_heads)[None, :, None]
    pidx = jnp.asarray(positions)[:, None, :]
    if kv == "int8":
        vq, vs = jtf._quantize_kv(jnp.asarray(vals))
        jout = {"q": jentry["q"].at[bidx, hidx, pidx].set(vq),
                "s": jentry["s"].at[bidx, hidx, pidx].set(vs)}
    else:
        jout = jentry.at[bidx, hidx, pidx].set(jnp.asarray(vals))
    tentry = ttf._map(lambda a: a[0], ttf.make_kv_cache(tcfg, 2, cols + 1, device="cpu")["k"])
    ttf._scatter_at(tentry, t(vals), ttf._dense_index(t(positions), cols + 1, tcfg.n_kv_heads))
    real = ttf._map(lambda a: a[:, :, :cols].numpy(), tentry)
    jax.tree.map(np.testing.assert_array_equal, real, jax.tree.map(np.asarray, jout))
    sink = (tentry["q"] if kv == "int8" else tentry)[:, :, cols]
    assert bool(sink.abs().sum() > 0)


# -- the dense engine -----------------------------------------------------------

JCFG, CFG = cfgs(impl="jnp")
JCFG = dataclasses.replace(JCFG, attention_impl="auto")
CFG = dataclasses.replace(CFG, attention_impl="auto")
ENGINE_KW = dict(
    max_batch=4, max_seq_len=512, decode_chunk=4, prefill_buckets=(32, 64, 128),
    kv_layout="dense",
)
# the 150- and 300-token prompts are wider than the widest bucket: 2 and 3
# segments of 128 into local caches of 256 and 512 columns
PROMPT_LENS = (3, 40, 100, 150, 300)
NEW_TOKENS = 12


def prompts(lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def jax_tokens(weights):
    engine = JaxEngine(JCFG, weights[0], **ENGINE_KW)
    engine.start()
    try:
        opts = JaxOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
        reqs = [engine.submit(JaxRequest(prompt_tokens=p, options=opts)) for p in prompts()]
        return [r.result(timeout=600).tokens for r in reqs]
    finally:
        engine.stop()


def run_port(tparams, cfg=CFG, plist=None, new_tokens=NEW_TOKENS, **kw):
    engine = ServingEngine(cfg, tparams, device="cpu", **{**ENGINE_KW, **kw})
    engine.start()
    try:
        opts = GenerationOptions(max_new_tokens=new_tokens, temperature=0.0)
        reqs = [
            engine.submit(GenerationRequest(prompt_tokens=p, options=opts))
            for p in (plist or prompts())
        ]
        results = [r.result(timeout=600) for r in reqs]
        return results, engine.stats(), engine
    finally:
        engine.stop()


@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_dense_engine_greedy_tokens_equal_jax(weights, jax_tokens, impl):
    """Short prompts through admit groups and long ones through chunked
    prefill: the kernel path (plain versions on the CPU) and the reference
    path both give the JAX dense engine's greedy tokens."""
    from langstream_tpu_torch.ops.attention import reset_kernel_counts

    reset_kernel_counts()
    results, stats, _ = run_port(weights[1], dataclasses.replace(CFG, attention_impl=impl))
    assert [r.finish_reason for r in results] == ["length"] * len(PROMPT_LENS)
    assert [r.tokens for r in results] == jax_tokens
    assert stats["kv-layout"] == "dense" and "kv-pages-total" not in stats
    assert stats["prefill-segments-total"] == 2 + 3
    assert stats["long-prefill-queued"] == stats["long-prefill-streams"] == 0
    kernels = stats["kernels"]
    if impl == "auto":
        assert kernels["flash_segment"]["cpu_calls"] == CFG.n_layers * 5
        assert kernels["dense_decode"]["cpu_calls"] >= CFG.n_layers * stats["decode-steps-total"]
        assert kernels["flash_prefill"]["cpu_calls"] >= CFG.n_layers * stats["admit-groups-total"]
    assert kernels["paged_decode"]["cpu_calls"] == 0
    assert all(k["launches"] == 0 for k in kernels.values())


def test_int8_dense_engine_runs_the_int8_kernels(weights):
    from langstream_tpu_torch.ops.attention import reset_kernel_counts

    reset_kernel_counts()
    cfg = dataclasses.replace(CFG, kv_cache_dtype="int8")
    results, stats, _ = run_port(weights[1], cfg, plist=prompts((20, 150, 300)))
    assert all(len(r.tokens) == NEW_TOKENS for r in results)
    assert all(0 <= tok < CFG.vocab_size for r in results for tok in r.tokens)
    kernels = stats["kernels"]
    segments, steps = stats["prefill-segments-total"], stats["decode-steps-total"]
    assert segments == 2 + 3 and steps > 0
    assert kernels["flash_segment_int8"]["cpu_calls"] == CFG.n_layers * segments
    assert kernels["dense_decode_int8"]["cpu_calls"] >= CFG.n_layers * steps
    assert kernels["flash_segment"]["cpu_calls"] == kernels["dense_decode"]["cpu_calls"] == 0


def test_request_ending_at_max_seq_len_leaves_the_slot_clean(weights):
    """One slot, decode_chunk 4: each request — a short one through an admit
    group, two long ones through chunked prefill — decodes until position
    max_seq_len - 1 while its device position runs on past the cache
    (those writes land in the sink column), and the next request in that
    slot gives what it gives alone on a fresh engine."""
    kw = dict(max_batch=1, max_seq_len=64, prefill_buckets=(16, 32))
    # decode steps run in chunks of 4 from the prompt's length: with these
    # lengths the chunk that reaches position 62 runs on to 64 or 65
    plist = prompts((50, 10, 41), seed=1)
    results, _, engine = run_port(weights[1], plist=plist, new_tokens=100, **kw)
    assert bool(engine._cache["k"][:, 0, :, 64].abs().sum() > 0)  # the sink took writes
    for p, got in zip(plist, results):
        assert got.finish_reason == "length" and len(got.tokens) == 64 - len(p)
        fresh, _, _ = run_port(weights[1], plist=[p], new_tokens=100, **kw)
        assert got.tokens == fresh[0].tokens


def test_dense_long_prompt_limits_and_cancel(weights):
    """A prompt may be as long as max_seq_len - 1 on the dense layout (and
    wider than the widest bucket); a stream cancelled mid-prefill ends
    cancelled and frees its slot."""
    engine = ServingEngine(CFG, weights[1], device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.submit(GenerationRequest(prompt_tokens=[1] * 512, options=GenerationOptions()))
    req = GenerationRequest(prompt_tokens=[2] * 400, options=GenerationOptions(max_new_tokens=4))
    req.cancel()
    engine.start()
    try:
        engine.submit(req)
        assert req.result(timeout=120).finish_reason == "cancelled"
        res = engine.generate([3] * 511, GenerationOptions(max_new_tokens=4), timeout=300)
        assert res.finish_reason == "length" and len(res.tokens) == 1
    finally:
        engine.stop()
    assert engine.stats()["cancelled-total"] == 1
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(CFG, weights[1], device="cpu", kv_layout="ring")


def test_provider_serves_the_dense_layout():
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
        "kv-layout": "dense", "max-seq-len": 256, "prefill-buckets": [16, 32],
    })
    chunks = []
    try:
        engine = svc.engine()
        assert (engine.kv_layout, engine.max_seq_len, engine.prefill_buckets) == (
            "dense", 256, (16, 32)
        )
        # the rendered prompt ("user: ...\nassistant:") is wider than 32
        result = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="hello, a prompt of a few segments")],
            {"max-tokens": 5, "min-chunks-per-message": 2},
            chunks.append,
        ))
        stats = svc.engine_stats()
    finally:
        svc.close()
    assert result.completion_tokens == 5 and chunks and chunks[-1].last
    assert "".join(c.content for c in chunks) == result.content
    assert stats["kv-layout"] == "dense" and stats["prefill-segments-total"] >= 2
    assert stats["kernels"]["dense_decode"]["cpu_calls"] > 0


@pytest.mark.parametrize(
    "kind", ["prefill", "segment", "segment_int8", "decode", "decode_int8"]
)
def test_tensors_off_the_cpu_never_reach_a_plain_version(kind):
    """A wrapper takes its plain version only for a CPU tensor: any other
    device goes to the kernel launch, which refuses what is not a CUDA
    tensor of an sm_90 card (meta tensors stand in for one here)."""
    _, pcfg = kernel_configs(None)
    int8 = kind.endswith("int8")
    fn = {
        "prefill": port_attn.flash_prefill_attention,
        "segment": port_attn.flash_segment_attention,
        "segment_int8": port_attn.flash_segment_attention_int8,
        "decode": port_attn.ragged_decode_attention,
        "decode_int8": port_attn.ragged_decode_attention_int8,
    }[kind]
    meta = {"device": "meta"}
    if int8:
        k = {"q": torch.empty((2, HKV, 32, D), dtype=torch.int8, **meta),
             "s": torch.empty((2, HKV, 32), **meta)}
    else:
        k = torch.empty((2, HKV, 32, D), dtype=torch.bfloat16, **meta)
    if kind == "prefill":
        q = torch.empty((2, 32, H, D), dtype=torch.bfloat16, **meta)
    elif kind.startswith("segment"):
        q = torch.empty((2, 8, H, D), dtype=torch.bfloat16, **meta)
    else:
        q = torch.empty((2, H, D), dtype=torch.bfloat16, **meta)
    extra = torch.zeros(2, dtype=torch.int32, **meta)
    before = (fn.cpu_calls, fn.launches)
    args = (q, k, k, pcfg) if kind == "prefill" else (q, k, k, extra, pcfg)
    with pytest.raises(ValueError, match="meta"):
        fn(*args)
    assert (fn.cpu_calls, fn.launches) == before


def test_dense_engine_refuses_cuda_without_a_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(CFG, weights[1], kv_layout="dense")  # the default device is "cuda"
