"""The PyTorch port's model path against the JAX package on the same
weights and inputs (numpy in between): int8 quantization bit for bit, the
building blocks, and prefill + paged decode logits, caches and pools with
attention forced to the kernels (JAX "pallas" runs the Pallas kernels in
interpret mode; the port's "auto" runs each kernel's plain version on the
CPU) and to the gathered reference ("jnp"), for model-dtype and int8 KV.

Tolerances (f32 throughout): logits 1e-4 and K/V 1e-5 absolute — the two
frameworks sum matmuls in different orders, ~1e-6. int8 KV: a K/V value
that lands within rounding noise of a .5 boundary may quantize one step
apart, so int8 codes agree to +-1 and logits to 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import quant as jquant
from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu_torch.models import quant as tquant
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import _tensor_from_numpy, init_params, params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
INT8_LOGIT_TOL = 1e-3


def cfgs(kv="model", impl="pallas", name="tiny-test"):
    """(JAX config, port config) of one preset; JAX's "pallas" ↔ the
    port's kernel path "auto"."""
    j = dataclasses.replace(
        JAX_PRESETS[name], dtype="float32", kv_cache_dtype=kv, attention_impl=impl
    )
    t = dataclasses.replace(
        MODEL_PRESETS[name], dtype="float32", kv_cache_dtype=kv,
        attention_impl="auto" if impl == "pallas" else impl,
    )
    return j, t


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_np(x):
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfgs()
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return params, params_from_numpy(np_tree(params), tcfg, device="cpu")


# -- quantization ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_exact(dtype):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((2, 32, 48)).astype(np.float32)).astype(dtype)
    ref = jquant.quantize_weight(w)
    tw = _tensor_from_numpy(np.asarray(w), torch.device("cpu"))
    assert tw.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    out = tquant.quantize_weight(tw)
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(out["s"].numpy(), np.asarray(ref["s"]))
    row_ref = jquant.quantize_row_wise(w)
    row = tquant.quantize_row_wise(tw)
    np.testing.assert_array_equal(row["q"].numpy(), np.asarray(row_ref["q"]))
    np.testing.assert_array_equal(row["s"].numpy(), np.asarray(row_ref["s"]))
    back = tquant.dequantize_weight(out, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jquant.dequantize_weight(ref, jnp.float32)))


def test_quantize_params_matches_jax(weights):
    jparams, tparams = weights
    jcfg, tcfg = cfgs()
    ref = np_tree(jquant.quantize_params(jparams, jcfg))
    out = tquant.quantize_params(tparams, tcfg)
    for key, leaf in ref["layers"].items():
        got = out["layers"][key]
        assert tquant.is_quantized(got) == jquant.is_quantized(leaf)
        np.testing.assert_array_equal(to_np(got["q"] if isinstance(got, dict) else got),
                                      leaf["q"] if isinstance(leaf, dict) else leaf)
    np.testing.assert_array_equal(out["lm_head"]["s"].numpy(), ref["lm_head"]["s"])
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32))
    np.testing.assert_allclose(
        tquant.quantized_matmul(x, out["lm_head"]).numpy(),
        np.asarray(jquant.quantized_matmul(jnp.asarray(x.numpy()), jnp.asarray(ref["lm_head"]["q"])
                                           .astype(jnp.float32) * ref["lm_head"]["s"])),
        atol=LOGIT_TOL,
    )


def test_quantize_kv_bit_exact():
    x = np.random.default_rng(2).standard_normal((3, 4, 5, 16)).astype(np.float32) * 3
    jq, js = jtf._quantize_kv(jnp.asarray(x))
    tq, ts = ttf._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- building blocks --------------------------------------------------------


def test_rms_norm_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = jtf.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = ttf.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("name", ["llama-3-8b", "llama-3.1-8b", "gemma-2b"])
def test_rope_matches(name):
    """sin/cos (with llama3 NTK scaling for llama-3.1) at positions up to
    8192, and the rotation."""
    pos = np.arange(0, 8192, 16, dtype=np.int64).reshape(2, -1) + np.array([[0], [7]])
    js, jc = jtf._rope_freqs(jnp.asarray(pos), JAX_PRESETS[name])
    ts, tc = ttf._rope_freqs(torch.from_numpy(pos), MODEL_PRESETS[name])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    hd = MODEL_PRESETS[name].resolved_head_dim
    x = np.random.default_rng(4).standard_normal((2, pos.shape[1], 2, hd)).astype(np.float32)
    ref = jtf.apply_rope(jnp.asarray(x), js, jc)
    out = ttf.apply_rope(torch.from_numpy(x), ts, tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_llama3_scaling_changes_low_frequencies():
    base = ttf._rope_freqs(torch.arange(1)[None] + 1, MODEL_PRESETS["llama-3-8b"])[0]
    scaled = ttf._rope_freqs(torch.arange(1)[None] + 1, MODEL_PRESETS["llama-3.1-8b"])[0]
    assert torch.allclose(base[..., 0], scaled[..., 0])  # highest frequency kept
    assert not torch.allclose(base[..., -1], scaled[..., -1])  # lowest slowed down


# -- model entry points -----------------------------------------------------


PROMPTS = np.array(
    [[7, 3, 9, 4, 1] + [0] * 11, [5, 8, 2, 6, 4, 4, 9, 1, 3, 2, 7, 7, 1] + [0] * 3], np.int32
)
LENGTHS = np.array([5, 13], np.int32)
PS, NUM_PAGES = 8, 8
# row 0 crosses from page 3 into page 1 at position 8, row 1 from page 2
# into page 5 at position 16; unmapped entries carry the sentinel
TABLE = np.array([[3, 1, NUM_PAGES, NUM_PAGES], [0, 2, 5, NUM_PAGES]], np.int32)
STEPS = 4


def _assert_kv(got, ref, kv):
    if kv == "int8":
        q, rq = got["q"].astype(np.int32), ref["q"].astype(np.int32)
        assert np.abs(q - rq).max() <= 1
        assert (q != rq).mean() < 1e-3
        np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-5, atol=1e-12)
    else:
        np.testing.assert_allclose(got, ref, atol=KV_TOL)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_prefill_and_paged_decode_match_jax(weights, kv, impl):
    jparams, tparams = weights
    jcfg, tcfg = cfgs(kv, impl)
    tol = INT8_LOGIT_TOL if kv == "int8" else LOGIT_TOL
    b, w = PROMPTS.shape

    # prefill into a local cache, logits at each prompt's last token
    jlogits, jcache = jtf.prefill(
        jparams, jnp.asarray(PROMPTS), jnp.asarray(LENGTHS),
        jtf.make_kv_cache(jcfg, b, w), jcfg,
    )
    tlogits, tcache = ttf.prefill(
        tparams, torch.from_numpy(PROMPTS), torch.from_numpy(LENGTHS),
        ttf.make_kv_cache(tcfg, b, w, device="cpu"), tcfg,
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=tol)
    for name in ("k", "v"):
        _assert_kv(to_np(tcache[name]), np_tree(jcache[name]), kv)

    # the admit group's page insert, then decode steps through the table
    jpool = jtf.paged_insert_cache(
        jtf.make_page_pool(jcfg, NUM_PAGES, PS), jcache, jnp.asarray(TABLE), PS
    )
    tpool = ttf.paged_insert_cache(
        ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu"), tcache,
        torch.from_numpy(TABLE), PS,
    )
    tokens = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    positions = LENGTHS.copy()
    for _ in range(STEPS):
        jl, jpool = jtf.paged_decode_step_inplace(
            jparams, jnp.asarray(tokens), jnp.asarray(positions), jpool,
            jnp.asarray(TABLE), jcfg, PS,
        )
        tl, tpool = ttf.paged_decode_step_inplace(
            tparams, torch.from_numpy(tokens), torch.from_numpy(positions), tpool,
            torch.from_numpy(TABLE), tcfg, PS,
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
        tokens = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        positions = positions + 1
    # real pages agree; the port's extra page is the sentinel's write sink
    for name in ("k", "v"):
        got = to_np(tpool[name])
        got = {k: v[:, :NUM_PAGES] for k, v in got.items()} if kv == "int8" else got[:, :NUM_PAGES]
        _assert_kv(got, np_tree(jpool[name]), kv)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_forward_matches_jax(weights, impl):
    jparams, tparams = weights
    jcfg, tcfg = cfgs(impl=impl)
    tokens = np.random.default_rng(5).integers(0, 512, (2, 32)).astype(np.int32)
    ref = jtf.forward(jparams, jnp.asarray(tokens), jcfg)
    out = ttf.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL)


def test_kernel_and_reference_paths_agree(weights):
    """The port's own two paths (kernel plain versions vs gathered
    reference) give the same prefill logits."""
    _, tparams = weights
    _, kcfg = cfgs(impl="pallas")
    _, rcfg = cfgs(impl="jnp")
    b, w = PROMPTS.shape
    outs = [
        ttf.prefill(
            tparams, torch.from_numpy(PROMPTS), torch.from_numpy(LENGTHS),
            ttf.make_kv_cache(c, b, w, device="cpu"), c,
        )[0].numpy()
        for c in (kcfg, rcfg)
    ]
    np.testing.assert_allclose(outs[0], outs[1], atol=LOGIT_TOL)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_paged_scatter_and_gather_match_jax(kv):
    """Per-token scatter into one layer's pool entry: row 0 crosses a page
    boundary; row 1 writes into an unmapped (sentinel) logical page and past
    its table. JAX drops those writes, the port lands them in the sink page;
    the real pages must be equal bit for bit, and so must the gathered view
    through a fully mapped table."""
    jcfg, tcfg = cfgs(kv=kv)
    rng = np.random.default_rng(11)
    table = np.array([[3, 1, 5], [6, NUM_PAGES, 2]], np.int32)
    positions = np.array([[PS - 2, PS - 1, PS, PS + 1], [1, PS + 3, 3 * PS + 1, 2 * PS]])
    vals = rng.standard_normal((2, tcfg.n_kv_heads, 4, tcfg.resolved_head_dim)).astype(np.float32)
    jentry = jax.tree.map(lambda a: a[0], jtf.make_page_pool(jcfg, NUM_PAGES, PS)["k"])
    jout = jtf._paged_scatter_entry(
        jentry, jnp.asarray(vals), jnp.asarray(table), jnp.asarray(positions, jnp.int32), PS
    )
    tentry = ttf._map(lambda a: a[0], ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu")["k"])
    ttf._paged_scatter_entry(
        tentry, torch.from_numpy(vals), torch.from_numpy(table), torch.from_numpy(positions), PS
    )
    real = ttf._map(lambda a: a[:NUM_PAGES], tentry)
    jax.tree.map(np.testing.assert_array_equal, to_np(real), to_np(jout))
    sink = (tentry["q"] if kv == "int8" else tentry)[NUM_PAGES]
    assert bool(sink.abs().sum() > 0)  # the dropped writes went to the sink
    mapped = np.array([[3, 1, 5], [6, 0, 2]], np.int32)
    jax.tree.map(
        np.testing.assert_array_equal,
        to_np(ttf._paged_gather_entry(tentry, torch.from_numpy(mapped), PS)),
        to_np(jtf._paged_gather_entry(jout, jnp.asarray(mapped), PS)),
    )


def test_insert_of_padding_rows_lands_only_in_the_sink():
    _, tcfg = cfgs()
    local = ttf.make_kv_cache(tcfg, 2, 16, device="cpu")
    for name in ("k", "v"):
        local[name].fill_(1.0)
    table = torch.tensor([[2, NUM_PAGES], [NUM_PAGES, NUM_PAGES]], dtype=torch.int32)
    pool = ttf.paged_insert_cache(
        ttf.make_page_pool(tcfg, NUM_PAGES, PS, device="cpu"), local, table, PS
    )
    touched = pool["k"].abs().sum(dim=(0, 2, 3, 4)) > 0  # per physical page
    assert touched.tolist() == [False, False, True] + [False] * 5 + [True]


# -- parameters ---------------------------------------------------------------


def test_params_from_numpy_keeps_layout_and_bits():
    cfg = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="bfloat16")
    params = jquant.quantize_params(jtf.init_params(cfg, jax.random.PRNGKey(1)), cfg)
    out = params_from_numpy(np_tree(params), MODEL_PRESETS["tiny-test"], device="cpu")
    assert out["embed"].dtype == torch.bfloat16
    assert tquant.is_quantized(out["layers"]["wq"])
    np.testing.assert_array_equal(
        out["embed"].view(torch.int16).numpy(),
        np.asarray(params["embed"]).view(np.int16),
    )
    np.testing.assert_array_equal(out["layers"]["w_up"]["q"].numpy(),
                                  np.asarray(params["layers"]["w_up"]["q"]))


def test_init_params_shapes_and_scales_match_jax():
    jcfg, tcfg = cfgs()
    shapes = jax.tree.map(
        lambda a: tuple(a.shape), jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    )
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(v.shape) for k, v in params["layers"].items()}
    assert got == dict(shapes["layers"])
    assert tuple(params["embed"].shape) == shapes["embed"]
    assert tuple(params["lm_head"].shape) == shapes["lm_head"]
    # N(0, 1) * fan_in^-0.5
    assert abs(params["layers"]["w_down"].std().item() - tcfg.d_ff ** -0.5) < 0.01
    assert abs(params["layers"]["wq"].std().item() - tcfg.d_model ** -0.5) < 0.01


def test_moe_configs_raise():
    """MoE configs raised NotImplementedError until ``moe_ffn`` was ported;
    now a tiny-moe-test config builds its params and runs a forward on the
    CPU (tests/test_torch_moe.py holds it against JAX)."""
    cfg = dataclasses.replace(MODEL_PRESETS["tiny-moe-test"], dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tuple(params["layers"]["router"].shape) == (cfg.n_layers, cfg.d_model, cfg.n_experts)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    logits = ttf.forward(params, tokens, cfg)
    assert logits.shape == (2, 9, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
