"""The PyTorch port's attention kernels, through their plain versions on the
CPU, against the JAX package's Pallas kernels run in interpret mode (as
tests/test_pallas_ops.py runs them), on the same numpy inputs.

Tolerances: f32 everywhere; the two sides sum in different orders (the
Pallas kernels blockwise with an online softmax, the plain versions in one
pass), so outputs agree to ~1e-6 and are held to 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import ModelConfig as JaxModelConfig
from langstream_tpu.ops import attention as jax_attn
from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops import attention as port_attn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = dict(
    name="k", vocab_size=128, d_model=64, n_layers=1, n_heads=8, n_kv_heads=4,
    d_ff=64, head_dim=16, dtype="float32",
)
TOL = 1e-5


def configs(softcap):
    return (
        JaxModelConfig(**FIELDS, attn_logit_softcap=softcap),
        ModelConfig(**FIELDS, attn_logit_softcap=softcap),
    )


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("s", [32, 64, 96])
def test_flash_prefill_plain_matches_pallas(s, softcap):
    rng = np.random.default_rng(s)
    b, h, hkv, d = 2, 8, 4, 16
    q = rand(rng, b, s, h, d)
    k, v = rand(rng, b, hkv, s, d), rand(rng, b, hkv, s, d)
    jcfg, pcfg = configs(softcap)
    ref = jax_attn.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
        block_q=32, block_k=32, interpret=True,
    )
    before = port_attn.flash_prefill_attention.cpu_calls
    out = port_attn.flash_prefill_attention(t(q), t(k), t(v), pcfg)
    assert port_attn.flash_prefill_attention.cpu_calls == before + 1
    assert out.shape == (b, s, h * d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _paged_case(rng, int8: bool):
    b, h, hkv, d, ps, pages, tp = 5, 8, 4, 16, 8, 16, 4
    q = rand(rng, b, h, d)
    # ragged tables; unmapped entries carry the sentinel (= pages). Row 1
    # ends exactly on a page boundary, row 3 fills its whole table, row 4
    # is a one-token row on its first page
    table = np.array(
        [[3, 1, pages, pages], [0, pages, pages, pages], [2, 5, 9, pages],
         [7, 4, 6, 8], [11, pages, pages, pages]],
        np.int32,
    )
    lengths = np.array([13, 8, 20, 32, 1], np.int32)
    if int8:
        def entry():
            return {
                "q": rng.integers(-127, 128, (pages, hkv, ps, d)).astype(np.int8),
                "s": (rng.random((pages, hkv, ps)) * 0.05 + 0.01).astype(np.float32),
            }
    else:
        def entry():
            return rand(rng, pages, hkv, ps, d)
    return q, entry(), entry(), lengths, table, ps


def _to(entry, conv):
    return {k: conv(v) for k, v in entry.items()} if isinstance(entry, dict) else conv(entry)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_plain_matches_pallas(int8, softcap):
    rng = np.random.default_rng(7 + int8)
    q, k, v, lengths, table, ps = _paged_case(rng, int8)
    jcfg, pcfg = configs(softcap)
    jax_fn = (
        jax_attn.ragged_paged_decode_attention_int8
        if int8 else jax_attn.ragged_paged_decode_attention
    )
    port_fn = (
        port_attn.ragged_paged_decode_attention_int8
        if int8 else port_attn.ragged_paged_decode_attention
    )
    ref = jax_fn(
        jnp.asarray(q), _to(k, jnp.asarray), _to(v, jnp.asarray), jnp.asarray(lengths),
        jnp.asarray(table), jcfg, ps, interpret=True,
    )
    before = (port_fn.cpu_calls, port_fn.launches)
    out = port_fn(t(q), _to(k, t), _to(v, t), t(lengths), t(table), pcfg, ps)
    assert (port_fn.cpu_calls, port_fn.launches) == (before[0] + 1, before[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_paged_decode_ignores_pages_past_the_length():
    """Garbage (even NaN) in the unread part of a row's last page, or in
    pages past its length, must not reach the output."""
    rng = np.random.default_rng(3)
    q, k, v, lengths, table, ps = _paged_case(rng, int8=False)
    _, pcfg = configs(None)
    clean = port_attn.ragged_paged_decode_attention(
        t(q), t(k), t(v), t(lengths), t(table), pcfg, ps
    )
    k2, v2 = k.copy(), v.copy()
    # row 0 (length 13) reads page 3 whole and rows 0..4 of page 1; page
    # 15 is mapped nowhere
    for a in (k2, v2):
        a[1, :, 5:] = np.nan
        a[15] = np.nan
    dirty = port_attn.ragged_paged_decode_attention(
        t(q), t(k2), t(v2), t(lengths), t(table), pcfg, ps
    )
    np.testing.assert_array_equal(clean.numpy(), dirty.numpy())


def test_zero_length_row_is_zero_not_nan():
    rng = np.random.default_rng(4)
    q, k, v, lengths, table, ps = _paged_case(rng, int8=False)
    _, pcfg = configs(None)
    lengths = lengths.copy()
    lengths[2] = 0
    out = port_attn.ragged_paged_decode_attention(
        t(q), t(k), t(v), t(lengths), t(table), pcfg, ps
    )
    assert np.all(out.numpy()[2] == 0.0)
    assert np.isfinite(out.numpy()).all()


def test_kernel_gates():
    _, pcfg = configs(None)
    cpu = torch.device("cpu")
    assert port_attn.kernel_path_ok(pcfg, cpu)
    assert port_attn.kernel_path_ok(dataclasses.replace(pcfg, attention_impl="pallas"), cpu)
    assert not port_attn.kernel_path_ok(dataclasses.replace(pcfg, attention_impl="jnp"), cpu)
    with pytest.raises(ValueError, match="attention_impl"):
        port_attn.kernel_path_ok(dataclasses.replace(pcfg, attention_impl="triton"), cpu)


def test_kernel_counts_report_every_kernel():
    counts = port_attn.kernel_counts()
    assert set(counts) == {
        "flash_prefill", "paged_decode", "paged_decode_int8", "flash_segment",
        "flash_segment_int8", "dense_decode", "dense_decode_int8",
    }
    for c in counts.values():
        assert set(c) == {"launches", "cpu_calls"}


def test_build_is_lazy_and_keyed_by_source(monkeypatch, tmp_path):
    """Importing the port builds nothing; a library's path names a hash of
    its source and flags; a machine without nvcc raises a clear error."""
    assert _build._libs == {}
    assert set(_build.SOURCES) == {"flash_segment", "ragged_decode"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path == _build.library_path(name)
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


# ---------------------------------------------------------------------------
# The segment kernel's launch plan (pure: shapes, strides, dtypes, bases)
# ---------------------------------------------------------------------------

SMEM_PER_CTA = 232448  # an H100 CTA's shared memory


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_segment_plan_prompt_cache(d, group, int8):
    """A contiguous prompt cache [B, Hkv, S, D]: TMA maps over the view's own
    dims and byte strides, 128-row work items of one kv-head group, a
    persistent grid, and the int8 scales read without TMA."""
    b, s, hkv = 2, 300, 2
    h = hkv * group
    kv_shape = (b, hkv, s, d)
    dtype = torch.int8 if int8 else torch.bfloat16
    item = 1 if int8 else 2
    plan = port_attn.segment_launch_plan(
        (b, s, h, d), kv_shape, _contiguous_strides(kv_shape), dtype,
        scale_strides=_contiguous_strides(kv_shape[:-1]) if int8 else None,
    )
    p = 128 // group
    assert plan["positions_per_item"] == p
    assert plan["work_items"] == (-(-s // p), hkv, b)
    assert plan["grid"] == min(-(-s // p) * hkv * b, port_attn.H100_SMS)
    assert plan["threads"] == 384
    q = plan["tma"]["q"]
    assert q["dims"] == (d, h, s, b)
    assert q["strides"] == (2 * d, 2 * h * d, 2 * s * h * d)
    assert q["box"] == (64, group, p, 1) and q["swizzle"] == 128
    bk = 64 if int8 or d == 256 else 128
    assert plan["keys_per_tile"] == bk
    for name in ("k", "v"):
        m = plan["tma"][name]
        assert m["dims"] == (d, s, hkv, b)
        assert m["strides"] == (d * item, s * d * item, hkv * s * d * item)
        assert m["box"] == ((d if int8 else 64), bk, 1, 1)
        assert m["swizzle"] == (0 if int8 else 128)
        assert all(x % 16 == 0 for x in m["strides"])
    assert set(plan["tma"]) == {"q", "k", "v"}
    assert plan["plain_loads"] == (("k_scale", "v_scale") if int8 else ())
    assert plan["smem_bytes"] <= SMEM_PER_CTA


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_segment_plan_reads_big_cache_view_in_place(d, int8):
    """A [..., :kv_bound] view of the dense big cache, whose sink column
    makes rows of max_seq_len + 1 = 8,193: the K/V maps take the view's
    width and the big cache's byte strides (no copy); the scale rows of
    8,193 f32 (32,772 bytes, not a multiple of 16) never go to TMA."""
    b, hkv, width, bound = 2, 8, 8193, 6024
    big = (b, hkv, width, d)
    strides = _contiguous_strides(big)
    scale_strides = _contiguous_strides(big[:-1])
    dtype = torch.int8 if int8 else torch.bfloat16
    item = 1 if int8 else 2
    plan = port_attn.segment_launch_plan(
        (b, 1024, 4 * hkv, d), (b, hkv, bound, d), strides, dtype,
        kv_ptr=1 << 20, q_ptr=1 << 21, scale_strides=scale_strides if int8 else None,
    )
    for name in ("k", "v"):
        assert plan["tma"][name]["dims"] == (d, bound, hkv, b)
        assert plan["tma"][name]["strides"] == (d * item, width * d * item, hkv * width * d * item)
    assert (width * 4) % 16 != 0
    assert "k_scale" not in plan["tma"] and "v_scale" not in plan["tma"]
    assert plan["plain_loads"] == (("k_scale", "v_scale") if int8 else ())
    # the same strides as torch gives a real view of a (small) sink-column cache
    small = torch.empty((1, 2, 17 + 1, d), dtype=dtype)[:, :, :17]
    plan = port_attn.segment_launch_plan(
        (1, 17, 8, d), tuple(small.shape), small.stride(), dtype, small.data_ptr(),
        scale_strides=torch.empty((1, 2, 18))[:, :, :17].stride() if int8 else None,
    )
    assert plan["tma"]["k"]["strides"] == (d * item, 18 * d * item, 2 * 18 * d * item)


_REFUSED = {
    # a batch stride of 8 bytes past a multiple of 16 (TMA's stride rule)
    "batch_stride_not_16": dict(kv_strides=(2 * 300 * 64 + 4, 300 * 64, 64, 1)),
    "head_stride_not_16": dict(kv_strides=(4 * 300 * 64, 300 * 64 + 4, 64, 1)),
    "misaligned_base": dict(kv_ptr=(1 << 20) + 8),
    "misaligned_q": dict(q_ptr=(1 << 20) + 2),
    "rows_not_contiguous": dict(kv_strides=(2 * 300 * 128, 300 * 128, 128, 1)),
    "head_dim_96": dict(q_shape=(1, 300, 4, 96), kv_shape=(1, 2, 300, 96)),
    "group_3": dict(q_shape=(1, 300, 6, 64)),
    "float16_cache": dict(kv_dtype=torch.float16),
    "int8_without_scales": dict(kv_dtype=torch.int8),
    "q_and_cache_batches_differ": dict(q_shape=(2, 300, 4, 64)),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_segment_plan_refuses_what_the_kernel_cannot_take(case):
    args = dict(
        q_shape=(1, 300, 4, 64), kv_shape=(1, 2, 300, 64),
        kv_strides=_contiguous_strides((1, 2, 300, 64)), kv_dtype=torch.bfloat16,
        kv_ptr=1 << 20, q_ptr=1 << 21,
    )
    args.update(_REFUSED[case])
    with pytest.raises(ValueError, match="segment kernel"):
        port_attn.segment_launch_plan(**args)
