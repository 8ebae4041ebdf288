"""The decode kernel's launch plan and its partition of a row's tiles.

``decode_launch_plan`` (pure: shapes, strides, dtypes, bases) for the paged
and dense layouts and the bf16 and int8 caches, and a plain-torch emulation
of what the kernel computes with that plan — each cluster rank's share of a
row's valid tiles, its partial (m, l, acc), then rank 0's merge with
weights exp(m_r - M); for an int8 cache the K scale multiplies each row's
dot and the V scale its probability, as the kernel does — held against the
JAX package's ``ragged_decode_attention`` / ``ragged_paged_decode_attention``
and their ``_int8`` twins in interpret mode, on the same numpy inputs. f32
on both sides, summed (and, for int8, scaled) in different orders:
agreement to ~1e-6, held to 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import ModelConfig as JaxModelConfig
from langstream_tpu.ops import attention as jax_attn
from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.ops import attention as port_attn

TOL = 1e-5
NEG = -1e30


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_plan_paged(d, group, ps):
    """A contiguous page pool [P, Hkv, ps, D] read through a 24-wide table:
    tiles of 64 rows (a page of 64, or half a page of 128), a cluster of 4
    CTAs per (row, kv head), a ring of at least 3 stages, whole-row copies
    of 16-byte multiples, and the kernel's shared-memory layout within a
    CTA's."""
    hkv, tp = 2, 24
    pool = (40, hkv, ps, d)
    plan = port_attn.decode_launch_plan(
        (3, hkv * group, d), pool, _contiguous_strides(pool), torch.bfloat16, "paged",
        table_width=tp, kv_ptr=1 << 20, q_ptr=1 << 21,
    )
    assert plan["layout"] == "paged"
    assert plan["page_rows"] == ps and plan["table_width"] == tp
    assert plan["tile_rows"] == 64 and plan["tiles"] == tp * ps // 64
    assert plan["width"] == tp * ps
    assert plan["cluster"] == 4 and plan["grid"] == (hkv, 3, 4)
    assert plan["tiles_per_rank"] == math.ceil(plan["tiles"] / 4)
    assert plan["threads"] == 160
    assert plan["row_bytes"] == 2 * d and plan["copy_bytes"] == 64 * 2 * d
    assert plan["copy_bytes"] % 16 == 0 and plan["row_bytes"] % 16 == 0
    stage = 2 * plan["copy_bytes"]
    assert 3 <= plan["stages"] <= 8
    assert plan["stages"] * stage <= plan["smem_bytes"] <= port_attn.SMEM_PER_CTA
    assert plan["smem_bytes"] == port_attn._cluster_smem(group, d, 64, plan["stages"])


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_plan_reads_big_cache_view_in_place(d, group):
    """A [..., :T] view of a sink-column cache is read through its strides:
    the plan takes the view's width T and the big cache's strides, and
    copies only whole rows, so a row never reads past T."""
    hkv = 2
    big = torch.empty((2, hkv, 300 + 1, d), dtype=torch.bfloat16)
    view = big[:, :, :300]
    plan = port_attn.decode_launch_plan(
        (2, hkv * group, d), tuple(view.shape), view.stride(), view.dtype, "dense",
        kv_ptr=view.data_ptr(), q_ptr=1 << 21,
    )
    assert view.stride() == (hkv * 301 * d, 301 * d, d, 1)
    assert plan["layout"] == "dense" and plan["table_width"] == 0
    assert plan["tile_rows"] == 64 and plan["tiles"] == math.ceil(300 / 64)
    assert plan["width"] == 300
    assert plan["cluster"] == 4 and plan["grid"] == (hkv, 2, 4)
    assert plan["tiles_per_rank"] == 2
    assert plan["smem_bytes"] <= port_attn.SMEM_PER_CTA
    # a short cache: fewer tiles than the cluster size
    short = port_attn.decode_launch_plan(
        (2, hkv * group, d), (2, hkv, 70, d), _contiguous_strides((2, hkv, 70, d)),
        torch.bfloat16, "dense",
    )
    assert short["tiles"] == 2 and short["cluster"] == 2 and short["grid"] == (hkv, 2, 2)
    wide = port_attn.decode_launch_plan(
        (2, hkv * group, d), (2, hkv, 2048, d), (hkv * 8193 * d, 8193 * d, d, 1),
        torch.bfloat16, "dense",
    )
    assert wide["tiles"] == 32 and wide["cluster"] == 4 and wide["tiles_per_rank"] == 8


def test_decode_plan_page_tiles():
    """A page of at most 64 rows is one tile; a wider page splits into the
    largest equal parts of at most 64 rows (96 → 2 x 48, 128 → 2 x 64)."""
    for ps, tile in ((16, 16), (48, 48), (8, 8), (96, 48), (128, 64)):
        pool = (10, 2, ps, 128)
        plan = port_attn.decode_launch_plan(
            (1, 8, 128), pool, _contiguous_strides(pool), torch.bfloat16, "paged",
            table_width=4,
        )
        assert plan["tile_rows"] == tile and plan["tiles"] == 4 * (ps // tile)
        assert plan["stages"] >= 3


_PAGED = dict(q_shape=(2, 8, 64), kv_shape=(10, 2, 64, 64),
              kv_strides=_contiguous_strides((10, 2, 64, 64)), layout="paged", table_width=4)
_DENSE = dict(q_shape=(2, 8, 64), kv_shape=(2, 2, 300, 64),
              kv_strides=(2 * 301 * 64, 301 * 64, 64, 1), layout="dense")
_DENSE_I8 = dict(_DENSE, kv_dtype=torch.int8, scale_strides=(2 * 301, 301, 1))
_PAGED_I8 = dict(_PAGED, kv_dtype=torch.int8, scale_strides=_contiguous_strides((10, 2, 64)))
_REFUSED = {
    "misaligned_base": dict(_DENSE, kv_ptr=(1 << 20) + 8),
    "misaligned_q": dict(_DENSE, q_ptr=(1 << 20) + 2),
    "head_stride_not_whole_rows": dict(_DENSE, kv_strides=(2 * 301 * 64, 301 * 64 + 8, 64, 1)),
    "batch_stride_not_whole_rows": dict(_DENSE, kv_strides=(2 * 301 * 64 + 8, 301 * 64, 64, 1)),
    "rows_not_contiguous": dict(_DENSE, kv_strides=(2 * 301 * 128, 301 * 128, 128, 1)),
    "pool_not_contiguous": dict(_PAGED, kv_strides=(2 * 65 * 64, 65 * 64, 64, 1)),
    "head_dim_96": dict(_DENSE, q_shape=(2, 8, 96), kv_shape=(2, 2, 300, 96),
                        kv_strides=_contiguous_strides((2, 2, 300, 96))),
    "group_3": dict(_DENSE, q_shape=(2, 6, 64)),
    "int8_cache": dict(_DENSE, kv_dtype=torch.int8),  # without its scales' strides
    "float16_cache": dict(_DENSE, kv_dtype=torch.float16),
    "no_table": dict(_PAGED, table_width=0),
    "batches_differ": dict(_DENSE, q_shape=(3, 8, 64)),
    "unknown_layout": dict(_DENSE, layout="ring"),
    "pages_too_big": dict(_PAGED, q_shape=(2, 16, 256), kv_shape=(10, 2, 1024, 256),
                          kv_strides=_contiguous_strides((10, 2, 1024, 256))),
    "int8_scale_rows_strided": dict(_DENSE_I8, scale_strides=(2 * 301 * 2, 301 * 2, 2)),
    "int8_scale_strides_short": dict(_DENSE_I8, scale_strides=(2 * 301, 301)),
    "int8_scale_pool_not_contiguous": dict(_PAGED_I8, scale_strides=(2 * 65, 65, 1)),
    "int8_misaligned_base": dict(_DENSE_I8, kv_ptr=(1 << 20) + 8),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_decode_plan_refuses_what_the_kernel_cannot_take(case, monkeypatch):
    args = dict(kv_dtype=torch.bfloat16, kv_ptr=1 << 20, q_ptr=1 << 21)
    args.update(_REFUSED[case])
    if case == "pages_too_big":
        # tiles of whole 1024-row pages: 3 stages of 1 MiB do not fit a CTA
        monkeypatch.setattr(port_attn, "DECODE_TILE_ROWS", 1024)
    with pytest.raises(ValueError, match="decode kernel"):
        port_attn.decode_launch_plan(**args)


def test_plan_accepts_both_default_examples():
    for base in (_PAGED, _DENSE):
        port_attn.decode_launch_plan(kv_dtype=torch.bfloat16, **base)
    for base in (_PAGED_I8, _DENSE_I8):
        port_attn.decode_launch_plan(**base)


# ring stages of an int8 tile of 64 rows (2 x 64 x D bytes + 2 x 64 f32
# scales) within the 72 KB int8 ring, at least 3 and at most 8
INT8_STAGES = {64: 8, 128: 4, 256: 3}


@pytest.mark.parametrize("ps", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_plan_paged_int8(d, group, ps):
    """An int8 pool [P, Hkv, ps, D] with its scale pool [P, Hkv, ps]: the
    bf16 plan's tiles, cluster and grid; a stage of half the bf16 bytes
    plus the tile's K and V scales, so a smaller ring holds as many stages; the
    scales copied 4 bytes a row."""
    hkv, tp = 2, 24
    pool = (40, hkv, ps, d)
    args = dict(q_shape=(3, hkv * group, d), kv_shape=pool, kv_strides=_contiguous_strides(pool),
                layout="paged", table_width=tp, kv_ptr=1 << 20, q_ptr=1 << 21)
    plan = port_attn.decode_launch_plan(
        kv_dtype=torch.int8, scale_strides=_contiguous_strides(pool[:-1]), **args,
    )
    bf16 = port_attn.decode_launch_plan(kv_dtype=torch.bfloat16, **args)
    for key in ("cluster", "grid", "threads", "page_rows", "table_width", "tile_rows", "tiles",
                "width", "tiles_per_rank"):
        assert plan[key] == bf16[key], key
    assert plan["row_bytes"] == d and plan["copy_bytes"] == 64 * d
    assert plan["copy_bytes"] % 16 == 0
    assert plan["stage_bytes"] == 2 * 64 * d + 2 * 64 * 4
    assert bf16["stage_bytes"] == 2 * 64 * 2 * d
    assert plan["stages"] == INT8_STAGES[d] >= bf16["stages"]
    assert plan["scale_copy"] == port_attn.DECODE_SCALE_COPY and bf16["scale_copy"] is None
    assert plan["scale_strides"] == (hkv * ps, ps) and bf16["scale_strides"] == (0, 0)
    assert plan["stages"] * plan["stage_bytes"] <= plan["smem_bytes"] <= port_attn.SMEM_PER_CTA
    assert plan["smem_bytes"] == port_attn._cluster_smem(group, d, 64, plan["stages"], 1)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_plan_int8_reads_sink_column_view(d, group):
    """The engine's dense int8 cache is max_seq_len + 1 columns wide: the
    scale rows of a [..., :T] view start (T + 1) * 4 bytes apart, off the
    16-byte grid, and the plan takes them in place (4-byte scale copies),
    with the view's width and the big cache's strides; 8,193 wide is the
    engine's own shape."""
    hkv = 2
    for t in (300, 2048, 8192):
        kv_strides = (hkv * (t + 1) * d, (t + 1) * d, d, 1)
        scale_strides = (hkv * (t + 1), t + 1, 1)
        assert (scale_strides[1] * 4) % 16
        plan = port_attn.decode_launch_plan(
            (2, hkv * group, d), (2, hkv, t, d), kv_strides, torch.int8, "dense",
            kv_ptr=1 << 20, q_ptr=1 << 21, scale_strides=scale_strides,
        )
        tiles = math.ceil(t / 64)
        assert plan["layout"] == "dense" and plan["table_width"] == 0
        assert plan["width"] == t and plan["tile_rows"] == 64 and plan["tiles"] == tiles
        assert plan["cluster"] == min(4, tiles) and plan["grid"] == (hkv, 2, min(4, tiles))
        assert plan["scale_strides"] == scale_strides[:2]
        assert plan["scale_copy"] == port_attn.DECODE_SCALE_COPY
        assert plan["stages"] == INT8_STAGES[d]
        assert plan["smem_bytes"] == port_attn._cluster_smem(group, d, 64, plan["stages"], 1)
        assert plan["smem_bytes"] <= port_attn.SMEM_PER_CTA


# ---------------------------------------------------------------------------
# The partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cluster", [1, 3, 8])
def test_rank_shares_cover_exactly_the_valid_tiles(cluster):
    """The shares of the ranks are contiguous, disjoint, at most ceil(n /
    C) tiles each, and together exactly the row's n valid tiles; ranks past
    the last share get none."""
    plan = {"tile_rows": 32, "width": 32 * 10, "cluster": cluster}
    for length in range(-1, 400):
        n = math.ceil(min(max(length, 0), plan["width"]) / 32)
        shares = [port_attn.decode_rank_tiles(length, plan, r) for r in range(cluster)]
        assert [j for s in shares for j in s] == list(range(n))
        assert all(len(s) <= max(1, math.ceil(n / cluster)) for s in shares)
        if n and n < cluster:
            assert any(len(s) == 0 for s in shares)


def _emulate(q, tile_kv, lengths, plan, scale, cap):
    """What the kernel computes with ``plan``, in plain f32 torch: per (row,
    kv head), each rank's online softmax over its share of the valid tiles
    (``tile_kv(b, kvh, j, valid)`` → the tile's first ``valid`` K and V
    rows, and for an int8 cache their K and V scales), then rank 0's merge.
    int8 rows stay integers: each row's dot is scaled by its K scale times
    1/sqrt(D), and its probability by its V scale in PV (l sums the
    unscaled p), where the kernel does. → [B, H * D]."""
    b_n, h, d = q.shape
    hkv = plan["grid"][0]
    g = h // hkv
    tr = plan["tile_rows"]
    out = torch.zeros((b_n, hkv, g, d))
    for b in range(b_n):
        length = min(max(int(lengths[b]), 0), plan["width"])
        for kvh in range(hkv):
            qg = q[b, kvh * g:(kvh + 1) * g]  # [G, D]
            parts = []
            for rank in range(plan["cluster"]):
                m = torch.full((g,), NEG)
                l = torch.zeros(g)
                acc = torch.zeros((g, d))
                for j in port_attn.decode_rank_tiles(length, plan, rank):
                    valid = min(tr, length - j * tr)
                    kk, vv, *scales = tile_kv(b, kvh, j, valid)
                    s = (qg @ kk.T) * (scales[0] * scale if scales else scale)
                    if cap is not None:
                        s = torch.tanh(s / cap) * cap
                    m_new = torch.maximum(m, s.max(dim=-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * corr + p.sum(dim=-1)
                    acc = acc * corr[:, None] + (p * scales[1] if scales else p) @ vv
                    m = m_new
                parts.append((m, l, acc))
            big_m = torch.stack([p[0] for p in parts]).max(dim=0).values
            w = [torch.exp(p[0] - big_m) for p in parts]
            big_l = sum(wi * p[1] for wi, p in zip(w, parts))
            o = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
            out[b, kvh] = o / big_l.clamp_min(1e-30)[:, None]
    return out.reshape(b_n, h * d)


# lengths 0, 1, tile - 1, tile, tile + 1, page - 1, page, page + 1, the
# dense width, the paged width (past the dense one) and past both; short
# rows leave ranks with no tiles
LENGTHS = np.array([0, 1, 63, 64, 65, 127, 128, 129, 320, 384, 1000], np.int32)
H, HKV, D, T, PS, TP, POOL = 8, 4, 64, 320, 128, 3, 40


def _configs(cap):
    fields = dict(name="k", vocab_size=128, d_model=64, n_layers=1, n_heads=H,
                  n_kv_heads=HKV, d_ff=64, head_dim=D, dtype="float32",
                  attn_logit_softcap=cap)
    return JaxModelConfig(**fields), ModelConfig(**fields)


def _ragged_table(rng):
    """Ragged tables of distinct pages; unmapped entries carry the sentinel
    POOL (clamped to POOL - 1, as both kernels do)."""
    table = np.full((len(LENGTHS), TP), POOL, np.int32)
    perm = rng.permutation(POOL)
    cursor = 0
    for row, n in enumerate(np.minimum(-(-LENGTHS // PS), TP)):
        table[row, :n] = perm[cursor:cursor + n]
        cursor += n
    return table


def _int8_entry(rng, shape):
    """An int8 cache entry as numpy: values in [-127, 127], f32 scales in
    [0.005, 0.015)."""
    return (rng.integers(-127, 128, shape).astype(np.int8),
            (rng.random(shape[:-1]) * 0.01 + 0.005).astype(np.float32))


@pytest.mark.parametrize("cap", [None, 30.0])
def test_dense_partition_matches_pallas(cap):
    rng = np.random.default_rng(11 + (cap is not None))
    b = len(LENGTHS)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    # the JAX side takes the contiguous [..., :T]; the port's plan reads a
    # view of a sink-column cache
    k = rng.standard_normal((b, HKV, T + 1, D)).astype(np.float32)
    v = rng.standard_normal((b, HKV, T + 1, D)).astype(np.float32)
    jcfg, _ = _configs(cap)
    ref = jax_attn.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k[:, :, :T]), jnp.asarray(v[:, :, :T]),
        jnp.asarray(LENGTHS), jcfg, interpret=True,
    )
    kt, vt = torch.from_numpy(k)[:, :, :T], torch.from_numpy(v)[:, :, :T]
    plan = port_attn.decode_launch_plan(
        (b, H, D), tuple(kt.shape), kt.stride(), torch.bfloat16, "dense",
    )
    assert plan["cluster"] == 4 and plan["tile_rows"] == 64
    tr = plan["tile_rows"]

    def tile_kv(b_, kvh, j, valid):
        rows = slice(j * tr, j * tr + valid)
        return kt[b_, kvh, rows], vt[b_, kvh, rows]

    out = _emulate(torch.from_numpy(q), tile_kv, LENGTHS, plan, 1.0 / math.sqrt(D), cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(out.numpy()[0] == 0.0)  # length 0 gives 0


@pytest.mark.parametrize("cap", [None, 30.0])
def test_paged_partition_matches_pallas(cap):
    rng = np.random.default_rng(21 + (cap is not None))
    b = len(LENGTHS)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    k = rng.standard_normal((POOL, HKV, PS, D)).astype(np.float32)
    v = rng.standard_normal((POOL, HKV, PS, D)).astype(np.float32)
    table = _ragged_table(rng)
    jcfg, _ = _configs(cap)
    ref = jax_attn.ragged_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENGTHS),
        jnp.asarray(table), jcfg, PS, interpret=True,
    )
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    plan = port_attn.decode_launch_plan(
        (b, H, D), tuple(kt.shape), kt.stride(), torch.bfloat16, "paged", table_width=TP,
    )
    # pages of 128 rows: two tiles each
    assert plan["cluster"] == 4 and plan["tile_rows"] == 64 and plan["tiles"] == 2 * TP
    tr, spp = plan["tile_rows"], PS // plan["tile_rows"]

    def tile_kv(b_, kvh, j, valid):
        page = min(max(int(table[b_, j // spp]), 0), POOL - 1)
        rows = slice((j % spp) * tr, (j % spp) * tr + valid)
        return kt[page, kvh, rows], vt[page, kvh, rows]

    out = _emulate(torch.from_numpy(q), tile_kv, LENGTHS, plan, 1.0 / math.sqrt(D), cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(out.numpy()[0] == 0.0)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_dense_int8_partition_matches_pallas(cap):
    """The int8 kernel's arithmetic over a [..., :T] view of a sink-column
    cache, whose scale rows are not 16-byte aligned, against the JAX int8
    kernel over the contiguous [..., :T]; NaN scales past every row's
    length leave the emulation's output bit-equal (no tile reads them)."""
    rng = np.random.default_rng(31 + (cap is not None))
    b = len(LENGTHS)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    kq, ks = _int8_entry(rng, (b, HKV, T + 1, D))
    vq, vs = _int8_entry(rng, (b, HKV, T + 1, D))
    jcfg, _ = _configs(cap)
    ref = jax_attn.ragged_decode_attention_int8(
        jnp.asarray(q), {"q": jnp.asarray(kq[:, :, :T]), "s": jnp.asarray(ks[:, :, :T])},
        {"q": jnp.asarray(vq[:, :, :T]), "s": jnp.asarray(vs[:, :, :T])},
        jnp.asarray(LENGTHS), jcfg, interpret=True,
    )
    kt, vt, kst, vst = (torch.from_numpy(a)[:, :, :T] for a in (kq, vq, ks, vs))
    assert (kst.stride(1) * 4) % 16  # scale rows off the 16-byte grid
    plan = port_attn.decode_launch_plan(
        (b, H, D), tuple(kt.shape), kt.stride(), torch.int8, "dense",
        scale_strides=kst.stride(),
    )
    assert plan["cluster"] == 4 and plan["tile_rows"] == 64 and plan["stages"] == INT8_STAGES[D]
    tr = plan["tile_rows"]

    def run(ksc, vsc):
        def tile_kv(b_, kvh, j, valid):
            rows = slice(j * tr, j * tr + valid)
            return (kt[b_, kvh, rows].float(), vt[b_, kvh, rows].float(), ksc[b_, kvh, rows],
                    vsc[b_, kvh, rows])

        return _emulate(torch.from_numpy(q), tile_kv, LENGTHS, plan, 1.0 / math.sqrt(D), cap)

    out = run(kst, vst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(out.numpy()[0] == 0.0)  # length 0 gives 0
    dirty = [a.clone() for a in (kst, vst)]
    for a in dirty:
        for row, n in enumerate(LENGTHS):
            a[row, :, n:] = float("nan")
    assert torch.equal(run(*dirty), out)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_paged_int8_partition_matches_pallas(cap):
    """The int8 kernel's arithmetic over pages of 128 rows (two tiles each)
    through ragged tables with unmapped sentinel entries, against the JAX
    paged int8 kernel."""
    rng = np.random.default_rng(41 + (cap is not None))
    b = len(LENGTHS)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    kq, ks = _int8_entry(rng, (POOL, HKV, PS, D))
    vq, vs = _int8_entry(rng, (POOL, HKV, PS, D))
    table = _ragged_table(rng)
    jcfg, _ = _configs(cap)
    ref = jax_attn.ragged_paged_decode_attention_int8(
        jnp.asarray(q), {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)}, jnp.asarray(LENGTHS),
        jnp.asarray(table), jcfg, PS, interpret=True,
    )
    kt, vt, kst, vst = (torch.from_numpy(a) for a in (kq, vq, ks, vs))
    plan = port_attn.decode_launch_plan(
        (b, H, D), tuple(kt.shape), kt.stride(), torch.int8, "paged", table_width=TP,
        scale_strides=kst.stride(),
    )
    assert plan["cluster"] == 4 and plan["tile_rows"] == 64 and plan["tiles"] == 2 * TP
    tr, spp = plan["tile_rows"], PS // plan["tile_rows"]

    def tile_kv(b_, kvh, j, valid):
        page = min(max(int(table[b_, j // spp]), 0), POOL - 1)
        rows = slice((j % spp) * tr, (j % spp) * tr + valid)
        return (kt[page, kvh, rows].float(), vt[page, kvh, rows].float(), kst[page, kvh, rows],
                vst[page, kvh, rows])

    out = _emulate(torch.from_numpy(q), tile_kv, LENGTHS, plan, 1.0 / math.sqrt(D), cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(out.numpy()[0] == 0.0)
