"""The bf16 decode kernel's launch plan and its partition of a row's tiles.

``decode_launch_plan`` (pure: shapes, strides, dtypes, bases) for the paged
and dense layouts, and a plain-torch emulation of what the kernel computes
with that plan — each cluster rank's share of a row's valid tiles, its
partial (m, l, acc), then rank 0's merge with weights exp(m_r - M) — held
against the JAX package's ``ragged_decode_attention`` and
``ragged_paged_decode_attention`` in interpret mode, on the same numpy
inputs. f32 on both sides, summed in different orders: agreement to ~1e-6,
held to 1e-5.
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
    tiles of 64 rows (a page of 64, or half a page of 128), a cluster of 8
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
    assert plan["cluster"] == 8 and plan["grid"] == (hkv, 3, 8)
    assert plan["tiles_per_rank"] == math.ceil(plan["tiles"] / 8)
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
    assert plan["cluster"] == 5 and plan["grid"] == (hkv, 2, 5)
    assert plan["smem_bytes"] <= port_attn.SMEM_PER_CTA
    # a short cache: fewer tiles than the portable cluster size
    short = port_attn.decode_launch_plan(
        (2, hkv * group, d), (2, hkv, 70, d), _contiguous_strides((2, hkv, 70, d)),
        torch.bfloat16, "dense",
    )
    assert short["tiles"] == 2 and short["cluster"] == 2 and short["grid"] == (hkv, 2, 2)
    wide = port_attn.decode_launch_plan(
        (2, hkv * group, d), (2, hkv, 2048, d), (hkv * 8193 * d, 8193 * d, d, 1),
        torch.bfloat16, "dense",
    )
    assert wide["tiles"] == 32 and wide["cluster"] == 8 and wide["tiles_per_rank"] == 4


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
    "int8_cache": dict(_DENSE, kv_dtype=torch.int8),
    "float16_cache": dict(_DENSE, kv_dtype=torch.float16),
    "no_table": dict(_PAGED, table_width=0),
    "batches_differ": dict(_DENSE, q_shape=(3, 8, 64)),
    "unknown_layout": dict(_DENSE, layout="ring"),
    "pages_too_big": dict(_PAGED, q_shape=(2, 16, 256), kv_shape=(10, 2, 1024, 256),
                          kv_strides=_contiguous_strides((10, 2, 1024, 256))),
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
    rows), then rank 0's merge. → [B, H * D]."""
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
                    kk, vv = tile_kv(b, kvh, j, valid)
                    s = (qg @ kk.T) * scale
                    if cap is not None:
                        s = torch.tanh(s / cap) * cap
                    m_new = torch.maximum(m, s.max(dim=-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * corr + p.sum(dim=-1)
                    acc = acc * corr[:, None] + p @ vv
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
    assert plan["cluster"] == 5 and plan["tile_rows"] == 64
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
    # ragged tables of distinct pages; unmapped entries carry the sentinel
    # POOL (clamped to POOL - 1, as both kernels do)
    table = np.full((b, TP), POOL, np.int32)
    perm = rng.permutation(POOL)
    cursor = 0
    for row, n in enumerate(np.minimum(-(-LENGTHS // PS), TP)):
        table[row, :n] = perm[cursor:cursor + n]
        cursor += n
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
    assert plan["cluster"] == 6 and plan["tile_rows"] == 64 and plan["tiles"] == 2 * TP
    tr, spp = plan["tile_rows"], PS // plan["tile_rows"]

    def tile_kv(b_, kvh, j, valid):
        page = min(max(int(table[b_, j // spp]), 0), POOL - 1)
        rows = slice((j % spp) * tr, (j % spp) * tr + valid)
        return kt[page, kvh, rows], vt[page, kvh, rows]

    out = _emulate(torch.from_numpy(q), tile_kv, LENGTHS, plan, 1.0 / math.sqrt(D), cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(out.numpy()[0] == 0.0)
