"""KV row copies between the dense serving cache and the prefix pool — the
port of ``langstream_tpu/ops/kvcopy.py``.

Both helpers move whole cache rows between the big dense cache ``[L, B,
Hkv, T, D]`` (model dtype, or the int8 ``{"q", "s"}`` dict of
``models/transformer.make_kv_cache``) and the prefix pool, which uses the
same layout with B = pool entries and T = the widest prefill bucket
(``serving/prefix_cache.PrefixCachePool``). Both directions copy ``min(src_T,
dst_T)`` columns: columns past a cached prefix's true length carry garbage
by design, and the serving mask invariant (no column past the written
frontier is read until it is overwritten) makes masking the copy waste.

Differences from the JAX package: the copies are in place (``copy_`` on
row views; the JAX helpers donate the pool), and JAX's ``mode="drop"``
for an out-of-range pool row is the pool's SINK ROW: the pool carries one
extra row at index ``entries`` (``prefix_pool_rows``), and an out-of-range
entry row writes there — clamped, never raised. A source row index
clamps into range as ``lax.dynamic_index_in_dim`` clamps it.
"""

from __future__ import annotations

from langstream_tpu_torch.device import DeviceLike
from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.models.transformer import KVCache, make_kv_cache


def _leaf_pairs(a: KVCache, b: KVCache) -> list:
    """(a leaf, b leaf) for K and V (an int8 cache's codes and scales)."""
    pairs = []
    for name in ("k", "v"):
        if isinstance(a[name], dict):
            pairs += [(a[name][leaf], b[name][leaf]) for leaf in ("q", "s")]
        else:
            pairs.append((a[name], b[name]))
    return pairs


def _leading(cache: KVCache) -> int:
    leaf = cache["k"]
    return (leaf["q"] if isinstance(leaf, dict) else leaf).shape[1]


def prefix_pool_rows(pool: KVCache) -> int:
    """Real rows of a prefix pool (the index of its sink row)."""
    return _leading(pool) - 1


def make_prefix_pool(config: ModelConfig, entries: int, width: int,
                     device: DeviceLike = "cuda") -> KVCache:
    """The pool ``[L, entries + 1, Hkv, width, D]`` (int8: with its scales);
    row ``entries`` is the sink row that takes out-of-range writes."""
    return make_kv_cache(config, entries + 1, width, device=device)


def publish_prefix_rows(pool: KVCache, cache: KVCache, slot: int, entry_row: int) -> KVCache:
    """Copy big-cache row ``slot`` (its first pool-width columns) into pool
    row ``entry_row``, in place, every leaf; an ``entry_row`` out of range
    writes the sink row (the JAX package's dropped write)."""
    slot = min(max(int(slot), 0), _leading(cache) - 1)
    rows = prefix_pool_rows(pool)
    entry_row = int(entry_row)
    row = entry_row if 0 <= entry_row < rows else rows
    for dst, src in _leaf_pairs(pool, cache):
        w = min(dst.shape[3], src.shape[3])
        dst[:, row, :, :w].copy_(src[:, slot, :, :w])
    return pool


def gather_prefix_local(pool: KVCache, entry_row: int, config: ModelConfig, width: int,
                        device: DeviceLike = "cuda") -> KVCache:
    """A batch-1 local cache of ``width`` columns whose first ``min(width,
    pool_T)`` columns are pool row ``entry_row`` (clamped into the real
    rows) and the rest the cache's zero init: the seed a warm admission's
    suffix segment then extends in place."""
    local = make_kv_cache(config, 1, width, device=device)
    row = min(max(int(entry_row), 0), prefix_pool_rows(pool) - 1)
    for dst, src in _leaf_pairs(local, pool):
        w = min(dst.shape[3], src.shape[3])
        dst[:, 0, :, :w].copy_(src[:, row, :, :w])
    return local
