"""Serving memory accounting: what a (model, batch, context) configuration
costs on the card before it is allocated (port of
``langstream_tpu/serving/memory.py``).

``plan_serving_memory`` adds up the terms the port's engine really
allocates, from tensor shapes (``meta`` tensors, or the loaded tree
itself): the weights; the paged KV pool with its sink page, or the dense
cache with its sink column; the admission group's local cache; on the
dense layout the chunked-prefill streams' local caches; with speculation
the verify chunk's logits; and a flat workspace allowance (activations,
cuBLAS workspace, the captured graphs' pool). The streamed weight load's
host staging peak is host RAM and stays outside the device total.

The JAX plan's XLA-only terms have no counterpart here: the port has no
``kv_bound`` compile ladder on the card (a captured decode chunk reads the
dense cache at full width, the kernels read each row to its length), so
there is no ``bound_slice_bytes``; and the layer loop updates the cache in
place, so there is no ``scan_buffer_bytes``. The prefix pool of the dense
layout, the host KV tier, adapters, grammars, migration and the durable
tier are not ported, so neither are their terms.

``max_context_single_chip`` inverts the plan to the largest power-of-two
context a device budget serves. The engine logs its plan when it is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from langstream_tpu_torch.models.configs import ModelConfig


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a (nested dict) tree, ``meta`` ones too."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@dataclass(frozen=True)
class ServingMemoryPlan:
    weights_bytes: int
    cache_bytes: int  # dense cache: max_batch x (max_seq_len + 1 sink column)
    long_cache_bytes: int  # dense chunked-prefill local caches (one prompt wide each)
    workspace_bytes: int  # activations, cuBLAS workspace, graph pool: a flat allowance
    # an admit group's local cache (prefill_batch rows x the widest
    # bucket), live while the decode state is
    fused_prefill_bytes: int = 0
    # the paged pool ``[L, P + 1, Hkv, page_size, D]`` (the extra page is
    # the write sink); when set, cache and long_cache are 0
    page_pool_bytes: int = 0
    # speculation: the verify's f32 logits for all k + 1 positions of every
    # slot, charged at 5 such buffers (the sampler's filtered peak), as the
    # JAX plan charges them; 0 with speculation off
    verify_chunk_bytes: int = 0
    # the streamed weight load's host staging high-water mark: HOST RAM,
    # transient, outside total_bytes
    weight_load_staging_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return (
            self.weights_bytes
            + self.cache_bytes
            + self.long_cache_bytes
            + self.workspace_bytes
            + self.fused_prefill_bytes
            + self.page_pool_bytes
            + self.verify_chunk_bytes
        )

    def fits(self, device_bytes: int) -> bool:
        return self.total_bytes <= device_bytes

    def summary(self) -> str:
        gib = 1024**3
        kv = (
            f"page-pool {self.page_pool_bytes / gib:.2f}GiB"
            if self.page_pool_bytes
            else f"cache {self.cache_bytes / gib:.2f}GiB + "
            f"long-prefill {self.long_cache_bytes / gib:.2f}GiB"
        )
        staging = (
            f" [+ weight-load staging {self.weight_load_staging_bytes / gib:.2f}GiB RAM, "
            f"transient]"
            if self.weight_load_staging_bytes
            else ""
        )
        return (
            f"weights {self.weights_bytes / gib:.2f}GiB + {kv} + "
            f"fused-prefill {self.fused_prefill_bytes / gib:.2f}GiB + "
            f"verify-chunk {self.verify_chunk_bytes / gib:.2f}GiB + "
            f"workspace {self.workspace_bytes / gib:.2f}GiB = "
            f"{self.total_bytes / gib:.2f}GiB{staging}"
        )


def plan_serving_memory(
    config: ModelConfig,
    max_batch: int,
    max_seq_len: int,
    *,
    params: Optional[Any] = None,
    quantized_weights: bool = False,
    long_prefill: bool = True,
    workspace_bytes: int = 1 << 30,
    prefill_batch: int = 0,
    prefill_bucket: int = 0,
    prefill_streams: int = 1,
    speculation_tokens: int = 0,
    kv_layout: str = "dense",
    page_size: int = 64,
    kv_pages: int = 0,
    page_fraction: float = 0.0,
    weight_load_staging: int = 0,
) -> ServingMemoryPlan:
    """Account a ServingEngine's device memory from tensor shapes; nothing
    is allocated.

    ``params``: the tree the engine serves (its bytes are the weights
    term); without it the tree ``config`` serves, as ``meta`` tensors
    (``quantized_weights``: the int8 tree). ``kv_layout`` "paged": one
    pool of ``kv_pages`` pages (or ``pages_for_fraction(max_batch,
    max_seq_len, page_size, page_fraction)``) plus the sink page; "dense":
    the ``[L, max_batch, Hkv, max_seq_len + 1, D]`` cache and, with
    ``long_prefill``, ``prefill_streams`` one-row local caches of
    ``max_seq_len`` columns. ``prefill_batch`` / ``prefill_bucket``: the
    admit group's local cache (0 omits it). ``speculation_tokens``: k of
    the verify (0: speculation off). ``weight_load_staging``: the streamed
    load's host staging peak, reported outside the total.
    """
    from langstream_tpu_torch.models.loader import expected_params
    from langstream_tpu_torch.models.transformer import make_kv_cache, make_page_pool

    meta = torch.device("meta")
    weights = tree_bytes(params if params is not None else expected_params(
        config, quantized=quantized_weights))
    fused = (
        tree_bytes(make_kv_cache(config, prefill_batch, min(prefill_bucket, max_seq_len),
                                 device=meta))
        if prefill_batch > 0 and prefill_bucket > 0
        else 0
    )
    verify = (
        5 * max_batch * (speculation_tokens + 1) * config.vocab_size * 4
        if speculation_tokens > 0
        else 0
    )
    staging = max(0, int(weight_load_staging))
    if kv_layout == "paged":
        from langstream_tpu_torch.serving.pagepool import pages_for_fraction

        pages = kv_pages or pages_for_fraction(max_batch, max_seq_len, page_size, page_fraction)
        return ServingMemoryPlan(
            weights_bytes=weights,
            cache_bytes=0,
            long_cache_bytes=0,  # paged segments write straight into pages
            workspace_bytes=workspace_bytes,
            fused_prefill_bytes=fused,
            page_pool_bytes=tree_bytes(make_page_pool(config, pages, page_size, device=meta)),
            verify_chunk_bytes=verify,
            weight_load_staging_bytes=staging,
        )
    long_bytes = (
        tree_bytes(make_kv_cache(config, 1, max_seq_len, device=meta)) * max(1, prefill_streams)
        if long_prefill
        else 0
    )
    return ServingMemoryPlan(
        weights_bytes=weights,
        cache_bytes=tree_bytes(make_kv_cache(config, max_batch, max_seq_len + 1, device=meta)),
        long_cache_bytes=long_bytes,
        workspace_bytes=workspace_bytes,
        fused_prefill_bytes=fused,
        verify_chunk_bytes=verify,
        weight_load_staging_bytes=staging,
    )


def max_context_single_chip(
    config: ModelConfig,
    max_batch: int,
    device_bytes: int,
    *,
    quantized_weights: bool = True,
    ceiling: int = 1 << 20,
) -> int:
    """Largest power-of-two max_seq_len (from 1k) the budget serves on the
    dense layout, or 0."""
    best = 0
    width = 1024
    while width <= min(ceiling, config.max_seq_len):
        plan = plan_serving_memory(config, max_batch, width, quantized_weights=quantized_weights)
        if not plan.fits(device_bytes):
            break
        best = width
        width *= 2
    return best
