"""Serving memory accounting: what a (model, batch, context) configuration
costs on the card before it is allocated (port of
``langstream_tpu/serving/memory.py``).

``plan_serving_memory`` adds up the terms the port's engine really
allocates, from tensor shapes (``meta`` tensors, or the loaded tree
itself): the weights; the paged KV pool with its sink page, or the dense
cache with its sink column; the admission group's local cache; on the
dense layout the chunked-prefill streams' local caches; with speculation
the verify chunk's logits; the captured graphs' pool, one term per graph
set ``start()`` captures (the decode chunk, the verify, or both); with
int8 weights the eager path's widened weights; the agentic tier's two
pools (the multi-LoRA adapter pool, the packed grammar pool); on the
dense layout with prefix reuse the prefix pool; and a flat workspace
allowance (activations, cuBLAS workspace). The streamed weight load's
host staging peak, the host KV tier's arena (host RAM) and the durable
tier's disk cap are reported and stay outside the device total.

On a rank of a tensor-parallel replica the engine plans with the rank's
shapes (``parallel.sharding.local_config``) and tree: the plan is that
rank's peak — its weight slices, its kv heads' pool and arena, its slice
of the adapter pool and the whole grammar pool (replicated: every rank
masks the gathered vocabulary).

int8 weights are widened to the model dtype at every matmul
(``models/quant.quantized_matmul``: the int8 codes to f32, times the
scales, then the model dtype). Inside a captured chunk those temporaries
live in the graph pool, and the pool keeps the largest of them: two f32
copies of the LM head's weight at once, beside the segments of the
largest layer weight's two f32 copies and its model-dtype copy. That is
``widened_weight_bytes``; each captured set is charged it, and the eager
admissions (outside any graph) are charged it once more.

The JAX plan's XLA-only terms have no counterpart here: the port has no
``kv_bound`` compile ladder on the card (a captured decode chunk reads the
dense cache at full width, the kernels read each row to its length), so
there is no ``bound_slice_bytes``; and the layer loop updates the cache in
place, so there is no ``scan_buffer_bytes``. A KV-page migration's staging
(``migrate_staging_bytes``) is pinned host RAM, reported outside the total,
as JAX reports it.

``max_context_single_chip`` inverts the plan to the largest power-of-two
context a device budget serves. The engine logs its plan when it is built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from langstream_tpu_torch.models.configs import ModelConfig

# what one captured set keeps in the graph pool for each (row, vocab
# entry) of its logits: the filtered sampling branch's sort (values and
# int64 indices), softmax, cumulative sum and their copies. chip_smoke.py's
# tenancy phase read 67-71 bytes on an H100 (llama-3-8b: 69.2 MB for the
# decode set's 8 rows, 362.8 MB for the verify set's 40); charged at 80
GRAPH_BYTES_PER_LOGIT = 80


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
    workspace_bytes: int  # activations and cuBLAS workspace: a flat allowance
    # an admit group's local cache (prefill_batch rows x the widest
    # bucket), live while the decode state is
    fused_prefill_bytes: int = 0
    # the paged pool ``[L, P + 1, Hkv, page_size, D]`` (the extra page is
    # the write sink); when set, cache and long_cache are 0
    page_pool_bytes: int = 0
    # the dense layout's prefix pool (serving/prefix_cache.py): entries + 1
    # rows (the sink row) of the widest bucket's columns, resident for the
    # engine's lifetime; 0 with reuse off or on the paged layout, whose
    # one page pool holds the shared prefixes
    prefix_pool_bytes: int = 0
    # speculation: the verify's f32 logits for all k + 1 positions of every
    # slot, charged at 5 such buffers (the sampler's filtered peak), as the
    # JAX plan charges them; 0 with speculation off
    verify_chunk_bytes: int = 0
    # the streamed weight load's host staging high-water mark: HOST RAM,
    # transient, outside total_bytes
    weight_load_staging_bytes: int = 0
    # the captured graphs' shared pool, one term per graph set: its rows'
    # sampling temporaries (GRAPH_BYTES_PER_LOGIT a row and vocab entry;
    # the verify set's less the verify-chunk term, which is in the same
    # pool) and, with int8 weights, the widened weights its captures keep
    graph_pool_bytes: int = 0
    graph_sets: tuple[str, ...] = ()
    # int8 weights: the eager admissions' widened weights, held by the
    # caching allocator outside the graph pool
    eager_widened_bytes: int = 0
    # the multi-LoRA adapter pool (serving/adapters.py): rows x per-row
    # factor bytes + the f32 scales, for the engine's lifetime; 0 without
    # adapters
    adapter_pool_bytes: int = 0
    # the packed grammar pool (serving/constrain.py): bits [G+1, S,
    # ceil(V/32)] + defaults [G+1, S] + exception key / next [G+1, E],
    # int32; 0 with constrained decoding off
    grammar_pool_bytes: int = 0
    # the host KV tier's arena (serving/pagepool.HostPageTier): ceil(pages
    # x host-kv-fraction) slots of the pool's page bytes, pinned HOST RAM —
    # reported, outside total_bytes; 0 with the tier off
    host_spill_bytes: int = 0
    # the durable tier's configured disk cap (durable-max-bytes): disk,
    # reported, outside total_bytes; 0 with the tier off or uncapped
    durable_disk_bytes: int = 0
    # the host-RAM staging of one in-flight KV-page migration (one slot's
    # worst-case page set, on each end): host RAM, reported, outside
    # total_bytes; 0 unless the engine was built with ``migrate_staging``
    migrate_staging_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return (
            self.weights_bytes
            + self.cache_bytes
            + self.long_cache_bytes
            + self.workspace_bytes
            + self.fused_prefill_bytes
            + self.page_pool_bytes
            + self.prefix_pool_bytes
            + self.verify_chunk_bytes
            + self.graph_pool_bytes
            + self.eager_widened_bytes
            + self.adapter_pool_bytes
            + self.grammar_pool_bytes
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
        if self.host_spill_bytes:
            staging += f" [+ host KV tier {self.host_spill_bytes / gib:.2f}GiB RAM]"
        if self.migrate_staging_bytes:
            staging += f" [+ migrate staging {self.migrate_staging_bytes / gib:.2f}GiB RAM]"
        if self.durable_disk_bytes:
            staging += f" [+ durable KV tier ≤{self.durable_disk_bytes / gib:.2f}GiB disk]"
        agentic = "".join(
            f"{name} {n / gib:.2f}GiB + "
            for name, n in (("adapter-pool", self.adapter_pool_bytes),
                            ("grammar-pool", self.grammar_pool_bytes))
            if n
        )
        return (
            f"weights {self.weights_bytes / gib:.2f}GiB + {kv} + {agentic}"
            f"fused-prefill {self.fused_prefill_bytes / gib:.2f}GiB + "
            f"prefix-pool {self.prefix_pool_bytes / gib:.2f}GiB + "
            f"verify-chunk {self.verify_chunk_bytes / gib:.2f}GiB + "
            f"graph-pool ({'+'.join(self.graph_sets) or 'none'}) "
            f"{self.graph_pool_bytes / gib:.2f}GiB + "
            f"eager-widened {self.eager_widened_bytes / gib:.2f}GiB + "
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
    prefix_pool_entries: int = 0,
    prefix_pool_width: int = 0,
    speculation_tokens: int = 0,
    kv_layout: str = "dense",
    page_size: int = 64,
    kv_pages: int = 0,
    page_fraction: float = 0.0,
    weight_load_staging: int = 0,
    graph_sets: tuple[str, ...] = (),
    adapter_pool_rows: int = 0,
    adapter_rank: int = 0,
    grammar_slots: int = 0,
    grammar_states: int = 0,
    grammar_exceptions: int = 65536,
    host_kv_fraction: float = 0.0,
    durable_max_bytes: int = 0,
    migrate_staging: bool = False,
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
    admit group's local cache (0 omits it). ``prefix_pool_entries`` /
    ``prefix_pool_width``: the dense layout's prefix pool (0 omits it; the
    paged layout's prefixes live in its page pool). ``speculation_tokens``: k of
    the verify (0: speculation off). ``weight_load_staging``: the streamed
    load's host staging peak, reported outside the total. ``graph_sets``:
    the sets of captured graphs (``"decode"``, ``"verify"``; empty: none
    captured, as on the CPU), one graph-pool term each; int8 weights (a
    quantized ``params`` tree, or ``quantized_weights``) add the widened
    weights to each set and once to the eager path.
    ``adapter_pool_rows`` / ``adapter_rank``: the adapter pool's shape (0
    omits the term); ``grammar_slots`` / ``grammar_states`` /
    ``grammar_exceptions``: the grammar pool's (``grammar_slots`` 0 omits
    it). ``host_kv_fraction``: the host KV tier's arena relative to the
    pool (paged only; host RAM, reported: the tier's page copies are DMA
    between the pool and the arena, with no device temporaries).
    ``durable_max_bytes``: the durable tier's disk cap (reported).
    ``migrate_staging``: a role-tagged replica's host staging of one
    in-flight KV-page migration, ``table_len_for(max_seq_len, page_size)``
    pages (paged only; host RAM, reported).
    """
    from langstream_tpu_torch.models.loader import expected_params
    from langstream_tpu_torch.models.transformer import make_kv_cache, make_page_pool

    meta = torch.device("meta")
    tree = params if params is not None else expected_params(config, quantized=quantized_weights)
    weights = tree_bytes(tree)
    widened = widened_weight_bytes(tree, config)
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
    logit_bytes = GRAPH_BYTES_PER_LOGIT * config.vocab_size
    per_set = {
        "decode": logit_bytes * max_batch + widened,
        "verify": max(0, logit_bytes * max_batch * (speculation_tokens + 1) - verify) + widened,
    }
    graph_pool = sum(per_set[k] for k in graph_sets)
    from langstream_tpu_torch.serving.adapters import lora_pool_bytes
    from langstream_tpu_torch.serving.constrain import grammar_pool_bytes

    extra = dict(
        graph_pool_bytes=graph_pool, graph_sets=tuple(graph_sets), eager_widened_bytes=widened,
        adapter_pool_bytes=lora_pool_bytes(config, adapter_pool_rows, adapter_rank),
        grammar_pool_bytes=(
            grammar_pool_bytes(grammar_slots, grammar_states, config.vocab_size,
                               grammar_exceptions)
            if grammar_states > 0 else 0
        ),
    )
    staging = max(0, int(weight_load_staging))
    if kv_layout == "paged":
        from langstream_tpu_torch.serving.pagepool import pages_for_fraction, table_len_for

        pages = kv_pages or pages_for_fraction(max_batch, max_seq_len, page_size, page_fraction)
        pool_bytes = tree_bytes(make_page_pool(config, pages, page_size, device=meta))
        page_bytes = pool_bytes // (pages + 1)  # the sink page included
        tiered = host_kv_fraction > 0
        return ServingMemoryPlan(
            weights_bytes=weights,
            cache_bytes=0,
            long_cache_bytes=0,  # paged segments write straight into pages
            workspace_bytes=workspace_bytes,
            fused_prefill_bytes=fused,
            page_pool_bytes=pool_bytes,
            verify_chunk_bytes=verify,
            weight_load_staging_bytes=staging,
            host_spill_bytes=math.ceil(pages * host_kv_fraction) * page_bytes if tiered else 0,
            durable_disk_bytes=max(0, int(durable_max_bytes)),
            migrate_staging_bytes=(
                table_len_for(max_seq_len, page_size) * page_bytes if migrate_staging else 0
            ),
            **extra,
        )
    long_bytes = (
        tree_bytes(make_kv_cache(config, 1, max_seq_len, device=meta)) * max(1, prefill_streams)
        if long_prefill
        else 0
    )
    prefix = 0
    if prefix_pool_entries > 0 and prefix_pool_width > 0:
        from langstream_tpu_torch.ops.kvcopy import make_prefix_pool

        prefix = tree_bytes(
            make_prefix_pool(config, prefix_pool_entries, prefix_pool_width, device=meta)
        )
    return ServingMemoryPlan(
        weights_bytes=weights,
        cache_bytes=tree_bytes(make_kv_cache(config, max_batch, max_seq_len + 1, device=meta)),
        prefix_pool_bytes=prefix,
        long_cache_bytes=long_bytes,
        workspace_bytes=workspace_bytes,
        fused_prefill_bytes=fused,
        verify_chunk_bytes=verify,
        weight_load_staging_bytes=staging,
        durable_disk_bytes=max(0, int(durable_max_bytes)),
        **extra,
    )


def widened_weight_bytes(params: Any, config: ModelConfig) -> int:
    """What widening int8 weights to the model dtype keeps on the card (0
    for a tree in the model dtype): two f32 copies of the LM head's weight
    (or of the tied row-quantized embedding) at once, plus two f32 copies
    and one model-dtype copy of the largest layer weight (an MoE layer's
    weight counts all its experts, as ``moe_ffn`` widens them together)."""
    from langstream_tpu_torch.models.bridge import torch_dtype
    from langstream_tpu_torch.models.quant import is_quantized

    layers = params["layers"]
    quantized = [v for v in layers.values() if is_quantized(v)]
    head = params.get("lm_head", params["embed"] if config.tie_embeddings else None)
    if not quantized and not is_quantized(head):
        return 0
    itemsize = torch.empty((), dtype=torch_dtype(config.dtype), device="meta").element_size()
    layer = max((v["q"][0].numel() for v in quantized), default=0)
    head_n = head["q"].numel() if is_quantized(head) else 0
    return 2 * 4 * head_n + (2 * 4 + itemsize) * layer


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
