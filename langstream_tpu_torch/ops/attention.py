"""Attention kernels of the port (answers to ``langstream_tpu/ops/attention.py``).

Seven kernels, each a hand-written CUDA C++ kernel for Hopper
(``csrc/*.cu``, built by ``_build``) with a plain PyTorch version beside it:

- ``flash_segment_attention`` / ``flash_segment_attention_int8``: a
  chunked-prefill segment at a per-row global offset against the dense
  cache prefix plus its own lower triangle, over a model-dtype or an int8
  cache (``csrc/flash_segment.cu``; replaces ``_segment_kernel`` /
  ``_segment_int8_kernel``);
- ``flash_prefill_attention``: causal GQA prefill attention, the same
  kernel at offset 0 over the prompt's own K/V (replaces the Pallas
  ``_prefill_kernel``);
- ``ragged_decode_attention`` / ``ragged_decode_attention_int8``: one query
  per row against a dense head-major cache (``csrc/ragged_decode.cu``;
  replaces ``_decode_kernel`` / ``_decode_int8_kernel``); several query
  rows may share a cache row (``queries_per_row``: a verify's k + 1
  queries, routed by ``multitoken_verify_attention``);
- ``ragged_paged_decode_attention`` / ``ragged_paged_decode_attention_int8``:
  one query per row against the page pool through a page table
  (``csrc/ragged_decode.cu``; replaces ``_paged_decode_kernel`` /
  ``_paged_decode_int8_kernel``).

``fused_segment_decode_attention`` routes a mixed batch of prefill
segments and decode rows over one cache to those kernels and the
reference read, as the JAX package's does; nothing serves through it.

A wrapper takes its plain version only because the tensor it was given lies
on the CPU; on a CUDA tensor it launches the kernel or raises — there is no
fallback. Each wrapper counts its kernel launches in a plain int attribute
(``wrapper.launches``, bumped only where the kernel is launched) and its
plain-version calls on the CPU (``wrapper.cpu_calls``). A CUDA graph runs
no host code when it is replayed, so the engine takes each graph's
per-kernel counts at capture (``count_snapshot`` before and after), removes
them from the totals (the capture itself launched nothing on the card) and
adds them back on every replay (``add_counts``): the counts stay exactly
the launches the card ran.

Layouts are the JAX package's: queries ``[B, S, H, D]``, head-major K/V
``[B, Hkv, S, D]``, dense caches ``[B, Hkv, T, D]`` (int8: ``{"q": i8
[B, Hkv, T, D], "s": f32 [B, Hkv, T]}``), page-pool entries ``[P, Hkv,
page_size, D]`` (int8 likewise). A dense cache may be a ``[..., :T]`` view
of a wider one: the kernels read it in place through its strides.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Callable, Optional, Union

import torch

from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.ops import _build

_NEG = -1e30

# launches and plain-version calls per kernel wrapper; several engines of
# one process (a fleet of in-process replicas) count from their own
# threads, so every update holds this lock
_COUNT_LOCK = threading.Lock()


def _count(fn: Callable, field: str) -> None:
    with _COUNT_LOCK:
        setattr(fn, field, getattr(fn, field) + 1)
# head dims and query heads per kv head the CUDA kernels are built for
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_GROUPS = (1, 2, 4, 8)
CacheEntry = Union[torch.Tensor, dict]


def kernel_path_ok(config: ModelConfig, device: torch.device) -> bool:
    """The dispatch gate that replaces ``pallas_ok`` / ``paged_pallas_ok``
    for prompt attention and single-token paged decode alike.
    ``"jnp"`` takes the gathered reference ``attention``. ``"auto"`` and
    ``"pallas"`` take the kernel path: the kernel's plain version on the
    CPU, and on the card the CUDA kernel at ANY prompt length (the TPU's
    128-multiple tiling rule does not apply) — which needs compute
    capability >= 9.0, a head dim the kernels are built for and a bf16
    model (the kernels take bf16 activations only). A card or a config
    that cannot take the kernel raises instead of quietly running the
    reference path; ask for ``attention_impl="jnp"`` to run it there. The
    engine and the provider ask once when they are built, so such a
    config is refused before any request. Every layer of every step asks
    too, so the answer is decided once per (config fields, device) and
    cached."""
    return _kernel_gate(
        config.attention_impl, config.resolved_head_dim, config.n_heads,
        config.n_kv_heads, str(config.dtype), torch.device(device),
    )


@functools.lru_cache(maxsize=None)
def _kernel_gate(
    impl: str, head_dim: int, h: int, hkv: int, dtype: str, device: torch.device
) -> bool:
    if impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown attention_impl {impl!r}; supported: auto, pallas, jnp")
    if impl == "jnp":
        return False
    if device.type == "cpu":
        return True
    what = f"attention_impl={impl!r}"
    if dtype != "bfloat16":
        raise ValueError(
            f"{what}: the CUDA kernels take bfloat16 models, this config's dtype is "
            f"{dtype!r}; serve it with attention_impl=\"jnp\" (the reference attention) "
            "or in bfloat16"
        )
    _require_cuda_kernel(device, head_dim, what)
    _require_group(h, hkv, what)
    return True


# The two requirements below are checked on every launch; they are cached
# (a raise is not) so the capability query runs once per device.
@functools.lru_cache(maxsize=None)
def _require_cuda_kernel(device: torch.device, head_dim: int, what: str) -> None:
    """A CUDA tensor goes to the kernel or raises: sm_90+ and a head dim the
    kernels are instantiated for."""
    if device.type != "cuda":
        raise ValueError(f"{what}: tensors on {device} are not supported")
    cap = torch.cuda.get_device_capability(device)
    if cap < (9, 0):
        raise RuntimeError(f"{what}: the CUDA kernels need compute capability >= 9.0, got {cap}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {head_dim} not in {KERNEL_HEAD_DIMS}")


@functools.lru_cache(maxsize=None)
def _require_group(h: int, hkv: int, what: str) -> None:
    if h % hkv or h // hkv not in KERNEL_GROUPS:
        raise ValueError(f"{what}: {h} query heads over {hkv} kv heads; groups {KERNEL_GROUPS}")


def _check(t: torch.Tensor, name: str, dtypes: tuple, device: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rows(t: torch.Tensor, name: str, dtypes: tuple, device: torch.device) -> None:
    """A cache leaf the kernels read through its strides: rows of its last
    dimension contiguous (``[..., T, D]`` with T stride D; scales ``[..., T]``
    with T stride 1), every other stride a whole number of rows, 16-byte
    aligned — a ``[..., :T]`` view of a contiguous cache qualifies."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    row = t.shape[-1] if t.dim() == 4 else 1
    inner = (t.stride(-1), t.stride(-2)) if t.dim() == 4 else (t.stride(-1), 1)
    if inner != (1, row) or t.stride(0) % row or t.stride(1) % row:
        raise ValueError(f"{name}: strides {t.stride()} do not keep rows contiguous")
    if t.dim() == 4 and t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _check_cache(k: CacheEntry, v: CacheEntry, device: torch.device, what: str) -> tuple:
    """Validate a dense cache pair (tensors, or int8 dicts with scales) for
    the kernels that read it through its strides → (k, v, k scales, v
    scales, scale strides (batch, kv head)); the scales are None and their
    strides 0 for a model-dtype cache."""
    quant = isinstance(k, dict)
    kq, vq = (k["q"], v["q"]) if quant else (k, v)
    kv_types = (torch.int8,) if quant else (torch.bfloat16,)
    _check_rows(kq, "k", kv_types, device)
    _check_rows(vq, "v", kv_types, device)
    if vq.shape != kq.shape or vq.stride() != kq.stride():
        raise ValueError(f"{what}: k {tuple(kq.shape)} and v {tuple(vq.shape)} differ in layout")
    if not quant:
        return kq, vq, None, None, (0, 0)
    ks, vs = k["s"], v["s"]
    _check_rows(ks, "k scales", (torch.float32,), device)
    _check_rows(vs, "v scales", (torch.float32,), device)
    if ks.shape != kq.shape[:-1] or vs.shape != ks.shape or vs.stride() != ks.stride():
        raise ValueError(f"{what}: scales {tuple(ks.shape)} vs cache {tuple(kq.shape)}")
    return kq, vq, ks, vs, (ks.stride(0), ks.stride(1))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Prefill: causal flash attention
# ---------------------------------------------------------------------------


def _flash_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Hkv, T, D] head-major, model dtype
    v: torch.Tensor,
    offset: torch.Tensor,  # [B] global position of query 0
    config: ModelConfig,
) -> torch.Tensor:
    """The math of the prefill and segment kernels → [B, S, H*D]: f32
    scores of the model-dtype operands, key k visible to query i of row b
    iff k <= offset[b] + i, the -1e30 mask, f32 softmax statistics, p
    rounded to v's dtype before PV (l sums the unrounded p), l clamped to
    1e-30 so a row that sees no key gives 0."""
    b, s, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, s, hkv, group, d).permute(0, 2, 3, 1, 4).float()  # [B,Hkv,G,S,D]
    scores = torch.matmul(qg, k.float().transpose(-1, -2)[:, :, None]) * (1.0 / math.sqrt(d))
    scores = softcap(scores, config.attn_logit_softcap)
    qpos = offset.long()[:, None] + torch.arange(s, device=q.device)[None, :]  # [B, S]
    visible = torch.arange(t, device=q.device)[None, None, :] <= qpos[:, :, None]  # [B, S, T]
    scores = torch.where(visible[:, None, None], scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(scores <= _NEG, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.matmul(p.to(v.dtype).float(), v.float()[:, :, None])  # [B,Hkv,G,S,D]
    out = (pv / l).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h * d)


def flash_prefill_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Hkv, S, D] head-major
    v: torch.Tensor,
    config: ModelConfig,
) -> torch.Tensor:
    """Plain version of the prefill kernel → [B, S, H*D]: the segment math
    at offset 0 over the prompt's own S keys (causal)."""
    offset = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    return _flash_reference(q, k, v, offset, config)


def flash_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Hkv, S, D] head-major
    v: torch.Tensor,
    config: ModelConfig,
) -> torch.Tensor:
    """Causal GQA attention → [B, S, H*D]; on a CUDA tensor (bf16) the
    segment kernel at offset 0 with the prompt's own K/V as its cache, the
    plain version on a CPU tensor."""
    b, s, h, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if q.device.type == "cpu":
        _count(flash_prefill_attention, "cpu_calls")
        return flash_prefill_reference(q, k, v, config)
    out = _segment_launch(q, k, v, None, config, "flash_prefill")
    _count(flash_prefill_attention, "launches")
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.cpu_calls = 0


# ---------------------------------------------------------------------------
# Chunked-prefill segment: queries at a per-row global offset against the
# dense cache prefix plus their own lower triangle
# ---------------------------------------------------------------------------


def _dequantize(entry: CacheEntry, dtype: torch.dtype) -> torch.Tensor:
    """An int8 cache entry dequantized as the int8 segment kernel does:
    (float(q) * s) rounded to ``dtype``; a tensor passes through."""
    if isinstance(entry, dict):
        return (entry["q"].float() * entry["s"][..., None]).to(dtype)
    return entry


def flash_segment_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, Hkv, T, D] cache
    v: torch.Tensor,
    offset: torch.Tensor,  # [B]
    config: ModelConfig,
) -> torch.Tensor:
    """Plain version of the segment kernel → [B, S, H*D]."""
    return _flash_reference(q, k, v, offset, config)


def flash_segment_int8_reference(
    q: torch.Tensor,  # [B, S, H, D]
    k: dict,  # {"q": i8 [B, Hkv, T, D], "s": f32 [B, Hkv, T]}
    v: dict,
    offset: torch.Tensor,  # [B]
    config: ModelConfig,
) -> torch.Tensor:
    """Plain version of the int8 segment kernel → [B, S, H*D]: K/V are
    dequantized to the MODEL dtype (q's) before the dots, as on the TPU."""
    return _flash_reference(q, _dequantize(k, q.dtype), _dequantize(v, q.dtype), offset, config)


# The segment kernel's launch (csrc/flash_segment.cu, which computes the
# same plan again on the host): work items of 128 (query position, head)
# rows of one kv-head group, a persistent grid of at most one CTA per SM,
# each of two consumer warpgroups and a producer.
SEGMENT_ROWS = 128
SEGMENT_THREADS = 384
H100_SMS = 132
_SWIZZLE_ATOM = 64  # bf16 columns of one 128-byte swizzle row
_TMA_MAX_DIM = 2**32
_TMA_MAX_STRIDE = 2**40


def segment_launch_plan(
    q_shape: tuple, kv_shape: tuple, kv_strides: tuple, kv_dtype: torch.dtype,
    kv_ptr: int = 0, q_ptr: int = 0, scale_strides: Optional[tuple] = None,
) -> dict:
    """The launch of the segment kernel for these shapes, element strides,
    dtypes and base addresses → {"work_items" (query tiles, kv heads,
    batch rows), "grid" (CTAs on an H100: one per SM, or one per item
    where there are fewer; the kernel asks the card), "threads",
    "positions_per_item", "keys_per_tile", "tma": {q, k, v: {"dims",
    "strides", "box", "swizzle"}} (innermost dim first, byte strides of
    dims 1..3, swizzle in bytes or 0), "plain_loads" (tensors the producer
    reads without TMA: the int8 scales, whose rows — 8,193 floats in a
    sink-column cache — need not be 16-byte multiples), "smem_bytes"}.
    Raises ValueError for what the kernel cannot take: a
    head dim, group or dtype it is not built for, K/V rows that are not
    contiguous, or a K/V byte stride or base address that is not a
    multiple of 16 (TMA's rule)."""
    b, s, h, d = q_shape
    kb, hkv, t, kd = kv_shape
    if kd != d or kb != b or hkv <= 0 or h % hkv or s <= 0 or t <= 0:
        raise ValueError(f"segment kernel: q {tuple(q_shape)} vs cache {tuple(kv_shape)}")
    g = h // hkv
    if d not in KERNEL_HEAD_DIMS or g not in KERNEL_GROUPS:
        raise ValueError(f"segment kernel: head dim {d} / group {g}; built for "
                         f"{KERNEL_HEAD_DIMS} / {KERNEL_GROUPS}")
    if kv_dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"segment kernel: cache dtype {kv_dtype}")
    int8 = kv_dtype == torch.int8
    item = 1 if int8 else 2
    sb, sh, st, sd = kv_strides
    if (sd, st) != (1, d):
        raise ValueError(f"segment kernel: cache strides {tuple(kv_strides)} do not keep "
                         f"rows of {d} contiguous")
    kv_bytes = (d * item, sh * item, sb * item)
    if any(x % 16 or not 0 < x < _TMA_MAX_STRIDE for x in kv_bytes) or kv_ptr % 16:
        raise ValueError(f"segment kernel: cache byte strides {kv_bytes} and base "
                         f"{kv_ptr:#x} must be positive multiples of 16 (TMA)")
    if q_ptr % 16:
        raise ValueError(f"segment kernel: q base {q_ptr:#x} is not 16-byte aligned")
    if max(t, s, h, b) >= _TMA_MAX_DIM:
        raise ValueError("segment kernel: a dimension past TMA's 2^32")
    if int8 and (scale_strides is None or scale_strides[-1] != 1):
        raise ValueError(f"segment kernel: int8 scales need rows of stride 1, "
                         f"got {scale_strides}")
    p = SEGMENT_ROWS // g
    # keys per tile, and the depth of the bf16 ring and of the int8 TMA
    # ring (flash_segment.cu's Layout)
    bk = 64 if int8 or d == 256 else 128
    stages = 2 if d == 256 else (3 if bk == 128 and d == 128 else 4)
    raw_stages = (1 if d == 256 else 2) if int8 else 0
    kv_map = {
        "dims": (d, t, hkv, b),
        "strides": kv_bytes,
        # bf16 tiles land swizzled for wgmma; int8 tiles land plain for
        # the producer's dequantize pass
        "box": (d if int8 else _SWIZZLE_ATOM, bk, 1, 1),
        "swizzle": 0 if int8 else 128,
    }
    smem = (SEGMENT_ROWS * d * 2 + 2 * stages * bk * d * 2 + raw_stages * 2 * bk * d
            + (2 * 2 * bk * 4 if int8 else 0) + 8 * (2 * stages + raw_stages + 2) + 1024)
    items = (-(-s // p), hkv, b)
    return {
        "work_items": items,
        "grid": min(math.prod(items), H100_SMS),
        "threads": SEGMENT_THREADS,
        "positions_per_item": p,
        "keys_per_tile": bk,
        "tma": {
            "q": {
                "dims": (d, h, s, b),
                "strides": (d * 2, h * d * 2, s * h * d * 2),
                "box": (_SWIZZLE_ATOM, g, p, 1),
                "swizzle": 128,
            },
            "k": kv_map,
            "v": dict(kv_map),
        },
        "plain_loads": ("k_scale", "v_scale") if int8 else (),
        "smem_bytes": smem,
    }


def _segment_launch(
    q: torch.Tensor, k: CacheEntry, v: CacheEntry, offset: Optional[torch.Tensor],
    config: ModelConfig, what: str,
) -> torch.Tensor:
    """Launch csrc/flash_segment.cu; ``offset`` None is offset 0 for every
    row (a prefill)."""
    b, s, h, d = q.shape
    dev = q.device
    _require_cuda_kernel(dev, d, what)
    kq, vq, ks, vs, sc_strides = _check_cache(k, v, dev, what)
    hkv, t = kq.shape[1], kq.shape[2]
    if kq.shape != (b, hkv, t, d) or (offset is not None and offset.shape != (b,)):
        raise ValueError(f"{what}: q {tuple(q.shape)} / offset "
                         f"{None if offset is None else tuple(offset.shape)} "
                         f"vs cache {tuple(kq.shape)}")
    _require_group(h, hkv, what)
    _check(q, "q", (torch.bfloat16,), dev)
    if offset is not None:
        _check(offset, "offset", (torch.int32,), dev)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if s == 0:
        return out.reshape(b, s, h * d)
    # raises before the launch on a tensor TMA cannot read (v shares k's
    # shape and strides, so only its base differs)
    segment_launch_plan(
        q.shape, kq.shape, kq.stride(), kq.dtype, kq.data_ptr() | vq.data_ptr(),
        q.data_ptr(), ks.stride() if ks is not None else None,
    )
    lib = _build.library("flash_segment")
    cap = config.attn_logit_softcap
    err = lib.lstpu_flash_segment(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        ks.data_ptr() if ks is not None else None, vs.data_ptr() if vs is not None else None,
        offset.data_ptr() if offset is not None else None, out.data_ptr(),
        b, s, h, hkv, d, t, kq.stride(0), kq.stride(1), *sc_strides,
        1.0 / math.sqrt(d), float(cap) if cap else 0.0, int(ks is not None), _stream(dev),
    )
    _build.check(err, what)
    return out.reshape(b, s, h * d)


def flash_segment_attention(
    q: torch.Tensor,  # [B, S, H, D] segment queries
    k: torch.Tensor,  # [B, Hkv, T, D] cache, the segment's K/V already written
    v: torch.Tensor,
    offset: torch.Tensor,  # [B] int32 global position of each row's segment start
    config: ModelConfig,
) -> torch.Tensor:
    """Causal GQA attention of a segment against the cache prefix plus
    itself → [B, S, H*D]; the CUDA kernel on CUDA tensors (bf16 q and
    cache, int32 offsets on the card), the plain version on the CPU."""
    if q.device.type == "cpu":
        _count(flash_segment_attention, "cpu_calls")
        return flash_segment_reference(q, k, v, offset, config)
    out = _segment_launch(q, k, v, offset, config, "flash_segment")
    _count(flash_segment_attention, "launches")
    return out


flash_segment_attention.launches = 0
flash_segment_attention.cpu_calls = 0


def flash_segment_attention_int8(
    q: torch.Tensor,  # [B, S, H, D]
    k: dict,  # int8 cache entry {"q": [B,Hkv,T,D] i8, "s": [B,Hkv,T] f32}
    v: dict,
    offset: torch.Tensor,  # [B] int32
    config: ModelConfig,
) -> torch.Tensor:
    """``flash_segment_attention`` over the int8 cache → [B, S, H*D]; the
    int8 tiles are dequantized to bf16 on the chip, so no cache-sized bf16
    copy is ever made."""
    if q.device.type == "cpu":
        _count(flash_segment_attention_int8, "cpu_calls")
        return flash_segment_int8_reference(q, k, v, offset, config)
    out = _segment_launch(q, k, v, offset, config, "flash_segment_int8")
    _count(flash_segment_attention_int8, "launches")
    return out


flash_segment_attention_int8.launches = 0
flash_segment_attention_int8.cpu_calls = 0


# ---------------------------------------------------------------------------
# Ragged decode: one query per row against its dense cache row, or against
# the page pool through a page table
# ---------------------------------------------------------------------------


# The decode kernel's launch (csrc/ragged_decode.cu, decode_cluster_kernel,
# whose cluster_layout computes the shared memory again and refuses a
# launch whose plan disagrees): one cluster of CTAs per (kv head, row),
# four consumer warps and a producer warp each, and a ring of bulk-copied
# tiles — for a bf16 and an int8 cache alike.
DECODE_THREADS = 160
DECODE_WARPS = 4
# CTAs splitting one (row, kv head), at most: on an H100, 4 beat 8 at both
# shapes chip_smoke.py measures (PERF.md)
DECODE_MAX_CLUSTER = 4
DECODE_TILE_ROWS = 64  # rows of a tile (a paged tile is a page, or a part of one)
# the ring's budget: bf16 3 stages of 64 rows at D = 128 (two CTAs an SM);
# int8 4 stages, so that three CTAs share an SM (the kernel's min_ctas)
DECODE_RING_BYTES = {torch.bfloat16: 96 * 1024, torch.int8: 72 * 1024}
DECODE_STAGES = (3, 8)  # the ring's least and most stages
SMEM_PER_CTA = 232448  # an H100 CTA's shared memory
# How an int8 tile's f32 scales reach its ring stage: the producer warp's
# lanes copy each valid row's K and V scale with a 4-byte cp.async counted
# on the stage's full mbarrier. A scale row of the engine's sink-column
# cache (max_seq_len + 1 floats) is not 16-byte aligned, so no bulk copy
# could take it; 4-byte copies take any layout.
DECODE_SCALE_COPY = "cp.async 4-byte per row, producer lanes"


def _a16(x: int) -> int:
    return (x + 15) & ~15


def _decode_stage_bytes(d: int, tile_rows: int, item: int) -> int:
    """One ring stage of the decode kernel: a tile's K rows, its V rows and
    (int8) their f32 scales."""
    return _a16(2 * tile_rows * d * item + (2 * tile_rows * 4 if item == 1 else 0))


def _cluster_smem(g: int, d: int, tile_rows: int, stages: int, item: int = 2) -> int:
    """Shared memory of one CTA of the decode kernel (its cluster_layout):
    the ring — or, once drained, the warps' f32 accumulators — then the
    warps' and the CTA's softmax statistics, rank 0's merge weights, the
    batch row the cluster takes, and a full and an empty mbarrier per
    stage."""
    ring = stages * _decode_stage_bytes(d, tile_rows, item)
    region = _a16(max(ring, DECODE_WARPS * g * d * 4))
    stats = 2 * DECODE_WARPS * g * 4 + 2 * g * 4 + DECODE_MAX_CLUSTER * g * 4 + g * 4 + 4
    return _a16(region + stats) + 16 * stages


def decode_launch_plan(
    q_shape: tuple, kv_shape: tuple, kv_strides: tuple, kv_dtype: torch.dtype, layout: str,
    table_width: Optional[int] = None, kv_ptr: int = 0, q_ptr: int = 0,
    scale_strides: Optional[tuple] = None, queries_per_row: int = 1,
) -> dict:
    """The launch of the decode kernel for these shapes, element strides,
    dtype and base addresses. ``layout`` "paged": ``kv_shape`` is the pool
    (P, Hkv, page_size, D), read through the ``table_width``-wide table,
    and a tile is the largest part of a page of at most
    ``DECODE_TILE_ROWS`` rows that divides it; "dense": the cache (B, Hkv,
    T, D), read through its strides (a ``[..., :T]`` view in place), in
    tiles of ``DECODE_TILE_ROWS`` rows. An int8 cache also takes its f32
    scales' element strides (``scale_strides``: rows of stride 1, a paged
    scale pool contiguous; any f32 base is aligned for their 4-byte
    copies). ``queries_per_row`` (dense only): query row r reads cache row
    ``r // queries_per_row`` — a flattened verify's k + 1 queries share
    their cache row; 1 is one query a row.
    → {"layout", "queries_per_row", "cluster" (CTAs splitting one (row, kv head): min(4,
    tiles)), "grid" (Hkv, B, cluster), "threads", "page_rows",
    "table_width" (0 when dense), "tile_rows", "tiles" (of a full row),
    "width" (the rows a row can reach), "tiles_per_rank" (of a full row),
    "stages", "stage_bytes", "smem_bytes", "row_bytes", "copy_bytes" (one
    bulk copy of a whole tile; a row's last tile copies only its valid
    rows, a whole number of rows), "scale_copy" (``DECODE_SCALE_COPY`` for
    int8, None for bf16), "scale_strides" ((batch, kv head) elements, or
    (page, kv head); (0, 0) for bf16)}. Raises ValueError for what the
    kernel cannot take: a head dim or group it is not built for, a cache
    dtype other than bf16 and int8, an int8 cache without its scales' row
    layout, rows that are not contiguous (a pool that is not contiguous),
    or a K/V base, stride or copy size that is not a multiple of 16 bytes
    (the bulk copies' rule)."""
    b, h, d = q_shape
    n0, hkv, rows, kd = kv_shape
    if layout not in ("paged", "dense"):
        raise ValueError(f"decode kernel: layout {layout!r}")
    if kd != d or hkv <= 0 or h % hkv or rows <= 0 or n0 <= 0 or b <= 0:
        raise ValueError(f"decode kernel: q {tuple(q_shape)} vs cache {tuple(kv_shape)}")
    g = h // hkv
    if d not in KERNEL_HEAD_DIMS or g not in KERNEL_GROUPS:
        raise ValueError(f"decode kernel: head dim {d} / group {g}; built for "
                         f"{KERNEL_HEAD_DIMS} / {KERNEL_GROUPS}")
    if kv_dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"decode kernel: cache dtype {kv_dtype} (bf16 or int8)")
    qpr = int(queries_per_row)
    if qpr < 1 or (layout == "paged" and qpr != 1):
        raise ValueError(f"decode kernel: {qpr} queries a cache row ({layout}); a paged "
                         "launch gives each query its own table row")
    int8 = kv_dtype == torch.int8
    item = 1 if int8 else 2
    sb, sh, st, sd = kv_strides
    if (sd, st) != (1, d):
        raise ValueError(f"decode kernel: cache strides {tuple(kv_strides)} do not keep "
                         f"rows of {d} contiguous")
    if int8:
        if scale_strides is None or len(scale_strides) != 3 or scale_strides[-1] != 1:
            raise ValueError(f"decode kernel: an int8 cache needs scales with rows of "
                             f"stride 1, got strides {scale_strides}")
    if layout == "paged":
        if (sb, sh) != (hkv * rows * d, rows * d):
            raise ValueError(f"decode kernel: pool strides {tuple(kv_strides)} are not "
                             f"contiguous (a page is one bulk copy)")
        if int8 and tuple(scale_strides[:2]) != (hkv * rows, rows):
            raise ValueError(f"decode kernel: scale pool strides {tuple(scale_strides)} are "
                             f"not contiguous")
        if not table_width or table_width <= 0:
            raise ValueError(f"decode kernel: table width {table_width}")
        tile_rows = max(t for t in range(1, min(rows, DECODE_TILE_ROWS) + 1) if rows % t == 0)
        tiles = table_width * (rows // tile_rows)
    else:
        if n0 * qpr != b:
            raise ValueError(f"decode kernel: q {tuple(q_shape)} ({qpr} a cache row) vs "
                             f"cache {tuple(kv_shape)}")
        if sb <= 0 or sh <= 0 or sb % d or sh % d:
            raise ValueError(f"decode kernel: cache strides {tuple(kv_strides)} are not "
                             f"whole rows of {d}")
        tile_rows = DECODE_TILE_ROWS
        tiles = -(-rows // tile_rows)
    row_bytes = d * item
    if row_bytes % 16 or (sb * item) % 16 or (sh * item) % 16 or kv_ptr % 16:
        raise ValueError(f"decode kernel: cache byte strides "
                         f"{(row_bytes, sh * item, sb * item)} and base {kv_ptr:#x} must be "
                         f"multiples of 16 (bulk copies)")
    if q_ptr % 16:
        raise ValueError(f"decode kernel: q base {q_ptr:#x} is not 16-byte aligned")
    cluster = min(DECODE_MAX_CLUSTER, tiles)
    stage = _decode_stage_bytes(d, tile_rows, item)
    stages = max(DECODE_STAGES[0], min(DECODE_STAGES[1], DECODE_RING_BYTES[kv_dtype] // stage))
    smem = _cluster_smem(g, d, tile_rows, stages, item)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"decode kernel: {stages} stages of {tile_rows}-row tiles need "
                         f"{smem} bytes of shared memory (a CTA has {SMEM_PER_CTA})")
    return {
        "layout": layout,
        "queries_per_row": qpr,
        "cluster": cluster,
        "grid": (hkv, b, cluster),
        "threads": DECODE_THREADS,
        "page_rows": rows if layout == "paged" else tile_rows,
        "table_width": table_width if layout == "paged" else 0,
        "tile_rows": tile_rows,
        "tiles": tiles,
        "width": rows if layout == "dense" else table_width * rows,
        "tiles_per_rank": -(-tiles // cluster),
        "stages": stages,
        "stage_bytes": stage,
        "smem_bytes": smem,
        "row_bytes": row_bytes,
        "copy_bytes": tile_rows * row_bytes,
        "scale_copy": DECODE_SCALE_COPY if int8 else None,
        "scale_strides": tuple(scale_strides[:2]) if int8 else (0, 0),
    }


def decode_rank_tiles(length: int, plan: dict, rank: int) -> range:
    """The tiles of a row of ``length`` keys that cluster rank ``rank``
    reads, as the kernel computes them on the device: the length clamped to
    [0, width], its n = ceil(length / tile_rows) valid tiles cut into
    contiguous shares of ceil(n / cluster); a rank past the last share
    gets none."""
    n = -(-min(max(length, 0), plan["width"]) // plan["tile_rows"])
    per = -(-n // plan["cluster"])
    t0 = min(rank * per, n)
    return range(t0, min(t0 + per, n))


def _decode_launch(
    q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor, ks: Optional[torch.Tensor],
    vs: Optional[torch.Tensor], lengths: torch.Tensor, table: Optional[torch.Tensor],
    config: ModelConfig, what: str, qpr: int = 1,
) -> torch.Tensor:
    """One launch of decode_cluster_kernel for all four decode wrappers
    (inputs already checked; ``ks``/``vs`` None for a bf16 cache, ``table``
    None for the dense layout, ``qpr`` query rows a dense cache row); the
    plan raises before a launch the copies cannot take, and the output is
    the only allocation."""
    b, h, d = q.shape
    dev = q.device
    dense = table is None
    plan = decode_launch_plan(
        q.shape, kq.shape, kq.stride(), kq.dtype, "dense" if dense else "paged",
        table_width=None if dense else table.shape[1], kv_ptr=kq.data_ptr() | vq.data_ptr(),
        q_ptr=q.data_ptr(), scale_strides=None if ks is None else ks.stride(),
        queries_per_row=qpr,
    )
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    cap = config.attn_logit_softcap
    err = _build.library("ragged_decode").lstpu_decode(
        q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        lengths.data_ptr(), None if dense else table.data_ptr(), out.data_ptr(),
        b, h, kq.shape[1], d, 0 if dense else kq.shape[0], plan["page_rows"], plan["tile_rows"],
        plan["table_width"], kq.shape[2] if dense else 0,
        kq.stride(0) if dense else 0, kq.stride(1) if dense else 0, *plan["scale_strides"],
        int(ks is not None), int(dense), plan["queries_per_row"], plan["cluster"],
        plan["stages"], plan["smem_bytes"], 1.0 / math.sqrt(d), float(cap) if cap else 0.0,
        _stream(dev),
    )
    _build.check(err, what)
    return out.reshape(b, h * d)


def _f32(entry: CacheEntry) -> torch.Tensor:
    """A cache entry in f32 (int8 dicts dequantized q*s)."""
    if isinstance(entry, dict):
        return entry["q"].float() * entry["s"][..., None]
    return entry.float()


def _decode_f32(
    q: torch.Tensor,  # [B, H, D], B = cache rows x qpr
    kk: torch.Tensor,  # [B / qpr, Hkv, T, D] f32
    vv: torch.Tensor,
    lengths: torch.Tensor,  # [B]
    config: ModelConfig,
    qpr: int = 1,
) -> torch.Tensor:
    """The math of every decode kernel → [B, H*D]: query row r reads cache
    row r // qpr, keys past its length (clamped to T) masked to -1e30 and
    never accumulated, f32 softmax, l clamped to 1e-30. The qpr queries of
    a cache row run as one [qpr * G, T] product (V zeroed past the longest
    of their lengths; a shorter query's masked p is exactly 0)."""
    b, h, d = q.shape
    rows, hkv, t = kk.shape[0], kk.shape[1], kk.shape[2]
    group = h // hkv
    valid = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]  # [B, T]
    vv = vv.masked_fill(~valid.reshape(rows, qpr, t).any(1)[:, None, :, None], 0.0)
    qf = (q.float().reshape(rows, qpr, hkv, group, d).transpose(1, 2)
          .reshape(rows, hkv, qpr * group, d))
    scores = torch.matmul(qf, kk.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # [R,Hkv,qG,T]
    scores = softcap(scores, config.attn_logit_softcap)
    seen = valid.reshape(rows, qpr, 1, t).expand(rows, qpr, group, t).reshape(rows, 1, -1, t)
    scores = torch.where(seen, scores, torch.full_like(scores, _NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(scores <= _NEG, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, vv) / l  # [R, Hkv, qpr * G, D]
    out = out.reshape(rows, hkv, qpr, group, d).transpose(1, 2)
    return out.to(q.dtype).reshape(b, h * d)


def ragged_decode_reference(
    q: torch.Tensor,  # [B, H, D], B = cache rows x queries_per_row
    k: CacheEntry,  # [B / queries_per_row, Hkv, T, D] cache (or int8 dict)
    v: CacheEntry,
    lengths: torch.Tensor,  # [B]
    config: ModelConfig,
    queries_per_row: int = 1,
) -> torch.Tensor:
    """Plain version of both dense decode kernels → [B, H*D]: K/V in f32
    (int8 dequantized, f32 throughout as on the TPU); query row r reads
    cache row ``r // queries_per_row``."""
    return _decode_f32(q, _f32(k), _f32(v), lengths, config, queries_per_row)


def _dense_decode_launch(
    q: torch.Tensor, k: CacheEntry, v: CacheEntry, lengths: torch.Tensor,
    config: ModelConfig, what: str, qpr: int,
) -> torch.Tensor:
    b, h, d = q.shape
    dev = q.device
    _require_cuda_kernel(dev, d, what)
    kq, vq, ks, vs, _ = _check_cache(k, v, dev, what)
    hkv, t = kq.shape[1], kq.shape[2]
    if (qpr < 1 or b % qpr or kq.shape != (b // qpr, hkv, t, d) or t == 0
            or lengths.shape != (b,)):
        raise ValueError(f"{what}: q {tuple(q.shape)} ({qpr} a cache row) / lengths "
                         f"{tuple(lengths.shape)} vs cache {tuple(kq.shape)}")
    _require_group(h, hkv, what)
    _check(q, "q", (torch.bfloat16,), dev)
    _check(lengths, "lengths", (torch.int32,), dev)
    return _decode_launch(q, kq, vq, ks, vs, lengths, None, config, what, qpr)


def ragged_decode_attention(
    q: torch.Tensor,  # [B, H, D] single query per row
    k: torch.Tensor,  # [B / qpr, Hkv, T, D] dense cache (a [..., :T] view is read in place)
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 valid cache prefix per row (clamped to T)
    config: ModelConfig,
    queries_per_row: int = 1,
) -> torch.Tensor:
    """GQA decode attention over a dense cache → [B, H*D]; the CUDA kernel
    on CUDA tensors (bf16 q and cache), the plain version on the CPU. Query
    row r reads cache row ``r // queries_per_row`` (a flattened verify's
    k + 1 queries share their row; ``dense_verify_queries``)."""
    if q.device.type == "cpu":
        _count(ragged_decode_attention, "cpu_calls")
        return ragged_decode_reference(q, k, v, lengths, config, queries_per_row)
    out = _dense_decode_launch(q, k, v, lengths, config, "dense_decode", queries_per_row)
    _count(ragged_decode_attention, "launches")
    return out


ragged_decode_attention.launches = 0
ragged_decode_attention.cpu_calls = 0


def ragged_decode_attention_int8(
    q: torch.Tensor,  # [B, H, D]
    k: dict,  # int8 cache entry {"q": [B/qpr,Hkv,T,D] i8, "s": [B/qpr,Hkv,T] f32}
    v: dict,
    lengths: torch.Tensor,  # [B] int32
    config: ModelConfig,
    queries_per_row: int = 1,
) -> torch.Tensor:
    """GQA decode attention over an int8 dense cache → [B, H*D]; rows are
    dequantized to f32 in registers, as the TPU kernel does in VMEM. Query
    row r reads cache row ``r // queries_per_row``."""
    if q.device.type == "cpu":
        _count(ragged_decode_attention_int8, "cpu_calls")
        return ragged_decode_reference(q, k, v, lengths, config, queries_per_row)
    out = _dense_decode_launch(q, k, v, lengths, config, "dense_decode_int8",
                               queries_per_row)
    _count(ragged_decode_attention_int8, "launches")
    return out


ragged_decode_attention_int8.launches = 0
ragged_decode_attention_int8.cpu_calls = 0


# ---------------------------------------------------------------------------
# Ragged PAGED decode: one query per row through the page table
# ---------------------------------------------------------------------------


def _gather_pages_f32(entry: CacheEntry, pages: torch.Tensor) -> torch.Tensor:
    """Pool entry [P, Hkv, ps, D] (int8 dicts dequantized q*s in f32)
    gathered through ``pages`` [B, Tp] → [B, Hkv, Tp*ps, D] f32."""
    if isinstance(entry, dict):
        g = entry["q"][pages].float() * entry["s"][pages][..., None]
    else:
        g = entry[pages].float()
    b, tp, hkv, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, tp * ps, d)


def paged_decode_reference(
    q: torch.Tensor,  # [B, H, D]
    k: CacheEntry,  # [P, Hkv, ps, D] (or int8 dict)
    v: CacheEntry,
    lengths: torch.Tensor,  # [B]
    table: torch.Tensor,  # [B, Tp]
    config: ModelConfig,
    page_size: int,
) -> torch.Tensor:
    """Plain version of both paged decode kernels → [B, H*D]: pages gathered
    through the table with the physical index clamped into [0, P-1], then
    the dense decode math."""
    num_pages = (k["q"] if isinstance(k, dict) else k).shape[0]
    pages = table.long().clamp(0, num_pages - 1)
    return _decode_f32(
        q, _gather_pages_f32(k, pages), _gather_pages_f32(v, pages), lengths, config
    )


def _paged_decode_launch(
    q: torch.Tensor, k: CacheEntry, v: CacheEntry, lengths: torch.Tensor,
    table: torch.Tensor, page_size: int, config: ModelConfig, what: str,
) -> torch.Tensor:
    b, h, d = q.shape
    quant = isinstance(k, dict)
    kq, vq = (k["q"], v["q"]) if quant else (k, v)
    num_pages, hkv = kq.shape[0], kq.shape[1]
    tp = table.shape[1]
    if kq.shape != (num_pages, hkv, page_size, d) or vq.shape != kq.shape or h % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs pool {tuple(kq.shape)}")
    if lengths.shape != (b,) or table.shape != (b, tp):
        raise ValueError(f"{what}: lengths {tuple(lengths.shape)} / table {tuple(table.shape)}")
    _require_cuda_kernel(q.device, d, what)
    _require_group(h, hkv, what)
    dev = q.device
    _check(q, "q", (torch.bfloat16,), dev)
    _check(lengths, "lengths", (torch.int32,), dev)
    _check(table, "table", (torch.int32,), dev)
    kv_types = (torch.int8,) if quant else (torch.bfloat16,)
    _check(kq, "k", kv_types, dev)
    _check(vq, "v", kv_types, dev)
    ks = vs = None
    if quant:
        ks, vs = k["s"], v["s"]
        _check(ks, "k scales", (torch.float32,), dev)
        _check(vs, "v scales", (torch.float32,), dev)
        if ks.shape != kq.shape[:-1] or vs.shape != ks.shape:
            raise ValueError(f"{what}: scales {tuple(ks.shape)} vs pool {tuple(kq.shape)}")
    return _decode_launch(q, kq, vq, ks, vs, lengths, table, config, what)


def ragged_paged_decode_attention(
    q: torch.Tensor,  # [B, H, D] single query per row
    k: torch.Tensor,  # page pool entry [P, Hkv, ps, D]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 valid logical columns per row
    table: torch.Tensor,  # [B, Tp] int32 physical page per logical page
    config: ModelConfig,
    page_size: int,
) -> torch.Tensor:
    """GQA paged decode attention → [B, H*D]; the CUDA kernel on CUDA
    tensors (bf16 q and pool), the plain version on CPU."""
    if q.device.type == "cpu":
        _count(ragged_paged_decode_attention, "cpu_calls")
        return paged_decode_reference(q, k, v, lengths, table, config, page_size)
    out = _paged_decode_launch(
        q, k, v, lengths, table, page_size, config, "paged_decode"
    )
    _count(ragged_paged_decode_attention, "launches")
    return out


ragged_paged_decode_attention.launches = 0
ragged_paged_decode_attention.cpu_calls = 0


def ragged_paged_decode_attention_int8(
    q: torch.Tensor,  # [B, H, D]
    k: dict,  # int8 pool entry {"q": [P,Hkv,ps,D] i8, "s": [P,Hkv,ps] f32}
    v: dict,
    lengths: torch.Tensor,  # [B] int32
    table: torch.Tensor,  # [B, Tp] int32
    config: ModelConfig,
    page_size: int,
) -> torch.Tensor:
    """GQA paged decode attention over the int8 page pool → [B, H*D]; pages
    are dequantized to f32 in registers, as the TPU kernel does in VMEM."""
    if q.device.type == "cpu":
        _count(ragged_paged_decode_attention_int8, "cpu_calls")
        return paged_decode_reference(q, k, v, lengths, table, config, page_size)
    out = _paged_decode_launch(
        q, k, v, lengths, table, page_size, config, "paged_decode_int8"
    )
    _count(ragged_paged_decode_attention_int8, "launches")
    return out


ragged_paged_decode_attention_int8.launches = 0
ragged_paged_decode_attention_int8.cpu_calls = 0


# ---------------------------------------------------------------------------
# Multi-token verify over the dense cache: the seam of the JAX package's
# ``multitoken_verify_attention`` (a routing over the kernels, not a kernel)
# ---------------------------------------------------------------------------


def multitoken_verify_attention(
    q: torch.Tensor,  # [B, S, H, D]: each row's current token and its S - 1 drafts
    k: CacheEntry,  # [B, Hkv, T, D] dense cache (or int8 dict), the drafts' K/V written
    v: CacheEntry,
    mask: Optional[torch.Tensor],  # [B, S, T] per-slot causal mask (reference path)
    config: ModelConfig,
    lengths: Optional[torch.Tensor] = None,  # [B*S] int32 (kernel path)
) -> torch.Tensor:
    """Per-slot causal attention of a verify's queries against the dense
    cache → [B, S, H*D]: query j of row b sees the columns ``<= positions[b]
    + j``. With ``lengths`` (the kernel path, ``dense_verify_queries``) the
    B*S queries run as single-query rows of the dense decode kernel, S a
    cache row — one launch, each query read to its own length (the plain
    version on CPU tensors); without, the masked reference ``attention``
    under ``mask``, which is what the JAX package computes."""
    b, s, h, d = q.shape
    if lengths is None:
        from langstream_tpu_torch.models.transformer import attention

        return attention(q, k, v, mask, config)
    kernel = ragged_decode_attention_int8 if isinstance(k, dict) else ragged_decode_attention
    out = kernel(q.reshape(b * s, h, d).contiguous(), k, v, lengths, config, queries_per_row=s)
    return out.reshape(b, s, h * d)


# ---------------------------------------------------------------------------
# A mixed batch of prefill segments and decode rows over one cache: the
# JAX package's ``fused_segment_decode_attention`` (a routing over the
# kernels, not a kernel; no serving path calls it, there or here)
# ---------------------------------------------------------------------------


def fused_segment_decode_attention(
    q_seg: torch.Tensor,  # [P, S, H, D] segment queries (prefill rows)
    seg_offsets: torch.Tensor,  # [P] int32 global position of each segment start
    q_dec: torch.Tensor,  # [Bd, H, D] one query per decode row
    k: CacheEntry,  # [B, Hkv, T, D] shared head-major cache (or int8 {"q","s"})
    v: CacheEntry,
    seg_rows: torch.Tensor,  # [P] cache row of each prefill row
    dec_rows: torch.Tensor,  # [Bd] cache row of each decode row
    dec_lengths: torch.Tensor,  # [Bd] valid cache prefix per decode row
    config: ModelConfig,
    kv_bound: Optional[int] = None,  # cap on the decode rows' readable columns
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill-segment rows and single-token decode rows over ONE cache →
    ([P, S, H*D] segment out, [Bd, H*D] decode out). The segment rows' own
    K/V must already be in the cache at [offset, offset + S) (the
    ``flash_segment_attention`` contract); decode rows attend to their
    first ``dec_lengths`` columns. It only routes: the segment rows go to
    ``flash_segment_attention`` (``_int8`` over an int8 cache) when the
    kernel gate holds, else to the masked reference ``attention``; the
    decode rows to the masked reference over the ``kv_bound``-sliced
    cache — each half what its standalone path computes."""
    from langstream_tpu_torch.models.transformer import attention

    def each(entry: CacheEntry, fn: Callable) -> CacheEntry:
        return {n: fn(a) for n, a in entry.items()} if isinstance(entry, dict) else fn(entry)

    quantized = isinstance(k, dict)
    t = (k["q"] if quantized else k).shape[2]
    k_seg, v_seg = (each(e, lambda a: a[seg_rows.long()]) for e in (k, v))
    s = q_seg.shape[1]
    if kernel_path_ok(config, q_seg.device):
        kernel = flash_segment_attention_int8 if quantized else flash_segment_attention
        seg_out = kernel(q_seg.contiguous(), k_seg, v_seg,
                         seg_offsets.to(torch.int32).contiguous(), config)
    else:
        positions = seg_offsets.long()[:, None] + torch.arange(s, device=q_seg.device)[None, :]
        kv_pos = torch.arange(t, device=q_seg.device)[None, None, :]
        seg_out = attention(q_seg, k_seg, v_seg, kv_pos <= positions[:, :, None], config)

    t_dec = t if kv_bound is None else min(kv_bound, t)
    k_dec, v_dec = (each(e, lambda a: a[dec_rows.long(), :, :t_dec]) for e in (k, v))
    dec_mask = (
        torch.arange(t_dec, device=q_dec.device)[None, None, :]
        < dec_lengths.long()[:, None, None]
    )  # [Bd, 1, T]
    dec_out = attention(q_dec[:, None], k_dec, v_dec, dec_mask, config)
    return seg_out, dec_out[:, 0]


# name → wrapper, the set chip_smoke.py and stats() report
KERNELS: dict[str, Callable] = {
    "flash_prefill": flash_prefill_attention,
    "paged_decode": ragged_paged_decode_attention,
    "paged_decode_int8": ragged_paged_decode_attention_int8,
    "flash_segment": flash_segment_attention,
    "flash_segment_int8": flash_segment_attention_int8,
    "dense_decode": ragged_decode_attention,
    "dense_decode_int8": ragged_decode_attention_int8,
}


def kernel_counts() -> dict[str, dict[str, int]]:
    """Per kernel: CUDA launches and CPU plain-version calls so far."""
    with _COUNT_LOCK:
        return {
            name: {"launches": fn.launches, "cpu_calls": fn.cpu_calls}
            for name, fn in KERNELS.items()
        }


def reset_kernel_counts() -> None:
    with _COUNT_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0
            fn.cpu_calls = 0


def count_snapshot() -> dict[str, tuple[int, int]]:
    """Per kernel: (launches, plain-version calls) so far."""
    with _COUNT_LOCK:
        return {name: (fn.launches, fn.cpu_calls) for name, fn in KERNELS.items()}


def count_delta(
    before: dict[str, tuple[int, int]], after: dict[str, tuple[int, int]]
) -> dict[str, tuple[int, int]]:
    """The counts made between two snapshots, kernels that moved only."""
    out = {}
    for name, (launches, calls) in after.items():
        d = (launches - before[name][0], calls - before[name][1])
        if d != (0, 0):
            out[name] = d
    return out


def add_counts(delta: dict[str, tuple[int, int]], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts (negative ``times`` removes):
    a captured graph's launches, on each of its replays."""
    with _COUNT_LOCK:
        for name, (launches, calls) in delta.items():
            fn = KERNELS[name]
            fn.launches += times * launches
            fn.cpu_calls += times * calls
