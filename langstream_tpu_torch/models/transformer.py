"""Decoder-only transformer (Llama and Mixtral families) in PyTorch — the
port of ``langstream_tpu/models/transformer.py`` for the serving main path.

Layout follows the JAX package so the two can be compared tensor for tensor:
stacked per-layer params ``[L, ...]`` in a dict (a Python loop over layers
replaces ``lax.scan``), head-major KV caches ``[L, B, Hkv, T, D]`` and a
page pool ``[L, P + 1, Hkv, page_size, D]`` (int8 caches are
``{"q": int8, "s": f32}`` dicts with per-token scales). Two KV layouts are
served: the paged pool (``paged_prefill_segment_inplace`` for chunked
prefill and warm prefix suffixes, ``paged_decode_step_inplace`` for
decode, ``paged_verify_step_inplace`` for a speculative verify of k+1
tokens a row, ``page_copy`` for a prefix alias's copy-on-write page) and the
dense per-slot cache (``prefill_segment`` for chunked prefill,
``decode_step_inplace`` for decode, ``verify_step_inplace`` for a
speculative verify). ``encode`` is the embedding model: bidirectional
attention over each row's real tokens, mean-pooled and L2-normalised. A
config with ``n_experts > 0``
takes ``moe_ffn`` (Mixtral-style top-k routing with a capacity limit) in
place of the dense FFN.

Differences from the JAX package:

- caches and pools are updated IN PLACE (the JAX functions return new
  arrays; donation makes that in place there too). The entry points still
  return the cache so call sites read alike, and ``decode_step`` is
  ``decode_step_inplace`` without a bound.
- JAX drops out-of-bounds scatters (``mode="drop"``); PyTorch raises on
  them. So the page pool carries one extra physical page at index
  ``num_pages`` — the WRITE SINK. The out-of-bounds sentinel of the page
  tables (= ``num_pages``) lands there instead of being dropped; nothing
  ever reads it as valid data (every read stays inside a row's length,
  and the length mask makes the rest harmless), so the sink is the drop
  without a host sync. One exception: a verify query on the card whose
  position lies past its row's reserved pages reads its own column back
  from the sink. Its token is never delivered, but sampling's NaN guard
  looks at every verify position, so the sink must hold finite values
  while speculation runs. A dense cache that may be written past its end
  (the engine's big cache, where a slot that finished mid-chunk keeps
  advancing; a long prompt's local cache, whose last padded segment can
  overrun it) is allocated with one extra last column, the SINK COLUMN:
  dense scatter positions clamp into the cache, so those writes land
  there, and reads go through ``[..., :kv_bound]`` views that stop short
  of it.
- The dense decode kernel is taken under ``attention_impl="auto"`` too
  (on the card, and its plain version on the CPU). The JAX package keeps
  it opt-in (``"pallas"``) because XLA's masked read beat it on a TPU;
  ``chip_smoke.py`` times that masked read beside the kernel on the H100.
- A paged segment on the kernel path gathers the pages it can read into a
  contiguous temporary and runs the segment kernel on it; the JAX package
  reads the whole gathered table with its reference attention there.
- A verify on the kernel path flattens its B x (k+1) queries into single-
  query rows: the paged decode kernel through each row's table
  (``verify_queries``), the dense decode kernel with k + 1 query rows a
  cache row (``dense_verify_queries``). The JAX package computes verify
  attention with its masked read, which the port keeps as the reference
  path (``attention_impl="jnp"``).
- The paged reference read zeroes V (an int8 pool's V scales) at columns
  no query of the row can see: a masked probability is exactly 0, which
  leaves every finite result bit-equal, but 0 x NaN is NaN.
- ``moe_ffn`` computes the JAX package's function without its ``[T, k, E,
  C]`` one-hots: rows scatter into per-expert buffers, the expert FFN runs
  as batched matmuls over the experts, outputs gather back.

Multi-LoRA (``lora`` / ``adapter_rows`` on every serving entry point): the
adapter pool of ``serving/adapters.py`` is gathered by each batch row's
adapter row at every adapted projection (``_lora_delta``: two batched f32
matmuls, cast to the activation dtype), so base rows (row 0, all zeros)
and N adapters share one call. K/V written to a cache include the
``wk`` / ``wv`` deltas; a verify applies a row's adapter to all k+1 of its
queries before the kernel path flattens them.

Sequence parallelism: ``forward`` and the layer take a ring handle
(``ring``, ``parallel/ring_attention.py``) as they take ``tp``; with one
and no cache, a layer's attention is ``ring_attention`` over the rank's
block of the sequence at global positions (``parallel/sp.py``).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.models.bridge import torch_dtype
from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.models.quant import dequantize_weight, is_quantized, quantized_matmul
from langstream_tpu_torch.ops.attention import (
    flash_prefill_attention,
    flash_segment_attention,
    flash_segment_attention_int8,
    kernel_path_ok,
    multitoken_verify_attention,
    ragged_decode_attention,
    ragged_decode_attention_int8,
    ragged_paged_decode_attention,
    ragged_paged_decode_attention_int8,
    softcap,
)

Params = dict
KVCache = dict

_NEG = -1e30


def _map(fn, entry):
    """Apply ``fn`` to a cache entry: a tensor, or each leaf of an int8 dict."""
    if isinstance(entry, dict):
        return {k: fn(v) for k, v in entry.items()}
    return fn(entry)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


# per (rope fields, device): the inverse frequencies, made once. A tensor
# built from a Python number on the card is a host-to-device copy, which a
# CUDA graph capture refuses; the decode steps a graph captures find them
# here (the engine's warm-up call fills the entry before any capture).
_ROPE_FREQS: dict[tuple, torch.Tensor] = {}
_EMBED_SCALES: dict[tuple, torch.Tensor] = {}


def _rope_inv_freqs(config: ModelConfig, device: torch.device) -> torch.Tensor:
    """[head_dim/2] f32 inverse frequencies (llama3-scaled where the config
    says so), cached per device. On the card the table is made on the
    calling thread's stream, which is synchronized before the entry is
    published: another thread's stream (the engine's, an embedding's) may
    read it next."""
    key = (
        config.resolved_head_dim, config.rope_theta, config.rope_scaling_factor,
        config.rope_scaling_low_freq_factor, config.rope_scaling_high_freq_factor,
        config.rope_scaling_original_max_seq_len, str(device),
    )
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        half = config.resolved_head_dim // 2
        exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
        # f32 pow correctly rounded (as XLA computes it): PyTorch's f32 pow
        # can land 1 ulp off, which moves angles at long positions by p * ulp
        freqs = torch.pow(
            torch.tensor(config.rope_theta, dtype=torch.float64, device=device),
            exponent.double(),
        ).float()
        if config.rope_scaling_factor:
            freqs = _llama3_rope_scale(freqs, config)
        if freqs.device.type == "cuda":
            torch.cuda.current_stream(freqs.device).synchronize()
        freqs = _ROPE_FREQS.setdefault(key, freqs)
    return freqs


def _rope_freqs(
    positions: torch.Tensor, config: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] → sin/cos [B, S, head_dim/2], f32."""
    angles = positions.float()[..., None] * _rope_inv_freqs(config, positions.device)
    return torch.sin(angles), torch.cos(angles)


def _llama3_rope_scale(freqs: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """NTK-by-parts scaling (HF rope_scaling type "llama3"): low-frequency
    components slow down by ``factor``; a smooth ramp interpolates through
    the transition wavelength band."""

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=freqs.device)

    factor = f32(config.rope_scaling_factor)
    low = f32(config.rope_scaling_low_freq_factor)
    high = f32(config.rope_scaling_high_freq_factor)
    original = f32(config.rope_scaling_original_max_seq_len)

    wavelen = 2.0 * math.pi / freqs
    low_wavelen = original / low
    high_wavelen = original / high
    smooth = ((original / wavelen - low) / (high - low)).clamp(0.0, 1.0)
    scaled = freqs / factor
    interpolated = (1.0 - smooth) * scaled + smooth * freqs
    return torch.where(
        wavelen > low_wavelen,
        scaled,
        torch.where(wavelen < high_wavelen, freqs, interpolated),
    )


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; half-rotation convention (HF llama/gemma)."""
    half = x.shape[-1] // 2
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] → int8 values + f32 scale per leading index (symmetric);
    bit-exact with the JAX package (true division, half-to-even rounding)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(c, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(c, dict):
        return (c["q"].float() * c["s"][..., None]).to(dtype)
    return c


def cache_width(cache: KVCache) -> int:
    leaf = cache["k"]
    return (leaf["q"] if isinstance(leaf, dict) else leaf).shape[3]


def _int_dot(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int8 x int8 contraction with an exact integer result, as f32.
    Products of int8 summed over the contracted axis are integers below
    2^53, so float64 holds them exactly on every device (PyTorch has no
    integer matmul on CUDA); the JAX package dots in s8 with s32 accum."""
    return torch.einsum(equation, a.double(), b.double()).float()


def attention(
    q: torch.Tensor,  # [B, S, H, D]
    k,  # [B, Hkv, T, D] head-major tensor, or int8 {"q","s"} cache entry
    v,
    mask: torch.Tensor,  # [B, S, T] bool — True = attend
    config: ModelConfig,
) -> torch.Tensor:
    """GQA attention, f32 softmax — the gathered reference path
    (``attention_impl="jnp"``). int8 caches take the JAX package's
    hoisted-scale math: q and the probabilities are quantized per vector
    and dotted in integers, with the scales applied to the scores."""
    h, hkv = config.n_heads, config.n_kv_heads
    group = h // hkv
    b, s, _, d = q.shape
    qg = q.reshape(b, s, hkv, group, d)
    if isinstance(k, dict):
        qq, qs = _quantize_kv(qg)  # [B,S,Hkv,G,D] int8, [B,S,Hkv,G] f32
        scores = _int_dot("bshgd,bhtd->bhgst", qq, k["q"])
        scores = scores * qs.permute(0, 2, 3, 1)[:, :, :, :, None]
        scores = scores * k["s"][:, :, None, None, :]
    else:
        scores = torch.einsum("bshgd,bhtd->bhgst", qg, k).float()
    scores = scores / torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=q.device))
    scores = softcap(scores, config.attn_logit_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1)
    if isinstance(v, dict):
        pv = probs * v["s"][:, :, None, None, :]
        pq, ps = _quantize_kv(pv)  # int8 [B,Hkv,G,S,T], f32 [B,Hkv,G,S]
        out = _int_dot("bhgst,bhtd->bshgd", pq, v["q"])
        out = (out * ps.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
    else:
        out = torch.einsum("bhgst,bhtd->bshgd", probs.to(q.dtype), v)
    return out.reshape(b, s, h * d)


def _dispatch_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k_all,  # [B, Hkv, T, D] tensor, or int8 {"q","s"} dict
    v_all,
    mask: Optional[torch.Tensor],  # [B, S, T'] over the readable columns
    config: ModelConfig,
    causal: bool,
    kv_offset: Optional[torch.Tensor] = None,  # [B] i32: segment prefill at an offset
    kv_bound: Optional[int] = None,  # readable cache columns
    lengths: Optional[torch.Tensor] = None,  # [B] i32: single-token decode ([B*S]: a verify)
    verify: bool = False,  # a speculative verify's S queries a row
) -> torch.Tensor:
    """Route attention over a dense cache (or the prompt's own K/V) to a
    kernel when the gate allows it, else to the reference ``attention``.
    ``kv_bound`` cuts the cache to a ``[..., :kv_bound]`` view first (read
    in place by the kernels). Then: a verify → ``multitoken_verify_attention``
    (the dense decode kernel over its flattened queries with ``lengths``,
    else the masked read); decode (``lengths``) → the dense decode
    kernel; a segment (``kv_offset``) → the segment kernel; a causal prompt
    → the flash prefill kernel over the first S columns (int8 caches
    dequantize just that slice)."""
    if kv_bound is not None:
        k_all = _map(lambda x: x[:, :, :kv_bound], k_all)
        v_all = _map(lambda x: x[:, :, :kv_bound], v_all)
    if verify:
        return multitoken_verify_attention(q, k_all, v_all, mask, config, lengths)
    s = q.shape[1]
    if kernel_path_ok(config, q.device):
        quantized = isinstance(k_all, dict)
        if lengths is not None:
            kernel = ragged_decode_attention_int8 if quantized else ragged_decode_attention
            return kernel(q[:, 0].contiguous(), k_all, v_all, lengths, config)[:, None, :]
        if kv_offset is not None:
            kernel = flash_segment_attention_int8 if quantized else flash_segment_attention
            return kernel(q.contiguous(), k_all, v_all, kv_offset, config)
        if s > 1 and causal:
            ksl = _map(lambda x: x[:, :, :s], k_all)
            vsl = _map(lambda x: x[:, :, :s], v_all)
            return flash_prefill_attention(
                q.contiguous(),
                _dequantize_kv(ksl, q.dtype).contiguous(),
                _dequantize_kv(vsl, q.dtype).contiguous(),
                config,
            )
    return attention(q, k_all, v_all, mask, config)


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# Multi-LoRA: each batch row gathers ITS adapter's factors from the pool, so
# one call serves base + N adapters; the low-rank product runs in f32 and
# adds onto the base projection: W_i = W + scale_i * A_i @ B_i, never merged
# ---------------------------------------------------------------------------

LORA_PROJS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# one layer's adapter inputs: ({proj: {"a": [R, din, r], "b": [R, r, dout]}},
# scale [R] f32, rows [B] pool row per batch row)
LayerLora = tuple


def _lora_delta(
    x: torch.Tensor,  # [B, S, din]
    entry: dict,  # {"a": [R, din, r], "b": [R, r, dout]}: one layer's slice
    scale: torch.Tensor,  # [R]
    rows: torch.Tensor,  # [B] pool row per batch row (0 = base, all zeros)
) -> torch.Tensor:
    """Per-row low-rank correction ``scale_i * (x @ A_i) @ B_i`` with the
    factors gathered by each row's adapter row, accumulated in f32 and cast
    to the activation dtype (the JAX package's two einsums)."""
    rows = rows.long()
    ag = entry["a"].index_select(0, rows).float()  # [B, din, r]
    bg = entry["b"].index_select(0, rows).float()  # [B, r, dout]
    out = torch.bmm(torch.bmm(x.float(), ag), bg)  # [B, S, dout]
    return (out * scale.index_select(0, rows)[:, None, None]).to(x.dtype)


def _lora_proj(x: torch.Tensor, base: torch.Tensor, proj: str,
               lora: Optional[LayerLora]) -> torch.Tensor:
    """``base`` (x's projection) plus its adapter delta; ``base`` alone
    without adapters or when the pool has no such projection (MoE layers
    carry attention-only adapters)."""
    if lora is None or proj not in lora[0]:
        return base
    entries, scale, rows = lora
    return base + _lora_delta(x, entries[proj], scale, rows)


def _lora_layer(lora: Optional[dict], rows: Optional[torch.Tensor], i: int) -> Optional[LayerLora]:
    """Layer ``i``'s slice of the stacked pool ``{proj: {"a": [L, R, din,
    r], "b": [L, R, r, dout]}, "scale": [R]}`` with the rows, or None."""
    if lora is None or rows is None:
        return None
    entries = {k: {f: v[f][i] for f in ("a", "b")} for k, v in lora.items() if k != "scale"}
    return entries, lora["scale"], rows


def dense_ffn(x: torch.Tensor, lp: dict, config: ModelConfig,
              lora: Optional[LayerLora] = None, tp: Optional[Any] = None) -> torch.Tensor:
    """Gated FFN. Under tensor parallelism (``tp``) the rank holds a column
    slice of ``w_gate`` / ``w_up`` and the matching row slice of
    ``w_down``: its output is a partial sum, all-reduced over the model
    axis."""
    gate = _activation(
        _lora_proj(x, quantized_matmul(x, lp["w_gate"]), "w_gate", lora), config.activation
    )
    up = _lora_proj(x, quantized_matmul(x, lp["w_up"]), "w_up", lora)
    h = gate * up
    out = _lora_proj(h, quantized_matmul(h, lp["w_down"]), "w_down", lora)
    return out if tp is None else tp.all_reduce(out)


def moe_capacity(tokens: int, config: ModelConfig) -> int:
    """Rows of each expert's buffer for ``tokens`` routed tokens: ``ceil(T *
    k * factor / E)``, floored at ``min(T, 64)`` so small decode batches
    drop nothing, at most T; ``factor <= 0`` is lossless (C = T)."""
    factor = config.moe_capacity_factor
    if not factor or factor <= 0:
        return tokens
    e, k = config.n_experts, config.n_experts_per_tok
    return min(tokens, max(math.ceil(tokens * k * factor / e), min(tokens, 64)))


def _expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x [E, C, in] @ w [E, in, out]`` batched over the experts. An int8
    ``w`` multiplies its integer values (exact in the activation dtype) and
    applies the per-output-channel scale after the product — ``(x @ q) *
    s`` is ``x @ (q * s)`` up to rounding — so the layer's experts are
    widened to the activation dtype, never to an f32 copy."""
    if is_quantized(w):
        return (torch.bmm(x, w["q"].to(x.dtype)) * w["s"]).to(x.dtype)
    return torch.bmm(x, w)


def moe_ffn(x: torch.Tensor, lp: dict, config: ModelConfig,
            tp: Optional[Any] = None) -> torch.Tensor:
    """Mixture of experts, the function of the JAX package's ``moe_ffn``:
    f32 router logits, top-k experts per token with a softmax over their k
    logits, and a capacity of ``moe_capacity(T)`` rows per expert filled in
    token-major order — a (token, slot) past its expert's capacity is
    dropped and adds 0. Each kept row is scattered into its expert's buffer
    ``[E, C + 1, D]`` (row C takes the dropped ones and is never read), the
    expert FFN runs as three batched matmuls over the experts, and each
    token sums its kept outputs weighted by their routing weights (in f32,
    rounded once). Linear in T; the same value as the JAX package's
    one-hot einsums up to summation order.

    Under tensor parallelism (``tp``) routing, capacity and buffer places
    are computed over all experts on every rank; the rank runs only its
    experts ``[expert_start, expert_start + experts_local)`` (on "expert"),
    the others' (token, slot)s going to the dropped row, over its slice of
    ``d_ff`` (on "model"), so its f32 weighted sum is a partial one,
    all-reduced over the expert and model axes and rounded once."""
    b, s, d = x.shape
    t = b * s
    e, k = config.n_experts, config.n_experts_per_tok
    e0, el = (tp.expert_start, tp.experts_local) if tp is not None else (0, e)
    xf = x.reshape(t, d)
    logits = torch.matmul(xf, lp["router"]).float()  # [T, E]
    weights, chosen = torch.topk(logits, k, dim=-1)  # [T, k]
    weights = torch.softmax(weights, dim=-1)
    capacity = moe_capacity(t, config)
    # place of each (token, slot) in its expert's buffer: earlier (token,
    # slot)s routed to the same expert, in token-major order
    flat = chosen.reshape(t * k, 1)
    onehot = torch.zeros((t * k, e), dtype=torch.int32, device=x.device).scatter_(1, flat, 1)
    pos = (onehot.cumsum(0) - 1).gather(1, flat).reshape(t, k).long()
    keep = pos < capacity
    if tp is not None:
        keep = keep & (chosen >= e0) & (chosen < e0 + el)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))  # dropped → row C
    mine = chosen if tp is None else (chosen - e0).clamp(0, el - 1)
    buf = xf.new_zeros((el, capacity + 1, d))
    buf[mine, slot] = xf[:, None, :].expand(t, k, d)
    expert_in = buf[:, :capacity]
    gate = _activation(_expert_matmul(expert_in, lp["w_gate"]), config.activation)
    up = _expert_matmul(expert_in, lp["w_up"])
    expert_out = _expert_matmul(gate * up, lp["w_down"])  # [El, C, D]
    picked = expert_out[mine, slot.clamp_max(capacity - 1)]  # [T, k, D]
    combine = weights.to(x.dtype).float()[..., None]  # the weights in the model dtype
    mixed = torch.where(keep[..., None], picked.float() * combine, torch.zeros((), device=x.device))
    out = mixed.sum(dim=1)
    if tp is not None:
        out = tp.all_reduce(out, moe=True)
    return out.to(x.dtype).reshape(b, s, d)


# ---------------------------------------------------------------------------
# KV caches and the paged pool
# ---------------------------------------------------------------------------


def make_kv_cache(
    config: ModelConfig, batch: int, max_len: int, device: DeviceLike = "cuda"
) -> KVCache:
    """Head-major cache ``[L, B, Hkv, T, D]``; with ``kv_cache_dtype ==
    "int8"`` each entry is ``{"q": int8 [L,B,Hkv,T,D], "s": f32 [L,B,Hkv,T]}``
    with the JAX package's scale init ``1e-8 / 127``."""
    dev = resolve_device(device)
    dtype = torch_dtype(config.dtype)
    shape = (config.n_layers, batch, config.n_kv_heads, max_len, config.resolved_head_dim)
    if config.kv_cache_dtype == "int8":

        def entry() -> dict:
            return {
                "q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "s": torch.full(shape[:-1], 1e-8 / 127.0, dtype=torch.float32, device=dev),
            }

        return {"k": entry(), "v": entry()}
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def _dense_index(positions: torch.Tensor, width: int, n_kv_heads: int) -> tuple:
    """(row [B, 1, 1], kv head [1, Hkv, 1], column [B, 1, S]) indices of
    every token's row in a dense cache of ``width`` columns; positions past
    the last column land in it (the sink column, see the module note)."""
    dev = positions.device
    return (
        torch.arange(positions.shape[0], device=dev)[:, None, None],
        torch.arange(n_kv_heads, device=dev)[None, :, None],
        positions.long().clamp(0, width - 1)[:, None, :],
    )


def make_page_pool(
    config: ModelConfig, num_pages: int, page_size: int, device: DeviceLike = "cuda"
) -> KVCache:
    """Device page pool: leaves ``[L, num_pages + 1, Hkv, ps, D]`` (int8:
    ``{"q","s"}`` with scales ``[L, num_pages + 1, Hkv, ps]``). Pages
    ``0 .. num_pages - 1`` are real; page ``num_pages`` is the write sink
    that takes the out-of-bounds sentinel's writes (see the module note)."""
    return make_kv_cache(config, num_pages + 1, page_size, device=device)


def pool_pages(pool: KVCache) -> int:
    """Real pages of a pool (its sentinel / sink index)."""
    leaf = pool["k"]
    return (leaf["q"] if isinstance(leaf, dict) else leaf).shape[1] - 1


def _page_index(
    table: torch.Tensor, positions: torch.Tensor, page_size: int, num_pages: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical position → (physical page, in-page offset). Positions past
    the table map to the sentinel ``num_pages`` (the sink)."""
    lidx = positions // page_size  # [B, S]
    pages = torch.gather(table.long(), 1, lidx.clamp(0, table.shape[1] - 1))
    pages = torch.where(lidx >= table.shape[1], torch.full_like(pages, num_pages), pages)
    return pages, positions % page_size


def _scatter_index(
    table: torch.Tensor, positions: torch.Tensor, page_size: int, sink: int, n_kv_heads: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(page [B, 1, S], kv head [1, Hkv, 1], offset [B, 1, S]) indices of
    every token's pool row; sentinel pages are the sink page."""
    pages, offs = _page_index(table, positions, page_size, sink)
    hidx = torch.arange(n_kv_heads, device=positions.device)[None, :, None]
    return pages.clamp(0, sink)[:, None, :], hidx, offs[:, None, :]


def _scatter_at(entry, vals: torch.Tensor, index: tuple) -> None:
    """Write ``vals`` [B, Hkv, S, D] into ``entry`` at ``index`` in place
    (int8 entries are quantized per token and head first)."""
    if isinstance(entry, dict):
        q, s = _quantize_kv(vals)
        entry["q"][index] = q
        entry["s"][index] = s
    else:
        entry[index] = vals.to(entry.dtype)


def _paged_scatter_entry(entry, vals: torch.Tensor, table: torch.Tensor,
                         positions: torch.Tensor, page_size: int):
    """Scatter per-token K/V ``vals`` [B, Hkv, S, D] IN PLACE into a
    per-layer pool entry [P + 1, Hkv, ps, D] (or its int8 dict) at pages
    ``table[b, pos // ps]``, offset ``pos % ps``. Unmapped (sentinel) pages
    write into the sink page — the port's ``mode="drop"``."""
    leaf = entry["q"] if isinstance(entry, dict) else entry
    index = _scatter_index(table, positions, page_size, leaf.shape[0] - 1, vals.shape[1])
    _scatter_at(entry, vals, index)
    return entry


def _paged_gather_entry(entry, table: torch.Tensor, page_size: int):
    """Dense head-major view of every slot's logical columns: a pool entry
    [P + 1, Hkv, ps, D] gathered through ``table`` [B, Tp] →
    [B, Hkv, Tp*ps, D] (int8 dicts gather q and s alike). The reference
    read of ``attention_impl="jnp"`` (and of a verify on the CPU). Physical
    pages clamp into the real pages [0, P - 1], as the JAX package's
    clipped gather reads them: a sentinel entry reads the last real page,
    never the sink, so a column past a row's reservation reads what it
    reads in JAX (only a verify's columns can be visible there)."""

    def gather(a: torch.Tensor) -> torch.Tensor:
        b, tp = table.shape
        g = a[table.long().clamp(0, a.shape[0] - 2)]  # [B, Tp, Hkv, ps, ...]
        g = g.movedim(2, 1)  # [B, Hkv, Tp, ps, ...]
        return g.reshape((b, a.shape[1], tp * page_size) + tuple(a.shape[3:]))

    return _map(gather, entry)


def _page_rows(pages: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """Rows of a pool entry viewed as ``[(P + 1) * Hkv, ps, ...]`` (one row:
    one kv head's slice of a page) that hold the pages ``pages`` [B, n]
    (physical, in range), flattened in [B, Hkv, n] order."""
    hidx = torch.arange(n_kv_heads, device=pages.device)[None, :, None]
    return (pages.long()[:, None, :] * n_kv_heads + hidx).reshape(-1)


def _gather_pages(entry, rows: torch.Tensor, batch: int):
    """The pool rows ``rows`` (``_page_rows``) of a pool entry [P + 1, Hkv,
    ps, D] (or its int8 dict, scales alike) copied into one contiguous
    [B, Hkv, n*ps, D] temporary: the kernel path's read of a paged
    segment's prefix. One ``index_select`` of whole contiguous rows per
    leaf (a page of one head: 16 KB in bf16 at ps 64, D 128), no copy of
    the table's other pages."""

    def gather(a: torch.Tensor) -> torch.Tensor:
        g = a.reshape((-1,) + tuple(a.shape[2:])).index_select(0, rows)  # [B*Hkv*n, ps, ...]
        return g.reshape((batch, a.shape[1], -1) + tuple(a.shape[3:]))

    return _map(gather, entry)


def _hide_columns(entry, visible: torch.Tensor):
    """A gathered V entry [B, Hkv, T, D] (int8: its scales [B, Hkv, T])
    with the columns ``visible`` [B, T] marks False set to 0."""
    if isinstance(entry, dict):
        return {"q": entry["q"], "s": entry["s"].masked_fill(~visible[:, None, :], 0.0)}
    return entry.masked_fill(~visible[:, None, :, None], 0.0)


def verify_queries(
    table: torch.Tensor, positions: torch.Tensor, s: int, page_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel path's flattening of a paged verify: the ``s`` queries of
    each of B rows become B*s single-query rows of the paged decode kernel.
    Query j of row b gets row b's table and the length ``positions[b] + j +
    1``, capped at the table's ``Tp * page_size`` columns → (table [B*s,
    Tp] int32, lengths [B*s] int32). It then reads exactly the columns the
    verify's causal mask shows it: its own draft and the ones before, never
    a later (stale or rejected) draft's; the cap keeps the kernel's plan
    from reading table entries past the row for columns past the table
    (whose writes went to the sink)."""
    b, tp = table.shape
    flat = table.to(torch.int32)[:, None, :].expand(b, s, tp).reshape(b * s, tp).contiguous()
    pos = positions.long()[:, None] + torch.arange(s, device=positions.device)[None, :]
    lengths = (pos + 1).clamp_max(tp * page_size).to(torch.int32).reshape(b * s)
    return flat, lengths


def _paged_mask(table: torch.Tensor, page_size: int, positions: torch.Tensor) -> torch.Tensor:
    """Causal mask over the gathered paged view: logical column t of slot b
    is visible to query j iff t <= positions[b, j]."""
    t = table.shape[1] * page_size
    kv_pos = torch.arange(t, device=positions.device)[None, None, :]
    return kv_pos <= positions[:, :, None]


# ---------------------------------------------------------------------------
# Layer + model
# ---------------------------------------------------------------------------


def _layer_params(layers: dict, i: int) -> dict:
    return {k: _map(lambda a: a[i], v) for k, v in layers.items()}


def _layer(
    x: torch.Tensor,
    lp: dict,
    sin: torch.Tensor,
    cos: torch.Tensor,
    mask: Optional[torch.Tensor],
    config: ModelConfig,
    cache_kv: Optional[tuple] = None,
    cache_index: Optional[tuple] = None,  # dense scatter index (_dense_index)
    causal: bool = True,
    # (read table [B, Tp] i32, page_size, kernel lengths, scatter index,
    # segment read); a flattened verify's table and lengths are per query
    paged: Optional[tuple] = None,
    kv_offset: Optional[torch.Tensor] = None,
    kv_bound: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
    lora: Optional[LayerLora] = None,
    verify: bool = False,
    tp: Optional[Any] = None,
    ring: Optional[Any] = None,
    kv_out: Optional[list] = None,
) -> torch.Tensor:
    """One transformer block. With ``cache_kv`` (a dense cache: an admit
    group's local cache, a long prompt's local cache or the big cache) K/V
    are written at ``cache_index`` and attention runs over the cache
    (``_dispatch_attention``: ``kv_offset`` for a segment, ``lengths`` for
    decode, ``kv_bound`` readable columns; ``verify``: a dense verify's
    queries, ``lengths`` one a query on the kernel path). With ``paged`` the cache entries
    are per-layer page-pool entries and K/V scatter into the slot's pages;
    on the kernel path a segment (a segment read: the pool rows of the
    pages it can read, ``_page_rows``, and its readable columns) runs the
    segment kernel over those pages gathered at ``kv_offset``, a
    single-token step — or a verify's queries flattened into single-query
    rows (``verify_queries``) — reads through the table with the paged
    decode kernel (``lengths`` given); the reference path reads the
    gathered table under ``mask``, V zeroed where no query of the row can
    see. The FFN is ``moe_ffn`` for an MoE config, else ``dense_ffn``.
    ``lora`` (``_lora_layer``) adds each row's adapter delta at every
    adapted projection, before K/V are written. Under tensor parallelism
    (``tp``) ``config`` holds the rank's heads (``parallel.sharding
    .local_config``): q/k/v run over them and the row-parallel ``wo``'s
    partial sum is all-reduced over the model axis before the residual.
    With ``ring`` (a ring handle, ``parallel.ring_attention``) and no cache
    the rows are this rank's block of a sequence split over the ring, and
    attention is ``ring_attention`` (never a kernel: causality comes from
    the blocks' global positions); ``kv_out`` collects the layer's roped
    head-major K/V."""
    b, s, _ = x.shape
    hd = config.resolved_head_dim

    attn_in = rms_norm(x, lp["attn_norm"], config.rms_norm_eps)

    def project(name: str, heads: int) -> torch.Tensor:
        out = _lora_proj(attn_in, quantized_matmul(attn_in, lp[name]), name, lora)
        return out.reshape(b, s, heads, hd)

    q = project("wq", config.n_heads)
    k = project("wk", config.n_kv_heads)
    v = project("wv", config.n_kv_heads)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [B, Hkv, S, D]
    if kv_out is not None:
        kv_out.append((kt, vt))

    if ring is not None and cache_kv is None and paged is None:
        from langstream_tpu_torch.parallel.ring_attention import ring_attention

        attn = ring_attention(q, k, v, config, ring)
    elif paged is not None:
        table, page_size, lengths, index, segment = paged
        ck, cv = cache_kv
        _scatter_at(ck, kt, index)
        _scatter_at(cv, vt, index)
        if segment is not None:
            rows, bound = segment
            attn = _dispatch_attention(
                q, _gather_pages(ck, rows, b), _gather_pages(cv, rows, b), None, config, True,
                kv_offset=kv_offset, kv_bound=bound,
            )
        elif lengths is not None:
            kernel = (
                ragged_paged_decode_attention_int8
                if isinstance(ck, dict)
                else ragged_paged_decode_attention
            )
            flat_q = q.reshape(b * s, config.n_heads, hd).contiguous()
            attn = kernel(flat_q, ck, cv, lengths, table, config, page_size)
            attn = attn.reshape(b, s, config.n_heads * hd)
        else:
            k_all = _paged_gather_entry(ck, table, page_size)
            v_all = _hide_columns(_paged_gather_entry(cv, table, page_size), mask.any(dim=1))
            attn = attention(q, k_all, v_all, mask, config)
    else:
        if cache_kv is not None:
            ck, cv = cache_kv  # [B, Hkv, T, D] head-major (maybe int8)
            _scatter_at(ck, kt, cache_index)
            _scatter_at(cv, vt, cache_index)
            k_all, v_all = ck, cv
        else:
            k_all, v_all = kt, vt
        attn = _dispatch_attention(
            q, k_all, v_all, mask, config, causal, kv_offset, kv_bound, lengths, verify
        )
    out = _lora_proj(attn, quantized_matmul(attn, lp["wo"]), "wo", lora)
    x = x + (out if tp is None else tp.all_reduce(out))
    ffn_in = rms_norm(x, lp["ffn_norm"], config.rms_norm_eps)
    if config.is_moe:
        return x + moe_ffn(ffn_in, lp, config, tp)
    return x + dense_ffn(ffn_in, lp, config, lora, tp)


def _embed(params: Params, tokens: torch.Tensor, config: ModelConfig,
           tp: Optional[Any] = None) -> torch.Tensor:
    """Embedding lookup; under tensor parallelism (``tp``) the rank holds
    rows ``[vocab_start, vocab_start + vocab_local)``: it looks up the
    tokens that fall there, zeroes the rest and all-reduces over the model
    axis."""
    table = params["embed"]
    tokens = tokens.long()
    valid = None
    if tp is not None:
        tokens = tokens - tp.vocab_start
        valid = (tokens >= 0) & (tokens < tp.vocab_local)
        tokens = tokens.clamp(0, tp.vocab_local - 1)
    if is_quantized(table):
        x = (table["q"][tokens].float() * table["s"][tokens]).to(torch_dtype(config.dtype))
    else:
        x = table[tokens]
    if tp is not None:
        x = tp.all_reduce(torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                        device=x.device)))
    if config.embedding_scale:
        key = (config.d_model, x.dtype, str(x.device))
        scale = _EMBED_SCALES.get(key)
        if scale is None:  # cached for capture, as the rope frequencies
            scale = torch.sqrt(torch.tensor(float(config.d_model), dtype=torch.float32))
            scale = scale.to(x.dtype).to(x.device)
            if scale.device.type == "cuda":  # read by other threads' streams too
                torch.cuda.current_stream(scale.device).synchronize()
            scale = _EMBED_SCALES.setdefault(key, scale)
        x = x * scale
    return x


def _unembed(params: Params, x: torch.Tensor, config: ModelConfig,
             tp: Optional[Any] = None) -> torch.Tensor:
    """Final norm and the vocabulary projection → f32 logits. Under tensor
    parallelism (``tp``) the rank's vocabulary columns are gathered to the
    full row before the soft cap (sampling and grammar masks read it)."""
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if config.tie_embeddings:
        table = params["embed"]
        head = dequantize_weight(table, x.dtype) if is_quantized(table) else table
        logits = (x @ head.T).float()
    else:
        logits = quantized_matmul(x, params["lm_head"]).float()
    if tp is not None:
        logits = tp.gather_vocab(logits)
    return softcap(logits, config.final_logit_softcap)


def _cache_layer(cache: KVCache, i: int) -> tuple:
    return (_map(lambda a: a[i], cache["k"]), _map(lambda a: a[i], cache["v"]))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor, config: ModelConfig,
            tp: Optional[Any] = None, ring: Optional[Any] = None) -> torch.Tensor:
    """Full-sequence causal forward → logits [B, S, V] (scoring).

    With ``ring`` (``parallel.sp``) ``tokens`` is this rank's block of the
    sequence: RoPE positions are global (``ring.rank · S`` on) and the
    causal mask lives inside ring attention."""
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    if ring is not None:
        positions = positions + ring.rank * s
    sin, cos = _rope_freqs(positions, config)
    mask = None
    if ring is None and (not kernel_path_ok(config, dev) or s == 1):
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))[None].expand(b, s, s)
    x = _embed(params, tokens, config, tp)
    x, _ = _scan_layers(params, x, sin, cos, mask, config, tp=tp, ring=ring)
    return _unembed(params, x, config, tp)


def _scan_layers(params: Params, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                 mask: Optional[torch.Tensor], config: ModelConfig, collect_kv: bool = False,
                 tp: Optional[Any] = None, ring: Optional[Any] = None) -> tuple:
    """The cache-less layer loop. With ``collect_kv`` each layer's roped
    head-major K/V stack into ``{"k", "v"}`` of ``[L, B, Hkv, S, D]`` — the
    makings of a serving cache (the JAX package's ``_scan_layers(...,
    collect_kv=True)``); else the second result is None."""
    kvs: Optional[list] = [] if collect_kv else None
    for i in range(config.n_layers):
        x = _layer(x, _layer_params(params["layers"], i), sin, cos, mask, config, tp=tp,
                   ring=ring, kv_out=kvs)
    if kvs is None:
        return x, None
    return x, {"k": torch.stack([k for k, _ in kvs]), "v": torch.stack([v for _, v in kvs])}


@torch.no_grad()
def encode(
    params: Params,
    tokens: torch.Tensor,  # [B, S] padded
    lengths: torch.Tensor,  # [B] true lengths
    config: ModelConfig,
) -> torch.Tensor:
    """Mean-pooled, L2-normalised final hidden states → [B, D] f32
    embeddings (the embeddings service's model; the JAX package's
    ``encode``). Each row's real tokens attend to each other both ways
    (``valid[:, None, :] & valid[:, :, None]``) through the reference
    ``attention`` on every device, as the JAX package computes it outside
    any Pallas kernel (the segment kernel is causal); the final norm, then
    an f32 mean over the valid positions (divided by ``max(count, 1)``)
    and ``pooled / max(||pooled||, 1e-9)``. The layers are the serving
    ones: int8 weights through ``quantized_matmul``, MoE configs through
    ``moe_ffn``; no adapter applies."""
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    sin, cos = _rope_freqs(positions, config)
    valid = positions < lengths.long()[:, None]  # [B, S]
    mask = valid[:, None, :] & valid[:, :, None]
    x = _embed(params, tokens, config)
    for i in range(config.n_layers):
        lp = _layer_params(params["layers"], i)
        x = _layer(x, lp, sin, cos, mask, config, causal=False)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    w = valid[:, :, None].float()
    pooled = (x.float() * w).sum(1) / w.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


@torch.no_grad()
def prefill(
    params: Params,
    tokens: torch.Tensor,  # [B, S] padded prompts
    lengths: torch.Tensor,  # [B] true prompt lengths
    cache: KVCache,
    config: ModelConfig,
    lora: Optional[dict] = None,  # the adapter pool (serving/adapters.py)
    adapter_rows: Optional[torch.Tensor] = None,  # [B] pool row per prompt
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """Process prompts, fill cache columns 0..S (in place), return logits at
    the last real token of each prompt ([B, V])."""
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    sin, cos = _rope_freqs(positions, config)
    mask = None
    if not kernel_path_ok(config, dev) or s == 1:
        t = cache_width(cache)
        kv_pos = torch.arange(t, device=dev)[None, None, :]
        mask = (kv_pos <= positions[:, :, None]) & (kv_pos < s)
    index = _dense_index(positions, cache_width(cache), config.n_kv_heads)
    x = _embed(params, tokens, config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(cache, i), cache_index=index,
            lora=_lora_layer(lora, adapter_rows, i),
            tp=tp,
        )
    last = (lengths.long() - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=dev), last]  # [B, D]
    logits = _unembed(params, x_last[:, None, :], config, tp)[:, 0]
    return logits, cache


@torch.no_grad()
def prefill_segment(
    params: Params,
    tokens: torch.Tensor,  # [B, W] one padded prompt segment per row
    offsets: torch.Tensor,  # [B] global position of each row's segment start
    seg_lengths: torch.Tensor,  # [B] true token count within the segment
    cache: KVCache,
    config: ModelConfig,
    kv_bound: Optional[int] = None,  # readable cache columns (>= offset + W where it fits)
    lora: Optional[dict] = None,
    adapter_rows: Optional[torch.Tensor] = None,
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """Chunked prefill: one segment of a longer prompt against a dense cache
    whose columns [0, offsets) were written by earlier segments. Writes the
    segment's K/V at global positions [offsets, offsets + W) in place
    (positions past the cache land in its last, sink column) and attends
    causally over prefix + segment. Returns logits at the last real token
    of the segment ([B, V]) — meaningful only on the final segment."""
    b, s = tokens.shape
    dev = tokens.device
    positions = offsets.long()[:, None] + torch.arange(s, device=dev)[None, :]  # [B, W]
    sin, cos = _rope_freqs(positions, config)
    t = cache_width(cache)
    view = t if kv_bound is None else min(kv_bound, t)
    mask = None
    if not kernel_path_ok(config, dev):
        mask = torch.arange(view, device=dev)[None, None, :] <= positions[:, :, None]
    index = _dense_index(positions, t, config.n_kv_heads)
    kv_offset = offsets.to(torch.int32).contiguous()
    x = _embed(params, tokens, config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(cache, i), cache_index=index,
            kv_offset=kv_offset, kv_bound=kv_bound, lora=_lora_layer(lora, adapter_rows, i),
            tp=tp,
        )
    last = (seg_lengths.long() - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=dev), last]  # [B, D]
    logits = _unembed(params, x_last[:, None, :], config, tp)[:, 0]
    return logits, cache


@torch.no_grad()
def decode_step_inplace(
    params: Params,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B]
    cache: KVCache,  # dense [L, B, Hkv, T, D]
    config: ModelConfig,
    kv_bound: Optional[int] = None,  # readable cache columns
    lora: Optional[dict] = None,
    adapter_rows: Optional[torch.Tensor] = None,
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """One decode step over the dense cache → logits [B, V]; the cache is
    updated in place (positions past it land in its sink column). Each row
    attends to columns [0, position] of the ``[..., :kv_bound]`` view; the
    kernel reads exactly that (its length is clamped to the view), so the
    bound only narrows the reference path's masked read."""
    pos2 = positions.long()[:, None]  # [B, 1]
    dev = tokens.device
    sin, cos = _rope_freqs(pos2, config)
    t = cache_width(cache)
    view = t if kv_bound is None else min(kv_bound, t)
    mask = None
    if not kernel_path_ok(config, dev):
        mask = torch.arange(view, device=dev)[None, None, :] <= pos2[:, :, None]
    lengths = (pos2[:, 0] + 1).to(torch.int32)
    # one index per step serves every layer's K/V scatter
    index = _dense_index(pos2, t, config.n_kv_heads)
    x = _embed(params, tokens[:, None], config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(cache, i), cache_index=index,
            kv_bound=kv_bound, lengths=lengths, lora=_lora_layer(lora, adapter_rows, i),
            tp=tp,
        )
    return _unembed(params, x, config, tp)[:, 0], cache


def dense_verify_queries(positions: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """The kernel path's flattening of a dense verify: the ``s`` queries of
    each of B rows become B*s single-query rows of the dense decode kernel,
    ``s`` a cache row (``queries_per_row``); query j of row b gets the
    length ``positions[b] + j + 1``, capped at the ``width`` columns the
    kernel reads → lengths [B*s] int32. It reads exactly the columns the
    verify's causal mask shows it: its own draft and the ones before, never
    a later (stale or rejected) draft's."""
    pos = positions.long()[:, None] + torch.arange(s, device=positions.device)[None, :]
    return (pos + 1).clamp_max(width).to(torch.int32).reshape(-1)


@torch.no_grad()
def verify_step_inplace(
    params: Params,
    tokens: torch.Tensor,  # [B, K+1]: each row's current token and its K drafts
    positions: torch.Tensor,  # [B] position of each row's first token
    cache: KVCache,  # dense [L, B, Hkv, T, D]
    config: ModelConfig,
    kv_bound: Optional[int] = None,  # readable cache columns
    lora: Optional[dict] = None,
    adapter_rows: Optional[torch.Tensor] = None,  # [B]: a row's adapter serves all K+1
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """Multi-token speculative verify over the dense cache → logits at
    every position ``[B, K+1, V]``; the cache is updated in place. K/V of
    all K+1 inputs are written at ``[positions, positions + K]`` (columns
    past the cache land in its last, sink column). Positions advance only
    past the accepted tokens, so a rejected draft's column is stale until
    the next dispatch overwrites it, before any query can reach it.

    Query j of row b attends to the columns ``<= positions[b] + j`` of the
    ``[..., :kv_bound]`` view (``multitoken_verify_attention``). On the
    kernel path the B*(K+1) queries run through the dense decode kernel as
    single-query rows, K+1 a cache row (``dense_verify_queries``; one
    launch a layer, on CPU tensors its plain version); with
    ``attention_impl="jnp"`` the view is read under the per-slot causal
    mask — what the JAX package's ``verify_step_inplace`` computes.

    An MoE config sends T = B*(K+1) tokens through ``moe_ffn``, as the
    paged verify does."""
    b, s = tokens.shape
    dev = tokens.device
    positions = positions.long()
    pos = positions[:, None] + torch.arange(s, device=dev)[None, :]  # [B, K+1]
    sin, cos = _rope_freqs(pos, config)
    t = cache_width(cache)
    view = t if kv_bound is None else min(kv_bound, t)
    mask, lengths = None, None
    if kernel_path_ok(config, dev):
        lengths = dense_verify_queries(positions, s, view)
    else:
        mask = torch.arange(view, device=dev)[None, None, :] <= pos[:, :, None]
    # one index per verify serves every layer's K/V scatter
    index = _dense_index(pos, t, config.n_kv_heads)
    x = _embed(params, tokens, config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(cache, i), cache_index=index, kv_bound=kv_bound,
            lengths=lengths, lora=_lora_layer(lora, adapter_rows, i), verify=True,
            tp=tp,
        )
    return _unembed(params, x, config, tp), cache


def decode_step(
    params: Params, tokens: torch.Tensor, positions: torch.Tensor, cache: KVCache,
    config: ModelConfig,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step for every slot → logits [B, V], the cache updated in
    place: ``decode_step_inplace`` over the whole width."""
    return decode_step_inplace(params, tokens, positions, cache, config)


@torch.no_grad()
def dense_insert_cache(cache: KVCache, local_cache: KVCache, slots: torch.Tensor) -> KVCache:
    """Copy a prefill's local cache ([L, n, Hkv, W, D], int8 dicts leaf by
    leaf) into rows ``slots`` [n] of the big dense cache, columns [0, W),
    in place — the dense admit group's row insert."""
    for name in ("k", "v"):
        big, small = cache[name], local_cache[name]
        if isinstance(big, dict):
            pairs = [(big[leaf], small[leaf]) for leaf in ("q", "s")]
        else:
            pairs = [(big, small)]
        for dst, src in pairs:
            dst[:, slots, :, : src.shape[3]] = src.to(dst.dtype)
    return cache


@torch.no_grad()
def paged_decode_step_inplace(
    params: Params,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B]
    pool: KVCache,  # page pool [L, P + 1, Hkv, ps, D]
    table: torch.Tensor,  # [B, Tp] physical page per logical page
    config: ModelConfig,
    page_size: int,
    lora: Optional[dict] = None,
    adapter_rows: Optional[torch.Tensor] = None,
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """One decode step through the page table → logits [B, V]; the pool is
    updated in place. Each row reads exactly its mapped pages up to its
    length (position + 1)."""
    positions = positions.long()
    pos2 = positions[:, None]
    sin, cos = _rope_freqs(pos2, config)
    table = table.to(torch.int32).contiguous()
    mask, lengths = None, None
    if kernel_path_ok(config, tokens.device):
        lengths = (positions + 1).to(torch.int32)
    else:
        mask = _paged_mask(table, page_size, pos2)
    # one page lookup per step serves every layer's K/V scatter
    index = _scatter_index(table, pos2, page_size, pool_pages(pool), config.n_kv_heads)
    x = _embed(params, tokens[:, None], config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(pool, i), paged=(table, page_size, lengths, index, None),
            lora=_lora_layer(lora, adapter_rows, i),
            tp=tp,
        )
    return _unembed(params, x, config, tp)[:, 0], pool


@torch.no_grad()
def paged_verify_step_inplace(
    params: Params,
    tokens: torch.Tensor,  # [B, K+1]: each row's current token and its K drafts
    positions: torch.Tensor,  # [B] position of each row's first token
    pool: KVCache,  # page pool [L, P + 1, Hkv, ps, D]
    table: torch.Tensor,  # [B, Tp] physical page per logical page
    config: ModelConfig,
    page_size: int,
    lora: Optional[dict] = None,
    adapter_rows: Optional[torch.Tensor] = None,  # [B]: a row's adapter serves all K+1
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """Multi-token speculative verify through the page table → logits at
    every position ``[B, K+1, V]``; the pool is updated in place. K/V of all
    K+1 inputs scatter at ``[positions, positions + K]`` (unmapped pages and
    columns past the table into the sink). Positions advance only past the
    accepted tokens, so a rejected draft's column is stale until the next
    dispatch overwrites it, before any query can reach it.

    Query j of row b attends to the columns ``<= positions[b] + j``. On the
    kernel path the B*(K+1) queries run through the paged decode kernel as
    single-query rows (``verify_queries``): one launch a layer, the kernel
    math of plain decode (on CPU tensors, its plain version). With
    ``attention_impl="jnp"`` the gathered table is read under the causal
    mask — the JAX package's ``multitoken_verify_attention``.

    An MoE config sends T = B*(K+1) tokens through ``moe_ffn``: the
    capacity floor keeps C = T while T <= 64 (max batch 8 at K 4 is 40), so
    no verify token is dropped and a row's logits do not depend on the
    other rows'."""
    b, s = tokens.shape
    dev = tokens.device
    positions = positions.long()
    pos = positions[:, None] + torch.arange(s, device=dev)[None, :]  # [B, K+1]
    sin, cos = _rope_freqs(pos, config)
    table = table.to(torch.int32).contiguous()
    mask, lengths, read_table = None, None, table
    if kernel_path_ok(config, dev):
        read_table, lengths = verify_queries(table, positions, s, page_size)
    else:
        mask = _paged_mask(table, page_size, pos)
    # one page lookup per verify serves every layer's K/V scatter
    index = _scatter_index(table, pos, page_size, pool_pages(pool), config.n_kv_heads)
    x = _embed(params, tokens, config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(pool, i), paged=(read_table, page_size, lengths, index, None),
            lora=_lora_layer(lora, adapter_rows, i),
            tp=tp,
        )
    return _unembed(params, x, config, tp), pool


@torch.no_grad()
def paged_prefill_segment_inplace(
    params: Params,
    tokens: torch.Tensor,  # [B, W] one padded prompt segment per row
    offsets: torch.Tensor,  # [B] global position of each row's segment start
    seg_lengths: torch.Tensor,  # [B] true token count within the segment
    pool: KVCache,  # page pool [L, P + 1, Hkv, ps, D]
    table: torch.Tensor,  # [B, Tp] physical page per logical page
    config: ModelConfig,
    page_size: int,
    kv_bound: Optional[int] = None,  # readable columns: max(offsets) + W when None
    lora: Optional[dict] = None,
    adapter_rows: Optional[torch.Tensor] = None,
    tp: Optional[Any] = None,  # tensor parallelism (parallel.sharding)
) -> tuple[torch.Tensor, KVCache]:
    """Chunked prefill straight into the slots' pages: the segment's K/V
    scatter at global positions [offsets, offsets + W) through the table
    (unmapped pages into the sink) and attention reads the prefix through
    the table; the pool is updated in place. Returns logits at the last
    real token of each row's segment ([B, V]) — meaningful only on a
    prompt's final segment. On the kernel path the pages below
    ``min(kv_bound, Tp * ps)`` are gathered and the segment kernel reads
    them through a ``[..., :bound]`` view, so nothing past the widest
    row's frontier is read; ``kv_bound`` None derives it from ``offsets``
    (a device sync where they lie on the card). The reference path reads
    the whole gathered table under the causal mask."""
    b, s = tokens.shape
    dev = tokens.device
    offsets = offsets.long()
    positions = offsets[:, None] + torch.arange(s, device=dev)[None, :]  # [B, W]
    sin, cos = _rope_freqs(positions, config)
    table = table.to(torch.int32).contiguous()
    sink = pool_pages(pool)
    mask, segment = None, None
    if kernel_path_ok(config, dev):
        if kv_bound is None:
            kv_bound = int(offsets.max()) + s
        bound = min(kv_bound, table.shape[1] * page_size)
        pages = table[:, : -(-bound // page_size)].long().clamp(0, sink)
        # one row index per segment serves every layer's gather
        segment = (_page_rows(pages, config.n_kv_heads), bound)
    else:
        mask = _paged_mask(table, page_size, positions)
    # one page lookup per segment serves every layer's K/V scatter
    index = _scatter_index(table, positions, page_size, sink, config.n_kv_heads)
    kv_offset = offsets.to(torch.int32).contiguous()
    x = _embed(params, tokens, config, tp)
    for i in range(config.n_layers):
        x = _layer(
            x, _layer_params(params["layers"], i), sin, cos, mask, config,
            cache_kv=_cache_layer(pool, i), paged=(table, page_size, None, index, segment),
            kv_offset=kv_offset, lora=_lora_layer(lora, adapter_rows, i),
            tp=tp,
        )
    last = (seg_lengths.long() - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=dev), last]  # [B, D]
    logits = _unembed(params, x_last[:, None, :], config, tp)[:, 0]
    return logits, pool


@torch.no_grad()
def page_copy(pool: KVCache, src: int, dst: int) -> KVCache:
    """Copy ONE physical page across every layer and kv head, in place, for
    every leaf (K and V; an int8 pool's codes and scales alike): the
    copy-on-write a prefix alias needs when the cached prefix ends
    mid-page. The page axis is axis 1 of every leaf (``[L, P + 1, Hkv, ps,
    ...]``). Both indices clamp into ``[0, P]``, so a destination at the
    sink (the sentinel) writes only the sink page, the port's drop."""
    sink = pool_pages(pool)
    src, dst = min(max(int(src), 0), sink), min(max(int(dst), 0), sink)
    for name in ("k", "v"):
        for leaf in (pool[name].values() if isinstance(pool[name], dict) else (pool[name],)):
            leaf[:, dst].copy_(leaf[:, src])
    return pool


@torch.no_grad()
def paged_insert_cache(
    pool: KVCache, local_cache: KVCache, tables: torch.Tensor, page_size: int
) -> KVCache:
    """Scatter a batched prefill's local cache ([L, n, Hkv, W, D], the admit
    group's temporary) into each row's pages, in place. Positions are
    [0, W) per row; sentinel table entries (padding rows, logical pages the
    row does not own) write into the sink page."""
    n = tables.shape[0]

    def put(pl_entry: torch.Tensor, loc: torch.Tensor) -> None:
        w = loc.shape[3]
        sink = pl_entry.shape[1] - 1
        positions = torch.arange(w, device=loc.device)[None, :].expand(n, w)
        pages, offs = _page_index(tables, positions, page_size, sink)
        pidx = pages.clamp(0, sink)[:, None, :]  # [n, 1, W]
        oidx = offs[:, None, :]
        hidx = torch.arange(loc.shape[2], device=loc.device)[None, :, None]
        pl_entry[:, pidx, hidx, oidx] = loc.to(pl_entry.dtype)

    for name in ("k", "v"):
        if isinstance(pool[name], dict):
            for leaf in ("q", "s"):
                put(pool[name][leaf], local_cache[name][leaf])
        else:
            put(pool[name], local_cache[name])
    return pool
