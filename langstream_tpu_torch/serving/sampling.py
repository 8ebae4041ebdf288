"""Token sampling: greedy / temperature / top-k / top-p, batched on the
device (port of ``langstream_tpu/serving/sampling.py``).

Per-slot sampling params are tensors so one call serves a heterogeneous
continuous batch. The JAX package gates the sort and the random draw with
``lax.cond`` on device-side predicates; here a Python branch would cost a
host sync, so the caller passes the two predicates it already knows on the
host (``any_sample``, ``any_filter``) and they are only computed from the
tensors when it does not. Random draws come from an explicit
``torch.Generator`` (gumbel-max, the same construction as
``jax.random.categorical``); the bits differ from JAX's, so sampled outputs
agree in distribution only. Greedy is exact.

``sample`` syncs with nothing when both predicates are given, so the
engine's captured decode chunk can hold it: the engine registers its
generator with each CUDA graph (``CUDAGraph.register_generator_state``),
and every replay then advances the generator's Philox offset — a replay
draws fresh numbers, never the captured ones again.
"""

from __future__ import annotations

from typing import Optional

import torch


def _greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab with first-index tie semantics, at any vocab
    width. ``torch.argmax`` returns the first maximal index, so the JAX
    package's two-stage form (a TPU lane-layout device, padding ragged
    vocabs with -inf) is one call here; an all -inf row resolves to 0."""
    return torch.argmax(logits, dim=-1)


def _apply_filters(s: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """top-k + top-p cutoffs over [R, V] scaled logits with per-row params
    (0 / 1.0 = disabled); one descending sort serves both."""
    v = s.shape[-1]
    sorted_desc = torch.sort(s, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, torch.full_like(top_k, v)) - 1).clamp(0, v - 1).long()
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    ranks = torch.arange(v, device=s.device)[None, :]
    neg_inf = torch.full_like(sorted_desc, float("-inf"))
    sorted_masked = torch.where(ranks <= k_idx[:, None], sorted_desc, neg_inf)
    probs = torch.softmax(sorted_masked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # cumulative prob EXCLUSIVE < p; top_p >= 1 keeps every token even
    # where the f32 cumsum rounds the tail's exclusive mass up to 1.0
    keep = ((cum - probs) < top_p[:, None]) | (top_p >= 1.0)[:, None]
    cutoff = torch.where(keep, sorted_masked, -neg_inf).amin(dim=-1, keepdim=True)
    return torch.where(s < torch.maximum(kth, cutoff), float("-inf"), s)


def sample(
    logits: torch.Tensor,  # [B, V] f32
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int, 0 = disabled
    top_p: torch.Tensor,  # [B] f32, 1.0 = disabled
    any_sample: Optional[bool] = None,
    any_filter: Optional[bool] = None,
) -> torch.Tensor:
    """Sampled token ids [B] (int64). Temperature 0 → greedy for that row.

    NaN guard: a row whose logits hold any non-finite value returns the
    sentinel ``-1`` instead of a token; the engine fails that request.

    ``any_sample`` / ``any_filter``: whether some row samples (temperature
    > 0) and whether some sampling row filters (top-k / top-p). None reads
    them off the tensors, which syncs with the device."""
    finite = torch.isfinite(logits).all(dim=-1)
    greedy = _greedy_argmax(logits)
    if any_sample is None:
        any_sample = bool((temperature > 0.0).any())
    out = greedy
    if any_sample:
        scaled = logits / temperature.clamp_min(1e-6)[:, None]
        if any_filter is None:
            any_filter = bool(((temperature > 0.0) & ((top_k > 0) | (top_p < 1.0))).any())
        if any_filter:
            scaled = _apply_filters(scaled, top_k, top_p)
        u = torch.rand(
            scaled.shape, generator=generator, device=scaled.device, dtype=torch.float32
        )
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        sampled = torch.argmax(scaled + gumbel, dim=-1)
        out = torch.where(temperature <= 0.0, greedy, sampled)
    return torch.where(finite, out, torch.full_like(out, -1))
