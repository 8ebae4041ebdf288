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

``speculative_verify`` scores the drafts of self-speculative decoding the
same way: greedy rows accept the longest draft prefix that matches the
argmax chain (exact), sampled rows run lossless rejection sampling against
the point-mass draft (uniforms from the same generator for the accept
tests, gumbel-max for the corrections), so it too can sit inside a graph.

Both take a grammar mask (``allowed``, constrained decoding): the packed
legality bitmask of ``serving/constrain.py`` — int32 words holding the JAX
package's uint32 bit pattern, expanded on the device by
``_expand_allowed`` — or a ``[..., V]`` bool mask. Illegal tokens drop to
-inf after the NaN guard's finite check and before the argmax and the
filters.
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


def _expand_allowed(allowed: torch.Tensor, vocab: int) -> torch.Tensor:
    """Grammar mask → ``[..., V]`` bool. A packed ``[..., ceil(V/32)]``
    int32 bitmask (token t → bit t % 32 of word t // 32, LSB first) is
    expanded with one shift and AND: an arithmetic shift sign-extends, but
    ``& 1`` reads only bit 0, so the bits are the uint32 pattern's. A bool
    mask passes through."""
    if allowed.dtype == torch.bool:
        return allowed
    shifts = torch.arange(32, dtype=allowed.dtype, device=allowed.device)
    bits = (allowed[..., None] >> shifts) & 1  # [..., W, 32]
    flat = bits.reshape(*allowed.shape[:-1], allowed.shape[-1] * 32)
    return flat[..., :vocab].bool()


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
    allowed: Optional[torch.Tensor] = None,  # [B, W] packed int32 / [B, V] bool
) -> torch.Tensor:
    """Sampled token ids [B] (int64). Temperature 0 → greedy for that row.

    NaN guard: a row whose logits hold any non-finite value returns the
    sentinel ``-1`` instead of a token; the engine fails that request.
    ``allowed`` masks illegal tokens to -inf AFTER that check (a grammar's
    own -inf columns are not a fault) and before the argmax and the
    filters; the DFA's no-dead-end invariant leaves every row a legal
    token.

    ``any_sample`` / ``any_filter``: whether some row samples (temperature
    > 0) and whether some sampling row filters (top-k / top-p). None reads
    them off the tensors, which syncs with the device."""
    finite = torch.isfinite(logits).all(dim=-1)
    if allowed is not None:
        logits = logits.masked_fill(~_expand_allowed(allowed, logits.shape[-1]), float("-inf"))
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


def speculative_verify(
    logits: torch.Tensor,  # [B, K+1, V] f32: next-token logits after each verify input
    drafts: torch.Tensor,  # [B, K] int: the drafts being verified
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int, 0 = disabled
    top_p: torch.Tensor,  # [B] f32, 1.0 = disabled
    any_sample: Optional[bool] = None,
    any_filter: Optional[bool] = None,
    allowed: Optional[torch.Tensor] = None,  # [B, K+1, W] packed int32 / [B, K+1, V] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched draft verification → ``(out [B, K+1], accept [B])`` (int64).

    Position j of ``logits`` is the model's next-token distribution after
    verify input j (input 0: the slot's current token; 1..K: the drafts).
    ``accept`` drafts were accepted and the emitted tokens are ``out[:,
    :accept + 1]``: ``out[:, j] == drafts[:, j]`` for j < accept, and
    ``out[:, accept]`` is the correction (greedy: the argmax the draft
    missed; sampled: a draw from the residual) or, at accept == K, the
    bonus token of the last position.

    Greedy rows (temperature <= 0) accept the longest prefix matching the
    argmax chain: token-exact with plain greedy decode. Sampled rows accept
    draft d with probability p(d) (q(d) = 1 for the n-gram draft) and on
    the first rejection draw from p with d removed, renormalized, so the
    emitted marginal is exactly p. The per-row filters repeat across the
    K+1 positions. The bonus column K is drawn unmasked: it is handled
    apart from the draft columns instead of by an out-of-bounds scatter
    (which torch raises on where the JAX package's ``mode="drop"``
    discards).

    NaN guard (as ``sample``): a row with any non-finite value among its
    K+1 positions emits ``-1`` with accept 0.

    ``allowed``: position j's grammar mask, from the DFA state after drafts
    0..j-1 (``constrain.verify_states``), applied after the finite check as
    in ``sample``: an illegal draft's -inf logit never matches the argmax
    and has p(d) = 0, so it is rejected exactly where masked decode would
    have emitted something else.

    ``any_sample`` / ``any_filter``: the host predicates ``sample`` takes;
    None reads them off the tensors, which syncs with the device."""
    b, k1, v = logits.shape
    k = k1 - 1
    drafts = drafts.long()
    finite = torch.isfinite(logits.reshape(b, -1)).all(dim=-1)  # [B]
    if allowed is not None:
        logits = logits.masked_fill(~_expand_allowed(allowed, v), float("-inf"))
    greedy = _greedy_argmax(logits)  # [B, K+1]
    acc = drafts == greedy[:, :k]  # [B, K]
    corr = greedy
    if any_sample is None:
        any_sample = bool((temperature > 0.0).any())
    if any_sample:
        temp = temperature.clamp_min(1e-6)[:, None, None]
        flat = (logits / temp).reshape(b * k1, v)
        if any_filter is None:
            any_filter = bool(((temperature > 0.0) & ((top_k > 0) | (top_p < 1.0))).any())
        if any_filter:
            flat = _apply_filters(
                flat, top_k[:, None].expand(b, k1).reshape(-1),
                top_p[:, None].expand(b, k1).reshape(-1),
            )
        filtered = flat.reshape(b, k1, v)
        probs = torch.softmax(filtered, dim=-1)
        u = torch.rand((b, k), generator=generator, device=logits.device, dtype=torch.float32)
        p_draft = torch.gather(probs[:, :k], 2, drafts[..., None])[..., 0]
        sampled_acc = u < p_draft
        # corrections: each draft column with its draft removed; the bonus
        # column keeps every token. A column whose draft had p(d) = 1 is all
        # -inf, and is read only after a rejection, which cannot happen.
        removed = torch.zeros((b, k1, v), dtype=torch.bool, device=logits.device)
        removed[:, :k].scatter_(2, drafts[..., None], True)
        residual = filtered.masked_fill(removed, float("-inf"))
        g = torch.rand((b, k1, v), generator=generator, device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(g.clamp_min(torch.finfo(torch.float32).tiny)))
        sampled_corr = torch.argmax(residual + gumbel, dim=-1)
        is_greedy = (temperature <= 0.0)[:, None]
        acc = torch.where(is_greedy, acc, sampled_acc)
        corr = torch.where(is_greedy, greedy, sampled_corr)
    # accepted length: the longest all-accepted prefix
    accept = torch.cumprod(acc.long(), dim=-1).sum(dim=-1)  # [B]
    padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)  # [B, K+1]
    cols = torch.arange(k1, device=logits.device)[None, :]
    out = torch.where(cols < accept[:, None], padded, corr)
    accept = torch.where(finite, accept, torch.zeros_like(accept))
    out = torch.where(finite[:, None], out, torch.full_like(out, -1))
    return out, accept
