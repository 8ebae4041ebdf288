"""Sequence parallelism entry points — the port's ``parallel/sp.py``.

``sequence_parallel_forward`` runs the full-sequence forward with the
sequence split over the mesh's "seq" axis and ring attention exchanging
K/V blocks between the ranks; ``ring_prefill`` is the serving engine's
one-dispatch long-prompt prefill over the same split. Both take the JAX
package's arguments less its ``Mesh``: the port's mesh, or a ring handle
(``parallel.ring_attention``), and ``tp`` for tensor parallelism (the
weights are replicated over the seq axis, so a rank holds the same slices
as its model-axis peers of the other seq ranks). Every rank calls them
with the whole ``tokens``; each computes its own block."""

from __future__ import annotations

from typing import Any, Optional

import torch

from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.models.transformer import (
    Params,
    _embed,
    _rope_freqs,
    _scan_layers,
    _unembed,
    forward,
)
from langstream_tpu_torch.parallel.mesh import Mesh
from langstream_tpu_torch.parallel.ring_attention import seq_ring


def _ring(mesh_or_ring: Any) -> Any:
    """A ring handle from the port's mesh, or the handle itself."""
    return seq_ring(mesh_or_ring) if isinstance(mesh_or_ring, Mesh) else mesh_or_ring


@torch.no_grad()
def sequence_parallel_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, S] with S divisible by the seq axis
    config: ModelConfig,
    mesh: Any,
    tp: Optional[Any] = None,
) -> torch.Tensor:
    """Logits [B, S, V]; S split over the seq axis during compute (each
    rank's block gathered back over the ring)."""
    ring = _ring(mesh)
    n = ring.n
    b, s = tokens.shape
    if s % n != 0:
        raise ValueError(
            f"sequence length {s} must be divisible by the 'seq' axis size {n} (pad the batch)"
        )
    sl = s // n
    local = tokens[:, ring.rank * sl:(ring.rank + 1) * sl]
    logits = forward(params, local, config, tp=tp, ring=ring)  # [B, Sl, V]
    blocks = ring.all_gather(logits)  # [n, B, Sl, V]
    return blocks.permute(1, 0, 2, 3).reshape(b, s, -1)


@torch.no_grad()
def ring_prefill(
    params: Params,
    tokens: torch.Tensor,  # [B, S_pad] padded prompts, S_pad divisible by the seq axis
    lengths: torch.Tensor,  # [B] true prompt lengths
    config: ModelConfig,
    mesh: Any,
    tp: Optional[Any] = None,
) -> tuple[torch.Tensor, dict]:
    """One-dispatch long-prompt prefill with the sequence split over the
    ring: rank r embeds prompt block r at global positions ``r·Sl`` on,
    ring attention rotates the K/V blocks, and every layer's roped K/V of
    the block comes back for the serving cache's splice. Returns (the last
    real token's logits [B, V], identical on every rank; ``{"k", "v"}`` of
    ``[L, B, Hkv, Sl, D]``: this rank's block of positions, as the JAX
    package's result is sharded)."""
    ring = _ring(mesh)
    n = ring.n
    b, s = tokens.shape
    if s % n != 0:
        raise ValueError(
            f"padded prompt length {s} must be divisible by the 'seq' axis size {n}"
        )
    sl = s // n
    my = ring.rank
    dev = tokens.device
    local = tokens[:, my * sl:(my + 1) * sl]
    positions = torch.arange(sl, device=dev).expand(b, sl) + my * sl
    sin, cos = _rope_freqs(positions, config)
    x = _embed(params, local, config, tp)
    x, kv = _scan_layers(params, x, sin, cos, None, config, collect_kv=True, tp=tp, ring=ring)
    # the last real token lives in exactly one rank's block: that rank
    # contributes its hidden state, every other rank zeros, the sum selects
    last = (lengths.long() - 1).clamp(0, s - 1)  # [B] global index
    idx = (last - my * sl).clamp(0, sl - 1)
    own = (last // sl) == my  # [B]
    x_last = x[torch.arange(b, device=dev), idx]  # [B, D]
    x_last = torch.where(own[:, None], x_last, torch.zeros_like(x_last))
    x_last = ring.all_reduce(x_last.contiguous())
    logits = _unembed(params, x_last[:, None, :], config, tp)[:, 0]
    return logits, kv
