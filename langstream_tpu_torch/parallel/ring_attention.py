"""Ring attention: causal attention with the sequence axis split over the
ranks of a mesh's "seq" axis — the port's ``parallel/ring_attention.py``.

Each rank holds one sequence block of Q/K/V; the K/V blocks rotate around
the ring (rank r sends to r + 1 and receives from r - 1, ``permute``)
while an f32 online softmax (the flash-attention m / l / acc accumulators)
folds in one block's contribution a step. The fold is the JAX package's,
line for line, in plain PyTorch: the JAX package computes it in jnp
outside any Pallas kernel, so there is no kernel to port here.

The JAX package finds its ring through ``ModelConfig.ring_axis`` under
``shard_map``; the port passes a ring handle to the model instead, the
way it passes ``tp``:

- ``SeqRing``: the ranks of a mesh's "seq" group over ``torch.distributed``
  (NCCL on cards, gloo on the CPU) — ``dist.batch_isend_irecv`` for the
  rotation, ``all_reduce`` / an all-gather into one tensor for the sum and
  the gather;
- ``parallel.spmd_serving.LoopbackRing``: ranks of one process (a
  loopback pair's two engines on one card, or threads on the CPU), for
  tests and ``chip_smoke.py``.

A handle has ``n`` and ``rank``, ``permute(*tensors)``, ``all_reduce(x)``
(sum) and ``all_gather(x)`` (``[n, *x.shape]`` in rank order)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from langstream_tpu_torch.models.configs import ModelConfig

_NEG = -1e30

# the most f32 score elements one fold step materialises: the JAX package
# makes [B, Hkv, g, Sl, Sl] at once (2.1 GB at llama-3-8b with Sl 4096);
# the port folds query rows in tiles of at most this many scores
FOLD_TILE_SCORES = 1 << 26


class SeqRing:
    """The ranks of this rank's "seq" group of a ``parallel.mesh.Mesh``."""

    def __init__(self, mesh: Any) -> None:
        import torch.distributed as dist

        self.group = mesh.group("seq")
        if self.group is None:
            raise ValueError("a ring over the seq axis needs the mesh's device groups")
        self.n = int(mesh.shape["seq"])
        self.rank = int(mesh.coords["seq"])
        # global ranks of the group in seq order (the other coordinates
        # fixed, rank order is seq order)
        self.ranks = sorted(dist.get_process_group_ranks(self.group))
        self.next = self.ranks[(self.rank + 1) % self.n]
        self.prev = self.ranks[(self.rank - 1) % self.n]

    def permute(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """Send each tensor to the next rank and receive the previous
        rank's, in one batch (every rank takes part, or the ring hangs)."""
        import torch.distributed as dist

        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.next, self.group))
            ops.append(dist.P2POp(dist.irecv, o, self.prev, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return outs

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        # the ranks' tensors concatenated along dim 0 (the form every
        # backend takes); all_gather_single is its newer name
        out = torch.empty((self.n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x, group=self.group)
        return out.reshape((self.n,) + tuple(x.shape))

    def warm(self, device: torch.device) -> None:
        """One eager permute: the first P2P on an NCCL group may make a
        communicator of its own, which must not happen inside a capture."""
        self.permute(torch.zeros(1, device=device))


def seq_ring(mesh: Optional[Any]) -> Optional[SeqRing]:
    """The ring handle of a mesh whose "seq" axis is above 1 (its device
    groups built), else None."""
    if mesh is None or int(mesh.shape.get("seq", 1)) <= 1:
        return None
    return SeqRing(mesh)


def ring_attention(
    q: torch.Tensor,  # [B, Sl, H, D] local query block
    k: torch.Tensor,  # [B, Sl, Hkv, D] local key block
    v: torch.Tensor,  # [B, Sl, Hkv, D] local value block
    config: ModelConfig,
    ring: Any,
) -> torch.Tensor:
    """Causal GQA attention over the ring → [B, Sl, H*D] local output.
    Block r on rank r covers global positions [r·Sl, (r+1)·Sl). Under
    tensor parallelism ``config`` holds the rank's heads and the fold runs
    over them."""
    n, my = ring.n, ring.rank
    h, hkv = config.n_heads, config.n_kv_heads
    group = h // hkv
    b, sl, _, d = q.shape
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=dev))

    qg = q.reshape(b, sl, hkv, group, d)
    q_pos = my * sl + torch.arange(sl, device=dev)  # global positions of local queries

    # f32 online-softmax state
    m = torch.full((b, hkv, group, sl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, group, sl), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sl, hkv, group, d), dtype=torch.float32, device=dev)
    # each query row's softmax is its own, so the rows fold in tiles (the
    # same math as one [.., Sl, Sl] block, a fraction of its transients)
    tile = max(1, min(sl, FOLD_TILE_SCORES // max(1, b * h * sl)))

    def fold(k_blk: torch.Tensor, v_blk: torch.Tensor, src: int) -> None:
        kv_pos = src * sl + torch.arange(sl, device=dev)
        for r0 in range(0, sl, tile):
            r1 = min(sl, r0 + tile)
            scores = torch.einsum("bshgd,bthd->bhgst", qg[:, r0:r1], k_blk).float() * scale
            if config.attn_logit_softcap is not None:
                cap = torch.tensor(config.attn_logit_softcap, dtype=torch.float32, device=dev)
                scores = torch.tanh(scores / cap) * cap
            causal = kv_pos[None, :] <= q_pos[r0:r1, None]  # [rows, T]
            scores = torch.where(causal[None, None, None], scores, _NEG)
            m_old = m[..., r0:r1]
            m_new = torch.maximum(m_old, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])  # [B,h,g,rows,T]
            # fully-masked rows: scores=-1e30, m_new=-1e30 → p=1 — zero them
            p = torch.where(scores <= _NEG, 0.0, p)
            corr = torch.exp(m_old - m_new)
            l[..., r0:r1] = l[..., r0:r1] * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgst,bthd->bshgd", p.to(v_blk.dtype), v_blk).float()
            acc[:, r0:r1] = acc[:, r0:r1] * corr.permute(0, 3, 1, 2)[..., None] + pv
            m[..., r0:r1] = m_new

    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n  # which rank's block this rank holds at this step
        # causal block skip: a block wholly in this rank's future (src > my)
        # has every score masked — skip both products; the exchange below
        # stays outside the skip (every rank takes part in every step)
        if src <= my:
            fold(k_blk, v_blk, src)
        if i + 1 < n:  # the n-th exchange would only hand blocks back: no rank makes it
            k_blk, v_blk = ring.permute(k_blk, v_blk)
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype).reshape(b, sl, h * d)
