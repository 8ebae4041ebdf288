"""Rank meshes from axis dicts: the port's ``parallel/mesh.py``.

Axes (any may be size 1): "data" (replicas of the whole model), "expert"
(MoE experts), "seq" (sequence parallelism: the ring prefill of long
prompts, ``ring_attention.SeqRing`` over the axis's group; the weights
and the serving cache are replicated over it) and "model" (tensor
parallelism). The axis order is the JAX package's, "model"
innermost: rank ``r`` sits where device ``r`` sits in the JAX mesh's
device array for the same axes (``np.unravel_index`` over the axis sizes),
so the ranks of one tensor-parallel group are consecutive — on one host,
neighbouring cards.

One process a rank. ``build_mesh`` makes one process group an axis (the
ranks that share every other coordinate), plus one over the expert and
model axes together (the MoE layer's reduction), with ``dist.new_group``
in the same order on every rank, as ``new_group`` requires. Those are the
DEVICE groups the model's collectives run on: NCCL on the card, gloo on
the CPU. The control plane (the SPMD wire) uses a gloo group over the
whole mesh, whatever the device."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

AXIS_ORDER = ("data", "expert", "seq", "model")


@dataclass
class Mesh:
    """This rank's place in a mesh of ``world`` ranks."""

    shape: dict[str, int]  # every axis of AXIS_ORDER, missing ones 1
    rank: int = 0
    world: int = 1
    coords: dict[str, int] = field(default_factory=dict)
    # axis name (or "expert+model") → this rank's device process group
    groups: dict[str, Any] = field(default_factory=dict)
    # gloo group over every rank of the mesh: the control plane
    control_group: Any = None
    # "nccl" or "gloo": the backend of the device groups (None: no groups,
    # a mesh outside torch.distributed)
    device_backend: Optional[str] = None

    @property
    def tensor_parallel(self) -> int:
        """Ranks the model's weights are split over (expert x model)."""
        return self.shape["expert"] * self.shape["model"]

    def group(self, axis: str) -> Any:
        return self.groups.get(axis)


def axis_sizes(axes: dict[str, int]) -> list[int]:
    unknown = set(axes) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: {list(AXIS_ORDER)}")
    sizes = [int(axes.get(a, 1)) for a in AXIS_ORDER]
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh {axes}: every axis must be >= 1")
    return sizes


def rank_coords(rank: int, axes: dict[str, int]) -> dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: its place in the row-major
    array of the axis sizes — where device ``rank`` sits in the JAX mesh."""
    sizes = axis_sizes(axes)
    return {a: int(c) for a, c in zip(AXIS_ORDER, np.unravel_index(rank, sizes))}


def _group_ranks(sizes: list[int], axes_in: tuple[int, ...]) -> list[list[int]]:
    """Every group of ranks that differ only on the axes ``axes_in``
    (indices into AXIS_ORDER), in a fixed order: the other axes' coordinates
    row-major."""
    others = [i for i in range(len(sizes)) if i not in axes_in]
    out = []
    for fixed in itertools.product(*(range(sizes[i]) for i in others)):
        ranks = []
        for free in itertools.product(*(range(sizes[i]) for i in axes_in)):
            coord = [0] * len(sizes)
            for i, c in zip(others, fixed):
                coord[i] = c
            for i, c in zip(axes_in, free):
                coord[i] = c
            ranks.append(int(np.ravel_multi_index(coord, sizes)))
        out.append(sorted(ranks))
    return out


def build_mesh(axes: dict[str, int], device_backend: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh`` over ``axes`` (missing axes size 1). Outside
    ``torch.distributed`` (never initialized) it is a world-1 mesh with no
    groups. Inside it the axis product must equal the world size; every
    rank makes the same groups in the same order: for each axis in
    AXIS_ORDER, then for expert and model together, one group a
    combination of the other coordinates (``device_backend``: "nccl" or
    "gloo"; None makes no device groups), and one gloo group over the
    whole mesh for the control plane."""
    import torch.distributed as dist

    sizes = axis_sizes(axes)
    need = int(np.prod(sizes))
    shape = dict(zip(AXIS_ORDER, sizes))
    if not (dist.is_available() and dist.is_initialized()):
        if need > 1:
            raise ValueError(
                f"mesh {axes} needs {need} ranks; torch.distributed is not initialized"
            )
        return Mesh(shape=shape, coords=rank_coords(0, axes))
    world, rank = dist.get_world_size(), dist.get_rank()
    if need != world:
        raise ValueError(f"mesh {axes} needs {need} ranks, the process group has {world}")
    mesh = Mesh(shape=shape, rank=rank, world=world, coords=rank_coords(rank, axes),
                device_backend=device_backend)
    mesh.control_group = dist.new_group(list(range(world)), backend="gloo")
    if device_backend is None:
        return mesh
    families = [((i,), name) for i, name in enumerate(AXIS_ORDER)]
    families.append(((1, 3), "expert+model"))
    for axes_in, name in families:
        for ranks in _group_ranks(sizes, axes_in):
            group = dist.new_group(ranks, backend=device_backend)
            if rank in ranks:
                mesh.groups[name] = group
    return mesh


def mesh_from_tpu_spec(spec: Any, device_backend: Optional[str] = None) -> Mesh:
    """The mesh a resource spec asks for (an object with a ``.mesh`` dict,
    as the JAX package's ``TpuSpec``), or a world-1 ``{model: 1}`` mesh."""
    axes = getattr(spec, "mesh", None) if spec is not None else None
    if not axes:
        return build_mesh({"model": 1}, device_backend)
    return build_mesh(dict(axes), device_backend)


def single_device_mesh() -> Mesh:
    """A world-1 mesh with no process groups."""
    return Mesh(shape={a: 1 for a in AXIS_ORDER}, coords={a: 0 for a in AXIS_ORDER})
