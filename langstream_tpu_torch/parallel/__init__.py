"""Mesh, sharding and the SPMD serving plane — the port's counterpart of
``langstream_tpu/parallel/``. One process a card: a mesh is a set of
``torch.distributed`` ranks with one process group a mesh axis, tensor
parallelism is explicit collectives in the model (``sharding.TensorParallel``)
and every rank runs the same dispatches in the same order because the
leader announces each one (``spmd_serving``); a "seq" axis splits a long
prompt's prefill over a ring of ranks (``ring_attention``, ``sp``)."""

from langstream_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh, build_mesh, mesh_from_tpu_spec
from langstream_tpu_torch.parallel.sharding import param_specs, shard_params

__all__ = [
    "AXIS_ORDER",
    "Mesh",
    "build_mesh",
    "mesh_from_tpu_spec",
    "param_specs",
    "shard_params",
]
