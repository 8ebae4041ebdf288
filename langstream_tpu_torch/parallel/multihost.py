"""Multi-host bootstrap: one logical replica spanning N pods, each pod one
rank of a ``torch.distributed`` process group — the port's
``parallel/multihost.py``, with the JAX package's environment contract:

  LANGSTREAM_TPU_HOSTS              pods per logical replica (default 1)
  LANGSTREAM_TPU_SERVICE            headless service for peer DNS
  LANGSTREAM_TPU_COORDINATOR_PORT   the rendezvous port (default 8476)
  POD_NAME                          StatefulSet ordinal source (downward API)

Pod ordinal o → process_index = o % hosts, replica_index = o // hosts;
process 0 of each group hosts the rendezvous AND is the only pod that
opens the broker consumer (the SPMD leader, ``spmd_serving``).
``bootstrap`` is ``torch.distributed.init_process_group`` over gloo at the
coordinator: the control plane always rides gloo; the device collectives
get NCCL groups of their own (``mesh.build_mesh``)."""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Mapping, Optional

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476


@dataclass(frozen=True)
class DistributedConfig:
    """One pod's place in its logical replica's process group."""

    num_processes: int = 1
    process_index: int = 0
    replica_index: int = 0
    coordinator: str = ""  # host:port of process 0 (empty when single-host)

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1

    @property
    def is_leader(self) -> bool:
        """The pod that owns the broker consumer for this replica."""
        return self.process_index == 0

    @staticmethod
    def from_env(env: Optional[Mapping[str, str]] = None) -> "DistributedConfig":
        env = os.environ if env is None else env
        hosts = int(env.get("LANGSTREAM_TPU_HOSTS", "1") or 1)
        if hosts <= 1:
            return DistributedConfig()
        pod_name = env.get("POD_NAME", "")
        base, _, tail = pod_name.rpartition("-")
        if not tail.isdigit():
            raise ValueError(
                f"LANGSTREAM_TPU_HOSTS={hosts} requires a StatefulSet POD_NAME "
                f"with an ordinal suffix, got {pod_name!r}"
            )
        ordinal = int(tail)
        service = env.get("LANGSTREAM_TPU_SERVICE", "")
        port = int(env.get("LANGSTREAM_TPU_COORDINATOR_PORT", DEFAULT_COORDINATOR_PORT))
        group_start = (ordinal // hosts) * hosts
        coordinator_pod = f"{base}-{group_start}"
        host = f"{coordinator_pod}.{service}" if service else coordinator_pod
        return DistributedConfig(
            num_processes=hosts,
            process_index=ordinal % hosts,
            replica_index=ordinal // hosts,
            coordinator=f"{host}:{port}",
        )


def bootstrap(config: DistributedConfig, init_method: Optional[str] = None) -> None:
    """Join the replica's process group (gloo, rank = process index) at the
    coordinator — or at ``init_method`` when given (a ``file://`` store for
    ranks on one host). No-op for a single-host config or a process already
    in a group."""
    import torch.distributed as dist

    if not config.is_multihost or dist.is_initialized():
        return
    log.info(
        "joining process group: %d/%d via %s (replica %d)",
        config.process_index, config.num_processes, init_method or config.coordinator,
        config.replica_index,
    )
    dist.init_process_group(
        "gloo",
        init_method=init_method or f"tcp://{config.coordinator}",
        world_size=config.num_processes,
        rank=config.process_index,
    )
