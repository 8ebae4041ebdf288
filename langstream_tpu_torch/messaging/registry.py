"""Streaming-cluster runtime registry (the port's own copy of
``langstream_tpu/messaging/registry.py``; reference
TopicConnectionsRuntimeRegistry).

Maps ``instance.streamingCluster.type`` to a TopicConnectionsRuntime. The
port serves the in-memory broker, the local transport; ``kafka``,
``pulsar`` and ``pravega`` are known to the JAX package but not ported
yet: asking for one raises an error that names it as not ported.
"""

from __future__ import annotations

from typing import Callable

from langstream_tpu_torch.api.topics import TopicConnectionsRuntime

# broker types the JAX package serves and the port does not yet
NOT_PORTED = ("kafka", "pulsar", "pravega")


class TopicConnectionsRuntimeRegistry:
    _factories: dict[str, Callable[[], TopicConnectionsRuntime]] = {}

    @classmethod
    def register(cls, type_: str, factory: Callable[[], TopicConnectionsRuntime]) -> None:
        cls._factories[type_] = factory

    @classmethod
    def get(cls, type_: str) -> TopicConnectionsRuntime:
        cls._ensure_builtins()
        factory = cls._factories.get(type_)
        if factory is None:
            if type_ in NOT_PORTED:
                raise NotImplementedError(
                    f"streaming cluster type {type_!r} is not ported to langstream_tpu_torch "
                    "yet; the port serves: " + ", ".join(sorted(cls._factories))
                )
            known = ", ".join(sorted(cls._factories))
            raise ValueError(f"unknown streaming cluster type {type_!r}; known: {known}")
        return factory()

    @classmethod
    def _ensure_builtins(cls) -> None:
        if "memory" not in cls._factories:
            from langstream_tpu_torch.messaging.memory import MemoryTopicConnectionsRuntime

            cls._factories["memory"] = MemoryTopicConnectionsRuntime


def get_topic_connections_runtime(type_: str) -> TopicConnectionsRuntime:
    return TopicConnectionsRuntimeRegistry.get(type_)
