"""Streaming-cluster runtime registry (the port's own copy of
``langstream_tpu/messaging/registry.py``; reference
TopicConnectionsRuntimeRegistry).

Maps ``instance.streamingCluster.type`` to a TopicConnectionsRuntime. All
four broker runtimes — kafka, pulsar, pravega, memory — are stdlib-only
(asyncio wire-protocol clients, REST through ``runtime/http_client``, and
the in-process broker) and always register; the memory broker is the
default local transport. Any other type is refused by name.
"""

from __future__ import annotations

from typing import Callable

from langstream_tpu_torch.api.topics import TopicConnectionsRuntime


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
            known = ", ".join(sorted(cls._factories))
            raise ValueError(f"unknown streaming cluster type {type_!r}; known: {known}")
        return factory()

    @classmethod
    def _ensure_builtins(cls) -> None:
        # imported unconditionally: an import failure is a real bug and must
        # surface, not read as "unknown streaming cluster type"
        if "memory" not in cls._factories:
            from langstream_tpu_torch.messaging.memory import MemoryTopicConnectionsRuntime

            cls._factories["memory"] = MemoryTopicConnectionsRuntime
        if "kafka" not in cls._factories:
            from langstream_tpu_torch.messaging.kafka import KafkaTopicConnectionsRuntime

            cls._factories["kafka"] = KafkaTopicConnectionsRuntime
        if "pulsar" not in cls._factories:
            from langstream_tpu_torch.messaging.pulsar import PulsarTopicConnectionsRuntime

            cls._factories["pulsar"] = PulsarTopicConnectionsRuntime
        if "pravega" not in cls._factories:
            from langstream_tpu_torch.messaging.pravega import PravegaTopicConnectionsRuntime

            cls._factories["pravega"] = PravegaTopicConnectionsRuntime


def get_topic_connections_runtime(type_: str) -> TopicConnectionsRuntime:
    return TopicConnectionsRuntimeRegistry.get(type_)
