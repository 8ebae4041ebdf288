"""L2 of the port — messaging runtimes (broker transports between agents):
the in-memory broker, the local and default transport (the port's own copy
of ``langstream_tpu/messaging``' memory broker and registry)."""

from langstream_tpu_torch.messaging.memory import MemoryBroker, MemoryTopicConnectionsRuntime
from langstream_tpu_torch.messaging.registry import (
    TopicConnectionsRuntimeRegistry,
    get_topic_connections_runtime,
)

__all__ = [
    "MemoryBroker",
    "MemoryTopicConnectionsRuntime",
    "TopicConnectionsRuntimeRegistry",
    "get_topic_connections_runtime",
]
