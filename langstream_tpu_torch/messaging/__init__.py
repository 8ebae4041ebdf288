"""L2 of the port — messaging runtimes (broker transports between agents),
the port's own copy of ``langstream_tpu/messaging``: the in-memory broker
(the local and default transport), and Kafka, Pulsar and Pravega over
stdlib asyncio wire-protocol clients (``kafka_protocol.py``,
``pulsar_protocol.py``, ``pravega_protocol.py``), each with its
protocol-level fake broker (``*_fake.py``)."""

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
