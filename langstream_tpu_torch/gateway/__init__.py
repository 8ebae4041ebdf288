"""API gateway of the port (L6): websocket + HTTP surface onto application
topics, on an asyncio stdlib server (the port's own copy of
``langstream_tpu/gateway``; the authentication providers are
``gateway/auth.py``).
"""

from langstream_tpu_torch.gateway.core import (
    AuthFailedException,
    ConsumeGateway,
    GatewayRequestContext,
    ProduceException,
    ProduceGateway,
    build_message_filters,
    resolve_common_headers,
)
from langstream_tpu_torch.gateway.server import GatewayServer

__all__ = [
    "AuthFailedException",
    "ConsumeGateway",
    "GatewayRequestContext",
    "GatewayServer",
    "ProduceException",
    "ProduceGateway",
    "build_message_filters",
    "resolve_common_headers",
]
