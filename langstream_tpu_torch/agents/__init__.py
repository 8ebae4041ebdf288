"""Agents of the port: the built-ins (identity, list-source, collect-sink),
the text agents, the GenAI toolkit steps, the web crawler, the vector
stores and agents of the RAG pipelines, the flow-control agents
(``dispatch``, ``timer-source``, ``trigger-event``, ``log-event``), the HTTP
agents (``http-request``, ``langserve-invoke``), the object-storage
sources, the ``python-*`` agents (user code in a child process over
gRPC) and the Kafka Connect / Camel sources and sink (``source``, ``sink``,
``camel-source``). ``register_builtins`` registers every type the port has into
``core.registry.REGISTRY`` (the registry calls it on first lookup)."""


def register_builtins() -> None:
    # each module registers its agent types on import
    from langstream_tpu_torch.agents import builtin  # noqa: F401
    from langstream_tpu_torch.agents import connect  # noqa: F401
    from langstream_tpu_torch.agents import flow  # noqa: F401
    from langstream_tpu_torch.agents import genai  # noqa: F401
    from langstream_tpu_torch.agents import http  # noqa: F401
    from langstream_tpu_torch.agents import python_agents  # noqa: F401
    from langstream_tpu_torch.agents import storage  # noqa: F401
    from langstream_tpu_torch.agents import text  # noqa: F401
    from langstream_tpu_torch.agents import vector
    from langstream_tpu_torch.agents import web  # noqa: F401
    from langstream_tpu_torch.ai import register_providers

    register_providers()
    vector.register()
