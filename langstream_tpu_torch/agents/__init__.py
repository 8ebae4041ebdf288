"""Agents of the port: the built-ins (identity, list-source, collect-sink),
the text agents, the GenAI toolkit steps and the vector stores the RAG
pipelines query. ``register_builtins`` registers every type the port has
into ``core.registry.REGISTRY`` (the registry calls it on first lookup)."""


def register_builtins() -> None:
    # each module registers its agent types on import
    from langstream_tpu_torch.agents import builtin  # noqa: F401
    from langstream_tpu_torch.agents import genai  # noqa: F401
    from langstream_tpu_torch.agents import text  # noqa: F401
    from langstream_tpu_torch.agents import vector
    from langstream_tpu_torch.ai import register_providers

    register_providers()
    vector.register()
