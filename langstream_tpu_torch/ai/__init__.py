"""The AI service SPI of the port and its providers: the PyTorch serving
provider (completions and embeddings on the card), and the remote ones —
OpenAI-compatible endpoints, Bedrock, Vertex AI — and the mock for tests."""


def register_providers() -> None:
    """Register the built-in AI resource types in the port's
    ``core.registry.REGISTRY`` — the JAX package's ``register_providers``:
    ``mock-ai-configuration``, ``tpu-serving``, ``open-ai-configuration`` /
    ``openai-compatible``, ``bedrock-configuration`` and
    ``vertex-configuration``."""
    from langstream_tpu_torch.ai import mock_provider, openai_compat, remote_cloud, torch_serving

    mock_provider.register()
    torch_serving.register()
    openai_compat.register()
    remote_cloud.register()
