"""The AI service SPI of the port and its PyTorch serving provider
(completions and embeddings)."""


def register_providers() -> None:
    """Register the AI resource types the port serves (``tpu-serving``) in
    its ``core.registry.REGISTRY`` — the JAX package's
    ``register_providers``, for the types the port has."""
    from langstream_tpu_torch.ai import torch_serving

    torch_serving.register()
