"""PyTorch + CUDA port of ``langstream_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and never a module of ``langstream_tpu``. Module paths mirror
the JAX package (``langstream_tpu_torch/ops/attention.py`` answers to
``langstream_tpu/ops/attention.py``). Entry points take an explicit
``device`` argument that defaults to ``"cuda"``; asking for CUDA where there
is none raises instead of falling back to the CPU.

``torch`` is imported by the modules that compute, not by this package: a
python agent's child process imports the SDK (``api/``) and the gRPC runtime
only, and starts without torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from langstream_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
