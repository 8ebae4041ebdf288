"""Rules of the PyTorch port, checked statically and at its entry points:
the package and chip_smoke.py import neither JAX nor the JAX package;
asking for CUDA where there is none raises instead of running on the CPU;
and the completions service streams text through the port's engine."""

import ast
import asyncio
import dataclasses
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "langstream_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_files_exist():
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for mod in (
        "langstream_tpu_torch/models/transformer.py",
        "langstream_tpu_torch/ops/attention.py",
        "langstream_tpu_torch/serving/engine.py",
        "chip_smoke.py",
    ):
        assert mod in rel


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax"), f"{path.name} imports {name}"
        assert top != "langstream_tpu", f"{path.name} imports {name}"


def test_no_cuda_raises(monkeypatch):
    """Every entry point that takes a device refuses "cuda" without a card."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.models.transformer import make_kv_cache, make_page_pool
    from langstream_tpu_torch.serving.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    params = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_page_pool(cfg, 4, 8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchCompletionsService({"model": "tiny-test"})


def test_completions_service_streams_text():
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
        "page-size": 16, "kv-cache-quantization": "int8",
    })
    chunks = []
    try:
        result = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="hello")],
            {"max-tokens": 6, "min-chunks-per-message": 2},
            chunks.append,
        ))
        stats = svc.engine_stats()
    finally:
        svc.close()
    assert result.completion_tokens == 6 and result.finish_reason in ("length", "stop")
    assert chunks and chunks[-1].last
    assert "".join(c.content for c in chunks) == result.content
    assert svc.model_config.kv_cache_dtype == "int8"
    assert stats["kernels"]["paged_decode_int8"]["cpu_calls"] > 0


def test_completions_service_refuses_what_it_cannot_serve():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    with pytest.raises(NotImplementedError):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "weights": "/ckpt"})
    with pytest.raises(ValueError, match="kv-layout"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "kv-layout": "ring"})
    with pytest.raises(ValueError):
        TorchCompletionsService({"model": "no-such-model", "device": "cpu"})
    with pytest.raises(ValueError):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu",
                                 "kv-cache-quantization": "int4"})


def test_completions_service_default_max_seq_len():
    """max-seq-len defaults to min(2048, the preset's max_seq_len), as in
    the JAX provider: tiny-test's own cap at tiny-test (engine built),
    2048 for llama-3-8b (resolved only, nothing allocated)."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    tiny = MODEL_PRESETS["tiny-test"]
    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu"})
    try:
        assert svc.max_seq_len == min(2048, tiny.max_seq_len)
        assert svc.engine().max_seq_len == min(2048, tiny.max_seq_len)
    finally:
        svc.close()
    llama = TorchCompletionsService({"model": "llama-3-8b", "device": "cpu"})
    assert MODEL_PRESETS["llama-3-8b"].max_seq_len == 8192 and llama.max_seq_len == 2048
    assert llama._engine is None
