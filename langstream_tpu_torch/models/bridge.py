"""Parameters of the port: the bridge from the JAX param pytree, and random
init on the device.

The JAX package's params (``transformer.init_params``, stacked per-layer
leaves ``[L, ...]``) reach the port as a tree of numpy arrays —
``params_from_numpy`` turns that tree into tensors of the same layout,
int8 ``{"q","s"}`` leaves included, so both frameworks run the same weights.
``init_params`` makes random weights of the same shapes and scales directly
on the device from a ``torch.Generator`` (``jax.random`` and torch give
different bits from one seed, so the two inits are alike in distribution
only).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.models.configs import ModelConfig

Params = dict


def torch_dtype(name: str) -> torch.dtype:
    """Model dtype name (``ModelConfig.dtype``) → torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[str(name)]
    except KeyError:
        raise ValueError(f"unsupported model dtype {name!r}") from None


def _tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy-native twin
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def params_from_numpy(tree: Any, config: ModelConfig, device: DeviceLike = "cuda") -> Params:
    """JAX param pytree as numpy arrays → the port's dict of tensors on
    ``device``, same nesting and layout (int8 ``{"q","s"}`` leaves stay
    dicts; an MoE tree keeps its ``router`` and 4-D stacked experts)."""
    dev = resolve_device(device)

    def convert(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor_from_numpy(node, dev)

    params = convert(tree)
    embed = params["embed"]
    rows = (embed["q"] if isinstance(embed, dict) else embed).shape
    if tuple(rows) != (config.vocab_size, config.d_model):
        raise ValueError(
            f"embed table {tuple(rows)} does not match config "
            f"({config.vocab_size}, {config.d_model})"
        )
    return params


def init_params(
    config: ModelConfig, generator: torch.Generator, device: DeviceLike = "cuda"
) -> Params:
    """Random-init params with the JAX ``init_params`` shapes and scales
    (N(0,1)·fan_in^-0.5, norms at one), drawn layer by layer straight into
    the model dtype so no full-size float32 temporary is ever live. An MoE
    config draws a ``router`` [L, D, E] (model dtype) and stacked experts
    ``w_gate`` / ``w_up`` [L, E, D, F], ``w_down`` [L, E, F, D]."""
    dev = resolve_device(device)
    dtype = torch_dtype(config.dtype)
    d, h, hkv = config.d_model, config.n_heads, config.n_kv_heads
    hd = config.resolved_head_dim
    f, n_layers, v = config.d_ff, config.n_layers, config.vocab_size

    def norm(shape: tuple[int, ...], scale: int) -> torch.Tensor:
        return (
            torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            * scale**-0.5
        ).to(dtype)

    def stacked(*shape: int, scale: int) -> torch.Tensor:
        out = torch.empty((n_layers,) + shape, dtype=dtype, device=dev)
        for layer in range(n_layers):
            out[layer] = norm(shape, scale)
        return out

    # an MoE layer's FFN weights carry a leading expert axis
    experts = (config.n_experts,) if config.is_moe else ()

    layers = {
        "attn_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
        "wq": stacked(d, h * hd, scale=d),
        "wk": stacked(d, hkv * hd, scale=d),
        "wv": stacked(d, hkv * hd, scale=d),
        "wo": stacked(h * hd, d, scale=h * hd),
        "ffn_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
        "w_gate": stacked(*experts, d, f, scale=d),
        "w_up": stacked(*experts, d, f, scale=d),
        "w_down": stacked(*experts, f, d, scale=f),
    }
    if config.is_moe:
        layers["router"] = stacked(d, config.n_experts, scale=d)
    params: Params = {
        "embed": norm((v, d), d),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not config.tie_embeddings:
        params["lm_head"] = norm((d, v), d)
    return params
