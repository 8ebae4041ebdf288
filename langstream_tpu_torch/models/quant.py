"""Weight-only int8 quantization for serving (port of
``langstream_tpu/models/quant.py``).

Quantized weights are ``{"q": int8[..., in, out], "s": f32[..., 1, out]}``;
norms and embeddings stay in the original dtype. ``q``/``s`` are bit-exact
with the JAX package: the scale is ``max(amax, 1e-8) / 127.0`` — a true
division, because a reciprocal multiply lands 1 ulp off — and rounding is
half-to-even in both frameworks. A plain matrix product stays
``torch.matmul``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Any

import torch

from langstream_tpu_torch.models.configs import ModelConfig

Params = dict

# stacked-layer matmul weights that dominate HBM traffic
_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def quantize_weight(w: torch.Tensor, axis: int = -2) -> dict[str, torch.Tensor]:
    """Symmetric int8 with the amax reduced over ``axis`` — the default -2
    gives per-output-channel scales for [in, out] matmul weights."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize_weight(qw: dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return (qw["q"].float() * qw["s"]).to(dtype)


def quantized_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` where w is a plain tensor or a quantized dict (dequantized
    to the activation dtype first)."""
    if is_quantized(w):
        w = dequantize_weight(w, x.dtype)
    return torch.matmul(x, w)


def quantize_row_wise(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Symmetric per-ROW int8 (embedding tables: rows are vocab entries)."""
    return quantize_weight(w, axis=-1)


def quantize_params(params: Params, config: ModelConfig) -> Params:
    """Quantize the serving-dominant weights; everything else passes through."""
    out: Params = dict(params)
    layers = dict(params["layers"])
    for key in _QUANT_LAYER_KEYS:
        if key in layers:
            layers[key] = quantize_weight(layers[key])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    if config.tie_embeddings:
        out["embed"] = quantize_row_wise(params["embed"])
    return out
