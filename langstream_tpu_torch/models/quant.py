"""Weight-only int8 quantization for serving (port of
``langstream_tpu/models/quant.py``).

Quantized weights are ``{"q": int8[..., in, out], "s": f32[..., 1, out]}``;
norms and embeddings stay in the original dtype. ``q``/``s`` are bit-exact
with the JAX package: the scale is ``max(amax, 1e-8) / 127.0`` — a true
division, because a reciprocal multiply lands 1 ulp off — and rounding is
half-to-even in both frameworks. A plain matrix product stays
``torch.matmul``, as the JAX package leaves it to XLA. An MoE model's
stacked experts ``[L, E, in, out]`` quantize the same way (scales ``[L, E,
1, out]``); its router stays in the model dtype.

``init_random_quantized_params`` draws a random int8 tree on the device,
for models whose model-dtype tree would not fit the card (mixtral-8x7b:
93 GB in bf16, 46.9 GB in int8).
"""

from __future__ import annotations

from typing import Any

import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device
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


def init_random_quantized_params(
    config: ModelConfig, generator: torch.Generator, device: DeviceLike = "cuda"
) -> Params:
    """Random int8 params, shaped and typed as ``quantize_params(init_params(
    ...))``, drawn on ``device``: each int8 weight straight into int8
    storage (``random_`` over [-127, 127] from ``generator``), so no
    model-dtype or wider temporary of a stacked weight ever exists. Scales
    are ``fan_in**-0.5 / 127`` (the dequantized weights' spread is about
    ``fan_in**-0.5``, as ``init_params`` draws them); norms are one; the
    router and an untied embedding are N(0, 1)·d^-0.5 in the model dtype.
    A generator of the device draws the same tree on every run."""
    from langstream_tpu_torch.models.bridge import torch_dtype

    dev = resolve_device(device)
    dtype = torch_dtype(config.dtype)
    d, h, hkv = config.d_model, config.n_heads, config.n_kv_heads
    hd = config.resolved_head_dim
    f, n_layers, v = config.d_ff, config.n_layers, config.vocab_size

    def qw(*shape: int) -> dict[str, torch.Tensor]:
        q = torch.empty(shape, dtype=torch.int8, device=dev).random_(-127, 128, generator=generator)
        scale = shape[-2] ** -0.5 / 127.0
        s = torch.full(shape[:-2] + (1, shape[-1]), scale, dtype=torch.float32, device=dev)
        return {"q": q, "s": s}

    def normal(*shape: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * d**-0.5).to(dtype)

    experts = (config.n_experts,) if config.is_moe else ()
    layers: Params = {
        "attn_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
        "wq": qw(n_layers, d, h * hd),
        "wk": qw(n_layers, d, hkv * hd),
        "wv": qw(n_layers, d, hkv * hd),
        "wo": qw(n_layers, h * hd, d),
        "ffn_norm": torch.ones((n_layers, d), dtype=dtype, device=dev),
        "w_gate": qw(n_layers, *experts, d, f),
        "w_up": qw(n_layers, *experts, d, f),
        "w_down": qw(n_layers, *experts, f, d),
    }
    if config.is_moe:
        layers["router"] = normal(n_layers, d, config.n_experts)
    params: Params = {"layers": layers, "final_norm": torch.ones((d,), dtype=dtype, device=dev)}
    if config.tie_embeddings:
        # row-quantized table (quantize_row_wise: one scale per vocab row)
        q = torch.empty((v, d), dtype=torch.int8, device=dev).random_(-127, 128, generator=generator)
        params["embed"] = {"q": q, "s": torch.full((v, 1), d**-0.5 / 127.0, device=dev)}
    else:
        params["embed"] = normal(v, d)
        params["lm_head"] = qw(d, v)
    return params
