"""Parameter and cache sharding rules, and the tensor-parallel handle the
model's collectives go through — the port's ``parallel/sharding.py``.

The rules are the JAX package's (its Megatron schedule): attention heads
and the FFN hidden dimension split by column on the up-projections (``wq``,
``wk``, ``wv``, ``w_gate``, ``w_up`` on "model") and by row on the
down-projections (``wo``, ``w_down``), so each layer needs one all-reduce
after ``wo`` and one after ``w_down``; experts split on "expert"; the
embedding splits by vocabulary row and ``lm_head`` by vocabulary column,
both on "model". A spec is a tuple with one entry a dimension — an axis
name or None — leaf for leaf with the JAX package's ``PartitionSpec``
tree; ``shard_params`` cuts this rank's slices by it.

Where XLA inserts the collectives for the JAX package, the port names them
(``TensorParallel``): a vocabulary-parallel embedding lookup then an
all-reduce, q/k/v over the rank's heads, ``wo`` row-parallel then an
all-reduce, ``w_down`` row-parallel then an all-reduce, the MoE layer's
local experts over its slice of ``d_ff`` then one all-reduce over the
expert and model axes together, and vocabulary-parallel logits gathered
to the full vocabulary before sampling.

An adapter's factors split like the weight each adapts (``shard_lora``):
``B`` of a column-parallel projection on its output columns, ``A`` of a
row-parallel one on its input rows, so a rank's delta comes out at its
width or as its partial sum, added once by the projection's all-reduce.

The kv-head fallback: when the model axis does not divide the kv heads
(GQA at high TP) the JAX package replicates the cache over the model axis
(``serving_cache_specs``); the port keeps on each rank the kv head its
query heads read (Megatron's kv-head replication), so a rank's cache holds
one kv head, and ``wk`` / ``wv`` are cut by kv head, not by column."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.models.quant import is_quantized

Params = dict
Spec = tuple

_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def param_specs(config: ModelConfig) -> Params:
    """The spec tree of ``models.bridge.init_params``' layout (the JAX
    package's ``param_specs``, one tuple a leaf)."""
    layers: dict[str, Spec] = {
        "attn_norm": (None, None),
        "wq": (None, None, "model"),
        "wk": (None, None, "model"),
        "wv": (None, None, "model"),
        "wo": (None, "model", None),
        "ffn_norm": (None, None),
    }
    if config.is_moe:
        layers["router"] = (None, None, None)
        layers["w_gate"] = (None, "expert", None, "model")
        layers["w_up"] = (None, "expert", None, "model")
        layers["w_down"] = (None, "expert", "model", None)
    else:
        layers["w_gate"] = (None, None, "model")
        layers["w_up"] = (None, None, "model")
        layers["w_down"] = (None, "model", None)
    specs: Params = {"embed": ("model", None), "layers": layers, "final_norm": (None,)}
    if not config.tie_embeddings:
        specs["lm_head"] = (None, "model")
    return specs


def quantize_specs_for_params(specs: Params, params: Params) -> Params:
    """The spec tree of an int8 tree: ``q`` keeps its weight's spec, the
    scales drop the contracted (second-to-last) axis; a row-quantized
    embedding's per-row scales split like its rows."""

    def scale_spec(spec: Spec) -> Spec:
        parts = list(spec)
        if len(parts) >= 2:
            parts[-2] = None
        return tuple(parts)

    out = dict(specs)
    layers = dict(specs["layers"])
    for key in _QUANT_LAYER_KEYS:
        if key in layers:
            layers[key] = {"q": layers[key], "s": scale_spec(layers[key])}
    out["layers"] = layers
    if "lm_head" in specs:
        out["lm_head"] = {"q": specs["lm_head"], "s": scale_spec(specs["lm_head"])}
    if is_quantized(params.get("embed")):
        out["embed"] = {"q": specs["embed"], "s": (specs["embed"][0], None)}
    return out


def serving_cache_specs(n_kv_heads: int, mesh: Any) -> dict[str, Spec]:
    """The engine cache's spec: kv heads on "model" when they divide it,
    replicated otherwise (the JAX package's rule; batch replicated)."""
    ways = int(mesh.shape.get("model", 1))
    spec = (
        (None, None, "model", None, None)
        if ways > 1 and n_kv_heads % ways == 0
        else (None, None, None, None, None)
    )
    return {"k": spec, "v": spec}


def page_pool_specs(n_kv_heads: int, mesh: Any) -> Spec:
    """The page pool's spec ``[L, P, Hkv, ps, D]``: as ``serving_cache_specs``
    (the page axis is never split: page ids are runtime table indices)."""
    return serving_cache_specs(n_kv_heads, mesh)["k"]


def kv_heads_of_rank(config: ModelConfig, model_ways: int, model_rank: int) -> range:
    """The kv heads rank ``model_rank`` keeps: its share when the model
    axis divides the kv heads, else the one kv head its query heads read
    (Megatron's replication; the model axis must be a multiple of the kv
    heads, and a rank's query heads must fall in one kv group)."""
    h, hkv = config.n_heads, config.n_kv_heads
    if h % model_ways:
        raise ValueError(f"model axis {model_ways} does not divide {h} attention heads")
    if hkv % model_ways == 0:
        per = hkv // model_ways
        return range(model_rank * per, (model_rank + 1) * per)
    group = h // hkv
    q_per = h // model_ways
    if model_ways % hkv or group % q_per:
        raise ValueError(
            f"model axis {model_ways} cannot split {h} query heads over {hkv} kv heads"
        )
    first = (model_rank * q_per) // group
    return range(first, first + 1)


def local_config(config: ModelConfig, mesh: Any) -> ModelConfig:
    """The shapes one rank computes: its query heads, its kv heads, its
    slice of ``d_ff`` (experts stay counted whole: the router scores all of
    them), the head dim pinned (it defaults to d_model / n_heads)."""
    ways = int(mesh.shape.get("model", 1))
    kv = kv_heads_of_rank(config, ways, 0)
    if config.d_ff % ways:
        raise ValueError(f"model axis {ways} does not divide d_ff {config.d_ff}")
    experts = int(mesh.shape.get("expert", 1))
    if experts > 1 and (not config.is_moe or config.n_experts % experts):
        raise ValueError(f"expert axis {experts} does not divide {config.n_experts} experts")
    if config.vocab_size % ways:
        raise ValueError(f"model axis {ways} does not divide vocab {config.vocab_size}")
    return dataclasses.replace(
        config,
        n_heads=config.n_heads // ways,
        n_kv_heads=len(kv),
        d_ff=config.d_ff // ways,
        head_dim=config.resolved_head_dim,
    )


def _cut(x: torch.Tensor, dim: int, ways: int, rank: int) -> torch.Tensor:
    size = x.shape[dim]
    if size % ways:
        raise ValueError(f"dimension {dim} of size {size} does not split {ways} ways")
    per = size // ways
    return x.narrow(dim, rank * per, per)


def _slice(x: torch.Tensor, spec: Spec, mesh: Any) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _cut(x, dim, int(mesh.shape[axis]), int(mesh.coords[axis]))
    return x


def shard_params(params: Params, mesh: Any, config: ModelConfig) -> Params:
    """This rank's slices of ``params`` by ``param_specs`` (an int8 tree by
    ``quantize_specs_for_params``), each a contiguous copy. ``wk`` / ``wv``
    under the kv-head fallback keep the kv head this rank's queries read
    (``kv_heads_of_rank``)."""
    specs = param_specs(config)
    if is_quantized(params.get("layers", {}).get("wq")):
        specs = quantize_specs_for_params(specs, params)
    ways = int(mesh.shape.get("model", 1))
    fallback = ways > 1 and config.n_kv_heads % ways != 0
    kv = kv_heads_of_rank(config, ways, int(mesh.coords.get("model", 0))) if ways > 1 else None
    hd = config.resolved_head_dim

    def walk(tree: Any, spec: Any, key: str) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, spec[k] if isinstance(spec, dict) else spec, k if key in (
                "", "layers") else key) for k, v in tree.items()}
        if fallback and key in ("wk", "wv"):  # int8: q and its [..., 1, out] scales alike
            return tree.narrow(-1, kv.start * hd, len(kv) * hd).contiguous()
        return _slice(tree, spec, mesh).contiguous()

    return walk(params, specs, "")


# which factor of an adapter's projection splits, and on which of its axes
# (host factors ``{"a": [L, din, r], "b": [L, r, dout]}``): a column-parallel
# projection's ``B`` on its output columns, a row-parallel one's ``A`` on its
# input rows — the delta then comes out at the rank's width (column) or as
# the rank's partial sum, which the projection's all-reduce adds once (row)
LORA_SPLITS = {
    "wq": ("b", 2), "wk": ("b", 2), "wv": ("b", 2), "w_gate": ("b", 2), "w_up": ("b", 2),
    "wo": ("a", 1), "w_down": ("a", 1),
}


def shard_lora(host: dict, mesh: Any, config: ModelConfig) -> dict:
    """This rank's slices of one adapter's host factors (numpy, drawn or
    loaded at the full model's shapes), split like the base weight each
    adapts (``param_specs``; the model axis only, as attention and the
    dense FFN split). ``wk`` / ``wv`` under the kv-head fallback keep the
    columns of the kv head this rank's queries read, as ``shard_params``."""
    ways = int(mesh.shape.get("model", 1))
    if ways <= 1:
        return host
    rank = int(mesh.coords.get("model", 0))
    fallback = config.n_kv_heads % ways != 0
    kv = kv_heads_of_rank(config, ways, rank)
    hd = config.resolved_head_dim
    out = {}
    for proj, ab in host.items():
        factor, axis = LORA_SPLITS[proj]
        x = ab[factor]
        if fallback and proj in ("wk", "wv"):
            x = x[..., kv.start * hd:(kv.start + len(kv)) * hd]
        else:
            per = x.shape[axis] // ways
            x = np.take(x, np.arange(rank * per, (rank + 1) * per), axis=axis)
        out[proj] = {**ab, factor: np.ascontiguousarray(x)}
    return out


class TensorParallel:
    """The model's collectives on one rank of a mesh with expert x model
    above 1 (or a world-1 mesh asked for on the card): the process groups
    and this rank's vocabulary and expert ranges. Passed to the model as
    ``tp``; None is the single-device path."""

    def __init__(self, mesh: Any, config: ModelConfig) -> None:
        self.mesh = mesh
        self.model = int(mesh.shape["model"])
        self.expert = int(mesh.shape["expert"])
        self.model_rank = int(mesh.coords["model"])
        self.expert_rank = int(mesh.coords["expert"])
        self.model_group = mesh.group("model")
        self.moe_group = mesh.group("expert+model")
        self.vocab_local = config.vocab_size // self.model
        self.vocab_start = self.model_rank * self.vocab_local
        self.experts_local = config.n_experts // self.expert if config.is_moe else 0
        self.expert_start = self.expert_rank * self.experts_local

    def all_reduce(self, x: torch.Tensor, moe: bool = False) -> torch.Tensor:
        """Sum ``x`` in place over the model axis (``moe``: over expert and
        model together)."""
        import torch.distributed as dist

        dist.all_reduce(x, group=self.moe_group if moe else self.model_group)
        return x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """``[..., V / model]`` vocabulary-parallel logits → ``[..., V]``."""
        import torch.distributed as dist

        lead, vl = logits.shape[:-1], logits.shape[-1]
        flat = logits.reshape(-1, vl).contiguous()
        out = torch.empty((self.model * flat.shape[0], vl), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self.model_group)
        full = out.reshape(self.model, flat.shape[0], vl).permute(1, 0, 2)
        return full.reshape(*lead, self.model * vl)


def tensor_parallel(mesh: Optional[Any], config: ModelConfig) -> Optional[TensorParallel]:
    """The TP handle a mesh needs: one when its device groups exist for
    expert x model above 1, or on a world-1 mesh on the card, else None (a
    seq-only mesh's groups serve its ring)."""
    if mesh is None or not mesh.groups or (mesh.tensor_parallel == 1 and mesh.world > 1):
        return None
    return TensorParallel(mesh, config)
