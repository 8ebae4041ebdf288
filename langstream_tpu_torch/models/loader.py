"""HF safetensors checkpoint → the port's stacked-layer params (port of
``langstream_tpu/models/loader.py``).

Maps Hugging Face llama / gemma / mixtral naming onto the layout of
``bridge.init_params``: HF stores linear weights as ``[out, in]``, the
port's matmuls are ``x @ W``, so every projection transposes on load, and
per-layer tensors stack onto the leading ``[L, ...]`` axis. Gemma RMSNorm
weights are stored zero-centred (the HF module computes ``x * (1 + w)``);
the port's ``rms_norm`` multiplies directly, so gemma norms load as
``w + 1`` (in the checkpoint's dtype, then cast, as the JAX loader does).

The safetensors format is read and written here without the
``safetensors`` package (the card's machine has none): an 8-byte
little-endian header length N, N bytes of JSON header (tensor name →
dtype tag, shape, ``data_offsets`` relative to the data section; padded
with spaces to a multiple of 8, as ``safetensors`` pads it), then the raw
little-endian bytes. bf16 travels as its 16-bit pattern (``torch``'s own
``bfloat16`` on the torch side, an ``int16`` view through numpy), so
neither ``ml_dtypes`` nor ``safetensors`` is needed on any path of the
port. ``save_params_hf`` writes files that the ``safetensors`` package and
the JAX loader read bit-equal.

``load_lora_params`` reads a peft LoRA checkpoint into the numpy factor
trees the adapter registry (``serving/adapters.py``) uploads.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.models.configs import ModelConfig

log = logging.getLogger(__name__)

Params = dict

# safetensors dtype tag ↔ torch dtype
ST_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
ST_TAGS: dict[torch.dtype, str] = {v: k for k, v in ST_DTYPES.items()}
# refuse a header larger than this (the ``safetensors`` package's own cap)
MAX_HEADER_BYTES = 100_000_000


def model_dtype(dtype: Any, config: ModelConfig) -> torch.dtype:
    """``dtype`` (a torch dtype, a dtype name, or None for the config's)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    from langstream_tpu_torch.models.bridge import torch_dtype

    return torch_dtype(dtype or config.dtype)


def _iter_safetensor_files(path: Union[str, Path]) -> Iterator[Path]:
    path = Path(path)
    if path.is_file():
        yield path
        return
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    yield from files


def read_header(f, size: int) -> tuple[dict, int]:
    """(JSON header, absolute offset of the data section) of an open
    safetensors file of ``size`` bytes. Raises ValueError on a header the
    file cannot hold or that is not JSON."""
    head = f.read(8)
    if len(head) < 8:
        raise ValueError(f"truncated safetensors header (file is {size} bytes)")
    n = int.from_bytes(head, "little")
    if n <= 0 or n > MAX_HEADER_BYTES or 8 + n > size:
        raise ValueError(f"header claims {n} bytes but the file holds {size}")
    try:
        header = json.loads(f.read(n))
    except ValueError as e:
        raise ValueError(f"corrupt safetensors header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("corrupt safetensors header: not a JSON object")
    return header, 8 + n


def tensor_from_bytes(buf: Any, dtype: torch.dtype, shape: tuple[int, ...]) -> torch.Tensor:
    """A CPU tensor over ``buf``'s bytes (any writable buffer),
    reinterpreted as ``dtype`` — bf16 through its 16-bit pattern."""
    return torch.from_numpy(np.frombuffer(buf, dtype=np.uint8)).view(dtype).reshape(shape)


def pread_into(fd: int, buf: Any, offset: int) -> int:
    """Fill ``buf`` (a writable buffer) from ``fd`` at ``offset`` with
    positioned reads (they release the GIL); returns the bytes read, short
    only at the end of the file."""
    view = memoryview(buf).cast("B")
    done = 0
    while done < len(view):
        n = os.preadv(fd, [view[done:]], offset + done)
        if n <= 0:
            break
        done += n
    return done


def load_raw_tensors(path: Union[str, Path]) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint dir (or single file) as a CPU tensor of
    its stored dtype, read with one positioned read per tensor."""
    tensors: dict[str, torch.Tensor] = {}
    for file in _iter_safetensor_files(path):
        size = file.stat().st_size
        with open(file, "rb") as f:
            try:
                header, data_start = read_header(f, size)
            except ValueError as e:
                raise ValueError(f"shard {file.name}: {e}") from None
            fd = f.fileno()
            for name, entry in header.items():
                if name == "__metadata__":
                    continue
                dtype = ST_DTYPES[entry["dtype"]]
                shape = tuple(int(d) for d in entry["shape"])
                begin, stop = (data_start + int(o) for o in entry["data_offsets"])
                buf = bytearray(stop - begin)
                if pread_into(fd, buf, begin) != len(buf):
                    raise ValueError(
                        f"shard {file.name} is truncated: tensor {name!r} needs bytes "
                        f"{begin}:{stop} but the file ends at {size}"
                    )
                tensors[name] = tensor_from_bytes(buf, dtype, shape)
    return tensors


def _gemma_like(config: ModelConfig) -> bool:
    # embedding_scale+gelu marks the gemma family in the presets
    return config.embedding_scale and config.activation == "gelu"


def _strip_prefix(name: str) -> str:
    return name[len("model.") :] if name.startswith("model.") else name


def load_params(
    path: Union[str, Path], config: ModelConfig, dtype: Any = None, device: DeviceLike = "cuda"
) -> Params:
    """Load a HF checkpoint dir (or single file) into the port's params on
    ``device``: the whole checkpoint is read into host memory, transformed
    there and uploaded key by key (the eager path; ``streamload`` is the
    pipelined one)."""
    dev = resolve_device(device)
    dtype = model_dtype(dtype, config)
    raw = {_strip_prefix(k): v for k, v in load_raw_tensors(path).items()}
    L = config.n_layers
    norm_offset = 1.0 if _gemma_like(config) else 0.0

    def take(name: str) -> torch.Tensor:
        if name not in raw:
            raise KeyError(f"checkpoint is missing {name!r}; found e.g. {sorted(raw)[:8]}")
        return raw.pop(name)

    def place(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype=dtype).to(dev)

    def stack(fmt: str, transform: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        return place(torch.stack([transform(take(fmt.format(i=i))) for i in range(L)]))

    def t(w: torch.Tensor) -> torch.Tensor:  # HF [out, in] → ours [in, out]
        return w.t()

    def add_norm(w: torch.Tensor) -> torch.Tensor:
        return w + norm_offset

    layers: dict[str, Any] = {
        "attn_norm": stack("layers.{i}.input_layernorm.weight", add_norm),
        "wq": stack("layers.{i}.self_attn.q_proj.weight", t),
        "wk": stack("layers.{i}.self_attn.k_proj.weight", t),
        "wv": stack("layers.{i}.self_attn.v_proj.weight", t),
        "wo": stack("layers.{i}.self_attn.o_proj.weight", t),
        "ffn_norm": stack("layers.{i}.post_attention_layernorm.weight", add_norm),
    }
    if config.is_moe:

        def stack_experts(w_name: str) -> torch.Tensor:
            # per layer [E, ...] from block_sparse_moe.experts.{e}.{w}
            return place(torch.stack([
                torch.stack([
                    t(take(f"layers.{i}.block_sparse_moe.experts.{e}.{w_name}.weight"))
                    for e in range(config.n_experts)
                ])
                for i in range(L)
            ]))

        layers["router"] = stack("layers.{i}.block_sparse_moe.gate.weight", t)
        layers["w_gate"] = stack_experts("w1")  # [L, E, D, F]
        layers["w_up"] = stack_experts("w3")
        layers["w_down"] = stack_experts("w2")  # [L, E, F, D]
    else:
        layers["w_gate"] = stack("layers.{i}.mlp.gate_proj.weight", t)
        layers["w_up"] = stack("layers.{i}.mlp.up_proj.weight", t)
        layers["w_down"] = stack("layers.{i}.mlp.down_proj.weight", t)

    params: Params = {
        "embed": place(take("embed_tokens.weight")),
        "layers": layers,
        "final_norm": place(add_norm(take("norm.weight"))),
    }
    if not config.tie_embeddings:
        params["lm_head"] = place(t(take("lm_head.weight")))
    else:
        raw.pop("lm_head.weight", None)  # some exports duplicate the tied head
    if raw:
        log.warning("checkpoint tensors unused by %s: %s", config.name, sorted(raw)[:10])
    _check_shapes(params, config)
    return params


# our projection name → the peft module path inside a layer
_LORA_PROJ_HF = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def load_lora_params(
    path: Union[str, Path], config: ModelConfig, rank: int
) -> dict[str, dict[str, np.ndarray]]:
    """A peft LoRA checkpoint → per projection ``{"a": [L, din, rank], "b":
    [L, rank, dout]}`` f32 numpy, the trees the adapter registry uploads.

    peft stores ``...layers.{i}.{proj}.lora_A.weight`` as [r, in] and
    ``lora_B.weight`` as [out, r]; the port's product is ``(x @ A) @ B``, so
    both transpose on load (the rule of ``load_params``). Keys match on
    their suffix from the last ``layers.`` on (peft's prefix depends on the
    export); two keys with one suffix raise ValueError. Projections absent
    from the checkpoint (a q/v-only adapter) load as zeros, which add
    nothing; MoE configs load attention projections only. A rank below
    ``rank`` is zero-padded, above it raises."""
    from langstream_tpu_torch.serving.adapters import _proj_dims

    raw = load_raw_tensors(path)
    n_layers = config.n_layers
    suffix_to_key: dict[str, str] = {}
    for key in raw:
        pos = key.rfind("layers.")
        if pos < 0:
            continue  # a tensor outside the layers is never a factor
        suffix = key[pos:]
        other = suffix_to_key.get(suffix)
        if other is not None:
            raise ValueError(
                f"ambiguous LoRA checkpoint under {path}: {other!r} and "
                f"{key!r} both end in {suffix!r}"
            )
        suffix_to_key[suffix] = key

    def find(i: int, hf_proj: str, factor: str) -> Optional[np.ndarray]:
        key = suffix_to_key.get(f"layers.{i}.{hf_proj}.{factor}.weight")
        return raw[key].float().numpy() if key is not None else None

    out: dict[str, dict[str, np.ndarray]] = {}
    found_any = False
    for proj, (din, dout) in _proj_dims(config).items():
        a = np.zeros((n_layers, din, rank), np.float32)
        b = np.zeros((n_layers, rank, dout), np.float32)
        for i in range(n_layers):
            raw_a = find(i, _LORA_PROJ_HF[proj], "lora_A")
            raw_b = find(i, _LORA_PROJ_HF[proj], "lora_B")
            if raw_a is None or raw_b is None:
                continue
            found_any = True
            r = raw_a.shape[0]
            if r > rank:
                raise ValueError(
                    f"{proj} layer {i}: checkpoint rank {r} exceeds the "
                    f"requested rank {rank}"
                )
            a[i, :, :r] = raw_a.T
            b[i, :r, :] = raw_b.T
        out[proj] = {"a": a, "b": b}
    if not found_any:
        raise ValueError(
            f"no lora_A/lora_B tensors under {path}; found e.g. {sorted(raw)[:6]}"
        )
    return out


def expected_params(config: ModelConfig, quantized: bool = False) -> Params:
    """The params tree ``config`` serves, as ``meta`` tensors: shapes and
    dtypes without an allocation (``quantized``: the int8 tree)."""
    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.models.quant import init_random_quantized_params

    init = init_random_quantized_params if quantized else init_params
    return init(config, torch.Generator(), device="meta")


def _shape_mismatches(expected: Any, got: Any, path: str = "params") -> list[str]:
    if isinstance(expected, dict):
        out = []
        for key in expected:
            if key not in got:
                out.append(f"{path}.{key}: missing")
            else:
                out.extend(_shape_mismatches(expected[key], got[key], f"{path}.{key}"))
        return out
    if tuple(expected.shape) != tuple(got.shape):
        return [f"{path}: expected {tuple(expected.shape)}, got {tuple(got.shape)}"]
    return []


def _check_shapes(params: Params, config: ModelConfig) -> None:
    """Raise ValueError naming every leaf whose shape differs from the tree
    ``config`` serves."""
    mismatches = _shape_mismatches(expected_params(config), params)
    if mismatches:
        raise ValueError(
            f"checkpoint does not match config {config.name!r}: " + "; ".join(mismatches)
        )


def write_safetensors(
    file: Union[str, Path],
    items: list[tuple[str, torch.dtype, tuple[int, ...], Callable[[], torch.Tensor]]],
    metadata: Optional[dict[str, str]] = None,
) -> int:
    """Write one safetensors file from ``(name, dtype, shape, produce)``
    items, where ``produce()`` returns the tensor (any device; it is made
    contiguous and copied to the host one item at a time, so a tree on the
    card is never held on the host whole). Returns the bytes written."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, dtype, shape, _ in items:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": ST_TAGS[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((8 - len(blob) % 8) % 8)
    with open(file, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name, dtype, shape, produce in items:
            x = produce()
            if x.dtype != dtype or tuple(x.shape) != tuple(shape):
                raise ValueError(
                    f"{name}: produced {x.dtype} {tuple(x.shape)}, declared {dtype} {shape}"
                )
            host = x.contiguous().cpu().reshape(-1).view(torch.uint8)
            f.write(memoryview(host.numpy()))
    return 8 + len(blob) + offset


def save_params_hf(
    params: Params,
    config: ModelConfig,
    path: Union[str, Path],
    *,
    max_shard_bytes: Optional[int] = None,
) -> None:
    """The inverse mapping (ours → HF naming), for tests, the card's smoke
    run and exporting weights back to the HF ecosystem: one
    ``model.safetensors``, or with ``max_shard_bytes`` HF-style
    ``model-0000i-of-0000N.safetensors`` shards (greedy, in the JAX
    writer's order, at least one tensor a shard) plus the
    ``model.safetensors.index.json`` weight map. Each tensor is transposed
    where it lives and copied to the host one at a time."""
    norm_offset = 1.0 if _gemma_like(config) else 0.0
    layers = params["layers"]
    items: list[tuple[str, torch.dtype, tuple[int, ...], Callable[[], torch.Tensor]]] = []

    def put(name: str, fn: Callable[[], torch.Tensor], like: torch.Tensor, transpose: bool) -> None:
        shape = tuple(like.shape[::-1]) if transpose else tuple(like.shape)
        items.append((name, like.dtype, shape, fn))

    def t_of(x: torch.Tensor) -> tuple[Callable[[], torch.Tensor], torch.Tensor, bool]:
        return (lambda: x.t()), x, True

    def norm_of(x: torch.Tensor) -> tuple[Callable[[], torch.Tensor], torch.Tensor, bool]:
        # a bf16 norm is written in f32, as the JAX writer writes it (numpy
        # promotes bf16 - float to f32): the gemma offset's round trip stays
        # exact and the two writers' files hold the same tensors
        like = x.float() if x.dtype == torch.bfloat16 else x
        return (lambda: like - norm_offset), like, False

    embed = params["embed"]
    put("model.embed_tokens.weight", lambda: embed, embed, False)
    put("model.norm.weight", *norm_of(params["final_norm"]))
    if not config.tie_embeddings:
        put("lm_head.weight", *t_of(params["lm_head"]))
    for i in range(config.n_layers):
        pre = f"model.layers.{i}"
        put(f"{pre}.input_layernorm.weight", *norm_of(layers["attn_norm"][i]))
        put(f"{pre}.post_attention_layernorm.weight", *norm_of(layers["ffn_norm"][i]))
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                             ("wo", "o_proj")):
            put(f"{pre}.self_attn.{theirs}.weight", *t_of(layers[ours][i]))
        if config.is_moe:
            put(f"{pre}.block_sparse_moe.gate.weight", *t_of(layers["router"][i]))
            for e in range(config.n_experts):
                for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                    put(f"{pre}.block_sparse_moe.experts.{e}.{theirs}.weight",
                        *t_of(layers[ours][i, e]))
        else:
            for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                                 ("w_down", "down_proj")):
                put(f"{pre}.mlp.{theirs}.weight", *t_of(layers[ours][i]))

    def nbytes(item) -> int:
        _, dtype, shape, _ = item
        return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    total = sum(nbytes(it) for it in items)
    if not max_shard_bytes or total <= max_shard_bytes:
        write_safetensors(path / "model.safetensors", items)
        return
    shards: list[list] = [[]]
    used = 0
    for it in items:
        if shards[-1] and used + nbytes(it) > max_shard_bytes:
            shards.append([])
            used = 0
        shards[-1].append(it)
        used += nbytes(it)
    n = len(shards)
    weight_map: dict[str, str] = {}
    for idx, shard in enumerate(shards, start=1):
        fname = f"model-{idx:05d}-of-{n:05d}.safetensors"
        write_safetensors(path / fname, shard)
        for it in shard:
            weight_map[it[0]] = fname
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1)
    )
