"""Streamed sharded safetensors → device: the cold-start weight pipeline
(port of ``langstream_tpu/models/streamload.py``).

``loader.load_params`` (the eager path) reads every shard into host memory,
stacks host copies (about twice the weight bytes at its peak) and only then
uploads. This module overlaps the three stages instead:

  1. **Read** — a pool of ``workers`` reader threads pulls one LAYER each
     straight into a pinned host staging buffer. The safetensors header
     (8-byte little-endian length, JSON) gives every tensor's byte range
     up front (``ShardIndex``, validated against each file's size before
     anything is read), so each tensor is one positioned read
     (``os.preadv``, which releases the GIL) and no shard is ever
     materialized whole. The staging buffers form a ring of ``workers +
     1`` layers (the readahead window), so host RAM holds the window and
     one buffer for the largest singleton (the embedding), never the tree.
  2. **Transfer** — the main thread copies each staged layer to the card
     with ``non_blocking=True`` on a dedicated load stream and records one
     event per ring buffer; a reader waits on that event before it reuses
     the buffer.
  3. **Transform** — on the card, on the load stream: the transpose (HF
     ``[out, in]`` → ours ``[in, out]``), the gemma norm offset (in the
     checkpoint's dtype) and the cast to the model dtype happen in the
     ``copy_`` into the layer's slot of the preallocated stacked ``[L,
     ...]`` buffers. With ``quantize=True`` each layer's matmul weights go
     through the port's own ``quant.quantize_weight`` on the card first
     and land in int8 ``{"q", "s"}`` buffers, so an int8 deployment never
     holds the model-dtype tree anywhere: the device peak is the int8 tree
     plus one model-dtype layer. Per-layer quantization is bit-equal to
     the stacked ``quantize_params`` because amax reduces within the layer
     (axis -2).

The embedding goes first, on the main thread, while the pool reads the
first layers. ``block=False`` returns with the copies in flight: the
caller's current stream already waits on the load stream's last event, and
``WeightLoadReport.wait()`` makes another stream wait (the engine does so
before its first warm-up and capture). On the CPU (tests) the same code
runs with plain host buffers and synchronous copies.

A short or torn read never yields silently-wrong weights: every tensor's
byte range is checked against the shard's size when the index is built,
every expected tensor's presence and shape against the config before any
read, and any violation raises (``WeightLoadError`` naming the shard and
the tensor, or ``ValueError`` for a checkpoint of another shape). The
``weight-load`` fault site (``serving/faultinject.py``) is consulted at
every tensor read. A failed read cancels the readahead and drains the
pool; it is never retried.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.models.loader import (
    ST_DTYPES,
    Params,
    _gemma_like,
    _iter_safetensor_files,
    _strip_prefix,
    expected_params,
    model_dtype,
    pread_into,
    read_header,
)
from langstream_tpu_torch.models.quant import _QUANT_LAYER_KEYS, quantize_weight

log = logging.getLogger(__name__)

# byte alignment of each tensor inside a staging buffer
_ALIGN = 256
# elements of one slice of an on-card quantize (64 MB of f32 temporaries
# each) or of a singleton's upload
_CHUNK_ELEMS = 1 << 24


def _quantize_into(x: torch.Tensor, dtype: torch.dtype, q: torch.Tensor, s: torch.Tensor,
                   axis: int) -> None:
    """``quant.quantize_weight(x.to(dtype), axis)`` written into ``q`` /
    ``s``, one slice across the reduced axis at a time (axis -2: columns;
    -1: rows). amax reduces along ``axis`` only, so each slice's codes and
    scales are the whole call's, bit for bit: the model dtype first (the
    eager path quantizes the cast tree), then the exact quantize ops."""
    dim = x.dim() - 1 if axis == -2 else x.dim() - 2
    n = x.shape[dim]
    step = max(1, _CHUNK_ELEMS // max(1, x.numel() // n))
    for a in range(0, n, step):
        b = min(step, n - a)
        qw = quantize_weight(x.narrow(dim, a, b).to(dtype), axis=axis)
        q.narrow(dim, a, b).copy_(qw["q"])
        s.narrow(dim, a, b).copy_(qw["s"])


class WeightLoadError(RuntimeError):
    """A checkpoint read that must not be retried: truncated or corrupt
    shard, malformed header, missing tensor, or an injected weight-load
    fault. The message names the shard file and, when one is implicated,
    the tensor."""


@dataclass(frozen=True)
class _TensorRef:
    """One tensor's location: an absolute byte range inside one shard."""

    file: Path
    dtype: torch.dtype
    shape: tuple[int, ...]
    start: int
    end: int

    @property
    def nbytes(self) -> int:
        return self.end - self.start


class ShardIndex:
    """Parsed safetensors headers of a checkpoint dir (or single file):
    tensor name (``model.`` prefix stripped) → byte range, with every range
    checked against the real file size, so truncation fails here, before
    any weight is read. Reads only the headers."""

    def __init__(self, path: Union[str, Path]) -> None:
        self.files: list[Path] = list(_iter_safetensor_files(path))
        self.tensors: dict[str, _TensorRef] = {}
        for file in self.files:
            size = file.stat().st_size
            with open(file, "rb") as f:
                try:
                    header, data_start = read_header(f, size)
                except ValueError as e:
                    raise WeightLoadError(f"shard {file.name}: {e}") from None
            for raw_name, entry in header.items():
                if raw_name == "__metadata__":
                    continue
                tag = entry.get("dtype")
                if tag not in ST_DTYPES:
                    raise WeightLoadError(
                        f"shard {file.name}: tensor {raw_name!r} has unsupported dtype {tag!r}"
                    )
                dtype = ST_DTYPES[tag]
                shape = tuple(int(d) for d in entry["shape"])
                begin, stop = entry["data_offsets"]
                ref = _TensorRef(file, dtype, shape, data_start + int(begin),
                                 data_start + int(stop))
                itemsize = torch.empty((), dtype=dtype).element_size()
                expect = int(np.prod(shape, dtype=np.int64)) * itemsize
                if ref.nbytes != expect:
                    raise WeightLoadError(
                        f"shard {file.name}: tensor {raw_name!r} spans {ref.nbytes} bytes "
                        f"but {shape} x {tag} needs {expect}"
                    )
                if ref.end > size:
                    # the header promises bytes the file does not have (a
                    # torn download, a truncated write)
                    raise WeightLoadError(
                        f"shard {file.name} is truncated: tensor {raw_name!r} needs bytes "
                        f"{ref.start}:{ref.end} but the file ends at {size}"
                    )
                name = _strip_prefix(raw_name)
                if name in self.tensors:
                    raise WeightLoadError(
                        f"tensor {raw_name!r} appears in both "
                        f"{self.tensors[name].file.name} and {file.name}"
                    )
                self.tensors[name] = ref

    def ref(self, name: str) -> _TensorRef:
        ref = self.tensors.get(name)
        if ref is None:
            raise WeightLoadError(
                f"checkpoint is missing tensor {name!r}; shards: "
                f"{[f.name for f in self.files]}, found e.g. {sorted(self.tensors)[:8]}"
            )
        return ref


class _ShardReader:
    """Positioned reads of one tensor at a time into a caller's buffer;
    thread-safe, one fd per shard, the ``weight-load`` fault site consulted
    at every read."""

    def __init__(self, index: ShardIndex, fault_injector: Optional[Any] = None) -> None:
        self._index = index
        self._injector = fault_injector
        self._fds: dict[Path, int] = {}
        self._lock = threading.Lock()
        self.reads = 0

    def _fd(self, file: Path) -> int:
        with self._lock:
            fd = self._fds.get(file)
            if fd is None:
                fd = os.open(file, os.O_RDONLY)
                self._fds[file] = fd
            return fd

    def read_into(self, name: str, out: torch.Tensor) -> None:
        """Read tensor ``name``'s bytes into ``out`` (a uint8 CPU tensor of
        exactly its size)."""
        ref = self._index.ref(name)
        if self._injector is not None and self._injector.fires("weight-load"):
            # the drill's stand-in for a torn mid-load read: the same error,
            # the same naming, the same no-retry contract
            raise WeightLoadError(
                f"injected weight-load fault: truncated read of tensor {name!r} from shard "
                f"{ref.file.name} (bytes {ref.start}:{ref.end})"
            )
        got = pread_into(self._fd(ref.file), out.numpy(), ref.start)
        if got != ref.nbytes:
            # the index checked the span against the size at open time, so
            # a short read here means the file changed under the load
            raise WeightLoadError(
                f"short read from shard {ref.file.name}: tensor {name!r} needs bytes "
                f"{ref.start}:{ref.end} but the read returned {got} of {ref.nbytes}"
            )
        with self._lock:
            self.reads += 1

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                with contextlib.suppress(OSError):
                    os.close(fd)
            self._fds.clear()


@dataclass
class WeightLoadReport:
    """Per-phase accounting of one load: the engine's ``weight-load-*``
    stats and the memory plan read it. ``read_s`` is summed across reader
    threads (they overlap each other and the transfer); on the card
    ``transfer_s`` / ``transform_s`` are the load stream's own times (CUDA
    events) when the load blocked, the host's dispatch time when it did
    not; ``total_s`` is the wall."""

    streamed: bool = True
    workers: int = 1
    quantize_on_load: bool = False
    shards: int = 0
    tensors: int = 0
    bytes_read: int = 0
    read_s: float = 0.0
    transform_s: float = 0.0
    transfer_s: float = 0.0
    total_s: float = 0.0
    staging_peak_bytes: int = 0
    # False ⇔ the caller took the transfer tail async (block=False)
    blocked: bool = True
    # outside as_dict (whose keys are the JAX report's): the wall before
    # the first read (index, checks, device buffers, staging), and of it
    # the allocation of the host staging buffers (pinned on the card)
    setup_s: float = 0.0
    staging_alloc_s: float = 0.0
    # the load stream's last event (on the card), which the params' first
    # user must wait on when the load did not block
    ready: Optional[Any] = field(default=None, repr=False, compare=False)

    def wait(self, stream: Optional[Any] = None) -> None:
        """Make ``stream`` (default: the current CUDA stream) wait for the
        load's last copy; a no-op on the CPU or for a blocking load."""
        if self.ready is not None:
            (stream or torch.cuda.current_stream()).wait_event(self.ready)

    def as_dict(self) -> dict[str, Any]:
        return {
            "streamed": self.streamed,
            "workers": self.workers,
            "quantize-on-load": self.quantize_on_load,
            "shards": self.shards,
            "tensors": self.tensors,
            "bytes-read": self.bytes_read,
            "read-s": round(self.read_s, 4),
            "transform-s": round(self.transform_s, 4),
            "transfer-s": round(self.transfer_s, 4),
            "total-s": round(self.total_s, 4),
            "staging-peak-bytes": self.staging_peak_bytes,
            "blocked": self.blocked,
        }


class _Staging:
    """Host staging accounting: bytes of the staging buffers (allocated
    once a load, so their sum is the report's ``staging_peak_bytes``) and
    the readers' summed read time and bytes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.peak = 0
        self.read_s = 0.0
        self.bytes_read = 0

    def grow(self, n: int) -> None:
        with self._lock:
            self.peak += n

    def account(self, read_s: float, nbytes: int) -> None:
        with self._lock:
            self.read_s += read_s
            self.bytes_read += nbytes


def _layer_spec(config: ModelConfig) -> list[tuple[str, str, tuple[str, ...]]]:
    """One layer's tensors: (our stacked key, kind, HF names with ``{i}``
    for the layer) — kind "norm" (offset, no transpose), "t" (one
    transposed matrix) or "experts" (E transposed matrices stacked)."""
    spec = [
        ("attn_norm", "norm", ("layers.{i}.input_layernorm.weight",)),
        ("wq", "t", ("layers.{i}.self_attn.q_proj.weight",)),
        ("wk", "t", ("layers.{i}.self_attn.k_proj.weight",)),
        ("wv", "t", ("layers.{i}.self_attn.v_proj.weight",)),
        ("wo", "t", ("layers.{i}.self_attn.o_proj.weight",)),
        ("ffn_norm", "norm", ("layers.{i}.post_attention_layernorm.weight",)),
    ]
    if config.is_moe:
        spec.append(("router", "t", ("layers.{i}.block_sparse_moe.gate.weight",)))
        for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            spec.append((ours, "experts", tuple(
                f"layers.{{i}}.block_sparse_moe.experts.{e}.{theirs}.weight"
                for e in range(config.n_experts)
            )))
    else:
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            spec.append((ours, "t", (f"layers.{{i}}.mlp.{theirs}.weight",)))
    return spec


def _hf_shape(shape: tuple[int, ...], kind: str) -> tuple[int, ...]:
    """The HF tensor shape of one of our per-layer (or singleton) leaves."""
    if kind == "norm":
        return shape
    return tuple(shape[-2:][::-1])  # "t" and each expert of "experts"


def _check_index(index: ShardIndex, config: ModelConfig) -> None:
    """Every tensor the config needs is in the index with its shape: a
    missing one raises WeightLoadError, a wrong shape ValueError (as the
    eager loader's shape check does) — before anything is read."""
    exp = expected_params(config)
    layers = exp["layers"]
    mismatches = []

    def need(name: str, shape: tuple[int, ...]) -> None:
        got = tuple(index.ref(name).shape)
        if got != tuple(shape):
            mismatches.append(f"{name}: expected {tuple(shape)}, got {got}")

    need("embed_tokens.weight", tuple(exp["embed"].shape))
    need("norm.weight", tuple(exp["final_norm"].shape))
    if not config.tie_embeddings:
        need("lm_head.weight", _hf_shape(tuple(exp["lm_head"].shape), "t"))
    for i in range(config.n_layers):
        for key, kind, names in _layer_spec(config):
            for fmt in names:
                need(fmt.format(i=i), _hf_shape(tuple(layers[key].shape[1:]), kind))
    if mismatches:
        raise ValueError(
            f"checkpoint does not match config {config.name!r}: " + "; ".join(mismatches)
        )


def _layout(index: ShardIndex, names: list[str]) -> tuple[list[tuple[str, int]], int]:
    """Offsets of ``names`` packed into one staging buffer (each aligned to
    ``_ALIGN`` bytes) and the buffer's size."""
    out, off = [], 0
    for name in names:
        out.append((name, off))
        off += -(-index.ref(name).nbytes // _ALIGN) * _ALIGN
    return out, off


def load_params_streamed(
    path: Union[str, Path],
    config: ModelConfig,
    dtype: Any = None,
    *,
    workers: int = 4,
    quantize: bool = False,
    fault_injector: Optional[Any] = None,
    block: bool = True,
    device: DeviceLike = "cuda",
) -> tuple[Params, WeightLoadReport]:
    """Streamed equivalent of ``loader.load_params`` (with ``quantize``, of
    ``quant.quantize_params(loader.load_params(...))``): the same tree bit
    for bit, built through the read → transfer → transform pipeline of the
    module docstring on ``device``. Returns (params, report)."""
    t_start = time.perf_counter()
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    dtype = model_dtype(dtype, config)
    workers = max(1, int(workers))
    index = ShardIndex(path)
    _check_index(index, config)
    L = config.n_layers
    norm_offset = 1.0 if _gemma_like(config) else 0.0
    spec = _layer_spec(config)
    quant_keys = set(_QUANT_LAYER_KEYS) if quantize else set()
    reader = _ShardReader(index, fault_injector)
    staging = _Staging()
    consumed: set[str] = set()

    # the stacked device buffers, allocated on the caller's stream; every
    # element is written by the load, so they start uninitialized
    exp = expected_params(config)
    bufs: dict[str, Any] = {}
    for key, _, _ in spec:
        shape = tuple(exp["layers"][key].shape)
        if key in quant_keys:
            bufs[key] = {
                "q": torch.empty(shape, dtype=torch.int8, device=dev),
                "s": torch.empty(shape[:-2] + (1, shape[-1]), dtype=torch.float32, device=dev),
            }
        else:
            bufs[key] = torch.empty(shape, dtype=dtype, device=dev)

    load_stream = torch.cuda.Stream(dev) if cuda else None
    if cuda:
        load_stream.wait_stream(torch.cuda.current_stream(dev))

    def on_load_stream():
        return torch.cuda.stream(load_stream) if cuda else contextlib.nullcontext()

    def new_event() -> Any:
        return torch.cuda.Event(enable_timing=True) if cuda else None

    def staging_buffer(nbytes: int) -> torch.Tensor:
        staging.grow(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)

    layer_names = [[fmt.format(i=i) for _, _, names in spec for fmt in names] for i in range(L)]
    layouts = [_layout(index, names) for names in layer_names]
    slot_bytes = max((size for _, size in layouts), default=0)
    window = min(workers + 1, L)  # readahead: workers busy + 1 done
    t_alloc = time.perf_counter()
    ring = [staging_buffer(slot_bytes) for _ in range(window)]
    # one buffer for the largest singleton (the embedding or the head)
    single = staging_buffer(max(
        index.ref(n).nbytes for n in ("embed_tokens.weight", "norm.weight", "lm_head.weight")
        if n in index.tensors
    ))
    staging_alloc_s = time.perf_counter() - t_alloc
    # one event per ring buffer: its last layer's host-to-device copies
    ring_events: list[Optional[Any]] = [None] * window

    def read_layer(i: int) -> None:
        """Stage 1 for layer ``i`` into ring buffer ``i % window`` (after
        the copies of the layer that used it last have run)."""
        slot = i % window
        if ring_events[slot] is not None:
            ring_events[slot].synchronize()
        buf = ring[slot]
        for name, off in layouts[i][0]:
            n = index.ref(name).nbytes
            t0 = time.perf_counter()
            reader.read_into(name, buf[off:off + n])
            staging.account(time.perf_counter() - t0, n)

    def staged(buf: torch.Tensor, name: str, off: int) -> torch.Tensor:
        ref = index.ref(name)
        return buf[off:off + ref.nbytes].view(ref.dtype).view(ref.shape)

    timings: list[tuple[Any, Any, Any]] = []  # (start, copied, transformed) events
    host_transfer_s = 0.0
    host_transform_s = 0.0

    def upload_layer(i: int) -> None:
        """Stages 2 and 3 for layer ``i``, on the load stream."""
        nonlocal host_transfer_s, host_transform_s
        slot = i % window
        t0 = time.perf_counter()
        marks = (new_event(), new_event(), new_event())
        with on_load_stream():
            if cuda:
                marks[0].record()
            dev_x = {name: staged(ring[slot], name, off).to(dev, non_blocking=True)
                     for name, off in layouts[i][0]}
            if cuda:
                if ring_events[slot] is None:
                    ring_events[slot] = torch.cuda.Event()
                ring_events[slot].record()
                marks[1].record()
            t1 = time.perf_counter()
            for key, kind, names in spec:
                xs = [dev_x[fmt.format(i=i)] for fmt in names]
                if kind == "norm":
                    x = xs[0] + norm_offset  # in the checkpoint's dtype, then cast
                elif kind == "t":
                    x = xs[0].t()
                else:
                    x = torch.stack([w.t() for w in xs])
                if key in quant_keys:
                    _quantize_into(x, dtype, bufs[key]["q"][i], bufs[key]["s"][i], -2)
                else:
                    bufs[key][i].copy_(x)
            if cuda:
                marks[2].record()
        consumed.update(dev_x)
        timings.append(marks)
        host_transfer_s += t1 - t0
        host_transform_s += time.perf_counter() - t1

    params: Params = {}
    single_event: Optional[Any] = None

    def upload_single(key: str, name: str, kind: str, mode: str) -> None:
        """A singleton (embed / final_norm / lm_head), read on the main
        thread into the singleton staging buffer, then uploaded, shaped and
        (``mode`` "row" / "col") quantized on the card a slice of HF rows at
        a time into its preallocated output, so the card never holds the
        whole model-dtype table, nor its f32 temporaries, beside the tree."""
        nonlocal single_event, host_transfer_s, host_transform_s
        ref = index.ref(name)
        if single_event is not None:
            single_event.synchronize()
        t0 = time.perf_counter()
        reader.read_into(name, single[:ref.nbytes])
        staging.account(time.perf_counter() - t0, ref.nbytes)
        consumed.add(name)
        host = staged(single, name, 0)
        ours = tuple(host.shape[::-1]) if kind == "t" else tuple(host.shape)
        if mode == "plain":
            out: Any = torch.empty(ours, dtype=dtype, device=dev)
        else:
            q = torch.empty(ours, dtype=torch.int8, device=dev)
            scales = ours[:-1] + (1,) if mode == "row" else (1, ours[-1])
            out = {"q": q, "s": torch.empty(scales, dtype=torch.float32, device=dev)}
        params[key] = out
        rows = host.shape[0]
        step = max(1, _CHUNK_ELEMS // max(1, host.numel() // rows))
        with on_load_stream():
            for r0 in range(0, rows, step):
                n = min(step, rows - r0)
                t1 = time.perf_counter()
                marks = (new_event(), new_event(), new_event())
                if cuda:
                    marks[0].record()
                x = host[r0:r0 + n].to(dev, non_blocking=True)
                if cuda:
                    marks[1].record()
                t2 = time.perf_counter()
                if kind == "norm":
                    x = x + norm_offset
                # the rows of an HF [out, in] matrix are our columns
                dim = 1 if kind == "t" else 0
                x = x.t() if kind == "t" else x
                if mode == "plain":
                    out.narrow(dim, r0, n).copy_(x)
                else:
                    _quantize_into(x, dtype, out["q"].narrow(dim, r0, n),
                                   out["s"].narrow(dim, r0, n), -2 if mode == "col" else -1)
                if cuda:
                    marks[2].record()
                timings.append(marks)
                host_transfer_s += t2 - t1
                host_transform_s += time.perf_counter() - t2
            if cuda:
                if single_event is None:
                    single_event = torch.cuda.Event()
                single_event.record()  # the staging buffer's last copy

    setup_s = time.perf_counter() - t_start
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="weight-load")
    ok = False
    try:
        futures: deque = deque(pool.submit(read_layer, i) for i in range(window))
        # the embedding, the largest single transfer, goes first on the
        # main thread while the pool reads the first layers
        upload_single("embed", "embed_tokens.weight", "plain",
                      "row" if quantize and config.tie_embeddings else "plain")
        for i in range(L):
            futures.popleft().result()
            upload_layer(i)
            if i + window < L:
                # ring buffer i % window is free once layer i's copies ran
                futures.append(pool.submit(read_layer, i + window))
        upload_single("final_norm", "norm.weight", "norm", "plain")
        if not config.tie_embeddings:
            upload_single("lm_head", "lm_head.weight", "t", "col" if quantize else "plain")
        elif "lm_head.weight" in index.tensors:
            consumed.add("lm_head.weight")  # some exports duplicate the tied head
        ok = True
    finally:
        # a failed read must not be retried nor keep pulling more of a
        # poisoned checkpoint: cancel the readahead, then drain
        pool.shutdown(wait=True, cancel_futures=True)
        reader.close()
        if cuda and not ok:
            load_stream.synchronize()  # no copy may land in freed memory

    params["layers"] = bufs
    params = {k: params[k] for k in ("embed", "layers", "final_norm", "lm_head") if k in params}
    unused = set(index.tensors) - consumed
    if unused:
        log.warning("checkpoint tensors unused by %s: %s", config.name, sorted(unused)[:10])

    ready = None
    transfer_s, transform_s = host_transfer_s, host_transform_s
    if cuda:
        ready = torch.cuda.Event()
        ready.record(load_stream)
        torch.cuda.current_stream(dev).wait_event(ready)
        # every output was made on the caller's stream and written on the
        # load stream: its memory must not be reused before that work ran
        for leaf in _leaves(params):
            leaf.record_stream(load_stream)
        if block:
            ready.synchronize()
            transfer_s = sum(a.elapsed_time(b) for a, b, _ in timings) / 1e3
            transform_s = sum(b.elapsed_time(c) for _, b, c in timings) / 1e3
    report = WeightLoadReport(
        streamed=True,
        workers=workers,
        quantize_on_load=bool(quantize),
        shards=len(index.files),
        tensors=len(consumed & set(index.tensors)),
        bytes_read=staging.bytes_read,
        read_s=staging.read_s,
        transform_s=transform_s,
        transfer_s=transfer_s,
        total_s=time.perf_counter() - t_start,
        staging_peak_bytes=staging.peak,
        blocked=bool(block),
        ready=None if block else ready,
        setup_s=setup_s,
        staging_alloc_s=staging_alloc_s,
    )
    log.info(
        "streamed weight load: %s — %d shards, %d tensors, %.2fGiB in %.2fs (read %.2fs, "
        "transfer %.2fs, transform %.2fs%s), staging peak %.1fMiB, %d workers%s",
        config.name, report.shards, report.tensors, report.bytes_read / 1024**3,
        report.total_s, report.read_s, report.transfer_s, report.transform_s,
        "" if block else " dispatched", report.staging_peak_bytes / 1024**2,
        report.workers, ", int8 on load" if quantize else "",
    )
    return params, report


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
