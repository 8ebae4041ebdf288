"""Multi-LoRA adapters: many logical models, one hot engine (port of
``langstream_tpu/serving/adapters.py``).

The engine keeps a fixed-shape device pool of stacked low-rank factors,
and every decode, verify and prefill gathers each row's factors by its
adapter row (``models/transformer.py`` ``_lora_delta``), so a batch of base
requests and N adapters mixed is one captured program.

- ``AdapterSpec``: one logical adapter — name, rank, scale (alpha/rank),
  and where its factors come from (a peft safetensors directory through
  ``models/loader.load_lora_params``, or a seed for random factors).
- ``AdapterRegistry``: the device pool — per projection ``{"a": [L, rows,
  din, r], "b": [L, rows, r, dout]}`` plus ``"scale": [rows]``, allocated
  once; row 0 is the all-zero base row — and the host bookkeeping that
  makes residency a cache: refcounted rows (a row serving an active slot
  is pinned), LRU eviction under pool pressure. A swap-in writes the row
  in place from pinned staging copies enqueued on the caller's current
  stream (the engine thread's, behind every chunk already in flight):
  the captured graphs hold the pool's addresses, so it is never rebound.

Registration is host work only (``register()`` loads or draws the factors
as numpy); ``acquire()`` makes them resident at first use, so more
adapters may be registered than the pool has rows. Adapters of a smaller
rank than the pool's are zero-padded (zero columns add nothing to ``(x @
A) @ B``); a larger rank is refused at registration. MoE configs carry
attention-only adapters; dense configs adapt all seven projections.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device
from langstream_tpu_torch.models.configs import ModelConfig

log = logging.getLogger(__name__)

# the base request (no adapter) rides pool row 0, the all-zero row
BASE_ROW = 0


class AdapterPoolExhausted(RuntimeError):
    """Every pool row is pinned by an active request — a transient
    saturation: the engine sheds the admission with a retry-after, it never
    evicts a resident tenant in use."""


def _proj_dims(config: ModelConfig) -> dict[str, tuple[int, int]]:
    """(din, dout) per adapted projection. MoE: attention only."""
    d, hd = config.d_model, config.resolved_head_dim
    h, hkv, f = config.n_heads, config.n_kv_heads, config.d_ff
    dims = {
        "wq": (d, h * hd),
        "wk": (d, hkv * hd),
        "wv": (d, hkv * hd),
        "wo": (h * hd, d),
    }
    if not config.is_moe:
        dims.update({
            "w_gate": (d, f),
            "w_up": (d, f),
            "w_down": (f, d),
        })
    return dims


def _pool_dtype(config: ModelConfig, dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from langstream_tpu_torch.models.bridge import torch_dtype

    return torch_dtype(dtype or config.dtype)


def make_lora_pool(
    config: ModelConfig, rows: int, rank: int, dtype: Any = None, device: DeviceLike = "cuda"
) -> dict:
    """The device pool: per projection ``{"a": [L, rows, din, rank], "b":
    [L, rows, rank, dout]}`` plus ``"scale": [rows]`` f32 — all zeros, so
    every row is the base row until a swap-in loads it."""
    dev = resolve_device(device)
    dt = _pool_dtype(config, dtype)
    n_layers = config.n_layers
    pool: dict[str, Any] = {}
    for proj, (din, dout) in _proj_dims(config).items():
        pool[proj] = {
            "a": torch.zeros((n_layers, rows, din, rank), dtype=dt, device=dev),
            "b": torch.zeros((n_layers, rows, rank, dout), dtype=dt, device=dev),
        }
    pool["scale"] = torch.zeros((rows,), dtype=torch.float32, device=dev)
    return pool


def lora_pool_bytes(config: ModelConfig, rows: int, rank: int, dtype: Any = None) -> int:
    """The pool's bytes without allocating it (the memory plan's term)."""
    if rows <= 0 or rank <= 0:
        return 0
    itemsize = torch.empty((), dtype=_pool_dtype(config, dtype), device="meta").element_size()
    per_row = sum(
        (din + dout) * rank * config.n_layers * itemsize
        for din, dout in _proj_dims(config).values()
    )
    return rows * per_row + rows * 4  # + the f32 scale vector


def rows_for_fraction(
    config: ModelConfig,
    rank: int,
    weights_bytes: int,
    fraction: float,
    n_registered: int = 0,
) -> int:
    """Pool rows from the ``adapter-pool-fraction`` budget: as many rows as
    ``fraction × weights_bytes`` holds, floored at 2 (base + one adapter)
    and at one row per registered adapter plus the base row, capped at 65."""
    per_row = lora_pool_bytes(config, 1, rank)
    if per_row <= 0:
        return 0
    by_budget = int(max(0.0, fraction) * weights_bytes // per_row)
    return max(2, min(65, max(by_budget, n_registered + 1)))


def init_random_lora(
    config: ModelConfig, rank: int, seed: int
) -> dict[str, dict[str, np.ndarray]]:
    """Random adapter factors (tests, the card's smoke run): the JAX
    package's numpy draws, so one seed gives the same factors in both.
    BOTH factors are random (standard LoRA starts B at zero): a test
    adapter must change the output."""
    rng = np.random.default_rng(seed)
    n_layers = config.n_layers
    out: dict[str, dict[str, np.ndarray]] = {}
    for proj, (din, dout) in _proj_dims(config).items():
        out[proj] = {
            "a": (rng.standard_normal((n_layers, din, rank)) / math.sqrt(din)).astype(
                np.float32
            ),
            "b": (rng.standard_normal((n_layers, rank, dout)) / math.sqrt(rank)).astype(
                np.float32
            ),
        }
    return out


@dataclass
class AdapterSpec:
    """One logical adapter, as configured (the provider's ``adapters``)."""

    name: str
    rank: int = 8
    # the LoRA scaling alpha/rank, configured directly
    scale: float = 1.0
    path: Optional[str] = None  # peft safetensors dir (models/loader)
    seed: Optional[int] = None  # random factors otherwise

    @staticmethod
    def from_dict(d: dict) -> "AdapterSpec":
        return AdapterSpec(
            name=str(d["name"]),
            rank=int(d.get("rank", 8)),
            scale=float(d.get("scale", 1.0)),
            path=d.get("path"),
            seed=int(d["seed"]) if d.get("seed") is not None else None,
        )


@dataclass
class _AdapterState:
    spec: AdapterSpec
    host: dict  # per projection {"a": [L, din, r], "b": [L, r, dout]} numpy
    row: Optional[int] = None  # pool row when resident
    refs: int = 0  # active slots decoding with this adapter
    last_used: int = 0
    loads: int = 0  # times swapped onto the device


class AdapterRegistry:
    """Host bookkeeping + device pool for hot-swappable LoRA adapters.

    Mutations run on the engine thread (acquire / release ride admissions
    and completions); ``advertised()`` and ``stats()`` may be read from
    other threads, hence the lock around the advertised snapshot."""

    _GUARDED = {"_ad_lock": ("_advertised",)}

    def __init__(
        self,
        config: ModelConfig,
        rows: int,
        rank: int,
        dtype: Any = None,
        device: DeviceLike = "cuda",
    ) -> None:
        if rows < 2 or rank < 1:
            raise ValueError(
                f"adapter pool needs >= 2 rows (base + 1) and rank >= 1; "
                f"got rows={rows} rank={rank}"
            )
        self.config = config
        self.rows = int(rows)
        self.rank = int(rank)
        self.device = resolve_device(device)
        self.pool = make_lora_pool(config, self.rows, self.rank, dtype, self.device)
        self.pool_bytes = lora_pool_bytes(config, self.rows, self.rank, dtype)
        self._by_name: dict[str, _AdapterState] = {}
        self._row_owner: dict[int, _AdapterState] = {}
        self._free_rows = list(range(self.rows - 1, BASE_ROW, -1))
        self._tick = 0
        self._ad_lock = threading.Lock()
        self._advertised: tuple[str, ...] = ()
        # cumulative stats; swap_s_total is the host time of the swap-ins
        # (staging; the copies themselves run on the stream)
        self.swaps_total = 0
        self.registered_total = 0
        self.swap_s_total = 0.0

    # -- registration (control plane) ----------------------------------------

    def register(self, spec: AdapterSpec | dict) -> None:
        """Load or draw the adapter host-side and make it acquirable. No
        device work — residency happens at first acquire. Registering a
        name again replaces its factors (the next acquire uploads them)."""
        if isinstance(spec, dict):
            spec = AdapterSpec.from_dict(spec)
        if spec.rank > self.rank:
            raise ValueError(
                f"adapter {spec.name!r} rank {spec.rank} exceeds the pool "
                f"rank {self.rank}; raise the pool rank (all adapters share "
                "one padded rank — the pool shape is the compile surface)"
            )
        if spec.path:
            from langstream_tpu_torch.models.loader import load_lora_params

            host = load_lora_params(spec.path, self.config, spec.rank)
        else:
            host = init_random_lora(
                self.config, spec.rank, spec.seed if spec.seed is not None else 0
            )
        host = self._pad_rank(host, spec.rank)
        old = self._by_name.get(spec.name)
        if old is not None and old.row is not None:
            # replaced while resident: drop the stale row (a pinned adapter
            # waits for its requests to finish)
            if old.refs > 0:
                raise ValueError(
                    f"adapter {spec.name!r} is serving {old.refs} active "
                    "request(s); drain before replacing its weights"
                )
            self._evict_state(old)
        self._by_name[spec.name] = _AdapterState(spec=spec, host=host)
        self.registered_total += 1

    def unregister(self, name: str) -> None:
        state = self._by_name.get(name)
        if state is None:
            return
        if state.refs > 0:
            raise ValueError(
                f"adapter {name!r} is serving {state.refs} active request(s)"
            )
        if state.row is not None:
            self._evict_state(state)
        del self._by_name[name]

    def _pad_rank(self, host: dict, rank: int) -> dict:
        if rank == self.rank:
            return host
        pad = self.rank - rank
        out = {}
        for proj, ab in host.items():
            out[proj] = {
                "a": np.pad(ab["a"], ((0, 0), (0, 0), (0, pad))),
                "b": np.pad(ab["b"], ((0, 0), (0, pad), (0, 0))),
            }
        return out

    # -- residency (data plane) ----------------------------------------------

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def acquire(self, name: str) -> int:
        """An adapter name's pool row, swapped in (evicting the LRU unpinned
        row) when not resident. Refcounted; the caller releases it once the
        request finishes. Raises KeyError for an unknown name and
        AdapterPoolExhausted when every row is pinned."""
        state = self._by_name.get(name)
        if state is None:
            raise KeyError(
                f"unknown adapter {name!r}; registered: {self.names()}"
            )
        self._tick += 1
        state.last_used = self._tick
        if state.row is None:
            self._swap_in(state)
        state.refs += 1
        return state.row

    def release(self, name: str) -> None:
        state = self._by_name.get(name)
        if state is None:
            return  # unregistered while in flight — row already recycled
        assert state.refs > 0, name
        state.refs -= 1

    def _swap_in(self, state: _AdapterState) -> None:
        t0 = time.monotonic()
        if not self._free_rows:
            victims = [s for s in self._row_owner.values() if s.refs == 0]
            if not victims:
                raise AdapterPoolExhausted(
                    f"all {self.rows - 1} adapter rows are pinned by active "
                    "requests; raise adapter-pool-fraction or retry"
                )
            self._evict_state(min(victims, key=lambda s: s.last_used))
        row = self._free_rows.pop()
        for proj, ab in state.host.items():
            for factor, host in ab.items():
                dst = self.pool[proj][factor]
                # cast on the host (round to nearest even, as the JAX
                # package's astype), then one asynchronous copy a factor
                staged = torch.from_numpy(np.ascontiguousarray(host)).to(dst.dtype)
                if dst.device.type == "cuda":
                    staged = staged.pin_memory()
                dst[:, row].copy_(staged, non_blocking=True)
        self.pool["scale"][row].fill_(float(state.spec.scale))
        state.row = row
        state.loads += 1
        self._row_owner[row] = state
        self.swaps_total += 1
        self.swap_s_total += time.monotonic() - t0
        self._refresh_advertised()

    def _evict_state(self, state: _AdapterState) -> None:
        assert state.refs == 0
        row = state.row
        state.row = None
        if row is not None:
            self._row_owner.pop(row, None)
            self._free_rows.append(row)
        self._refresh_advertised()
        # the stale factors stay in the row until the next upload: only
        # adapter rows reach a row, and nothing maps to an orphaned one

    # -- observability --------------------------------------------------------

    def _refresh_advertised(self) -> None:
        resident = tuple(sorted(s.spec.name for s in self._row_owner.values()))
        with self._ad_lock:
            self._advertised = resident

    def advertised(self) -> tuple[str, ...]:
        """Resident adapter names (names, never weights)."""
        with self._ad_lock:
            return self._advertised

    @property
    def resident(self) -> int:
        return len(self._row_owner)

    def stats(self) -> dict[str, Any]:
        return {
            "registered": len(self._by_name),
            "resident": self.resident,
            "rows": self.rows - 1,  # usable rows (base row excluded)
            "rank": self.rank,
            "swaps-total": self.swaps_total,
            "pool-bytes": self.pool_bytes,
        }
