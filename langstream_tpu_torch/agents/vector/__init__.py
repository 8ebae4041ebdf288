"""The ``local-vector`` store: an embedded vector database whose top-k
similarity search runs on the card — the port of ``LocalVectorDataSource``
in ``langstream_tpu/agents/vector/__init__.py``.

Indexes hold (id, vector, metadata). The query dialect is JSON:
``{"index": "docs", "vector": [...], "topK": 5, "include-vectors": true}``
(``top-k`` for ``topK``; ``?`` placeholders anywhere in the document take
the positional params). Results: ``[{"id", "similarity", ...metadata}]``,
the stored vector after the metadata when asked for. Persistence: an
optional ``path`` (one ``.npz`` and one ``.json`` per index, the JAX
store's format, saved on ``flush`` / ``close``), so an index either store
saved loads in the other.

The search is the JAX store's: cosine similarity ``(row / (||row|| + 1e-9))
. (q / (||q|| + 1e-9))`` as one ``[rows, dim] @ [dim]`` product, then the
top ``k = min(top_k, capacity)`` scores with the lower row first among
equal scores (``lax.top_k``'s order). The matrix keeps the JAX layout on the
host (capacity from 16 rows, doubling on growth; an upsert of an existing
id overwrites its row in place), and one difference is deliberate: the
JAX store hands its host matrix to the jitted search at every call, which
uploads the whole index each search, while this store keeps a device copy
of the rows as the product reads them (each divided by its norm + 1e-9,
computed once when the row is written), writes every upserted row through
and reallocates it only when the capacity doubles. A search then reads the
valid rows once, at the card's memory rate; the rows past them (JAX's
``-inf`` mask) are not read at all, which leaves the answers the same.

``LocalVectorWriter`` is the vector-db-sink writer of this store: each
record's ``id`` / ``vector`` / field expressions evaluate through the
port's expression language (``agents/genai/el.py``) and the row is
upserted through the device copy. ``build_datasource`` resolves a
``datasource`` / ``vector-database`` resource of service ``local-vector``
(``in-memory``, ``tpu-vector``), and ``register`` puts both types in the
port's ``core.registry.REGISTRY``, as the JAX package registers them.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from langstream_tpu_torch.device import DeviceLike, resolve_device

_EPS = 1e-9
# rows normalised and copied to the card at once by a bulk write
_WRITE_ROWS = 1 << 16


def _normalize_rows(m: torch.Tensor) -> torch.Tensor:
    """Each row of ``m`` [n, dim] divided by its L2 norm + 1e-9, in f32."""
    m = m.float()
    return m / (torch.linalg.vector_norm(m, dim=1, keepdim=True) + _EPS)


class _TorchSimilarity:
    """Cosine top-k over a [rows, dim] matrix — the JAX store's
    ``_JitSimilarity`` as one matrix-vector product (``torch.matmul``, as
    the JAX package leaves it to XLA) and a top-k. Masked rows score
    ``-inf``. Ties: ``lax.top_k`` returns the lower index first among equal
    scores; ``torch.topk`` promises no order among them, so the scores are
    sorted with a STABLE descending sort (equal scores keep their row
    order) and the first k taken."""

    def __call__(self, query, matrix, valid, k: int, normalized: bool = False):
        """→ (scores [k], rows [k]) of the k best rows of ``matrix`` [rows,
        dim] for ``query`` [dim] (rows where ``valid`` [rows] is False at
        ``-inf``; None: every row valid). ``normalized``: the rows are
        already divided by their norms (the store's device copy)."""
        q = torch.as_tensor(query).float()
        qn = q / (torch.linalg.vector_norm(q) + _EPS)
        matrix = torch.as_tensor(matrix)
        scores = (matrix.float() if normalized else _normalize_rows(matrix)) @ qn
        if valid is not None:
            valid = torch.as_tensor(valid, device=scores.device)
            scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
        top, rows = torch.sort(scores, descending=True, stable=True)
        return top[:k], rows[:k]


class LocalVectorDataSource:
    """``service: local-vector`` — an embedded vector database on the card
    (``device``, default "cuda"; "cpu" runs the same code on the host).
    ``path`` persists each index as ``<name>.npz`` + ``<name>.json``."""

    def __init__(self, config: dict[str, Any]) -> None:
        self._indexes: dict[str, dict[str, Any]] = {}
        self._path = config.get("path")
        self.device = resolve_device(config.get("device", "cuda"))
        self._search = _TorchSimilarity()
        if self._path:
            self._load()

    def _index(self, name: str, dim: Optional[int] = None) -> dict[str, Any]:
        if name not in self._indexes:
            if dim is None:
                raise ValueError(f"vector index {name!r} does not exist")
            self._indexes[name] = {
                "dim": dim,
                "ids": [],
                "pos": {},
                "matrix": np.zeros((16, dim), dtype=np.float32),
                "meta": [],
                # the card's copy of the rows as the product reads them
                "dev": torch.zeros((16, dim), dtype=torch.float32, device=self.device),
            }
        return self._indexes[name]

    def create_index(self, name: str, dim: int) -> None:
        self._index(name, dim)

    def delete_index(self, name: str) -> None:
        self._indexes.pop(name, None)
        if self._path:
            for suffix in (".npz", ".json"):
                f = Path(self._path) / f"{name}{suffix}"
                if f.exists():
                    f.unlink()

    def flush(self) -> None:
        if self._path:
            self._save()

    def has_index(self, name: str) -> bool:
        return name in self._indexes

    def _grow(self, idx: dict[str, Any], rows: int) -> None:
        """Double the capacity until ``rows`` fit, host and card alike (the
        card's old copy is released before the new one is made)."""
        cap = idx["matrix"].shape[0]
        if rows <= cap:
            return
        while cap < rows:
            cap *= 2
        n = len(idx["ids"])
        grown = np.zeros((cap, idx["dim"]), dtype=np.float32)
        grown[:n] = idx["matrix"][:n]
        idx["matrix"] = grown
        old, idx["dev"] = idx["dev"], None
        dev = torch.zeros((cap, idx["dim"]), dtype=torch.float32, device=self.device)
        dev[:n].copy_(old[:n])
        del old
        idx["dev"] = dev

    def _write_rows(self, idx: dict[str, Any], rows: np.ndarray, vectors: np.ndarray) -> None:
        """Write ``vectors`` [n, dim] at ``rows`` [n] on the host and through
        to the card, normalised there in slices of ``_WRITE_ROWS``."""
        idx["matrix"][rows] = vectors
        for a in range(0, len(rows), _WRITE_ROWS):
            block = torch.from_numpy(np.ascontiguousarray(vectors[a:a + _WRITE_ROWS]))
            at = torch.from_numpy(rows[a:a + _WRITE_ROWS]).to(self.device)
            idx["dev"][at] = _normalize_rows(block.to(self.device))

    def upsert(self, index: str, id_: str, vector: list[float], meta: dict[str, Any]) -> None:
        self.upsert_many(index, [id_], np.asarray(vector, dtype=np.float32)[None], [meta])

    def upsert_many(self, index: str, ids: list[str], vectors: np.ndarray,
                    metas: list[dict[str, Any]]) -> None:
        """``upsert`` of many rows in one write: each id in order, an
        existing id overwriting its row in place, a new one appended."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or len(vectors) != len(ids) or len(metas) != len(ids):
            raise ValueError(f"{len(ids)} ids, {len(metas)} metas, vectors {vectors.shape}")
        idx = self._index(index, dim=vectors.shape[1])
        if vectors.shape[1] != idx["dim"]:
            raise ValueError(f"vector dim {vectors.shape[1:]} != index dim {idx['dim']}")
        rows = np.empty(len(ids), np.int64)
        new = 0
        for i, id_ in enumerate(ids):
            row = idx["pos"].get(id_)
            if row is None:
                row = len(idx["ids"]) + new
                new += 1
                idx["pos"][id_] = row
            rows[i] = row
        self._grow(idx, len(idx["ids"]) + new)
        for i, id_ in enumerate(ids):
            if rows[i] >= len(idx["ids"]):
                idx["ids"].append(id_)
                idx["meta"].append(metas[i])
            else:
                idx["meta"][rows[i]] = metas[i]
        # a repeated id within the batch: its last vector wins, as in order
        last = {r: i for i, r in enumerate(rows.tolist())}
        keep = np.array(sorted(last.values()), np.int64)
        self._write_rows(idx, rows[keep], vectors[keep])

    def search(
        self,
        index: str,
        vector: list[float],
        top_k: int = 5,
        include_vectors: bool = False,
    ) -> list[dict[str, Any]]:
        idx = self._index(index)
        n = len(idx["ids"])
        if n == 0:
            return []
        k = min(top_k, idx["matrix"].shape[0])
        query = torch.as_tensor(np.asarray(vector, dtype=np.float32)).to(self.device)
        scores, rows = self._search(query, idx["dev"][:n], None, k, normalized=True)
        out = []
        for s, r in zip(scores.tolist(), rows.tolist()):
            if not math.isfinite(float(s)):
                continue
            row = {"id": idx["ids"][r], "similarity": float(s), **idx["meta"][r]}
            if include_vectors:
                # after the metadata, so a stale meta "vector" cannot shadow it
                row["vector"] = idx["matrix"][r].tolist()
            out.append(row)
        return out[:top_k]

    # -- the DataSource contract (JSON dialect) ---------------------------------

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        q = json.loads(query) if isinstance(query, str) else dict(query)
        # positional params substitute "?" placeholders anywhere in the doc
        q = _substitute_params(q, list(params))
        index = q.get("index", "default")
        vector = q.get("vector")
        if vector is None:
            raise ValueError("local-vector query requires a 'vector' field")
        return self.search(
            index,
            vector,
            int(q.get("topK", q.get("top-k", 5))),
            include_vectors=bool(q.get("include-vectors", False)),
        )

    async def close(self) -> None:
        if self._path:
            self._save()

    # -- persistence ------------------------------------------------------------

    def _save(self) -> None:
        root = Path(self._path)
        root.mkdir(parents=True, exist_ok=True)
        for name, idx in self._indexes.items():
            n = len(idx["ids"])
            np.savez(root / f"{name}.npz", matrix=idx["matrix"][:n])
            (root / f"{name}.json").write_text(
                json.dumps({"dim": idx["dim"], "ids": idx["ids"], "meta": idx["meta"]})
            )

    def _load(self) -> None:
        root = Path(self._path)
        if not root.exists():
            return
        for meta_file in root.glob("*.json"):
            name = meta_file.stem
            info = json.loads(meta_file.read_text())
            data = np.load(root / f"{name}.npz")["matrix"]
            self.create_index(name, info["dim"])
            if info["ids"]:
                self.upsert_many(name, list(info["ids"]), data[: len(info["ids"])],
                                 list(info["meta"]))


def _substitute_params(obj: Any, params: list[Any]) -> Any:
    if isinstance(obj, dict):
        return {k: _substitute_params(v, params) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute_params(v, params) for v in obj]
    if obj == "?" and params:
        return params.pop(0)
    return obj


class LocalVectorWriter:
    """vector-db-sink writer for the local vector store (the JAX package's
    ``LocalVectorWriter``): ``index-name`` (or ``table-name``, default
    "default"), the ``id`` expression (default ``fn:uuid()``), the
    ``vector`` expression (default ``value.embeddings``) and ``fields``
    (``{name, expression}``) for the row's metadata."""

    def __init__(self, datasource: LocalVectorDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
        self.index = config.get("index-name", config.get("table-name", "default"))
        self.id_expr = config.get("id", "fn:uuid()")
        self.vector_expr = config.get("vector", "value.embeddings")
        self.metadata_fields = list(config.get("fields", []))

    async def upsert(self, record: Any, context: dict[str, Any]) -> None:
        from langstream_tpu_torch.agents.genai import el
        from langstream_tpu_torch.agents.genai.mutable import MutableRecord

        ctx = MutableRecord.from_record(record)
        id_ = str(el.evaluate(self.id_expr, ctx))
        vector = el.evaluate(self.vector_expr, ctx)
        if vector is None:
            raise ValueError(f"vector expression {self.vector_expr!r} produced None")
        meta = {
            f["name"]: el.evaluate(f.get("expression", "value"), ctx)
            for f in self.metadata_fields
        }
        self.datasource.upsert(self.index, id_, list(map(float, vector)), meta)


def build_datasource(config: dict[str, Any]) -> LocalVectorDataSource:
    """The datasource a resource's ``service`` names: the port serves the
    local vector store (``local-vector``, ``in-memory``, ``tpu-vector``);
    any other service raises ValueError."""
    service = config.get("service", "jdbc")
    if service in ("local-vector", "in-memory", "tpu-vector"):
        return LocalVectorDataSource(config)
    raise ValueError(
        f"datasource service {service!r} is not served by the PyTorch port "
        "(local-vector only)"
    )


def register() -> None:
    """Register the ``datasource`` and ``vector-database`` resource types
    (factory ``build_datasource``) in the port's registry."""
    from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
    from langstream_tpu_torch.core.registry import REGISTRY, ResourceTypeInfo

    for rtype in ("datasource", "vector-database"):
        REGISTRY.register_resource(
            ResourceTypeInfo(
                type=rtype,
                factory=build_datasource,
                description="Vector datasource (local-vector, on the card).",
                config_model=ConfigModel(
                    type=rtype,
                    properties=props(
                        ConfigProperty("service", "backend service", required=True),
                        ConfigProperty("path", "persistence dir (local-vector)"),
                        ConfigProperty("device", "cuda (default) or cpu"),
                    ),
                    allow_unknown=True,
                ),
            )
        )
