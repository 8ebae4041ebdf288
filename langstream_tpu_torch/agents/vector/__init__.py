"""Vector / SQL datasources and the RAG agents — the port of
``langstream_tpu/agents/vector/__init__.py``: the ``jdbc`` store (stdlib
sqlite3) and its table writer, the ``local-vector`` store whose top-k runs
on the card, the resolution of every datasource service (the remote HTTP
stores in ``remote.py`` / ``milvus.py``, Cassandra and Astra over the CQL
protocol in ``cassandra.py``), the agents ``vector-db-sink``,
``query-vector-db``, ``re-rank`` (MMR or cosine) and ``flare-controller``,
and the ``vector-index`` / ``jdbc-table`` / Cassandra / Milvus asset
managers, registered with the JAX package's config models.

The ``local-vector`` store: an embedded vector database whose top-k
similarity search runs on the card.

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
upserted through the device copy.

The sqlite calls run in a worker thread under one lock, so a query or an
upsert never holds the event loop the gateway, the broker and the serving
provider's chunk writer share.
"""

from __future__ import annotations

import asyncio
import json
import math
import re
import sqlite3
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.api.agent import AgentSink, ComponentType, SingleRecordProcessor
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.api.storage import AssetManager, DataSource, VectorDatabaseWriter
from langstream_tpu_torch.core.registry import (
    REGISTRY,
    AgentTypeInfo,
    AssetTypeInfo,
    ResourceTypeInfo,
)
from langstream_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# SQLite datasource (the bundled "jdbc" driver)
# ---------------------------------------------------------------------------


class SqliteDataSource(DataSource):
    """``service: jdbc`` datasource backed by stdlib sqlite3 (reference
    jdbc/JdbcDataSource). Queries use ``?`` positional params; the sqlite
    calls run in a worker thread (one connection, one lock)."""

    def __init__(self, config: dict[str, Any]) -> None:
        url = config.get("url", ":memory:")
        if url.startswith("jdbc:sqlite:"):
            url = url[len("jdbc:sqlite:"):]
        # a URI url (file:...?cache=shared, the way to share an in-memory
        # database between connections) needs uri=True
        uri = url.startswith("file:")
        if url.startswith(":memory:"):
            url = ":memory:"
        self._conn = sqlite3.connect(url, uri=uri, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = asyncio.Lock()

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        async with self._lock:
            return await asyncio.to_thread(self._fetch, query, params)

    def _fetch(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        cur = self._conn.execute(query, [_to_sql_param(p) for p in params])
        return [dict(r) for r in cur.fetchall()]

    async def execute_statement(self, query: str, params: list[Any]) -> dict[str, Any]:
        async with self._lock:
            return await asyncio.to_thread(self._execute, query, params)

    def _execute(self, query: str, params: list[Any]) -> dict[str, Any]:
        cur = self._conn.execute(query, [_to_sql_param(p) for p in params])
        self._conn.commit()
        return {"generated-keys": [cur.lastrowid], "count": cur.rowcount}

    async def close(self) -> None:
        self._conn.close()


def _to_sql_param(p: Any) -> Any:
    if isinstance(p, (list, dict)):
        return json.dumps(p)
    return p


class JdbcTableWriter(VectorDatabaseWriter):
    """vector-db-sink writer for SQL tables: upsert by the configured
    fields (reference jdbc/JdbcWriter)."""

    def __init__(self, datasource: SqliteDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
        self.table = config.get("table-name", "documents")
        self.fields = list(config.get("fields", []))

    async def upsert(self, record: Any, context: dict[str, Any]) -> None:
        ctx = MutableRecord.from_record(record)
        names, values, keys = [], [], []
        for f in self.fields:
            names.append(f["name"])
            values.append(_to_sql_param(el.evaluate(f.get("expression", "value"), ctx)))
            if f.get("primary-key"):
                keys.append(f["name"])
        cols = ", ".join(names)
        placeholders = ", ".join("?" for _ in names)
        sql = f"INSERT INTO {self.table} ({cols}) VALUES ({placeholders})"
        if keys:
            updates = ", ".join(f"{n}=excluded.{n}" for n in names if n not in keys)
            conflict = f" ON CONFLICT ({', '.join(keys)})"
            sql += f"{conflict} DO UPDATE SET {updates}" if updates else f"{conflict} DO NOTHING"
        await self.datasource.execute_statement(sql, values)


# ---------------------------------------------------------------------------
# the local vector store, on the card
# ---------------------------------------------------------------------------

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


class LocalVectorDataSource(DataSource):
    """``service: local-vector`` — an embedded vector database on the card
    (``device``, default "cuda"; "cpu" runs the same code on the host).
    ``path`` persists each index as ``<name>.npz`` + ``<name>.json``."""

    def __init__(self, config: dict[str, Any]) -> None:
        self._indexes: dict[str, dict[str, Any]] = {}
        self._path = config.get("path")
        self.device = resolve_device(config.get("device", "cuda"))
        # the store's device work (row writes, searches) runs in order on a
        # stream of its own: on the legacy default stream a search would
        # wait for the serving engine's decode chunk in flight
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._search = _TorchSimilarity()
        if self._path:
            self._load()

    def _index(self, name: str, dim: Optional[int] = None) -> dict[str, Any]:
        if name not in self._indexes:
            if dim is None:
                raise ValueError(f"vector index {name!r} does not exist")
            with torch.cuda.stream(self._stream):
                dev = torch.zeros((16, dim), dtype=torch.float32, device=self.device)
            self._indexes[name] = {
                "dim": dim,
                "ids": [],
                "pos": {},
                "matrix": np.zeros((16, dim), dtype=np.float32),
                "meta": [],
                # the card's copy of the rows as the product reads them
                "dev": dev,
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
        with torch.cuda.stream(self._stream):
            dev = torch.zeros((cap, idx["dim"]), dtype=torch.float32, device=self.device)
            dev[:n].copy_(old[:n])
            del old
        idx["dev"] = dev

    def _write_rows(self, idx: dict[str, Any], rows: np.ndarray, vectors: np.ndarray) -> None:
        """Write ``vectors`` [n, dim] at ``rows`` [n] on the host and through
        to the card, normalised there in slices of ``_WRITE_ROWS``."""
        idx["matrix"][rows] = vectors
        with torch.cuda.stream(self._stream):
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
        with torch.cuda.stream(self._stream):
            query = torch.as_tensor(np.asarray(vector, dtype=np.float32)).to(self.device)
            scores, rows = self._search(query, idx["dev"][:n], None, k, normalized=True)
            # read back on the store's stream (waits for it alone)
            scores, rows = scores.tolist(), rows.tolist()
        out = []
        for s, r in zip(scores, rows):
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


class LocalVectorWriter(VectorDatabaseWriter):
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




# ---------------------------------------------------------------------------
# datasource resource resolution
# ---------------------------------------------------------------------------


def build_datasource(config: dict[str, Any]) -> DataSource:
    """The datasource a resource's ``service`` names; an unknown service
    raises ValueError."""
    service = config.get("service", "jdbc")
    if service in ("jdbc", "sqlite"):
        return SqliteDataSource(config)
    if service in ("local-vector", "in-memory", "tpu-vector"):
        return LocalVectorDataSource(config)
    if service in ("pinecone", "opensearch", "solr"):
        from langstream_tpu_torch.agents.vector import remote

        cls = {
            "pinecone": remote.PineconeDataSource,
            "opensearch": remote.OpenSearchDataSource,
            "solr": remote.SolrDataSource,
        }[service]
        return cls(config)
    if service in ("cassandra", "astra", "astra-vector-db"):
        from langstream_tpu_torch.agents.vector.cassandra import CassandraDataSource

        return CassandraDataSource(config)
    if service == "milvus":
        from langstream_tpu_torch.agents.vector.milvus import MilvusDataSource

        return MilvusDataSource(config)
    raise ValueError(f"unknown datasource service {service!r}")


def build_writer(datasource: DataSource, config: dict[str, Any]) -> VectorDatabaseWriter:
    """The vector-db-sink writer of a datasource."""
    from langstream_tpu_torch.agents.vector import remote
    from langstream_tpu_torch.agents.vector.cassandra import CassandraDataSource, CassandraWriter
    from langstream_tpu_torch.agents.vector.milvus import MilvusDataSource, MilvusWriter

    writers = (
        (LocalVectorDataSource, LocalVectorWriter),
        (SqliteDataSource, JdbcTableWriter),
        (remote.PineconeDataSource, remote.PineconeWriter),
        (remote.OpenSearchDataSource, remote.OpenSearchWriter),
        (remote.SolrDataSource, remote.SolrWriter),
        (CassandraDataSource, CassandraWriter),
        (MilvusDataSource, MilvusWriter),
    )
    for source, writer in writers:
        if isinstance(datasource, source):
            return writer(datasource, config)
    raise ValueError(f"no vector writer for datasource {type(datasource).__name__}")


# ---------------------------------------------------------------------------
# agents
# ---------------------------------------------------------------------------


class VectorDBSinkAgent(AgentSink):
    """``vector-db-sink``: upsert each record into the configured datasource
    (reference VectorDBSinkAgent; per-DB writers)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self._config = dict(configuration)
        self._writer: Optional[VectorDatabaseWriter] = None

    async def start(self) -> None:
        assert self.context is not None
        registry = self.context.get_service_provider_registry()
        datasource = registry.get_datasource(self._config.get("datasource"))
        self._writer = build_writer(datasource, self._config)
        await self._writer.init(self._config)

    async def write(self, record: Record) -> None:
        assert self._writer is not None
        await self._writer.upsert(record, {})
        self.processed(1)

    async def close(self) -> None:
        if self._writer is not None:
            await self._writer.close()


class QueryVectorDBAgent(SingleRecordProcessor):
    """``query-vector-db``: the GenAI ``query`` step as an agent of its own
    (reference QueryVectorDBAgentProvider): ``mode: execute`` runs the
    statement, else the rows (``only-first``: the first row or None) land
    in ``output-field``."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.query = configuration.get("query", "")
        self.fields = list(configuration.get("fields", []))
        self.output_field = configuration.get("output-field", "value.query-result")
        self.only_first = bool(configuration.get("only-first", False))
        self.mode = configuration.get("mode", "query")
        self.datasource_name = configuration.get("datasource")
        self._datasource: Optional[DataSource] = None

    async def start(self) -> None:
        assert self.context is not None
        registry = self.context.get_service_provider_registry()
        self._datasource = registry.get_datasource(self.datasource_name)

    async def process_record(self, record: Record) -> list[Record]:
        assert self._datasource is not None
        ctx = MutableRecord.from_record(record)
        params = [el.evaluate(f, ctx) for f in self.fields]
        if self.mode == "execute":
            result: Any = await self._datasource.execute_statement(self.query, params)
        else:
            rows = await self._datasource.fetch_data(self.query, params)
            result = (rows[0] if rows else None) if self.only_first else rows
        ctx.set_field(self.output_field, result)
        self.processed(1)
        return [ctx.to_record()]


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(np.linalg.norm(a) * np.linalg.norm(b)) + 1e-9
    return float(np.dot(a, b)) / denom


class ReRankAgent(SingleRecordProcessor):
    """``re-rank``: re-order candidate documents against the query with MMR
    (Maximal Marginal Relevance; reference rerank/ReRankAgent.java) or by
    plain cosine relevance, on the host in f32.

    Reads the candidates from ``field``, the query vector from
    ``query-embeddings``, each candidate's vector from ``embeddings-field``
    (``record`` bound to the candidate) and writes the best ``max`` to
    ``output-field``: the documents, or (``output-mode: text``) each one's
    ``text-field``. Ties keep the first best (a strictly greater score
    wins)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.field = configuration.get("field", "value.query-result")
        self.output_field = configuration.get("output-field", self.field)
        self.query_embeddings = configuration.get("query-embeddings", "value.embeddings")
        self.embeddings_field = configuration.get("embeddings-field", "record.embeddings")
        self.text_field = configuration.get("text-field", "record.text")
        self.algorithm = configuration.get("algorithm", "MMR")
        self.lambda_ = float(configuration.get("lambda", 0.5))
        self.max = int(configuration.get("max", 5))
        self.output_mode = configuration.get("output-mode", "documents")

    async def process_record(self, record: Record) -> list[Record]:
        ctx = MutableRecord.from_record(record)
        docs = el.evaluate(self.field, ctx) or []
        query_vec = el.evaluate(self.query_embeddings, ctx)
        self.processed(1)
        if not docs or query_vec is None:
            ctx.set_field(self.output_field, self._project(docs, ctx))
            return [ctx.to_record()]
        q = np.asarray(query_vec, dtype=np.float32)
        vecs = []
        for d in docs:
            v = el.evaluate(self.embeddings_field, ctx, extra={"record": d})
            vecs.append(np.asarray(v, dtype=np.float32) if v is not None else None)
        if self.algorithm.upper() == "MMR":
            ranked = self._mmr(docs, vecs, q)
        else:  # plain cosine relevance
            scored = sorted(
                range(len(docs)),
                key=lambda i: -(_cosine(vecs[i], q) if vecs[i] is not None else -1.0),
            )
            ranked = [docs[i] for i in scored[: self.max]]
        ctx.set_field(self.output_field, self._project(ranked, ctx))
        return [ctx.to_record()]

    def _project(self, docs: list, ctx: MutableRecord) -> list:
        if self.output_mode != "text":
            return docs
        return [str(el.evaluate(self.text_field, ctx, extra={"record": d}) or "") for d in docs]

    def _mmr(self, docs: list, vecs: list, q: np.ndarray) -> list:
        selected: list[int] = []
        candidates = [i for i in range(len(docs)) if vecs[i] is not None]
        while candidates and len(selected) < self.max:
            best, best_score = None, -np.inf
            for i in candidates:
                relevance = _cosine(vecs[i], q)
                redundancy = max((_cosine(vecs[i], vecs[j]) for j in selected), default=0.0)
                score = self.lambda_ * relevance - (1 - self.lambda_) * redundancy
                if score > best_score:
                    best, best_score = i, score
            assert best is not None
            selected.append(best)
            candidates.remove(best)
        return [docs[i] for i in selected]


class FlareControllerAgent(SingleRecordProcessor):
    """``flare-controller`` (reference flare/FlareControllerAgent.java): the
    FLARE active-RAG loop. A record whose ``tokens-field`` holds a token of
    probability below ``min-prob`` (from ``logprobs-field``) gets the
    low-confidence tokens as a retrieval query in ``retrieve-query-field``
    and goes to ``loop-topic``; a confident answer passes through."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.tokens_field = configuration.get("tokens-field", "value.tokens")
        self.logprobs_field = configuration.get("logprobs-field", "value.logprobs")
        self.min_prob = float(configuration.get("min-prob", 0.2))
        self.query_field = configuration.get("retrieve-query-field", "value.flare-query")
        self.loop_topic = configuration.get("loop-topic", "")

    async def process_record(self, record: Record) -> list[Record]:
        ctx = MutableRecord.from_record(record)
        tokens = el.evaluate(self.tokens_field, ctx) or []
        logprobs = el.evaluate(self.logprobs_field, ctx) or []
        self.processed(1)
        uncertain = [
            str(tok) for tok, lp in zip(tokens, logprobs) if math.exp(float(lp)) < self.min_prob
        ]
        if not uncertain:
            return [record]
        # the retrieval query is the low-confidence span, whitespace-joined
        query = re.sub(r"\s+", " ", " ".join(uncertain)).strip()
        ctx.set_field(self.query_field, query)
        if self.loop_topic:
            ctx.destination_topic = self.loop_topic
        return [ctx.to_record()]


# ---------------------------------------------------------------------------
# assets
# ---------------------------------------------------------------------------


def _asset_datasource_config(asset) -> dict[str, Any]:
    """The asset's ``datasource``: a resource's configuration (the deployer
    puts it there) or a literal config."""
    ds_config = asset.config.get("datasource", {})
    if isinstance(ds_config, dict):
        ds_config = ds_config.get("configuration", ds_config)
    return dict(ds_config)


class VectorIndexAssetManager(AssetManager):
    """``vector-index`` asset: create / drop a local-vector index.

    It opens its own store instance, so an in-memory store does not share
    its indexes with the pipeline's: use a persistent ``path`` in BOTH the
    asset's datasource and the ``vector-database`` resource (the same
    caveat as the jdbc-table asset's shared-cache URI)."""

    def __init__(self) -> None:
        self._asset = None
        self._name = ""
        self._path = None
        self._ds_config: dict[str, Any] = {}
        self._store: Optional[LocalVectorDataSource] = None

    async def initialize(self, asset) -> None:
        self._asset = asset
        name = asset.config.get("index-name")
        if not name:
            raise ValueError("vector-index asset requires config.index-name")
        self._name = str(name)
        self._ds_config = _asset_datasource_config(asset)
        self._path = self._ds_config.get("path")

    def _get_store(self) -> LocalVectorDataSource:
        # built when first needed: loading a persistent store reads every
        # index, which an existence check must not pay
        if self._store is None:
            self._store = LocalVectorDataSource(self._ds_config)
        return self._store

    async def asset_exists(self) -> bool:
        if self._path:
            return (Path(self._path) / f"{self._name}.json").exists()
        return self._get_store().has_index(self._name)

    async def deploy_asset(self) -> None:
        assert self._asset is not None
        store = self._get_store()
        store.create_index(self._name, int(self._asset.config.get("dimension", 0)))
        store.flush()

    async def delete_asset(self) -> None:
        self._get_store().delete_index(self._name)


class JdbcTableAssetManager(AssetManager):
    """``jdbc-table`` asset: create / drop a table with the DDL statements
    of its config (reference JdbcAssetsManagerProvider). It opens its own
    connection: an in-memory database is shared with the pipeline only
    through a shared-cache URI in both (``file:name?mode=memory&cache=shared``)."""

    def __init__(self) -> None:
        self._asset = None
        self._datasource: Optional[SqliteDataSource] = None

    async def initialize(self, asset) -> None:
        self._asset = asset
        self._datasource = SqliteDataSource(_asset_datasource_config(asset))

    async def close(self) -> None:
        if self._datasource is not None:
            await self._datasource.close()

    async def asset_exists(self) -> bool:
        assert self._asset and self._datasource
        table = self._asset.config.get("table-name", "")
        rows = await self._datasource.fetch_data(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=?", [table]
        )
        return bool(rows)

    async def deploy_asset(self) -> None:
        assert self._asset and self._datasource
        for stmt in self._asset.config.get("create-statements", []):
            await self._datasource.execute_statement(stmt, [])

    async def delete_asset(self) -> None:
        assert self._asset and self._datasource
        stmts = self._asset.config.get("delete-statements") or [
            f"DROP TABLE IF EXISTS {self._asset.config.get('table-name', '')}"
        ]
        for stmt in stmts:
            await self._datasource.execute_statement(stmt, [])


def _cassandra_table_factory():
    from langstream_tpu_torch.agents.vector.cassandra import CassandraTableAssetManager

    return CassandraTableAssetManager()


def _cassandra_keyspace_factory():
    from langstream_tpu_torch.agents.vector.cassandra import CassandraKeyspaceAssetManager

    return CassandraKeyspaceAssetManager()


def _milvus_collection_factory():
    from langstream_tpu_torch.agents.vector.milvus import MilvusCollectionAssetManager

    return MilvusCollectionAssetManager()


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


def register() -> None:
    """Register the ``datasource`` / ``vector-database`` resource types, the
    four agent types and every asset type in the port's registry, with the
    JAX package's config models."""
    for rtype in ("datasource", "vector-database"):
        REGISTRY.register_resource(
            ResourceTypeInfo(
                type=rtype,
                factory=build_datasource,
                description="SQL or vector datasource (jdbc/sqlite or local-vector).",
                config_model=ConfigModel(
                    type=rtype,
                    properties=props(
                        ConfigProperty("service", "backend driver", required=True),
                        ConfigProperty("url", "connection url"),
                        ConfigProperty("path", "persistence dir (local-vector)"),
                    ),
                    allow_unknown=True,
                ),
            )
        )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="vector-db-sink",
            component_type=ComponentType.SINK,
            factory=VectorDBSinkAgent,
            description="Upsert records into a vector/SQL datasource.",
            config_model=ConfigModel(
                type="vector-db-sink",
                properties=props(
                    ConfigProperty("datasource", "resource id", required=True),
                    ConfigProperty("table-name", "SQL table (jdbc)"),
                    ConfigProperty("index-name", "vector index (local-vector)"),
                    ConfigProperty("id", "EL for the row/vector id"),
                    ConfigProperty("vector", "EL for the embedding vector"),
                    ConfigProperty("fields", "list of {name, expression, primary-key}",
                                   type="array"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="query-vector-db",
            component_type=ComponentType.PROCESSOR,
            factory=QueryVectorDBAgent,
            composable=True,
            description="Query a vector/SQL datasource per record.",
            config_model=ConfigModel(
                type="query-vector-db",
                properties=props(
                    ConfigProperty("datasource", "resource id"),
                    ConfigProperty("query", "query text / JSON dialect", required=True),
                    ConfigProperty("fields", "EL expressions for params", type="array"),
                    ConfigProperty("output-field", "where results land",
                                   default="value.query-result"),
                    ConfigProperty("only-first", "store only the first row", type="boolean"),
                    ConfigProperty("mode", "query|execute", default="query"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="re-rank",
            component_type=ComponentType.PROCESSOR,
            factory=ReRankAgent,
            composable=True,
            description="Re-rank retrieved documents (MMR).",
            config_model=ConfigModel(
                type="re-rank",
                properties=props(
                    ConfigProperty("field", "EL for the candidate docs list"),
                    ConfigProperty("output-field", "where ranked docs land"),
                    ConfigProperty("query-embeddings", "EL for the query vector"),
                    ConfigProperty("embeddings-field", "EL for a doc's vector (record bound)"),
                    ConfigProperty("text-field", "EL for a doc's text (record bound)"),
                    ConfigProperty("algorithm", "MMR|cosine", default="MMR"),
                    ConfigProperty("output-mode", "documents|text", default="documents"),
                    ConfigProperty("lambda", "MMR relevance/diversity trade-off",
                                   type="number", default=0.5),
                    ConfigProperty("max", "documents to keep", type="integer", default=5),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="flare-controller",
            component_type=ComponentType.PROCESSOR,
            factory=FlareControllerAgent,
            composable=False,  # routes to the loop topic
            description="FLARE active-RAG loop controller.",
            config_model=ConfigModel(
                type="flare-controller",
                properties=props(
                    ConfigProperty("tokens-field", "EL for generated tokens"),
                    ConfigProperty("logprobs-field", "EL for per-token logprobs"),
                    ConfigProperty("min-prob", "confidence threshold", type="number",
                                   default=0.2),
                    ConfigProperty("retrieve-query-field", "where the retrieval query lands"),
                    ConfigProperty("loop-topic", "topic for another RAG round"),
                ),
            ),
        )
    )
    REGISTRY.register_asset(
        AssetTypeInfo(
            type="vector-index",
            factory=VectorIndexAssetManager,
            description="Create/drop a local-vector index declaratively.",
            config_model=ConfigModel(
                type="vector-index",
                properties=props(
                    ConfigProperty("index-name", "index to manage", required=True),
                    ConfigProperty("dimension", "vector dimension", type="integer",
                                   required=True),
                    ConfigProperty("datasource", "datasource config", type="object"),
                ),
                allow_unknown=True,
            ),
        )
    )
    REGISTRY.register_asset(
        AssetTypeInfo(
            type="jdbc-table",
            factory=JdbcTableAssetManager,
            description="Create/drop a SQL table from DDL statements.",
            config_model=ConfigModel(
                type="jdbc-table",
                properties=props(
                    ConfigProperty("table-name", "table to manage", required=True),
                    ConfigProperty("create-statements", "DDL to create", type="array"),
                    ConfigProperty("delete-statements", "DDL to drop", type="array"),
                    ConfigProperty("datasource", "datasource config", type="object"),
                ),
                allow_unknown=True,
            ),
        )
    )
    for type_ in ("cassandra-table", "astra-table"):
        REGISTRY.register_asset(
            AssetTypeInfo(
                type=type_,
                factory=_cassandra_table_factory,
                description="Create/drop a Cassandra/Astra table from CQL DDL.",
                config_model=ConfigModel(
                    type=type_,
                    properties=props(
                        ConfigProperty("table-name", "table to manage", required=True),
                        ConfigProperty("keyspace", "keyspace"),
                        ConfigProperty("create-statements", "CQL DDL", type="array"),
                        ConfigProperty("delete-statements", "CQL DDL", type="array"),
                        ConfigProperty("datasource", "datasource config", type="object"),
                    ),
                    allow_unknown=True,
                ),
            )
        )
    for type_ in ("cassandra-keyspace", "astra-keyspace"):
        REGISTRY.register_asset(
            AssetTypeInfo(
                type=type_,
                factory=_cassandra_keyspace_factory,
                description="Create/drop a Cassandra/Astra keyspace.",
                config_model=ConfigModel(
                    type=type_,
                    properties=props(
                        ConfigProperty("keyspace", "keyspace to manage", required=True),
                        ConfigProperty("datasource", "datasource config", type="object"),
                    ),
                    allow_unknown=True,
                ),
            )
        )
    REGISTRY.register_asset(
        AssetTypeInfo(
            type="milvus-collection",
            factory=_milvus_collection_factory,
            description="Create/drop a Milvus collection (REST v2 API).",
            config_model=ConfigModel(
                type="milvus-collection",
                properties=props(
                    ConfigProperty("collection-name", "collection", required=True),
                    ConfigProperty("dimension", "vector dim", type="integer"),
                    ConfigProperty("datasource", "datasource config", type="object"),
                ),
                allow_unknown=True,
            ),
        )
    )
