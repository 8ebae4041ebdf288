"""Remote vector databases over their REST APIs, on the stdlib — the port
of ``langstream_tpu/agents/vector/remote.py`` (reference
``langstream-vector-agents``: ``pinecone/PineconeDataSource.java``,
``opensearch/OpenSearchDataSource.java`` + ``OpenSearchWriter.java``,
``solr/SolrDataSource.java`` + writer).

The requests are the JAX clients': the same methods, paths, headers and
JSON bodies (``json.dumps`` with its default separators, as aiohttp sends
them, ``Content-Type: application/json`` when there is a body). Each runs
``urllib`` in a worker thread (``http_request``), so a query never holds
the event loop; no proxy is taken from the environment.

Query convention (the reference's for non-SQL stores): the ``query``
string is a JSON document; positional ``fields`` values substitute
``"?"`` placeholders in order.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Optional

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.vector import _substitute_params
from langstream_tpu_torch.api.storage import DataSource, VectorDatabaseWriter
from langstream_tpu_torch.runtime import http_client


async def http_request(method: str, url: str, body: Any = None,
                       headers: Optional[dict[str, str]] = None) -> tuple[int, bytes]:
    """One request off the event loop → (status, raw body). ``body``: a
    JSON value sent as aiohttp's ``json=`` sends it (None: no body)."""
    data = None
    if body is not None:
        data, headers = http_client.json_body(body, headers)
    resp = await http_client.request(method, url, data, headers)
    return resp.status, resp.body


def _parse_query(query: str, params: list[Any]) -> dict[str, Any]:
    try:
        parsed = json.loads(query)
    except json.JSONDecodeError as e:
        raise ValueError(f"remote vector query must be JSON: {e}") from e
    return _substitute_params(parsed, list(params))


class _HttpDataSource(DataSource):
    """The JSON request plumbing of the HTTP stores."""

    def __init__(self, config: dict[str, Any]) -> None:
        self.config = dict(config)

    async def _request(
        self, method: str, url: str, body: Optional[dict] = None,
        headers: Optional[dict[str, str]] = None,
    ) -> dict[str, Any]:
        status, raw = await http_request(method, url, body, headers)
        text = raw.decode("utf-8")
        if status >= 400:
            raise RuntimeError(f"{type(self).__name__} {method} {url}: "
                               f"{status} {text[:300]}")
        return json.loads(text) if text else {}

    async def close(self) -> None:
        pass

    async def execute_statement(self, query: str, params: list[Any]) -> dict[str, Any]:
        raise ValueError(f"{type(self).__name__} does not support execute mode")


# ---------------------------------------------------------------------------
# Pinecone
# ---------------------------------------------------------------------------


class PineconeDataSource(_HttpDataSource):
    """`service: pinecone` — REST index endpoint. Query JSON mirrors the
    reference (`PineconeDataSource.java`): {"vector": [...], "topK": N,
    "filter": {...}, "includeMetadata": true}; rows come back as
    {id, similarity, **metadata}."""

    def __init__(self, config: dict[str, Any]) -> None:
        super().__init__(config)
        # endpoint: the index host URL (https://{index}-{project}.svc...);
        # tests point it at a local stub
        self.endpoint = str(config.get("endpoint", "")).rstrip("/")
        self.api_key = config.get("api-key", "")
        if not self.endpoint:
            raise ValueError("pinecone datasource requires 'endpoint'")

    def _headers(self) -> dict[str, str]:
        return {"Api-Key": str(self.api_key)}

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        body = _parse_query(query, params)
        body.setdefault("topK", 10)
        body.setdefault("includeMetadata", True)
        out = await self._request(
            "POST", f"{self.endpoint}/query", body, self._headers()
        )
        rows = []
        for match in out.get("matches", []):
            row = {"id": match.get("id"), "similarity": match.get("score")}
            row.update(match.get("metadata") or {})
            rows.append(row)
        return rows

    async def upsert(self, id_: str, vector: list[float], metadata: dict) -> None:
        await self._request(
            "POST",
            f"{self.endpoint}/vectors/upsert",
            {"vectors": [{"id": id_, "values": vector, "metadata": metadata}]},
            self._headers(),
        )


class PineconeWriter(VectorDatabaseWriter):
    def __init__(self, datasource: PineconeDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
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
        await self.datasource.upsert(id_, list(map(float, vector)), meta)


# ---------------------------------------------------------------------------
# OpenSearch
# ---------------------------------------------------------------------------


class OpenSearchDataSource(_HttpDataSource):
    """`service: opensearch` — `_search` REST API. The query JSON is the
    standard search DSL (knn / match / whatever); rows are the hits with
    {id, similarity, **_source} (OpenSearchDataSource.java semantics)."""

    def __init__(self, config: dict[str, Any]) -> None:
        super().__init__(config)
        self.endpoint = str(config.get("endpoint", "")).rstrip("/")
        self.index = config.get("index-name", "langstream")
        self.username = config.get("username")
        self.password = config.get("password")
        if not self.endpoint:
            raise ValueError("opensearch datasource requires 'endpoint'")

    def _headers(self) -> dict[str, str]:
        if self.username:
            token = base64.b64encode(
                f"{self.username}:{self.password or ''}".encode()
            ).decode()
            return {"Authorization": f"Basic {token}"}
        return {}

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        body = _parse_query(query, params)
        out = await self._request(
            "POST", f"{self.endpoint}/{self.index}/_search", body, self._headers()
        )
        rows = []
        for hit in out.get("hits", {}).get("hits", []):
            row = {"id": hit.get("_id"), "similarity": hit.get("_score")}
            row.update(hit.get("_source") or {})
            rows.append(row)
        return rows

    async def index_document(self, id_: str, document: dict[str, Any]) -> None:
        await self._request(
            "PUT",
            f"{self.endpoint}/{self.index}/_doc/{id_}?refresh=true",
            document,
            self._headers(),
        )


class OpenSearchWriter(VectorDatabaseWriter):
    """vector-db-sink writer: each record becomes one document; the vector
    lands in `vector-field` alongside the computed fields
    (OpenSearchWriter.java's bulk-index semantics, one-at-a-time here)."""

    def __init__(self, datasource: OpenSearchDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
        self.id_expr = config.get("id", "fn:uuid()")
        self.vector_expr = config.get("vector", "value.embeddings")
        self.vector_field = config.get("vector-field", "embeddings")
        self.metadata_fields = list(config.get("fields", []))

    async def upsert(self, record: Any, context: dict[str, Any]) -> None:
        ctx = MutableRecord.from_record(record)
        id_ = str(el.evaluate(self.id_expr, ctx))
        doc = {
            f["name"]: el.evaluate(f.get("expression", "value"), ctx)
            for f in self.metadata_fields
        }
        vector = el.evaluate(self.vector_expr, ctx)
        if vector is not None:
            doc[self.vector_field] = list(map(float, vector))
        await self.datasource.index_document(id_, doc)


# ---------------------------------------------------------------------------
# Solr
# ---------------------------------------------------------------------------


class SolrDataSource(_HttpDataSource):
    """`service: solr` — JSON Request API on a collection. The query JSON
    is Solr's {"query": "...", "limit": N, ...} body (knn via
    {!knn f=vector topK=10}); rows are the response docs
    (SolrDataSource.java semantics)."""

    def __init__(self, config: dict[str, Any]) -> None:
        super().__init__(config)
        self.endpoint = str(config.get("endpoint", "")).rstrip("/")
        self.collection = config.get("collection-name", "langstream")
        if not self.endpoint:
            raise ValueError("solr datasource requires 'endpoint'")

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        body = _parse_query(query, params)
        out = await self._request(
            "POST", f"{self.endpoint}/solr/{self.collection}/select", body
        )
        return list(out.get("response", {}).get("docs", []))

    async def add_documents(self, docs: list[dict[str, Any]]) -> None:
        await self._request(
            "POST",
            f"{self.endpoint}/solr/{self.collection}/update/json/docs?commit=true",
            docs[0] if len(docs) == 1 else docs,  # Solr accepts either form
        )


class SolrWriter(VectorDatabaseWriter):
    def __init__(self, datasource: SolrDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
        self.id_expr = config.get("id", "fn:uuid()")
        self.vector_expr = config.get("vector", "value.embeddings")
        self.vector_field = config.get("vector-field", "embeddings")
        self.metadata_fields = list(config.get("fields", []))

    async def upsert(self, record: Any, context: dict[str, Any]) -> None:
        ctx = MutableRecord.from_record(record)
        doc = {"id": str(el.evaluate(self.id_expr, ctx))}
        for f in self.metadata_fields:
            doc[f["name"]] = el.evaluate(f.get("expression", "value"), ctx)
        vector = el.evaluate(self.vector_expr, ctx)
        if vector is not None:
            doc[self.vector_field] = list(map(float, vector))
        await self.datasource.add_documents([doc])
