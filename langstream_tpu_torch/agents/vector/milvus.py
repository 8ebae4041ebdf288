"""Milvus vector datasource + writer + collection asset over the REST v2
API, on the stdlib — the port of ``langstream_tpu/agents/vector/milvus.py``
(the same requests, through ``remote.http_request``: ``urllib`` in a worker
thread).

Parity: reference `langstream-vector-agents/.../milvus/`
(`MilvusDataSource.java`, `MilvusWriter.java`, assets) — the Java side uses
the Milvus gRPC SDK; this rebuild targets Milvus's RESTful v2 surface
(`/v2/vectordb/entities/{search,insert,delete}`,
`/v2/vectordb/collections/...`), which Zilliz serverless and Milvus ≥2.3
ship by default — same SDK-free approach as the other HTTP datasources
(remote.py).

`query` strings follow the platform's vector-query convention (a JSON object
with `?` placeholders substituted from fields), e.g.:

    {"collection": "docs", "vector": "?", "topK": 5, "output-fields": ["text"]}
"""

from __future__ import annotations

import json
import logging
from typing import Any, Optional

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.vector.remote import http_request
from langstream_tpu_torch.api.storage import AssetManager, DataSource, VectorDatabaseWriter

log = logging.getLogger(__name__)


def _substitute(obj: Any, params: list[Any]) -> Any:
    """Replace "?" placeholders depth-first from params (the remote.py
    convention shared by every JSON-query datasource)."""
    it = iter(params)

    def walk(o: Any) -> Any:
        if o == "?":
            return next(it)
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, list):
            return [walk(x) for x in o]
        return o

    return walk(obj)


class MilvusDataSource(DataSource):
    """`service: milvus` — config: ``url`` (or host/port), ``token``
    (api key / user:pass), ``database``."""

    def __init__(self, config: dict[str, Any]) -> None:
        url = config.get("url")
        if not url:
            host = config.get("host", "localhost")
            port = int(config.get("port", 19530))
            url = f"http://{host}:{port}"
        self.url = str(url).rstrip("/")
        self.token = config.get("token") or config.get("api-key") or ""
        if not self.token and config.get("user"):
            self.token = f"{config['user']}:{config.get('password', '')}"
        self.database = config.get("database", "")

    async def _request(self, path: str, body: dict[str, Any]) -> dict[str, Any]:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if self.database:
            body = {"dbName": self.database, **body}
        status, raw = await http_request("POST", f"{self.url}{path}", body, headers)
        # aiohttp's json(content_type=None): an empty answer is None
        payload = json.loads(raw.decode("utf-8")) if raw.strip() else None
        if status != 200 or (payload or {}).get("code", 0) not in (0, 200):
            raise RuntimeError(f"milvus {path} failed ({status}): {str(payload)[:300]}")
        return payload or {}

    async def close(self) -> None:
        pass

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        spec = _substitute(json.loads(query), list(params))
        collection = spec.get("collection") or spec.get("collection-name")
        vector = spec.get("vector")
        body: dict[str, Any] = {
            "collectionName": collection,
            "limit": int(spec.get("topK", spec.get("limit", 10))),
        }
        if spec.get("filter"):
            body["filter"] = spec["filter"]
        if spec.get("output-fields"):
            body["outputFields"] = spec["output-fields"]
        if vector is not None:
            body["data"] = [list(map(float, vector))]
            if spec.get("vector-field"):
                body["annsField"] = spec["vector-field"]
            payload = await self._request("/v2/vectordb/entities/search", body)
        else:
            payload = await self._request("/v2/vectordb/entities/query", body)
        return list(payload.get("data", []))

    async def execute_statement(self, query: str, params: list[Any]) -> dict[str, Any]:
        spec = _substitute(json.loads(query), list(params))
        action = spec.pop("action", "insert")
        collection = spec.get("collection") or spec.get("collection-name")
        if action == "insert":
            payload = await self._request(
                "/v2/vectordb/entities/insert",
                {"collectionName": collection, "data": spec.get("data", [])},
            )
        elif action == "delete":
            payload = await self._request(
                "/v2/vectordb/entities/delete",
                {"collectionName": collection, "filter": spec.get("filter", "")},
            )
        else:
            raise ValueError(f"unknown milvus action {action!r}")
        return {"result": payload.get("data", {})}

    # -- writer/asset helpers -----------------------------------------------

    async def insert_rows(self, collection: str, rows: list[dict[str, Any]]) -> None:
        await self._request(
            "/v2/vectordb/entities/insert",
            {"collectionName": collection, "data": rows},
        )

    async def has_collection(self, name: str) -> bool:
        payload = await self._request(
            "/v2/vectordb/collections/has", {"collectionName": name}
        )
        data = payload.get("data", {})
        return bool(data.get("has", data))

    async def create_collection(self, name: str, dimension: int) -> None:
        await self._request(
            "/v2/vectordb/collections/create",
            {"collectionName": name, "dimension": int(dimension)},
        )

    async def drop_collection(self, name: str) -> None:
        await self._request(
            "/v2/vectordb/collections/drop", {"collectionName": name}
        )


class MilvusWriter(VectorDatabaseWriter):
    """vector-db-sink writer: map fields → one row per record
    (reference MilvusWriter.java)."""

    def __init__(self, datasource: MilvusDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
        self.collection = config.get("collection-name", config.get("table-name", "documents"))
        self.fields = list(config.get("fields", []))

    async def upsert(self, record: Any, context: dict[str, Any]) -> None:
        ctx = MutableRecord.from_record(record)
        row = {
            f["name"]: el.evaluate(f.get("expression", "value"), ctx)
            for f in self.fields
        }
        await self.datasource.insert_rows(self.collection, [row])


class MilvusCollectionAssetManager(AssetManager):
    """`milvus-collection` asset (reference MilvusAssetsManagerProvider)."""

    def __init__(self) -> None:
        self._asset = None
        self._datasource: Optional[MilvusDataSource] = None

    async def initialize(self, asset) -> None:
        self._asset = asset
        ds_config = asset.config.get("datasource", {})
        if isinstance(ds_config, dict):
            ds_config = ds_config.get("configuration", ds_config)
        self._datasource = MilvusDataSource(dict(ds_config))

    async def close(self) -> None:
        if self._datasource is not None:
            await self._datasource.close()

    def _name(self) -> str:
        assert self._asset is not None
        return str(
            self._asset.config.get("collection-name")
            or self._asset.config.get("table-name", "")
        )

    async def asset_exists(self) -> bool:
        assert self._datasource
        return await self._datasource.has_collection(self._name())

    async def deploy_asset(self) -> None:
        assert self._asset and self._datasource
        await self._datasource.create_collection(
            self._name(), int(self._asset.config.get("dimension", 0) or 0)
        )

    async def delete_asset(self) -> None:
        assert self._datasource
        await self._datasource.drop_collection(self._name())
