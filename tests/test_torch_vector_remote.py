"""The port's remote vector stores (Pinecone, OpenSearch, Solr, Milvus over
``urllib`` in a worker thread) against the JAX package's (aiohttp) on the
stubs JAX's own tests use (``test_vector_remote.py``,
``test_cassandra.py``), each behind a recorder: the requests (method, path
and query, the content type and auth headers, the body bytes) and the
answers (rows, the stub's stored documents, error messages) must be equal.
Exact: nothing here is computed in floating point. aiohttp serves the stubs
(tests only)."""

import asyncio
import json
import types

import pytest
from aiohttp import web
from test_cassandra import make_milvus_stub
from test_vector_remote import make_opensearch_stub, make_pinecone_stub, make_solr_stub

import langstream_tpu.agents.vector as jax_vector
import langstream_tpu.agents.vector.milvus as jax_milvus
import langstream_tpu.api.model as jax_model
import langstream_tpu.api.record as jax_record
import langstream_tpu_torch.agents.vector as port_vector
import langstream_tpu_torch.agents.vector.milvus as port_milvus
import langstream_tpu_torch.api.model as port_model
import langstream_tpu_torch.api.record as port_record

JAX = types.SimpleNamespace(name="jax", vector=jax_vector, milvus=jax_milvus, model=jax_model,
                            record=jax_record)
PORT = types.SimpleNamespace(name="port", vector=port_vector, milvus=port_milvus,
                             model=port_model, record=port_record)
HEADERS = ("Content-Type", "Api-Key", "Authorization")


async def serve(routes, log):
    @web.middleware
    async def record(request, handler):
        body = await request.read()
        log.append((request.method, request.path_qs,
                    {h: request.headers.get(h) for h in HEADERS if h in request.headers}, body))
        return await handler(request)

    app = web.Application(middlewares=[record])
    app.add_routes(routes)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"


class _Context:
    def __init__(self, ds):
        self._ds = ds

    def get_service_provider_registry(self):
        return self

    def get_datasource(self, name=None):
        return self._ds


async def _query_agent(pkg, ds, query, field="value.embeddings"):
    agent = pkg.vector.QueryVectorDBAgent()
    await agent.init({"query": query, "fields": [field], "output-field": "value.result",
                      "datasource": "remote"})
    agent.set_context(_Context(ds))
    await agent.start()
    return agent


async def scenario(pkg, make_routes, ds_config, sink_config, query, docs):
    """Upsert ``docs`` through the sink's writer, query through the
    datasource and through query-vector-db, then hit a missing path."""
    state, seen, log = {}, [], []
    runner, base = await serve(make_routes(state, seen), log)
    ds = pkg.vector.build_datasource({**ds_config, **{
        k: base for k in ("endpoint", "url") if k in ds_config}})
    out = {}
    try:
        writer = pkg.vector.build_writer(ds, sink_config)
        for d in docs:
            await writer.upsert(pkg.record.SimpleRecord.of(json.dumps(d)), {})
        out["rows"] = await ds.fetch_data(query, [[0.25, 0.5]])
        agent = await _query_agent(pkg, ds, query)
        rec = await agent.process_record(pkg.record.SimpleRecord.of(
            json.dumps({"embeddings": [0.5, 0.25]})))
        out["agent"] = json.loads(rec[0].value)
        try:
            await ds.execute_statement(query, [])
        except Exception as e:  # noqa: BLE001 - the message is compared
            out["execute"] = f"{type(e).__name__}: {e}"
    finally:
        await ds.close()
        await runner.cleanup()
    out["state"], out["seen"], out["log"] = state, seen, log
    return out


DOCS = [{"doc_id": "d1", "embeddings": [0.1, 0.2], "text": "hello"},
        {"doc_id": "d2", "embeddings": [0.3, -0.4], "text": "world"}]

CASES = {
    "pinecone": (make_pinecone_stub, {"service": "pinecone", "endpoint": "", "api-key": "pk-test"},
                 {"id": "value.doc_id", "vector": "value.embeddings",
                  "fields": [{"name": "text", "expression": "value.text"}]},
                 json.dumps({"vector": "?", "topK": 5, "filter": {"text": {"$eq": "hello"}}})),
    "opensearch": (lambda docs, searches: make_opensearch_stub(docs, searches),
                   {"service": "opensearch", "endpoint": "", "index-name": "idx",
                    "username": "admin", "password": "pw"},
                   {"id": "value.doc_id", "vector": "value.embeddings", "vector-field": "vec",
                    "fields": [{"name": "content", "expression": "value.text"}]},
                   json.dumps({"query": {"knn": {"vec": {"vector": "?", "k": 3}}}})),
    "solr": (make_solr_stub, {"service": "solr", "endpoint": "", "collection-name": "col"},
             {"id": "value.doc_id", "vector": "value.embeddings",
              "fields": [{"name": "text", "expression": "value.text"}]},
             json.dumps({"query": "{!knn f=embeddings topK=10}?", "limit": 10})),
}


@pytest.mark.parametrize("service", sorted(CASES))
def test_remote_store_equals_jax(service):
    make_routes, ds_config, sink_config, query = CASES[service]
    jax_out, port_out = (asyncio.run(scenario(pkg, make_routes, ds_config, sink_config, query,
                                              DOCS)) for pkg in (JAX, PORT))
    assert port_out == jax_out
    assert len(port_out["log"]) == 4 and port_out["rows"]


def test_remote_error_answer_equals_jax():
    """A 4xx answer raises the same RuntimeError (status and body)."""
    async def run(pkg):
        runner, base = await serve([], [])
        ds = pkg.vector.build_datasource({"service": "solr", "endpoint": base,
                                          "collection-name": "nope"})
        try:
            await ds.fetch_data('{"query": "*:*"}', [])
        except RuntimeError as e:
            return str(e).replace(base, "BASE")
        finally:
            await ds.close()
            await runner.cleanup()

    want, got = (asyncio.run(run(pkg)) for pkg in (JAX, PORT))
    assert got == want and "404" in got


def test_milvus_equals_jax():
    """The collection asset's lifecycle, the writer, search (vector) and
    query (filter) reads, execute's insert and delete, with a token and a
    database."""
    async def run(pkg):
        collections, inserts, searches, log = {}, [], [], []
        routes = make_milvus_stub(collections, inserts, searches)

        async def query(request):
            return web.json_response({"code": 0, "data": [{"id": "m2", "text": "by filter"}]})

        async def delete(request):
            return web.json_response({"code": 0, "data": {"deleteCount": 1}})

        routes += [web.post("/v2/vectordb/entities/query", query),
                   web.post("/v2/vectordb/entities/delete", delete)]
        runner, base = await serve(routes, log)
        config = {"url": base, "token": "mv-token", "database": "db1"}
        ds = pkg.vector.build_datasource({"service": "milvus", **config})
        out = []
        try:
            manager = pkg.milvus.MilvusCollectionAssetManager()
            await manager.initialize(pkg.model.AssetDefinition(
                id="c", asset_type="milvus-collection",
                config={"collection-name": "docs", "dimension": 2, "datasource": config}))
            out.append(await manager.asset_exists())
            await manager.deploy_asset()
            out.append(await manager.asset_exists())
            writer = pkg.vector.build_writer(ds, {"collection-name": "docs", "fields": [
                {"name": "id", "expression": "value.doc_id"},
                {"name": "vector", "expression": "value.embeddings"}]})
            for d in DOCS:
                await writer.upsert(pkg.record.SimpleRecord.of(json.dumps(d)), {})
            out.append(await ds.fetch_data(json.dumps(
                {"collection": "docs", "vector": "?", "topK": 2, "output-fields": ["text"],
                 "vector-field": "vector", "filter": "id > 0"}), [[0.1, 0.2]]))
            out.append(await ds.fetch_data(json.dumps(
                {"collection-name": "docs", "filter": "?", "limit": 3}), ["id == 'm2'"]))
            out.append(await ds.execute_statement(json.dumps(
                {"action": "insert", "collection": "docs", "data": "?"}), [[{"id": "m3"}]]))
            out.append(await ds.execute_statement(json.dumps(
                {"action": "delete", "collection": "docs", "filter": "id == 'm3'"}), []))
            await manager.delete_asset()
            out.append(await manager.asset_exists())
            await manager.close()
        finally:
            await ds.close()
            await runner.cleanup()
        return out, collections, inserts, searches, log

    want, got = (asyncio.run(run(pkg)) for pkg in (JAX, PORT))
    assert got == want
    assert got[0][0] is False and got[0][1] is True and got[0][-1] is False
