"""The RAG agents and stores of the port against the JAX package's on the
same records: ``vector-db-sink``, ``query-vector-db`` (query, ``only-first``
and ``mode: execute``), ``re-rank`` (MMR and cosine, both output modes) and
``flare-controller``, over ``local-vector`` (the port's store on the CPU)
and over ``jdbc`` (sqlite); the ``vector-index`` and ``jdbc-table`` asset
managers; the config models of every agent, resource and asset type the
two packages share.

Tolerances: the local store's similarities are f32 cosines that XLA and
torch sum in other orders, held within 1e-6 (ids, order and stored vectors
exact); everything else is exact — the re-rank and the flare controller
compute on the host in numpy in both packages, and sqlite holds what it is
given."""

import asyncio
import dataclasses
import enum
import json
import math
import types

import numpy as np
import pytest

import langstream_tpu.agents.vector as jax_vector
import langstream_tpu.agents.web  # noqa: F401 - registers webcrawler-source
import langstream_tpu.api.model as jax_model
import langstream_tpu.api.record as jax_record
import langstream_tpu_torch.agents.vector as port_vector
import langstream_tpu_torch.api.model as port_model
import langstream_tpu_torch.api.record as port_record
from langstream_tpu.core.registry import REGISTRY as JAX_REGISTRY
from langstream_tpu_torch.core.registry import REGISTRY as PORT_REGISTRY

JAX = types.SimpleNamespace(name="jax", vector=jax_vector, record=jax_record, model=jax_model,
                            ds_extra={})
PORT = types.SimpleNamespace(name="port", vector=port_vector, record=port_record,
                             model=port_model, ds_extra={"device": "cpu"})
PKGS = (JAX, PORT)
SIM_TOL = 1e-6
DIM, DOCS = 8, 24


def plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


class _Registry:
    def __init__(self, datasources):
        self._datasources = datasources

    def get_datasource(self, name=None):
        return self._datasources[name]


class _Context:
    def __init__(self, datasources):
        self._registry = _Registry(datasources)

    def get_service_provider_registry(self):
        return self._registry


async def agent(pkg, cls_name, config, datasources=None):
    a = getattr(pkg.vector, cls_name)()
    await a.init(config)
    a.set_context(_Context(datasources or {}))
    await a.start()
    return a


def documents(seed=0):
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((DOCS, DIM)).astype(np.float32)
    return [{"id": f"d{i}", "text": f"document {i} " + "word " * (i % 5),
             "embeddings": vectors[i].tolist()} for i in range(DOCS)]


def queries(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(DIM).astype(np.float32).tolist() for _ in range(n)]


def values(records):
    return [json.loads(r.value) for r in records]


async def sink_and_query(pkg, docs, id_expr):
    store = pkg.vector.LocalVectorDataSource({**pkg.ds_extra})
    sink = await agent(pkg, "VectorDBSinkAgent", {
        "datasource": "vdb", "index-name": "docs", "id": id_expr, "vector": "value.embeddings",
        "fields": [{"name": "text", "expression": "value.text"}]}, {"vdb": store})
    for d in docs:
        await sink.write(pkg.record.SimpleRecord.of(json.dumps(d)))
    query = await agent(pkg, "QueryVectorDBAgent", {
        "datasource": "vdb",
        "query": '{"index": "docs", "vector": "?", "topK": 10, "include-vectors": true}',
        "fields": ["value.embeddings"], "output-field": "value.related"}, {"vdb": store})
    first = await agent(pkg, "QueryVectorDBAgent", {
        "datasource": "vdb", "query": '{"index": "docs", "vector": "?", "topK": 3}',
        "fields": ["value.embeddings"], "output-field": "value.best", "only-first": True},
        {"vdb": store})
    out = []
    for q in queries():
        rec = pkg.record.SimpleRecord.of(json.dumps({"question": "q", "embeddings": q}))
        rec = (await query.process_record(rec))[0]
        out += values(await first.process_record(rec))
    rows = store._indexes["docs"]
    stored = sorted((m["text"], tuple(rows["matrix"][i].tolist()))
                    for i, m in enumerate(rows["meta"]))
    await sink.close()
    return out, stored, list(rows["ids"])


def _hold_rows(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["similarity"] - w["similarity"]) <= SIM_TOL
        assert {k: v for k, v in g.items() if k != "similarity"} == {
            k: v for k, v in w.items() if k != "similarity"}


@pytest.mark.parametrize("id_expr", ["value.id", "fn:uuid()"])
def test_sink_and_query_over_local_vector_equal_jax(id_expr):
    docs = documents()
    (jax_out, jax_stored, jax_ids), (port_out, port_stored, port_ids) = (
        asyncio.run(sink_and_query(pkg, docs, id_expr)) for pkg in PKGS)
    # uuid ids differ run to run: the index is compared by (text, vector)
    assert port_stored == jax_stored and len(port_stored) == DOCS
    if id_expr == "value.id":
        assert port_ids == jax_ids == [d["id"] for d in docs]
    for got, want in zip(port_out, jax_out):
        if id_expr == "value.id":
            _hold_rows(got["related"], want["related"])
            _hold_rows([got["best"]], [want["best"]])
        assert [r["text"] for r in got["related"]] == [r["text"] for r in want["related"]]
        assert [r["vector"] for r in got["related"]] == [r["vector"] for r in want["related"]]
        assert len(got["related"]) == 10 and "vector" not in got["best"]


def test_query_vector_db_modes_over_jdbc_equal_jax():
    """``mode: execute`` through the sink's jdbc writer and the query agent
    (with an upsert on a primary key), ``only-first``, an empty result."""
    async def run(pkg):
        ds = pkg.vector.SqliteDataSource({"url": "jdbc:sqlite::memory:"})
        await ds.execute_statement(
            "CREATE TABLE docs (id TEXT PRIMARY KEY, text TEXT, meta TEXT)", [])
        sink = await agent(pkg, "VectorDBSinkAgent", {
            "datasource": "db", "table-name": "docs",
            "fields": [{"name": "id", "expression": "value.id", "primary-key": True},
                       {"name": "text", "expression": "value.text"},
                       {"name": "meta", "expression": "value.meta"}]}, {"db": ds})
        for i, text in enumerate(["a", "b", "c", "b2"]):
            doc = {"id": f"k{i % 3}", "text": text, "meta": {"n": i, "tags": ["x", i]}}
            await sink.write(pkg.record.SimpleRecord.of(json.dumps(doc)))
        insert = await agent(pkg, "QueryVectorDBAgent", {
            "datasource": "db", "mode": "execute", "output-field": "value.inserted",
            "query": "INSERT INTO docs (id, text, meta) VALUES (?, ?, ?)",
            "fields": ["value.id", "value.text", "value.meta"]}, {"db": ds})
        select = await agent(pkg, "QueryVectorDBAgent", {
            "datasource": "db", "output-field": "value.rows",
            "query": "SELECT id, text, meta FROM docs WHERE id >= ? ORDER BY id",
            "fields": ["value.start"]}, {"db": ds})
        first = await agent(pkg, "QueryVectorDBAgent", {
            "datasource": "db", "output-field": "value.first", "only-first": True,
            "query": "SELECT text FROM docs WHERE id = ?", "fields": ["value.id"]}, {"db": ds})
        out = []
        for doc in ({"id": "k9", "text": "new", "meta": [1, 2], "start": "k0"},
                    {"id": "zz", "text": "z", "meta": None, "start": "zzz"}):
            rec = pkg.record.SimpleRecord.of(json.dumps(doc))
            for a in (insert, select, first):
                rec = (await a.process_record(rec))[0]
            out.append(json.loads(rec.value))
        await ds.close()
        return out

    jax_out, port_out = (asyncio.run(run(pkg)) for pkg in PKGS)
    assert port_out == jax_out
    # k0 was written twice: the second write updated it in place
    assert port_out[0]["rows"][0] == {"id": "k0", "text": "b2", "meta": json.dumps(
        {"n": 3, "tags": ["x", 3]})}
    assert [r["id"] for r in port_out[0]["rows"]] == ["k0", "k1", "k2", "k9"]
    assert port_out[0]["first"] == {"text": "new"}
    assert port_out[1]["rows"] == [] and port_out[1]["first"] == {"text": "z"}


@pytest.mark.parametrize("algorithm,mode,lam", [("MMR", "documents", 0.5), ("MMR", "text", 0.3),
                                                ("cosine", "documents", 0.5),
                                                ("cosine", "text", 0.5)])
def test_rerank_equals_jax(algorithm, mode, lam):
    """The re-rank of the same retrieved documents (JAX's query output, so
    both see identical inputs), with a document that has no vector and two
    exact duplicates (the first best wins a tie)."""
    docs = documents(seed=3)[:12]
    docs[4]["embeddings"] = list(docs[2]["embeddings"])  # a tie
    docs[7] = {"id": "d7", "text": "no vector"}
    config = {"field": "value.related", "output-field": "value.context",
              "query-embeddings": "value.embeddings", "embeddings-field": "record.embeddings",
              "text-field": "record.text", "algorithm": algorithm, "output-mode": mode,
              "lambda": lam, "max": 5}

    async def run(pkg):
        rerank = await agent(pkg, "ReRankAgent", config)
        out = []
        for q in queries(seed=4, n=4) + [None]:
            value = {"related": docs, "embeddings": q} if q else {"related": docs}
            out += values(await rerank.process_record(pkg.record.SimpleRecord.of(
                json.dumps(value))))
        out += values(await rerank.process_record(pkg.record.SimpleRecord.of(
            json.dumps({"related": [], "embeddings": [1.0] * DIM}))))
        return out

    jax_out, port_out = (asyncio.run(run(pkg)) for pkg in PKGS)
    assert port_out == jax_out
    assert all(len(v["context"]) == 5 for v in port_out[:4])


def test_flare_controller_equals_jax():
    records = [
        {"tokens": ["a", "b"], "logprobs": [-0.01, -0.02]},
        {"tokens": ["Paris", "is", "  wrong"], "logprobs": [-0.01, math.log(0.1), math.log(0.05)]},
        {"answer": "no tokens field"},
        {"tokens": ["x"], "logprobs": [math.log(0.2)]},
    ]

    async def run(pkg, loop_topic):
        flare = await agent(pkg, "FlareControllerAgent", {
            "min-prob": 0.2, "retrieve-query-field": "value.flare-query",
            "loop-topic": loop_topic})
        out = []
        for value in records:
            for r in await flare.process_record(pkg.record.SimpleRecord.of(json.dumps(value))):
                out.append((json.loads(r.value), [(h.key, h.value) for h in r.headers]))
        return out

    for loop_topic in ("flare-loop", ""):
        jax_out, port_out = (asyncio.run(run(pkg, loop_topic)) for pkg in PKGS)
        assert port_out == jax_out
    assert port_out[1][0]["flare-query"] == "is wrong"


@pytest.mark.parametrize("persistent", [True, False])
def test_vector_index_asset_equals_jax(tmp_path, persistent):
    async def run(pkg):
        ds = {"configuration": {"path": str(tmp_path / pkg.name), **pkg.ds_extra}} \
            if persistent else dict(pkg.ds_extra)
        asset = pkg.model.AssetDefinition(
            id="idx", asset_type="vector-index", creation_mode="create-if-not-exists",
            config={"index-name": "docs", "dimension": 4, "datasource": ds})
        manager = pkg.vector.VectorIndexAssetManager()
        await manager.initialize(asset)
        seen = [await manager.asset_exists()]
        await manager.deploy_asset()
        seen.append(await manager.asset_exists())
        if persistent:
            seen.append(pkg.vector.LocalVectorDataSource(
                {"path": str(tmp_path / pkg.name), **pkg.ds_extra}).has_index("docs"))
        await manager.delete_asset()
        seen.append(await manager.asset_exists())
        await manager.close()
        return seen

    jax_seen, port_seen = (asyncio.run(run(pkg)) for pkg in PKGS)
    assert port_seen == jax_seen
    assert port_seen == ([False, True, True, False] if persistent else [False, True, False])


def test_jdbc_table_asset_equals_jax(tmp_path):
    async def run(pkg):
        url = f"jdbc:sqlite:{tmp_path / pkg.name}.db"
        asset = pkg.model.AssetDefinition(
            id="t", asset_type="jdbc-table", creation_mode="create-if-not-exists",
            config={"table-name": "chat_history", "datasource": {"configuration": {"url": url}},
                    "create-statements": ["CREATE TABLE chat_history (q TEXT, a TEXT)"]})
        manager = pkg.vector.JdbcTableAssetManager()
        await manager.initialize(asset)
        seen = [await manager.asset_exists()]
        await manager.deploy_asset()
        seen.append(await manager.asset_exists())
        ds = pkg.vector.SqliteDataSource({"url": url})
        seen.append(await ds.fetch_data(
            "SELECT name FROM sqlite_master WHERE type='table'", []))
        await ds.close()
        await manager.delete_asset()
        seen.append(await manager.asset_exists())
        await manager.close()
        return seen

    jax_seen, port_seen = (asyncio.run(run(pkg)) for pkg in PKGS)
    assert port_seen == jax_seen == [False, True, [{"name": "chat_history"}], False]


AGENT_TYPES = ("vector-db-sink", "query-vector-db", "re-rank", "flare-controller",
               "webcrawler-source")


@pytest.mark.parametrize("type_", AGENT_TYPES)
def test_agent_types_equal_jax(type_):
    got, want = PORT_REGISTRY.agent(type_), JAX_REGISTRY.agent(type_)
    assert plain(got.config_model) == plain(want.config_model)
    assert got.component_type.value == want.component_type.value
    assert (got.composable, got.description, got.aliases) == (
        want.composable, want.description, want.aliases)


@pytest.mark.parametrize("type_", sorted(JAX_REGISTRY.assets) or ["vector-index"])
def test_asset_types_equal_jax(type_):
    got, want = PORT_REGISTRY.asset(type_), JAX_REGISTRY.asset(type_)
    assert got is not None, f"the port does not register asset type {type_!r}"
    assert plain(got.config_model) == plain(want.config_model)
    assert got.description == want.description
    assert type(got.factory()).__name__ == type(want.factory()).__name__


@pytest.mark.parametrize("type_", ["datasource", "vector-database"])
def test_datasource_resources_equal_jax(type_):
    got, want = PORT_REGISTRY.resource(type_), JAX_REGISTRY.resource(type_)
    assert plain(got.config_model) == plain(want.config_model)


SERVICES = {
    "jdbc": {}, "sqlite": {}, "local-vector": {}, "in-memory": {}, "tpu-vector": {},
    "pinecone": {"endpoint": "http://127.0.0.1:9"}, "opensearch": {"endpoint": "http://h:9"},
    "solr": {"endpoint": "http://h:9"}, "cassandra": {}, "astra": {"token": "AstraCS:x"},
    "astra-vector-db": {}, "milvus": {},
}


@pytest.mark.parametrize("service", sorted(SERVICES))
def test_build_datasource_and_writer_equal_jax(service):
    """Every service resolves to the datasource and writer classes of the
    same names (no connection is made: clients connect on first use)."""
    config = {"service": service, **SERVICES[service]}
    jax_ds = jax_vector.build_datasource(config)
    port_ds = port_vector.build_datasource({**config, "device": "cpu"})
    assert type(port_ds).__name__ == type(jax_ds).__name__
    sink = {"index-name": "docs", "table-name": "docs", "fields": []}
    assert type(port_vector.build_writer(port_ds, sink)).__name__ == type(
        jax_vector.build_writer(jax_ds, sink)).__name__
    for ds in (jax_ds, port_ds):
        if hasattr(ds, "_conn") and hasattr(ds._conn, "close") and service in ("jdbc", "sqlite"):
            ds._conn.close()


def test_unknown_service_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jax_vector.build_datasource({"service": "nosuch"})
    with pytest.raises(ValueError) as got:
        port_vector.build_datasource({"service": "nosuch"})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown datasource service"):
        port_vector.build_datasource({"service": "weaviate"})
