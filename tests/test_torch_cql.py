"""The port's CQL v4 codec, Cassandra / Astra client and CQL fake against
the JAX package's: every frame, message body and value the codec builds is
byte-equal to JAX's (``vector<float, n>`` big-endian, Rows metadata flags,
paging state, stream ids) and decodes alike; the port's client works
against JAX's fake and JAX's client against the port's fake, each giving
what JAX's client gives against JAX's fake (rows, ANN order, upserts, the
prepared path's declared types, Astra's SASL-plain token auth, the asset
managers, the sink's writer), with the same statements reaching the
server. Exact: the values are decoded from the same bytes."""

import asyncio
import struct
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import langstream_tpu.agents.vector as jax_vector
import langstream_tpu.agents.vector.cassandra as jax_cassandra
import langstream_tpu.agents.vector.cql_fake as jax_fake
import langstream_tpu.agents.vector.cql_protocol as jax_wire
import langstream_tpu.api.model as jax_model
import langstream_tpu.api.record as jax_record
import langstream_tpu_torch.agents.vector as port_vector
import langstream_tpu_torch.agents.vector.cassandra as port_cassandra
import langstream_tpu_torch.agents.vector.cql_fake as port_fake
import langstream_tpu_torch.agents.vector.cql_protocol as port_wire
import langstream_tpu_torch.api.model as port_model
import langstream_tpu_torch.api.record as port_record

JAX = types.SimpleNamespace(name="jax", vector=jax_vector, cassandra=jax_cassandra,
                            fake=jax_fake, wire=jax_wire, model=jax_model, record=jax_record)
PORT = types.SimpleNamespace(name="port", vector=port_vector, cassandra=port_cassandra,
                             fake=port_fake, wire=port_wire, model=port_model,
                             record=port_record)

COLUMNS = [("id", jax_wire.T_VARCHAR), ("emb", ("vector", 3)), ("n", jax_wire.T_BIGINT),
           ("i", jax_wire.T_INT), ("f", jax_wire.T_FLOAT), ("d", jax_wire.T_DOUBLE),
           ("b", jax_wire.T_BOOLEAN), ("u", jax_wire.T_UUID), ("blob", jax_wire.T_BLOB),
           ("tags", ("list", jax_wire.T_VARCHAR)), ("s", ("set", jax_wire.T_INT)),
           ("m", ("map", jax_wire.T_VARCHAR, jax_wire.T_DOUBLE)), ("v", jax_wire.T_VARINT),
           ("si", jax_wire.T_SMALLINT), ("ti", jax_wire.T_TINYINT),
           ("ts", jax_wire.T_TIMESTAMP)]
ROWS = [
    ["a", [1.0, -2.5, 3.25], 1 << 40, -7, 1.5, 2.25, True,
     "12345678-1234-5678-1234-567812345678", b"\x00\x01", ["x", "y"], [1, 2],
     {"k": 0.5}, -(10 ** 20), -300, 12, 1700000000000],
    ["b", None, None, None, None, None, False, None, None, [], [], {}, 0, 0, 0, 0],
]


def both(build):
    got, want = build(PORT.wire), build(JAX.wire)
    assert got == want
    return got


def test_frames_and_bodies_byte_equal():
    for stream in (0, 1, 7, 32767, -1):
        both(lambda w: w.frame(w.OP_QUERY, b"body", stream=stream))
        both(lambda w: w.frame(w.OP_RESULT, b"", stream, version=w.VERSION_RESPONSE))
    both(lambda w: w.startup_body())
    both(lambda w: w.auth_response_body("token", "AstraCS:secret"))
    for values in (None, [], ["x1", 3, 2.5, True, b"\x01", [0.5, 1.5], ["a", "b"], {"k": "v"},
                          None]):
        body = both(lambda w: w.query_body("SELECT * FROM t WHERE id = ?", values))
        assert JAX.wire.parse_query_body(body) == PORT.wire.parse_query_body(body)
    body = both(lambda w: w.prepare_body("INSERT INTO t (a) VALUES (?)"))
    assert PORT.wire.parse_prepare_body(body) == JAX.wire.parse_prepare_body(body)
    types_ = [t for _, t in COLUMNS]
    body = both(lambda w: w.execute_body(b"\x01\x02id", types_, ROWS[0]))
    assert PORT.wire.parse_execute_body(body) == JAX.wire.parse_execute_body(body)
    for build in (lambda w: w.prepared_result_body(b"pid", types_),
                  lambda w: w.rows_body("ks", "t", COLUMNS, ROWS),
                  lambda w: w.void_body(),
                  lambda w: w.schema_change_body("CREATED", "TABLE", "ks", "t"),
                  lambda w: w.schema_change_body("DROPPED", "KEYSPACE", "ks")):
        body = both(build)
        assert PORT.wire.parse_result_body(body) == JAX.wire.parse_result_body(body)
    body = both(lambda w: w.error_body(0x2200, "invalid"))
    assert str(PORT.wire.parse_error_body(body)) == str(JAX.wire.parse_error_body(body))
    with pytest.raises(Exception) as got:
        PORT.wire.execute_body(b"id", types_, [1])
    with pytest.raises(Exception) as want:
        JAX.wire.execute_body(b"id", types_, [1])
    assert str(got.value) == str(want.value)


def test_rows_with_paging_state_and_no_metadata_parse_alike():
    """Rows whose flags carry has_more_pages (a paging state before the
    metadata), per-column table specs, or no_metadata."""
    w = JAX.wire
    head = struct.pack(">ii", w.RESULT_ROWS, 0x0003) + struct.pack(">i", 2)
    head += struct.pack(">i", 4) + b"page" + w.Writer().string("ks").string("t").build()
    for name, t in (("id", w.T_VARCHAR), ("emb", ("vector", 2))):
        cw = w.Writer().string(name)
        w.write_type(cw, t)
        head += cw.build()
    rows = struct.pack(">i", 1) + w.Writer().bytes_(b"r1").bytes_(
        struct.pack(">2f", 0.5, -1.0)).build()
    per_column = struct.pack(">iii", w.RESULT_ROWS, 0, 1) + w.Writer().string("ks").string(
        "t").string("id").u16(w.T_VARCHAR).build() + struct.pack(">i", 1) + w.Writer().bytes_(
        b"q").build()
    no_meta = struct.pack(">iii", w.RESULT_ROWS, 0x0004, 1) + struct.pack(">i", 0)
    for body in (head + rows, per_column, no_meta):
        assert PORT.wire.parse_result_body(body) == JAX.wire.parse_result_body(body)
    assert PORT.wire.parse_result_body(head + rows)["rows"] == [{"id": "r1", "emb": [0.5, -1.0]}]


@settings(max_examples=150, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), min_size=1, max_size=16),
       st.text(max_size=20), st.integers(-(2 ** 63), 2 ** 63 - 1),
       st.integers(-(2 ** 200), 2 ** 200))
def test_values_byte_equal(vector, text, bigint, varint):
    cases = [(("vector", len(vector)), vector), (jax_wire.T_VARCHAR, text),
             (jax_wire.T_BIGINT, bigint), (jax_wire.T_VARINT, varint),
             (("list", jax_wire.T_FLOAT), vector), (("map", jax_wire.T_VARCHAR,
                                                    jax_wire.T_BIGINT), {text: bigint})]
    for type_, value in cases:
        raw = both(lambda w: w.encode_value(type_, value))
        assert PORT.wire.decode_value(type_, raw) == JAX.wire.decode_value(type_, raw)
        assert PORT.wire.guess_type(value) == JAX.wire.guess_type(value)
    assert both(lambda w: w.encode_value(("vector", len(vector)), vector)) == struct.pack(
        f">{len(vector)}f", *vector)


async def _scenario(client, server):
    """``client``'s datasource, writer and asset managers against
    ``server``'s fake (auth on for the Astra half)."""
    out = []
    broker = await server.fake.FakeCassandra().start()
    try:
        ds_config = {"contact-points": broker.contact_point}
        ks = client.cassandra.CassandraKeyspaceAssetManager()
        await ks.initialize(client.model.AssetDefinition(
            id="ks", asset_type="cassandra-keyspace",
            config={"keyspace": "vs", "datasource": ds_config}))
        out.append(await ks.asset_exists())
        await ks.deploy_asset()
        out.append(await ks.asset_exists())
        await ks.close()
        table = client.cassandra.CassandraTableAssetManager()
        await table.initialize(client.model.AssetDefinition(
            id="t", asset_type="cassandra-table",
            config={"table-name": "docs", "keyspace": "vs",
                    "datasource": {**ds_config, "keyspace": "vs"},
                    "create-statements": [
                        "CREATE TABLE IF NOT EXISTS vs.docs (id text PRIMARY KEY, text text, "
                        "n int, score float, embeddings vector<float, 3>)"]}))
        out.append(await table.asset_exists())
        await table.deploy_asset()
        out.append(await table.asset_exists())
        ds = client.vector.build_datasource({"service": "cassandra", **ds_config,
                                             "keyspace": "vs"})
        writer = client.vector.build_writer(ds, {"table-name": "docs", "fields": [
            {"name": "id", "expression": "value.id"}, {"name": "text", "expression": "value.text"},
            {"name": "n", "expression": "value.n"}, {"name": "score", "expression": "value.s"},
            {"name": "embeddings", "expression": "value.e"}]})
        for i, e in enumerate([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.9, 0.1, 0.0],
                               [0.5, 0.5, 0.5]]):
            await writer.upsert(client.record.SimpleRecord.of(
                {"id": f"d{i}", "text": f"doc {i}", "n": i, "s": 0.5 * i, "e": e}), {})
        await ds.execute_statement("INSERT INTO docs (id, text, n, score, embeddings) "
                                   "VALUES (?, ?, ?, ?, ?)", ["d1", "doc 1 v2", 9, 1.25,
                                                             [0.0, 0.9, 0.1]])
        out.append(await ds.fetch_data("SELECT id, text, n, score FROM docs WHERE id = ?",
                                       ["d1"]))
        out.append(await ds.fetch_data(
            "SELECT id, embeddings FROM docs ORDER BY embeddings ANN OF ? LIMIT 3",
            [[1.0, 0.0, 0.0]]))
        out.append(await ds.fetch_data("SELECT id FROM docs", []))
        out.append(await ds.execute_statement("DELETE FROM docs WHERE id = ?", ["d3"]))
        out.append(sorted(r["id"] for r in await ds.fetch_data("SELECT id FROM docs", [])))
        await ds.close()
        await table.delete_asset()
        out.append(await table.asset_exists())
        await table.close()
        out.append([q for q in broker.queries])
    finally:
        await broker.stop()
    auth = await server.fake.FakeCassandra(require_auth=("token", "AstraCS:test")).start()
    try:
        good = client.vector.build_datasource(
            {"service": "astra", "contact-points": auth.contact_point, "token": "AstraCS:test"})
        out.append(await good.execute_statement("CREATE TABLE t (id text PRIMARY KEY)", []))
        await good.close()
        bad = client.vector.build_datasource(
            {"service": "astra-vector-db", "contact-points": auth.contact_point,
             "token": "AstraCS:wrong"})
        try:
            await bad.fetch_data("SELECT * FROM t", [])
        except Exception as e:  # noqa: BLE001 - the message is compared
            out.append(f"{type(e).__name__}: {e}")
        await bad.close()
    finally:
        await auth.stop()
    return out


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_client_against_the_other_fake(client, server):
    pkgs = {"jax": JAX, "port": PORT}
    want = asyncio.run(_scenario(JAX, JAX))
    got = asyncio.run(_scenario(pkgs[client], pkgs[server]))
    assert got == want
    assert got[:4] == [False, True, False, True]
    assert [r["id"] for r in got[5]] == ["d0", "d2", "d3"]
    assert "bad credentials" in got[-1]
