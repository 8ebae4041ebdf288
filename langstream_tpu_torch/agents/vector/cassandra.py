"""Cassandra / Astra vector datasource, writer and asset managers over the
native CQL protocol — the port of ``langstream_tpu/agents/vector/cassandra.py``
(asyncio streams, with ``ssl`` for TLS).

Parity: reference `langstream-vector-agents/.../cassandra/`
(`CassandraDataSource.java`, `CassandraWriter.java`,
`CassandraAssetsManagerProvider.java`, plus the `astra` / `astra-vector-db`
variants) — rebuilt on the stdlib CQL v4 codec (``cql_protocol.py``) instead
of the DataStax driver, the same no-SDK approach as the Kafka/Pulsar data
planes. Astra is the same wire protocol with SASL-plain auth (user
``token``, password ``AstraCS:...``); its cloud secure-connect bundle is TLS
around the same port, configured via ``contact-points`` + ``port`` here.

Supported surface (what the query / query-vector-db / vector-db-sink agents
use): QUERY with positional binds (including ``vector<float, n>`` values for
ANN searches), Rows/Void/SchemaChange results, and DDL for the asset
managers.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import ssl as ssl_mod
from typing import Any, Optional

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.vector import cql_protocol as wire
from langstream_tpu_torch.api.storage import AssetManager, DataSource, VectorDatabaseWriter

log = logging.getLogger(__name__)


class CqlConnection:
    """One server connection; stream-id multiplexed request/response."""

    def __init__(
        self,
        host: str,
        port: int = 9042,
        username: str = "",
        password: str = "",
        tls: bool = False,
    ) -> None:
        self.host = host
        self.port = port
        self.username = username
        self.password = password
        self.tls = tls
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._dispatch_task: Optional[asyncio.Task] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._streams = itertools.cycle(range(1, 32768))
        self._write_lock = asyncio.Lock()
        # statement → (prepared id, server-declared bind types)
        self._prepared: dict[str, tuple[bytes, list[Any]]] = {}
        self._prepare_unsupported = False

    async def connect(self) -> None:
        ssl_ctx = ssl_mod.create_default_context() if self.tls else None
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=ssl_ctx
        )
        # handshake is sequential (stream 0), then the dispatch loop starts
        opcode, body = await self._call_sequential(
            wire.OP_STARTUP, wire.startup_body()
        )
        if opcode == wire.OP_AUTHENTICATE:
            opcode, body = await self._call_sequential(
                wire.OP_AUTH_RESPONSE,
                wire.auth_response_body(self.username, self.password),
            )
            if opcode == wire.OP_ERROR:
                raise wire.parse_error_body(body)
            if opcode not in (wire.OP_AUTH_SUCCESS, wire.OP_READY):
                raise wire.CqlError(0, f"unexpected auth opcode 0x{opcode:02x}")
        elif opcode == wire.OP_ERROR:
            raise wire.parse_error_body(body)
        elif opcode != wire.OP_READY:
            raise wire.CqlError(0, f"unexpected startup opcode 0x{opcode:02x}")
        self._dispatch_task = asyncio.create_task(self._dispatch_loop())

    async def _call_sequential(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        assert self._writer is not None and self._reader is not None
        self._writer.write(wire.frame(opcode, body, stream=0))
        await self._writer.drain()
        header = await self._reader.readexactly(wire.HEADER_SIZE)
        _, _, resp_opcode, length = wire.parse_header(header)
        resp_body = await self._reader.readexactly(length) if length else b""
        return resp_opcode, resp_body

    async def _dispatch_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                header = await self._reader.readexactly(wire.HEADER_SIZE)
                _, stream, opcode, length = wire.parse_header(header)
                body = await self._reader.readexactly(length) if length else b""
                fut = self._pending.pop(stream, None)
                if fut is not None and not fut.done():
                    fut.set_result((opcode, body))
        except (asyncio.CancelledError, asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            err = ConnectionError("CQL connection closed")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

    async def close(self) -> None:
        if self._dispatch_task is not None:
            self._dispatch_task.cancel()
            try:
                await self._dispatch_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._dispatch_task = None
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None

    async def _call(self, opcode: int, payload: bytes) -> dict[str, Any]:
        assert self._writer is not None, "not connected"
        stream = next(self._streams)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[stream] = fut
        data = wire.frame(opcode, payload, stream)
        async with self._write_lock:
            self._writer.write(data)
            await self._writer.drain()
        resp_opcode, body = await asyncio.wait_for(fut, timeout=30)
        if resp_opcode == wire.OP_ERROR:
            raise wire.parse_error_body(body)
        if resp_opcode != wire.OP_RESULT:
            raise wire.CqlError(0, f"unexpected opcode 0x{resp_opcode:02x}")
        return wire.parse_result_body(body)

    async def query(
        self, statement: str, values: Optional[list[Any]] = None
    ) -> dict[str, Any]:
        """Run a statement. With bound values the path is PREPARE + EXECUTE
        so values are encoded with the SERVER-declared column types —
        guess_type's widths (python int → 8-byte bigint, numeric list →
        float32 vector) are rejected or mis-decoded by real Cassandra/Astra
        for int/smallint/float/list<double> columns. Plain QUERY with
        guessed types remains only as a fallback for servers without
        PREPARE (e.g. minimal test stubs)."""
        if not values:
            return await self._call(wire.OP_QUERY, wire.query_body(statement))
        if not self._prepare_unsupported:
            try:
                return await self._execute_prepared(statement, values)
            except wire.CqlError as e:
                if e.code != 0x000A:  # "unsupported opcode"
                    raise
                self._prepare_unsupported = True
        return await self._call(
            wire.OP_QUERY, wire.query_body(statement, values)
        )

    async def _execute_prepared(
        self, statement: str, values: list[Any], *, retried: bool = False
    ) -> dict[str, Any]:
        entry = self._prepared.get(statement)
        if entry is None:
            prepared = await self._call(
                wire.OP_PREPARE, wire.prepare_body(statement)
            )
            if prepared.get("kind") != "prepared":
                raise wire.CqlError(0, f"bad PREPARE result: {prepared}")
            entry = (prepared["id"], prepared["bind_types"])
            self._prepared[statement] = entry
        prepared_id, bind_types = entry
        try:
            return await self._call(
                wire.OP_EXECUTE, wire.execute_body(prepared_id, bind_types, values)
            )
        except wire.CqlError as e:
            # UNPREPARED (id evicted server-side): re-prepare ONCE — a
            # server that rejects even a fresh id must surface, not recurse
            if e.code != 0x2500 or retried:
                raise
            self._prepared.pop(statement, None)
            return await self._execute_prepared(statement, values, retried=True)


class CassandraDataSource(DataSource):
    """`service: cassandra` (and `astra` / `astra-vector-db`) datasource.

    config: ``contact-points`` (host or host:port), ``port``, ``username`` /
    ``password`` (Astra: ``token`` / ``AstraCS:...``; also accepts
    ``clientId`` / ``secret``), ``tls``, ``keyspace``."""

    def __init__(self, config: dict[str, Any]) -> None:
        contact = str(
            config.get("contact-points")
            or config.get("contactPoints")
            or "localhost"
        ).split(",")[0].strip()
        if ":" in contact:
            host, _, port_s = contact.rpartition(":")
            self.host, self.port = host, int(port_s)
        else:
            self.host = contact
            self.port = int(config.get("port", 9042))
        self.username = str(
            config.get("username") or config.get("clientId") or ""
        )
        self.password = str(
            config.get("password")
            or config.get("secret")
            or config.get("token")
            or ""
        )
        if config.get("token") and not config.get("username"):
            self.username = "token"  # Astra token auth convention
        self.tls = bool(config.get("tls", False))
        self.keyspace = config.get("keyspace")
        self._conn: Optional[CqlConnection] = None
        self._lock = asyncio.Lock()

    async def conn(self) -> CqlConnection:
        async with self._lock:
            if self._conn is None:
                conn = CqlConnection(
                    self.host, self.port, self.username, self.password, self.tls
                )
                await conn.connect()
                if self.keyspace:
                    await conn.query(f'USE "{self.keyspace}"')
                self._conn = conn
            return self._conn

    async def close(self) -> None:
        if self._conn is not None:
            await self._conn.close()
            self._conn = None

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        result = await (await self.conn()).query(query, params)
        return result.get("rows", [])

    async def execute_statement(self, query: str, params: list[Any]) -> dict[str, Any]:
        result = await (await self.conn()).query(query, params)
        return {"kind": result.get("kind", "void")}


class CassandraWriter(VectorDatabaseWriter):
    """vector-db-sink writer: INSERT is Cassandra's native upsert
    (reference CassandraWriter.java field mapping)."""

    def __init__(self, datasource: CassandraDataSource, config: dict[str, Any]) -> None:
        self.datasource = datasource
        table = config.get("table-name", "documents")
        keyspace = config.get("keyspace") or datasource.keyspace
        if "." in table:  # "ks.table" wins over the datasource keyspace
            keyspace, _, table = table.partition(".")
        self.table = table
        self.keyspace = keyspace
        self.fields = list(config.get("fields", []))

    async def upsert(self, record: Any, context: dict[str, Any]) -> None:
        ctx = MutableRecord.from_record(record)
        names: list[str] = []
        values: list[Any] = []
        for f in self.fields:
            names.append(f["name"])
            values.append(el.evaluate(f.get("expression", "value"), ctx))
        table = f'"{self.keyspace}"."{self.table}"' if self.keyspace else f'"{self.table}"'
        cols = ", ".join(f'"{n}"' for n in names)
        placeholders = ", ".join("?" for _ in names)
        await self.datasource.execute_statement(
            f"INSERT INTO {table} ({cols}) VALUES ({placeholders})", values
        )


class CassandraTableAssetManager(AssetManager):
    """`cassandra-table` asset: DDL create-statements / delete-statements
    (reference CassandraAssetsManagerProvider table manager)."""

    def __init__(self) -> None:
        self._asset = None
        self._datasource: Optional[CassandraDataSource] = None

    async def initialize(self, asset) -> None:
        self._asset = asset
        ds_config = asset.config.get("datasource", {})
        if isinstance(ds_config, dict):
            ds_config = ds_config.get("configuration", ds_config)
        self._datasource = CassandraDataSource(dict(ds_config))

    async def close(self) -> None:
        if self._datasource is not None:
            await self._datasource.close()

    def _table(self) -> str:
        assert self._asset is not None
        return str(self._asset.config.get("table-name", ""))

    async def asset_exists(self) -> bool:
        assert self._asset and self._datasource
        keyspace = self._asset.config.get("keyspace") or self._datasource.keyspace or ""
        rows = await self._datasource.fetch_data(
            "SELECT table_name FROM system_schema.tables "
            "WHERE keyspace_name = ? AND table_name = ?",
            [keyspace, self._table()],
        )
        return bool(rows)

    async def deploy_asset(self) -> None:
        assert self._asset and self._datasource
        for stmt in self._asset.config.get("create-statements", []):
            await self._datasource.execute_statement(stmt, [])

    async def delete_asset(self) -> None:
        assert self._asset and self._datasource
        stmts = self._asset.config.get("delete-statements") or [
            f"DROP TABLE IF EXISTS {self._table()}"
        ]
        for stmt in stmts:
            await self._datasource.execute_statement(stmt, [])


class CassandraKeyspaceAssetManager(AssetManager):
    """`cassandra-keyspace` / `astra-keyspace` asset (reference keyspace
    manager): create/drop a keyspace."""

    def __init__(self) -> None:
        self._asset = None
        self._datasource: Optional[CassandraDataSource] = None

    async def initialize(self, asset) -> None:
        self._asset = asset
        ds_config = asset.config.get("datasource", {})
        if isinstance(ds_config, dict):
            ds_config = ds_config.get("configuration", ds_config)
        ds_config = dict(ds_config)
        ds_config.pop("keyspace", None)  # must not USE a keyspace being created
        self._datasource = CassandraDataSource(ds_config)

    async def close(self) -> None:
        if self._datasource is not None:
            await self._datasource.close()

    def _keyspace(self) -> str:
        assert self._asset is not None
        return str(self._asset.config.get("keyspace", ""))

    async def asset_exists(self) -> bool:
        assert self._datasource
        rows = await self._datasource.fetch_data(
            "SELECT keyspace_name FROM system_schema.keyspaces WHERE keyspace_name = ?",
            [self._keyspace()],
        )
        return bool(rows)

    async def deploy_asset(self) -> None:
        assert self._asset and self._datasource
        stmts = self._asset.config.get("create-statements") or [
            f"CREATE KEYSPACE IF NOT EXISTS {self._keyspace()} WITH replication = "
            "{'class': 'SimpleStrategy', 'replication_factor': 1}"
        ]
        for stmt in stmts:
            await self._datasource.execute_statement(stmt, [])

    async def delete_asset(self) -> None:
        assert self._datasource
        await self._datasource.execute_statement(
            f"DROP KEYSPACE IF EXISTS {self._keyspace()}", []
        )
