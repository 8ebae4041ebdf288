"""Protocol-level fake Cassandra for tests (the `kafka_fake.py` pattern) —
the port's copy of ``langstream_tpu/agents/vector/cql_fake.py``, serving
the port's tests; nothing on the serving path uses it.

Speaks the CQL v4 subset the client in ``cassandra.py`` does — STARTUP/READY
(optionally the AUTHENTICATE SASL-plain dance, for the Astra token-auth
path), QUERY with bound positional values, Rows/Void/SchemaChange/Error
results — over a real asyncio socket, backed by a small in-memory table
engine that understands the statements the vector agents generate:

    CREATE KEYSPACE / DROP KEYSPACE / USE
    CREATE TABLE (typed columns incl. vector<float, n>) / DROP TABLE
    CREATE [CUSTOM] INDEX (no-op)
    INSERT INTO t (cols) VALUES (?, ...)        -- upsert by primary key
    SELECT cols FROM t [WHERE c = ? [AND ...]] [ORDER BY c ANN OF ?] [LIMIT n]
    DELETE FROM t WHERE c = ?
    SELECT ... FROM system_schema.{tables,keyspaces} WHERE ...

ANN ordering uses cosine similarity (the Astra vector-search default).
This stands in for testcontainers Cassandra in an image with no JVM and no
network egress.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import math
import re
import struct
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.agents.vector import cql_protocol as wire

log = logging.getLogger(__name__)

_TYPE_NAMES = {
    "ascii": wire.T_ASCII,
    "text": wire.T_VARCHAR,
    "varchar": wire.T_VARCHAR,
    "int": wire.T_INT,
    "bigint": wire.T_BIGINT,
    "smallint": wire.T_SMALLINT,
    "tinyint": wire.T_TINYINT,
    "varint": wire.T_VARINT,
    "float": wire.T_FLOAT,
    "double": wire.T_DOUBLE,
    "boolean": wire.T_BOOLEAN,
    "blob": wire.T_BLOB,
    "uuid": wire.T_UUID,
    "timeuuid": wire.T_TIMEUUID,
    "timestamp": wire.T_TIMESTAMP,
    "counter": wire.T_COUNTER,
}


def parse_col_type(spec: str) -> Any:
    spec = spec.strip().lower()
    m = re.match(r"vector\s*<\s*float\s*,\s*(\d+)\s*>", spec)
    if m:
        return ("vector", int(m.group(1)))
    m = re.match(r"(list|set)\s*<\s*(\w+)\s*>", spec)
    if m:
        return (m.group(1), _TYPE_NAMES.get(m.group(2), wire.T_VARCHAR))
    m = re.match(r"map\s*<\s*(\w+)\s*,\s*(\w+)\s*>", spec)
    if m:
        return (
            "map",
            _TYPE_NAMES.get(m.group(1), wire.T_VARCHAR),
            _TYPE_NAMES.get(m.group(2), wire.T_VARCHAR),
        )
    return _TYPE_NAMES.get(spec, wire.T_VARCHAR)


def _decode_bound(col_type: Any, b: Optional[bytes]) -> Any:
    """Decode a bound value tolerantly: un-prepared QUERY values are typed by
    the CLIENT's guess (e.g. python int → 8-byte bigint even for an `int`
    column), so integer/float widths are taken from the bytes, not the
    declared column."""
    if b is None:
        return None
    if isinstance(col_type, tuple):
        if col_type[0] == "vector":
            n = len(b) // 4
            return list(struct.unpack(f">{n}f", b))
        return wire.decode_value(col_type, b)
    if col_type in (
        wire.T_INT, wire.T_BIGINT, wire.T_SMALLINT, wire.T_TINYINT,
        wire.T_TIMESTAMP, wire.T_COUNTER, wire.T_VARINT,
    ):
        return int.from_bytes(b, "big", signed=True)
    if col_type in (wire.T_FLOAT, wire.T_DOUBLE):
        return struct.unpack(">f" if len(b) == 4 else ">d", b)[0]
    return wire.decode_value(col_type, b)


@dataclass
class _Table:
    keyspace: str
    name: str
    columns: dict[str, Any]  # name → type
    primary_key: list[str]
    rows: dict[tuple, dict[str, Any]] = field(default_factory=dict)


class FakeCassandra:
    """Single-node fake; optional SASL-plain auth (Astra token mode)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        require_auth: Optional[tuple[str, str]] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.require_auth = require_auth
        self.keyspaces: set[str] = {"system"}
        self.tables: dict[tuple[str, str], _Table] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set[asyncio.StreamWriter] = set()
        self.queries: list[str] = []  # observability for tests
        # prepared id → (query, server-declared bind types)
        self._prepared: dict[bytes, tuple[str, list[Any]]] = {}

    async def start(self) -> "FakeCassandra":
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def contact_point(self) -> str:
        return f"{self.host}:{self.port}"

    # -- connection ----------------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        keyspace: list[Optional[str]] = [None]  # per-connection USE state
        authenticated = self.require_auth is None
        try:
            while True:
                header = await reader.readexactly(wire.HEADER_SIZE)
                _, stream, opcode, length = wire.parse_header(header)
                body = await reader.readexactly(length) if length else b""
                if opcode == wire.OP_STARTUP:
                    if self.require_auth:
                        out = wire.frame(
                            wire.OP_AUTHENTICATE,
                            wire.Writer()
                            .string("org.apache.cassandra.auth.PasswordAuthenticator")
                            .build(),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                    else:
                        out = wire.frame(
                            wire.OP_READY, b"", stream, wire.VERSION_RESPONSE
                        )
                elif opcode == wire.OP_AUTH_RESPONSE:
                    token = wire.Reader(body).bytes_() or b""
                    parts = token.split(b"\x00")
                    user = parts[1].decode() if len(parts) > 1 else ""
                    pwd = parts[2].decode() if len(parts) > 2 else ""
                    if self.require_auth and (user, pwd) == self.require_auth:
                        authenticated = True
                        out = wire.frame(
                            wire.OP_AUTH_SUCCESS,
                            wire.Writer().bytes_(None).build(),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                    else:
                        out = wire.frame(
                            wire.OP_ERROR,
                            wire.error_body(0x0100, "bad credentials"),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                elif opcode == wire.OP_QUERY:
                    if not authenticated:
                        out = wire.frame(
                            wire.OP_ERROR,
                            wire.error_body(0x0100, "not authenticated"),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                    else:
                        query, raw_values, _ = wire.parse_query_body(body)
                        self.queries.append(query)
                        try:
                            result = self._execute(query, raw_values, keyspace)
                            out = wire.frame(
                                wire.OP_RESULT, result, stream, wire.VERSION_RESPONSE
                            )
                        except wire.CqlError as e:
                            out = wire.frame(
                                wire.OP_ERROR,
                                wire.error_body(e.code, e.message),
                                stream,
                                wire.VERSION_RESPONSE,
                            )
                        except Exception as e:  # noqa: BLE001 — surface as CQL error
                            log.exception("fake cassandra: query failed: %s", query)
                            out = wire.frame(
                                wire.OP_ERROR,
                                wire.error_body(0x2000, str(e)),
                                stream,
                                wire.VERSION_RESPONSE,
                            )
                elif opcode in (wire.OP_PREPARE, wire.OP_EXECUTE) and not authenticated:
                    out = wire.frame(
                        wire.OP_ERROR,
                        wire.error_body(0x0100, "not authenticated"),
                        stream,
                        wire.VERSION_RESPONSE,
                    )
                elif opcode == wire.OP_PREPARE:
                    query = wire.parse_prepare_body(body)
                    self.queries.append(f"PREPARE: {query}")
                    try:
                        bind_types = self._bind_types(query, keyspace)
                        prepared_id = hashlib.md5(query.encode()).digest()
                        self._prepared[prepared_id] = (query, bind_types)
                        out = wire.frame(
                            wire.OP_RESULT,
                            wire.prepared_result_body(prepared_id, bind_types),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                    except wire.CqlError as e:
                        out = wire.frame(
                            wire.OP_ERROR,
                            wire.error_body(e.code, e.message),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                elif opcode == wire.OP_EXECUTE:
                    prepared_id, raw_values, _ = wire.parse_execute_body(body)
                    entry = self._prepared.get(prepared_id)
                    if entry is None:
                        out = wire.frame(
                            wire.OP_ERROR,
                            wire.error_body(0x2500, "unprepared statement"),
                            stream,
                            wire.VERSION_RESPONSE,
                        )
                    else:
                        query, _ = entry
                        self.queries.append(query)
                        try:
                            result = self._execute(query, raw_values, keyspace)
                            out = wire.frame(
                                wire.OP_RESULT, result, stream, wire.VERSION_RESPONSE
                            )
                        except wire.CqlError as e:
                            out = wire.frame(
                                wire.OP_ERROR,
                                wire.error_body(e.code, e.message),
                                stream,
                                wire.VERSION_RESPONSE,
                            )
                        except Exception as e:  # noqa: BLE001
                            log.exception("fake cassandra: execute failed: %s", query)
                            out = wire.frame(
                                wire.OP_ERROR,
                                wire.error_body(0x2000, str(e)),
                                stream,
                                wire.VERSION_RESPONSE,
                            )
                elif opcode == wire.OP_OPTIONS:
                    out = wire.frame(
                        wire.OP_SUPPORTED,
                        wire.Writer().u16(0).build(),
                        stream,
                        wire.VERSION_RESPONSE,
                    )
                else:
                    out = wire.frame(
                        wire.OP_ERROR,
                        wire.error_body(0x000A, f"unsupported opcode {opcode}"),
                        stream,
                        wire.VERSION_RESPONSE,
                    )
                writer.write(out)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    # -- statement engine ----------------------------------------------------

    def _bind_types(
        self, query: str, keyspace: list[Optional[str]]
    ) -> list[Any]:
        """Server side of PREPARE: the declared CQL type of each ``?``
        marker, in order — what a real node derives from the schema. The
        point of the whole prepared path: clients must encode `int` columns
        as 4 bytes, `float` as 4, `list<double>` as doubles, which
        guess_type cannot know."""
        q = query.strip().rstrip(";")
        table: Optional[_Table] = None
        m = re.match(
            r"(?:INSERT\s+INTO|UPDATE|DELETE\s+FROM|SELECT\s+.*?\s+FROM)\s+([\w\".]+)",
            q, re.I | re.S,
        )
        if m:
            table = self.tables.get(self._resolve(m.group(1), keyspace))

        def col_type(name: str) -> Any:
            name = name.replace('"', "")
            if table is not None and name in table.columns:
                return table.columns[name]
            return wire.T_VARCHAR

        im = re.match(
            r"INSERT\s+INTO\s+[\w\".]+\s*\(([^)]*)\)\s*VALUES\s*\((.*)\)",
            q, re.I | re.S,
        )
        if im:
            cols = [c.strip() for c in im.group(1).split(",")]
            vals = self._split_args(im.group(2))
            return [
                col_type(c) for c, v in zip(cols, vals) if v.strip() == "?"
            ]
        types: list[Any] = []
        # blank quoted literals (length-preserving) so a '?' inside a string
        # is not counted as a bind marker
        scrubbed = re.sub(r"'[^']*'", lambda m: "'" + " " * (len(m.group()) - 2) + "'", q)
        for pos in (mm.start() for mm in re.finditer(r"\?", scrubbed)):
            before = q[:pos]
            cm = re.search(
                r"([\w\".]+)\s*(?:=|>=|<=|>|<|CONTAINS)\s*$", before, re.I
            )
            if cm:
                types.append(col_type(cm.group(1)))
                continue
            am = re.search(r"ORDER\s+BY\s+([\w\".]+)\s+ANN\s+OF\s*$", before, re.I)
            if am:
                types.append(col_type(am.group(1)))
                continue
            if re.search(r"LIMIT\s*$", before, re.I):
                types.append(wire.T_INT)
                continue
            types.append(wire.T_VARCHAR)
        return types

    def _resolve(self, name: str, keyspace: list[Optional[str]]) -> tuple[str, str]:
        name = name.replace('"', "")
        if "." in name:
            ks, _, table = name.partition(".")
            return ks, table
        return keyspace[0] or "default", name

    def _execute(
        self, query: str, raw_values: list[Optional[bytes]], keyspace: list[Optional[str]]
    ) -> bytes:
        q = query.strip().rstrip(";")
        upper = q.upper()

        if upper.startswith("USE "):
            ks = q[4:].strip().strip('"')
            keyspace[0] = ks
            self.keyspaces.add(ks)
            return wire.Writer().i32(wire.RESULT_SET_KEYSPACE).string(ks).build()

        if upper.startswith("CREATE KEYSPACE"):
            m = re.match(r"CREATE KEYSPACE (?:IF NOT EXISTS )?([\w\"]+)", q, re.I)
            ks = m.group(1).strip('"')
            self.keyspaces.add(ks)
            return wire.schema_change_body("CREATED", "KEYSPACE", ks)

        if upper.startswith("DROP KEYSPACE"):
            m = re.match(r"DROP KEYSPACE (?:IF EXISTS )?([\w\"]+)", q, re.I)
            ks = m.group(1).strip('"')
            self.keyspaces.discard(ks)
            for key in [k for k in self.tables if k[0] == ks]:
                del self.tables[key]
            return wire.schema_change_body("DROPPED", "KEYSPACE", ks)

        if upper.startswith("CREATE TABLE"):
            m = re.match(
                r"CREATE TABLE (?:IF NOT EXISTS )?([\w.\"]+)\s*\((.*)\)\s*(?:WITH .*)?$",
                q,
                re.I | re.S,
            )
            if not m:
                raise wire.CqlError(0x2000, f"cannot parse CREATE TABLE: {q[:80]}")
            ks, table = self._resolve(m.group(1), keyspace)
            body = m.group(2)
            columns: dict[str, Any] = {}
            pk: list[str] = []
            depth = 0
            parts, cur = [], ""
            for ch in body:
                if ch == "," and depth == 0:
                    parts.append(cur)
                    cur = ""
                    continue
                if ch in "(<":
                    depth += 1
                if ch in ")>":
                    depth -= 1
                cur += ch
            if cur.strip():
                parts.append(cur)
            for part in parts:
                part = part.strip()
                pk_match = re.match(r"PRIMARY KEY\s*\((.*)\)", part, re.I)
                if pk_match:
                    pk = [
                        c.strip().strip('"()')
                        for c in pk_match.group(1).replace("(", "").replace(")", "").split(",")
                    ]
                    continue
                m2 = re.match(r'"?(\w+)"?\s+(.+?)(\s+PRIMARY KEY)?$', part, re.I | re.S)
                if not m2:
                    continue
                col, spec, inline_pk = m2.group(1), m2.group(2), m2.group(3)
                columns[col] = parse_col_type(spec)
                if inline_pk:
                    pk.append(col)
            self.keyspaces.add(ks)
            if (ks, table) not in self.tables:
                self.tables[(ks, table)] = _Table(ks, table, columns, pk or list(columns)[:1])
            return wire.schema_change_body("CREATED", "TABLE", ks, table)

        if upper.startswith("DROP TABLE"):
            m = re.match(r"DROP TABLE (?:IF EXISTS )?([\w.\"]+)", q, re.I)
            ks, table = self._resolve(m.group(1), keyspace)
            self.tables.pop((ks, table), None)
            return wire.schema_change_body("DROPPED", "TABLE", ks, table)

        if upper.startswith("CREATE INDEX") or upper.startswith("CREATE CUSTOM INDEX"):
            return wire.void_body()

        if upper.startswith("INSERT INTO"):
            m = re.match(
                r"INSERT INTO\s+([\w.\"]+)\s*\(([^)]*)\)\s*VALUES\s*\((.*)\)", q, re.I | re.S
            )
            if not m:
                raise wire.CqlError(0x2000, f"cannot parse INSERT: {q[:80]}")
            ks, table_name = self._resolve(m.group(1), keyspace)
            table = self.tables.get((ks, table_name))
            if table is None:
                raise wire.CqlError(0x2200, f"unconfigured table {ks}.{table_name}")
            cols = [c.strip().strip('"') for c in m.group(2).split(",")]
            values: list[Any] = []
            value_it = iter(raw_values)
            for token in self._split_args(m.group(3)):
                token = token.strip()
                if token == "?":
                    col = cols[len(values)]
                    values.append(
                        _decode_bound(table.columns.get(col, wire.T_VARCHAR), next(value_it))
                    )
                else:
                    values.append(self._literal(token))
            row = dict(zip(cols, values))
            key = tuple(row.get(k) for k in table.primary_key)
            existing = table.rows.get(key, {})
            table.rows[key] = {**existing, **row}
            return wire.void_body()

        if upper.startswith("DELETE"):
            m = re.match(r"DELETE\s+FROM\s+([\w.\"]+)\s*(?:WHERE\s+(.*))?$", q, re.I | re.S)
            ks, table_name = self._resolve(m.group(1), keyspace)
            table = self.tables.get((ks, table_name))
            if table is None:
                return wire.void_body()
            conditions = self._conditions(m.group(2), table, raw_values)
            for key in [
                k for k, row in table.rows.items() if self._matches(row, conditions)
            ]:
                del table.rows[key]
            return wire.void_body()

        if upper.startswith("SELECT"):
            return self._select(q, raw_values, keyspace)

        if upper.startswith("TRUNCATE"):
            m = re.match(r"TRUNCATE\s+(?:TABLE\s+)?([\w.\"]+)", q, re.I)
            ks, table_name = self._resolve(m.group(1), keyspace)
            table = self.tables.get((ks, table_name))
            if table is not None:
                table.rows.clear()
            return wire.void_body()

        raise wire.CqlError(0x2000, f"unsupported statement: {q[:80]}")

    @staticmethod
    def _split_args(s: str) -> list[str]:
        parts, cur, depth, quoted = [], "", 0, False
        for ch in s:
            if ch == "'" and depth == 0:
                quoted = not quoted
            if ch == "," and depth == 0 and not quoted:
                parts.append(cur)
                cur = ""
                continue
            if ch in "([{<" and not quoted:
                depth += 1
            if ch in ")]}>" and not quoted:
                depth -= 1
            cur += ch
        if cur.strip():
            parts.append(cur)
        return parts

    @staticmethod
    def _literal(token: str) -> Any:
        token = token.strip()
        if token.startswith("'") and token.endswith("'"):
            return token[1:-1]
        if token.upper() in ("TRUE", "FALSE"):
            return token.upper() == "TRUE"
        if token.upper() == "NULL":
            return None
        if token.startswith("[") and token.endswith("]"):
            return [FakeCassandra._literal(t) for t in FakeCassandra._split_args(token[1:-1])]
        try:
            return int(token)
        except ValueError:
            try:
                return float(token)
            except ValueError:
                return token

    def _conditions(
        self, where: Optional[str], table: _Table, raw_values: list[Optional[bytes]]
    ) -> list[tuple[str, Any]]:
        if not where:
            return []
        where = re.sub(r"\s+ALLOW FILTERING\s*$", "", where.strip(), flags=re.I)
        conditions = []
        bound = [v for v in raw_values]
        # bound values are consumed left-to-right across the whole statement;
        # SELECT/DELETE use them only in WHERE and ANN OF (handled by caller
        # passing the remaining list)
        for clause in re.split(r"\s+AND\s+", where, flags=re.I):
            m = re.match(r'"?([\w]+)"?\s*=\s*(.+)', clause.strip())
            if not m:
                continue
            col, rhs = m.group(1), m.group(2).strip()
            if rhs == "?":
                value = _decode_bound(
                    table.columns.get(col, wire.T_VARCHAR), bound.pop(0)
                )
            else:
                value = self._literal(rhs)
            conditions.append((col, value))
        del raw_values[: len(raw_values) - len(bound)]
        return conditions

    @staticmethod
    def _matches(row: dict[str, Any], conditions: list[tuple[str, Any]]) -> bool:
        return all(row.get(col) == value for col, value in conditions)

    def _select(
        self, q: str, raw_values: list[Optional[bytes]], keyspace: list[Optional[str]]
    ) -> bytes:
        m = re.match(
            r"SELECT\s+(.*?)\s+FROM\s+([\w.\"]+)"
            r"(?:\s+WHERE\s+(.*?))?"
            r"(?:\s+ORDER\s+BY\s+\"?(\w+)\"?\s+ANN\s+OF\s+(\?))?"
            r"(?:\s+LIMIT\s+(\d+))?"
            r"(?:\s+ALLOW\s+FILTERING)?\s*$",
            q,
            re.I | re.S,
        )
        if not m:
            raise wire.CqlError(0x2000, f"cannot parse SELECT: {q[:120]}")
        cols_spec, table_ref, where, ann_col, _ann_q, limit = m.groups()
        ks, table_name = self._resolve(table_ref, keyspace)

        # system_schema introspection
        if ks == "system_schema":
            values = list(raw_values)
            if table_name == "keyspaces":
                target = _decode_bound(wire.T_VARCHAR, values[0]) if values else None
                rows = [[k] for k in sorted(self.keyspaces) if target in (None, k)]
                return wire.rows_body(
                    "system_schema", "keyspaces", [("keyspace_name", wire.T_VARCHAR)], rows
                )
            if table_name == "tables":
                ks_t = _decode_bound(wire.T_VARCHAR, values[0]) if values else None
                t_t = (
                    _decode_bound(wire.T_VARCHAR, values[1]) if len(values) > 1 else None
                )
                rows = [
                    [k[1]]
                    for k in sorted(self.tables)
                    if ks_t in (None, k[0]) and t_t in (None, k[1])
                ]
                return wire.rows_body(
                    "system_schema", "tables", [("table_name", wire.T_VARCHAR)], rows
                )
            raise wire.CqlError(0x2200, f"unknown system table {table_name}")

        table = self.tables.get((ks, table_name))
        if table is None:
            raise wire.CqlError(0x2200, f"unconfigured table {ks}.{table_name}")
        conditions = self._conditions(where, table, raw_values)
        rows = [row for row in table.rows.values() if self._matches(row, conditions)]

        if ann_col:
            query_vec = _decode_bound(("vector", 0), raw_values.pop(0))

            def cosine(row: dict[str, Any]) -> float:
                v = row.get(ann_col) or []
                dot = sum(a * b for a, b in zip(v, query_vec))
                na = math.sqrt(sum(a * a for a in v))
                nb = math.sqrt(sum(b * b for b in query_vec))
                return dot / (na * nb + 1e-12) if na else -1.0

            rows.sort(key=cosine, reverse=True)

        if limit:
            rows = rows[: int(limit)]

        cols_spec = cols_spec.strip()
        similarity_expr = re.search(
            r"similarity_cosine\(\"?(\w+)\"?,\s*\?\)", cols_spec, re.I
        )
        if cols_spec == "*":
            out_cols = [(c, t) for c, t in table.columns.items()]
        else:
            out_cols = []
            for c in self._split_args(cols_spec):
                c = c.strip().strip('"')
                if c in table.columns:
                    out_cols.append((c, table.columns[c]))
        out_rows = [[row.get(c) for c, _ in out_cols] for row in rows]
        if similarity_expr:
            # not commonly used by the agents; report 0.0 column
            out_cols.append(("similarity", wire.T_FLOAT))
            for r in out_rows:
                r.append(0.0)
        return wire.rows_body(ks, table_name, out_cols, out_rows)
