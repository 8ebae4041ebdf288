"""Protocol-level fake Pulsar broker for tests (the `kafka_fake.py` pattern).

Speaks the binary-protocol subset the client in ``pulsar.py`` does —
CONNECT/CONNECTED, PRODUCER, SEND (payload frames, crc32c verified),
SUBSCRIBE (shared + exclusive, durable + non-durable), FLOW permits, MESSAGE
delivery, individual + cumulative ACK, SEEK, CLOSE_*, PARTITIONED_METADATA,
GET_LAST_MESSAGE_ID, PING/PONG — over a real asyncio socket, plus the admin
REST surface (``/admin/v2/persistent/...``) on a stdlib HTTP server whose
handlers run on the fake's loop (``fake_rest.py``).

Broker semantics modelled:
- one ledger (id 0) per topic; entry_id is the append index
- a SHARED subscription round-robins undelivered entries among its
  consumers, honoring per-consumer FLOW permits (this is what splits work
  across agent replicas — the fake must get it right for the contract
  tests)
- a durable subscription's ack state survives consumer disconnects;
  in-flight (delivered, unacked) entries return to the pool when their
  consumer goes away, so redelivery-on-crash is exercised for real
- SEEK positions the cursor AFTER the given entry (matching the runtime's
  resume convention: the stored offset is the last-read message)

This stands in for the reference's testcontainers Pulsar in an image with
no JVM and no network egress.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.messaging import fake_rest
from langstream_tpu_torch.messaging import pulsar_protocol as wire

log = logging.getLogger(__name__)


@dataclass
class _ConsumerRef:
    conn: "_Conn"
    consumer_id: int
    permits: int = 0


@dataclass
class _Subscription:
    name: str
    sub_type: int = 1  # shared
    durable: bool = True
    acked: set = field(default_factory=set)
    in_flight: dict = field(default_factory=dict)  # entry_id → _ConsumerRef
    consumers: list = field(default_factory=list)
    rr: int = 0


@dataclass
class _Topic:
    entries: list = field(default_factory=list)  # (metadata bytes, payload)
    subscriptions: dict = field(default_factory=dict)
    producer_seq: int = 0


class _Conn:
    def __init__(self, broker: "FakePulsarBroker", writer: asyncio.StreamWriter) -> None:
        self.broker = broker
        self.writer = writer
        self.lock = asyncio.Lock()
        self.producers: dict[int, str] = {}  # producer_id → topic
        self.consumers: dict[int, tuple[str, str]] = {}  # consumer_id → (topic, sub)

    async def send(self, command: bytes, metadata: bytes = b"", payload: bytes = b"") -> None:
        data = (
            wire.payload_frame(command, metadata, payload)
            if metadata
            else wire.frame(command)
        )
        async with self.lock:
            self.writer.write(data)
            await self.writer.drain()


class FakePulsarBroker:
    """Single-node fake: binary protocol + admin REST, tenant/ns agnostic."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.admin_port = 0
        self.topics: dict[str, _Topic] = {}
        self.partitioned: dict[str, int] = {}  # base topic → partition count
        # multi-broker ownership: data topics listed here are answered with a
        # lookup REDIRECT to the given service_url instead of "connect here"
        self.lookup_redirects: dict[str, str] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._admin_runner: Any = None
        self._conns: set[_Conn] = set()
        self._producer_names = 0

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "FakePulsarBroker":
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        await self._start_admin()
        return self

    async def _start_admin(self) -> None:
        base = "/admin/v2/persistent/{tenant}/{ns}"
        rest = fake_rest.FakeRestServer(
            self.host,
            [
                ("GET", base, self._admin_list),
                ("PUT", base + "/{topic}/partitions", self._admin_create_partitioned),
                ("DELETE", base + "/{topic}/partitions", self._admin_delete_partitioned),
                ("GET", base + "/{topic}/partitions", self._admin_get_partitions),
                ("PUT", base + "/{topic}", self._admin_create),
                ("DELETE", base + "/{topic}", self._admin_delete),
            ],
        )
        self.admin_port = await rest.start()
        self._admin_runner = rest

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for conn in list(self._conns):
                conn.writer.close()
            await self._server.wait_closed()
            self._server = None
        if self._admin_runner is not None:
            await self._admin_runner.stop()
            self._admin_runner = None

    @property
    def service_url(self) -> str:
        return f"pulsar://{self.host}:{self.port}"

    @property
    def admin_url(self) -> str:
        return f"http://{self.host}:{self.admin_port}"

    # -- admin REST ----------------------------------------------------------

    def _full(self, request) -> str:
        return (
            f"persistent://{request.match_info['tenant']}/"
            f"{request.match_info['ns']}/{request.match_info['topic']}"
        )

    async def _admin_list(self, request):
        prefix = f"persistent://{request.match_info['tenant']}/{request.match_info['ns']}/"
        names = sorted(
            set(
                [t for t in self.topics if t.startswith(prefix)]
                + [t for t in self.partitioned if t.startswith(prefix)]
            )
        )
        return fake_rest.json_response(names)

    async def _admin_create(self, request):
        full = self._full(request)
        if full in self.topics:
            return fake_rest.Response(status=409)
        self.topics[full] = _Topic()
        return fake_rest.Response(status=204)

    async def _admin_create_partitioned(self, request):
        full = self._full(request)
        if full in self.partitioned:
            return fake_rest.Response(status=409)
        n = int((await request.read()) or b"1")
        self.partitioned[full] = n
        for i in range(n):
            self.topics.setdefault(f"{full}-partition-{i}", _Topic())
        return fake_rest.Response(status=204)

    async def _admin_get_partitions(self, request):
        return fake_rest.json_response(
            {"partitions": self.partitioned.get(self._full(request), 0)}
        )

    async def _admin_delete(self, request):
        return fake_rest.Response(
            status=204 if self.topics.pop(self._full(request), None) else 404
        )

    async def _admin_delete_partitioned(self, request):
        full = self._full(request)
        n = self.partitioned.pop(full, None)
        if n is None:
            return fake_rest.Response(status=404)
        for i in range(n):
            self.topics.pop(f"{full}-partition-{i}", None)
        return fake_rest.Response(status=204)

    # -- binary protocol -----------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _Conn(self, writer)
        self._conns.add(conn)
        try:
            while True:
                header = await reader.readexactly(4)
                total = int.from_bytes(header, "big")
                body = await reader.readexactly(total)
                name, fields, metadata, payload = wire.split_frame(body)
                handler = getattr(self, f"_on_{name}", None)
                if handler is None:
                    log.warning("fake pulsar: unhandled command %s", name)
                    continue
                await handler(conn, fields, metadata, payload)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(conn)
            # consumer crash semantics: their unacked in-flight entries return
            # to the pool and get redelivered to surviving consumers
            for consumer_id in list(conn.consumers):
                await self._drop_consumer(conn, consumer_id)
            writer.close()

    async def _drop_consumer(self, conn: _Conn, consumer_id: int) -> None:
        entry = conn.consumers.pop(consumer_id, None)
        if entry is None:
            return
        topic_name, sub_name = entry
        topic = self.topics.get(topic_name)
        if topic is None:
            return
        sub = topic.subscriptions.get(sub_name)
        if sub is None:
            return
        sub.consumers = [
            c for c in sub.consumers
            if not (c.conn is conn and c.consumer_id == consumer_id)
        ]
        returned = [
            e
            for e, ref in sub.in_flight.items()
            if ref.conn is conn and ref.consumer_id == consumer_id
        ]
        for e in returned:
            del sub.in_flight[e]
        if not sub.durable and not sub.consumers:
            topic.subscriptions.pop(sub_name, None)
        elif returned:
            await self._pump(topic_name, sub)

    def _topic(self, name: str) -> _Topic:
        t = self.topics.get(name)
        if t is None:  # auto-create (broker default)
            t = _Topic()
            self.topics[name] = t
        return t

    async def _on_connect(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        await conn.send(
            wire.encode_command(
                "connected",
                {
                    "server_version": "fake-pulsar",
                    "protocol_version": wire.PROTOCOL_VERSION,
                    "max_message_size": 5 * 1024 * 1024,
                },
            )
        )

    async def _on_ping(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        await conn.send(wire.encode_command("pong", {}))

    async def _on_pong(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        pass

    async def _on_partitioned_metadata(
        self, conn: _Conn, fields: dict, metadata, payload
    ) -> None:
        await conn.send(
            wire.encode_command(
                "partitioned_metadata_response",
                {
                    "partitions": self.partitioned.get(fields["topic"], 0),
                    "request_id": fields["request_id"],
                    "response": 0,
                },
            )
        )

    async def _on_lookup(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        owner = self.lookup_redirects.get(fields["topic"])
        await conn.send(
            wire.encode_command(
                "lookup_response",
                {
                    "broker_service_url": owner or self.service_url,
                    "response": 0 if owner else 1,  # 0 redirect, 1 connect
                    "request_id": fields["request_id"],
                    "authoritative": 1,
                },
            )
        )

    async def _on_producer(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        self._producer_names += 1
        producer_id = int(fields["producer_id"])
        conn.producers[producer_id] = fields["topic"]
        self._topic(fields["topic"])
        await conn.send(
            wire.encode_command(
                "producer_success",
                {
                    "request_id": fields["request_id"],
                    "producer_name": fields.get(
                        "producer_name", f"fake-producer-{self._producer_names}"
                    ),
                    "last_sequence_id": -1,
                },
            )
        )

    async def _on_close_producer(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        conn.producers.pop(int(fields["producer_id"]), None)
        await conn.send(
            wire.encode_command("success", {"request_id": fields["request_id"]})
        )

    async def _on_send(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        producer_id = int(fields["producer_id"])
        topic_name = conn.producers.get(producer_id)
        if topic_name is None:
            await conn.send(
                wire.encode_command(
                    "send_error",
                    {
                        "producer_id": producer_id,
                        "sequence_id": fields["sequence_id"],
                        "error": 0,
                        "message": "unknown producer",
                    },
                )
            )
            return
        topic = self._topic(topic_name)
        entry_id = len(topic.entries)
        # store the re-encoded metadata verbatim so consumers get the same
        # properties/partition_key/publish_time the producer sent
        topic.entries.append(
            (wire.encode_message(wire.MESSAGE_METADATA, metadata or {}), payload)
        )
        await conn.send(
            wire.encode_command(
                "send_receipt",
                {
                    "producer_id": producer_id,
                    "sequence_id": fields["sequence_id"],
                    "message_id": {"ledger_id": 0, "entry_id": entry_id},
                },
            )
        )
        for sub in topic.subscriptions.values():
            await self._pump(topic_name, sub)

    async def _on_subscribe(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        topic_name = fields["topic"]
        topic = self._topic(topic_name)
        sub_name = fields["subscription"]
        durable = bool(fields.get("durable", 1))
        sub = topic.subscriptions.get(sub_name)
        if sub is None:
            sub = _Subscription(
                name=sub_name,
                sub_type=int(fields.get("sub_type", 1)),
                durable=durable,
            )
            if int(fields.get("initial_position", 0)) == 0:  # latest
                sub.acked = set(range(len(topic.entries)))
            topic.subscriptions[sub_name] = sub
        consumer_id = int(fields["consumer_id"])
        sub.consumers.append(_ConsumerRef(conn, consumer_id))
        conn.consumers[consumer_id] = (topic_name, sub_name)
        await conn.send(
            wire.encode_command("success", {"request_id": fields["request_id"]})
        )

    async def _on_close_consumer(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        await self._drop_consumer(conn, int(fields["consumer_id"]))
        await conn.send(
            wire.encode_command("success", {"request_id": fields["request_id"]})
        )

    async def _on_unsubscribe(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        consumer_id = int(fields["consumer_id"])
        entry = conn.consumers.get(consumer_id)
        if entry is not None:
            topic = self.topics.get(entry[0])
            if topic is not None:
                topic.subscriptions.pop(entry[1], None)
        await self._drop_consumer(conn, consumer_id)
        await conn.send(
            wire.encode_command("success", {"request_id": fields["request_id"]})
        )

    async def _on_flow(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        consumer_id = int(fields["consumer_id"])
        entry = conn.consumers.get(consumer_id)
        if entry is None:
            return
        topic_name, sub_name = entry
        topic = self.topics.get(topic_name)
        sub = topic.subscriptions.get(sub_name) if topic else None
        if sub is None:
            return
        for ref in sub.consumers:
            if ref.conn is conn and ref.consumer_id == consumer_id:
                ref.permits += int(fields["message_permits"])
        await self._pump(topic_name, sub)

    async def _on_ack(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        consumer_id = int(fields["consumer_id"])
        entry = conn.consumers.get(consumer_id)
        if entry is None:
            return
        topic_name, sub_name = entry
        topic = self.topics.get(topic_name)
        sub = topic.subscriptions.get(sub_name) if topic else None
        if sub is None:
            return
        mids = fields.get("message_id", [])
        if not isinstance(mids, list):
            mids = [mids]
        cumulative = int(fields.get("ack_type", 0)) == 1
        for mid in mids:
            entry_id = int(mid.get("entry_id", 0))
            if cumulative:
                for e in range(entry_id + 1):
                    sub.acked.add(e)
                    sub.in_flight.pop(e, None)
            else:
                sub.acked.add(entry_id)
                sub.in_flight.pop(entry_id, None)

    async def _on_seek(self, conn: _Conn, fields: dict, metadata, payload) -> None:
        consumer_id = int(fields["consumer_id"])
        entry = conn.consumers.get(consumer_id)
        if entry is not None:
            topic_name, sub_name = entry
            topic = self.topics.get(topic_name)
            sub = topic.subscriptions.get(sub_name) if topic else None
            if sub is not None:
                seek_entry = int(fields.get("message_id", {}).get("entry_id", -1))
                # cursor lands AFTER the seeked entry (resume convention)
                sub.acked = set(range(seek_entry + 1))
                sub.in_flight.clear()
                await self._pump(topic_name, sub)
        await conn.send(
            wire.encode_command("success", {"request_id": fields["request_id"]})
        )

    async def _on_get_last_message_id(
        self, conn: _Conn, fields: dict, metadata, payload
    ) -> None:
        consumer_id = int(fields["consumer_id"])
        entry = conn.consumers.get(consumer_id)
        last = -1
        if entry is not None:
            topic = self.topics.get(entry[0])
            if topic is not None:
                last = len(topic.entries) - 1
        await conn.send(
            wire.encode_command(
                "get_last_message_id_response",
                {
                    "last_message_id": {"ledger_id": 0, "entry_id": last},
                    "request_id": fields["request_id"],
                },
            )
        )

    # -- delivery ------------------------------------------------------------

    async def _pump(self, topic_name: str, sub: _Subscription) -> None:
        """Deliver every available entry to consumers with permits.

        Shared subscription: round-robin across consumers. Exclusive: only
        the first consumer receives."""
        topic = self.topics.get(topic_name)
        if topic is None or not sub.consumers:
            return
        for entry_id in range(len(topic.entries)):
            if entry_id in sub.acked or entry_id in sub.in_flight:
                continue
            ref = self._next_consumer(sub)
            if ref is None:
                return  # no permits anywhere — wait for FLOW
            metadata_bytes, payload = topic.entries[entry_id]
            sub.in_flight[entry_id] = ref
            ref.permits -= 1
            try:
                await ref.conn.send(
                    wire.encode_command(
                        "message",
                        {
                            "consumer_id": ref.consumer_id,
                            "message_id": {"ledger_id": 0, "entry_id": entry_id},
                        },
                    ),
                    metadata_bytes,
                    payload,
                )
            except (ConnectionError, RuntimeError):
                del sub.in_flight[entry_id]
                return

    def _next_consumer(self, sub: _Subscription) -> Optional[_ConsumerRef]:
        if not sub.consumers:
            return None
        if sub.sub_type == 0:  # exclusive
            ref = sub.consumers[0]
            return ref if ref.permits > 0 else None
        n = len(sub.consumers)
        for i in range(n):
            ref = sub.consumers[(sub.rr + i) % n]
            if ref.permits > 0:
                sub.rr = (sub.rr + i + 1) % n
                return ref
        return None
