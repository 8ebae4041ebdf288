"""Protocol-level fake Kafka broker for tests (the `k8s/fake.py` pattern).

Speaks the same wire subset the client in ``kafka.py`` does — Produce v3,
Fetch v4, ListOffsets v1, Metadata v1, OffsetCommit v2, OffsetFetch v1,
FindCoordinator v1, CreateTopics v0, DeleteTopics v0 — over a real asyncio
socket, storing record batches exactly as a broker log does (batches are
fetched back verbatim from the requested offset's containing batch onward,
so the client's "skip records below fetch_offset" path is exercised).

This stands in for the reference's testcontainers Kafka (KafkaContainerTest
tier) in an image with no JVM and no network egress.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Optional

from langstream_tpu_torch.messaging import kafka_protocol as wire


@dataclass
class _GroupMember:
    member_id: str
    subscription: bytes = b""
    session_timeout_ms: int = 10_000
    rebalance_timeout_ms: int = 20_000
    last_heartbeat: float = 0.0
    join_future: Optional[asyncio.Future] = None
    sync_future: Optional[asyncio.Future] = None


@dataclass
class _Group:
    """Coordinator state for one consumer group (GroupCoordinator semantics:
    Empty → PreparingRebalance → CompletingRebalance → Stable)."""

    state: str = "Empty"
    generation: int = 0
    leader: Optional[str] = None
    protocol_name: Optional[str] = None
    members: dict[str, _GroupMember] = field(default_factory=dict)
    assignments: dict[str, bytes] = field(default_factory=dict)
    completer: Optional[asyncio.Task] = None
    member_seq: int = 0


@dataclass
class _PartitionLog:
    batches: list[tuple[int, int, bytes]] = field(default_factory=list)
    # (base_offset, record_count, batch_bytes)
    next_offset: int = 0

    def append(self, records: list[wire.WireRecord]) -> int:
        base = self.next_offset
        data = wire.encode_record_batch(records, base_offset=base)
        self.batches.append((base, len(records), data))
        self.next_offset += len(records)
        return base

    def read_from(self, offset: int) -> bytes:
        out = []
        for base, count, data in self.batches:
            if base + count > offset:  # batch contains offsets >= requested
                out.append(data)
        return b"".join(out)


class FakeKafkaBroker:
    """Single-node fake broker; node id 0, coordinator for every group."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.topics: dict[str, list[_PartitionLog]] = {}
        self.committed: dict[tuple[str, str, int], int] = {}
        self.groups: dict[str, _Group] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._data_event = asyncio.Event()
        self._writers: set[asyncio.StreamWriter] = set()
        self._sweeper: Optional[asyncio.Task] = None
        # protocol-visible knobs for tests
        self.auto_create_topics = True
        # one-shot fetch error injection: (topic, partition) → error code
        # (e.g. NOT_LEADER_FOR_PARTITION to simulate failover)
        self.fetch_errors: dict[tuple[str, int], int] = {}

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "FakeKafkaBroker":
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._sweeper = asyncio.create_task(self._session_sweeper())
        return self

    async def stop(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            self._sweeper = None
        for group in self.groups.values():
            if group.completer is not None:
                group.completer.cancel()
        if self._server is not None:
            self._server.close()
            # force-close live client connections — wait_closed() waits for
            # every handler, and a leaked client would park it forever
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def bootstrap(self) -> str:
        return f"{self.host}:{self.port}"

    # -- storage ------------------------------------------------------------

    def _topic(self, name: str, create: Optional[bool] = None) -> Optional[list[_PartitionLog]]:
        create = self.auto_create_topics if create is None else create
        t = self.topics.get(name)
        if t is None and create:
            t = [_PartitionLog()]
            self.topics[name] = t
        return t

    # -- connection handling -------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    size = int.from_bytes(await reader.readexactly(4), "big")
                except asyncio.IncompleteReadError:
                    return
                frame = await reader.readexactly(size)
                r = wire.Reader(frame)
                api_key, version, correlation, _client = wire.decode_request_header(r)
                handler = self._HANDLERS.get(api_key)
                if handler is None:
                    raise RuntimeError(f"fake broker: unsupported api {api_key}")
                body = await handler(self, r, version)
                out = wire.Writer().int32(correlation).raw(body).build()
                writer.write(len(out).to_bytes(4, "big") + out)
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            return
        finally:
            self._writers.discard(writer)
            writer.close()

    # -- handlers ------------------------------------------------------------

    async def _metadata(self, r: wire.Reader, version: int) -> bytes:
        topics = r.array(lambda rr: rr.string())
        if not topics:
            topics = sorted(self.topics)
        w = wire.Writer()
        w.array(
            [(0, self.host, self.port)],
            lambda w, b: w.int32(b[0]).string(b[1]).int32(b[2]).string(None),
        )
        w.int32(0)  # controller
        w.int32(len(topics))
        for name in topics:
            parts = self._topic(name, create=False)
            if parts is None:
                w.int16(wire.UNKNOWN_TOPIC_OR_PARTITION).string(name).boolean(False)
                w.int32(0)
                continue
            w.int16(wire.NONE).string(name).boolean(False)
            w.int32(len(parts))
            for pid in range(len(parts)):
                w.int16(wire.NONE).int32(pid).int32(0)  # leader = node 0
                w.array([0], lambda w2, x: w2.int32(x))  # replicas
                w.array([0], lambda w2, x: w2.int32(x))  # isr
        return w.build()

    async def _produce(self, r: wire.Reader, version: int) -> bytes:
        r.string()  # transactional id
        r.int16()  # acks
        r.int32()  # timeout
        responses = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            for _ in range(r.int32()):
                partition = r.int32()
                data = r.bytes_() or b""
                records = wire.decode_record_batches(data)
                parts = self._topic(topic)
                assert parts is not None
                while partition >= len(parts):
                    parts.append(_PartitionLog())
                base = parts[partition].append(records)
                responses.append((topic, partition, wire.NONE, base))
        self._data_event.set()
        self._data_event = asyncio.Event()
        w = wire.Writer()
        w.int32(len(responses))
        for topic, partition, err, base in responses:
            w.string(topic)
            w.int32(1)
            w.int32(partition).int16(err).int64(base).int64(-1)
        w.int32(0)  # throttle
        return w.build()

    async def _fetch(self, r: wire.Reader, version: int) -> bytes:
        r.int32()  # replica
        max_wait = r.int32()
        r.int32()  # min bytes
        r.int32()  # max bytes
        r.int8()  # isolation
        wants: list[tuple[str, int, int]] = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            for _ in range(r.int32()):
                partition = r.int32()
                offset = r.int64()
                r.int32()  # partition max bytes
                wants.append((topic, partition, offset))

        def collect() -> list[tuple[str, int, int, bytes]]:
            out = []
            for topic, partition, offset in wants:
                parts = self._topic(topic)
                log = parts[partition] if parts and partition < len(parts) else None
                data = log.read_from(offset) if log is not None else b""
                out.append((topic, partition, log.next_offset if log else 0, data))
            return out

        got = collect()
        if not any(d for *_x, d in got) and max_wait > 0:
            event = self._data_event
            try:
                await asyncio.wait_for(event.wait(), max_wait / 1000.0)
                got = collect()
            except asyncio.TimeoutError:
                pass

        w = wire.Writer()
        w.int32(0)  # throttle
        by_topic: dict[str, list[tuple[int, int, bytes]]] = {}
        for topic, partition, hw, data in got:
            by_topic.setdefault(topic, []).append((partition, hw, data))
        w.int32(len(by_topic))
        for topic, plist in by_topic.items():
            w.string(topic)
            w.int32(len(plist))
            for partition, hw, data in plist:
                err = self.fetch_errors.pop((topic, partition), wire.NONE)
                w.int32(partition).int16(err).int64(hw).int64(hw)
                w.array([], lambda w2, _: None)  # aborted txns
                w.bytes_(b"" if err != wire.NONE else data)
        return w.build()

    async def _list_offsets(self, r: wire.Reader, version: int) -> bytes:
        r.int32()  # replica
        answers = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            for _ in range(r.int32()):
                partition = r.int32()
                ts = r.int64()
                parts = self._topic(topic)
                log = parts[partition] if parts and partition < len(parts) else None
                if ts == wire.EARLIEST_TIMESTAMP:
                    offset = 0
                else:
                    offset = log.next_offset if log else 0
                answers.append((topic, partition, offset))
        w = wire.Writer()
        w.int32(len(answers))
        for topic, partition, offset in answers:
            w.string(topic).int32(1)
            w.int32(partition).int16(wire.NONE).int64(-1).int64(offset)
        return w.build()

    async def _find_coordinator(self, r: wire.Reader, version: int) -> bytes:
        r.string()  # group
        r.int8()  # type
        return (
            wire.Writer()
            .int32(0)  # throttle
            .int16(wire.NONE)
            .string(None)
            .int32(0)
            .string(self.host)
            .int32(self.port)
            .build()
        )

    async def _offset_commit(self, r: wire.Reader, version: int) -> bytes:
        group_id = r.string() or ""
        generation = r.int32()
        member_id = r.string() or ""
        r.int64()  # retention
        # generation -1 is the simple-consumer convention (no membership
        # fencing); a real generation is checked against the live group so a
        # zombie replica can't commit after being rebalanced away
        err = wire.NONE
        if generation >= 0:
            group = self.groups.get(group_id)
            if group is None or member_id not in group.members:
                err = wire.UNKNOWN_MEMBER_ID
            elif generation != group.generation:
                err = wire.ILLEGAL_GENERATION
        acks = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            for _ in range(r.int32()):
                partition = r.int32()
                offset = r.int64()
                r.string()  # metadata
                if err == wire.NONE:
                    self.committed[(group_id, topic, partition)] = offset
                acks.append((topic, partition))
        w = wire.Writer()
        w.int32(len(acks))
        for topic, partition in acks:
            w.string(topic).int32(1).int32(partition).int16(err)
        return w.build()

    async def _offset_fetch(self, r: wire.Reader, version: int) -> bytes:
        group = r.string() or ""
        answers = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            for _ in range(r.int32()):
                partition = r.int32()
                offset = self.committed.get((group, topic, partition), -1)
                answers.append((topic, partition, offset))
        w = wire.Writer()
        w.int32(len(answers))
        for topic, partition, offset in answers:
            w.string(topic).int32(1)
            w.int32(partition).int64(offset).string(None).int16(wire.NONE)
        return w.build()

    # -- group coordinator ---------------------------------------------------

    def _trigger_rebalance(self, group: _Group) -> None:
        """Move to PreparingRebalance and spawn the join-barrier completer.
        Pending SyncGroup waiters are bounced with REBALANCE_IN_PROGRESS so
        they rejoin under the new generation."""
        for m in group.members.values():
            if m.sync_future is not None and not m.sync_future.done():
                m.sync_future.set_result((wire.REBALANCE_IN_PROGRESS, b""))
                m.sync_future = None
        if group.state == "PreparingRebalance":
            return
        group.state = "PreparingRebalance"
        group.completer = asyncio.create_task(self._complete_join(group))

    async def _complete_join(self, group: _Group) -> None:
        """Wait for every known member to rejoin (or its rebalance timeout),
        evict stragglers, bump the generation, and answer all joiners."""
        loop = asyncio.get_running_loop()
        timeout = max(
            (m.rebalance_timeout_ms for m in group.members.values()), default=3000
        )
        deadline = loop.time() + timeout / 1000.0
        while loop.time() < deadline:
            if group.members and all(
                m.join_future is not None for m in group.members.values()
            ):
                break
            await asyncio.sleep(0.01)
        for mid in [m for m, st in group.members.items() if st.join_future is None]:
            del group.members[mid]
        if not group.members:
            group.state = "Empty"
            group.leader = None
            return
        group.generation += 1
        group.leader = sorted(group.members)[0]
        group.state = "CompletingRebalance"
        roster = [(mid, m.subscription) for mid, m in sorted(group.members.items())]
        now = loop.time()
        for mid, m in group.members.items():
            m.last_heartbeat = now
            fut, m.join_future = m.join_future, None
            if fut is not None and not fut.done():
                fut.set_result((group.generation, group.leader, roster))

    async def _join_group(self, r: wire.Reader, version: int) -> bytes:
        group_id = r.string() or ""
        session_timeout = r.int32()
        rebalance_timeout = r.int32() if version >= 1 else session_timeout
        member_id = r.string() or ""
        protocol_type = r.string() or ""
        protocols = []
        for _ in range(r.int32()):
            protocols.append((r.string() or "", r.bytes_() or b""))

        group = self.groups.setdefault(group_id, _Group())
        if not member_id:
            group.member_seq += 1
            member_id = f"member-{group.member_seq}"
        member = group.members.get(member_id)
        if member is None:
            member = _GroupMember(member_id)
            group.members[member_id] = member
        member.session_timeout_ms = session_timeout
        member.rebalance_timeout_ms = rebalance_timeout
        member.subscription = protocols[0][1] if protocols else b""
        member.last_heartbeat = asyncio.get_running_loop().time()
        group.protocol_name = protocols[0][0] if protocols else "range"
        member.join_future = asyncio.get_running_loop().create_future()
        self._trigger_rebalance(group)

        try:
            generation, leader, roster = await asyncio.wait_for(
                member.join_future, timeout=rebalance_timeout / 1000.0 + 1.0
            )
        except asyncio.TimeoutError:
            group.members.pop(member_id, None)
            return (
                wire.Writer().int32(0).int16(wire.REBALANCE_IN_PROGRESS)
                .int32(-1).string(None).string(None).string(member_id)
                .int32(0).build()
            )
        w = wire.Writer()
        w.int32(0)  # throttle
        w.int16(wire.NONE)
        w.int32(generation)
        w.string(group.protocol_name)
        w.string(leader)
        w.string(member_id)
        members = roster if member_id == leader else []
        w.array(members, lambda w2, m: w2.string(m[0]).bytes_(m[1]))
        return w.build()

    async def _sync_group(self, r: wire.Reader, version: int) -> bytes:
        group_id = r.string() or ""
        generation = r.int32()
        member_id = r.string() or ""
        assignments = []
        for _ in range(r.int32()):
            assignments.append((r.string() or "", r.bytes_() or b""))

        def reply(err: int, data: bytes = b"") -> bytes:
            return wire.Writer().int32(0).int16(err).bytes_(data).build()

        group = self.groups.get(group_id)
        if group is None or member_id not in group.members:
            return reply(wire.UNKNOWN_MEMBER_ID)
        if generation != group.generation:
            return reply(wire.ILLEGAL_GENERATION)
        if group.state == "PreparingRebalance":
            return reply(wire.REBALANCE_IN_PROGRESS)
        member = group.members[member_id]
        if member_id == group.leader:
            # leader distributes: store (late followers read it from the
            # group), resolve every parked follower, then Stable
            group.assignments = dict(assignments)
            group.state = "Stable"
            for mid, m in group.members.items():
                data = group.assignments.get(mid, b"")
                if m.sync_future is not None and not m.sync_future.done():
                    m.sync_future.set_result((wire.NONE, data))
                    m.sync_future = None
            return reply(wire.NONE, group.assignments.get(member_id, b""))
        if group.state == "Stable":
            # follower syncing after the leader already distributed (the
            # common ordering): serve its stored slice
            return reply(wire.NONE, group.assignments.get(member_id, b""))
        member.sync_future = asyncio.get_running_loop().create_future()
        try:
            err, data = await asyncio.wait_for(
                member.sync_future, timeout=member.rebalance_timeout_ms / 1000.0 + 1.0
            )
        except asyncio.TimeoutError:
            return reply(wire.REBALANCE_IN_PROGRESS)
        return reply(err, data)

    async def _heartbeat(self, r: wire.Reader, version: int) -> bytes:
        group_id = r.string() or ""
        generation = r.int32()
        member_id = r.string() or ""
        group = self.groups.get(group_id)
        err = wire.NONE
        if group is None or member_id not in group.members:
            err = wire.UNKNOWN_MEMBER_ID
        elif generation != group.generation:
            err = wire.ILLEGAL_GENERATION
        elif group.state == "PreparingRebalance":
            err = wire.REBALANCE_IN_PROGRESS
        if group is not None and member_id in group.members:
            group.members[member_id].last_heartbeat = asyncio.get_running_loop().time()
        return wire.Writer().int32(0).int16(err).build()

    async def _leave_group(self, r: wire.Reader, version: int) -> bytes:
        group_id = r.string() or ""
        member_id = r.string() or ""
        group = self.groups.get(group_id)
        if group is not None and member_id in group.members:
            del group.members[member_id]
            if group.members:
                self._trigger_rebalance(group)
            else:
                group.state = "Empty"
                group.leader = None
        return wire.Writer().int32(0).int16(wire.NONE).build()

    async def _session_sweeper(self) -> None:
        """Evict members whose session timed out (crashed without
        LeaveGroup) and hand their partitions to the survivors."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(0.1)
            now = loop.time()
            for group in self.groups.values():
                expired = [
                    mid
                    for mid, m in group.members.items()
                    if m.join_future is None
                    and now - m.last_heartbeat > m.session_timeout_ms / 1000.0
                ]
                if expired:
                    for mid in expired:
                        del group.members[mid]
                    if group.members:
                        self._trigger_rebalance(group)
                    else:
                        group.state = "Empty"
                        group.leader = None

    async def _create_topics(self, r: wire.Reader, version: int) -> bytes:
        results = []
        for _ in range(r.int32()):
            name = r.string() or ""
            partitions = r.int32()
            r.int16()  # replication
            r.array(lambda rr: None)  # assignments
            r.array(lambda rr: None)  # configs
            if name in self.topics:
                results.append((name, wire.TOPIC_ALREADY_EXISTS))
            else:
                self.topics[name] = [_PartitionLog() for _ in range(max(partitions, 1))]
                results.append((name, wire.NONE))
        r.int32()  # timeout
        w = wire.Writer()
        w.array(results, lambda w, t: w.string(t[0]).int16(t[1]))
        return w.build()

    async def _delete_topics(self, r: wire.Reader, version: int) -> bytes:
        results = []
        for name in r.array(lambda rr: rr.string()):
            self.topics.pop(name or "", None)
            results.append((name, wire.NONE))
        r.int32()  # timeout
        w = wire.Writer()
        w.array(results, lambda w, t: w.string(t[0]).int16(t[1]))
        return w.build()

    _HANDLERS = {
        wire.METADATA: _metadata,
        wire.PRODUCE: _produce,
        wire.FETCH: _fetch,
        wire.LIST_OFFSETS: _list_offsets,
        wire.FIND_COORDINATOR: _find_coordinator,
        wire.OFFSET_COMMIT: _offset_commit,
        wire.OFFSET_FETCH: _offset_fetch,
        wire.JOIN_GROUP: _join_group,
        wire.SYNC_GROUP: _sync_group,
        wire.HEARTBEAT: _heartbeat,
        wire.LEAVE_GROUP: _leave_group,
        wire.CREATE_TOPICS: _create_topics,
        wire.DELETE_TOPICS: _delete_topics,
    }
