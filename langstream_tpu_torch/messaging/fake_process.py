"""One of the port's fake brokers in a process of its own, so that its work
does not share the serving process's GIL, as a real broker's would not.

    python -m langstream_tpu_torch.messaging.fake_process kafka|pulsar|pravega

Once the broker listens, the process prints one JSON line: ``type``, ``pid``,
the ``ports`` it listens on and the ``configuration`` block of an
instance's ``streamingCluster`` that points at it. It then answers one JSON
line for each line on its standard input:

    committed <topic>    records of <topic> and, per consumer group or
                         subscription, the records committed at the broker:
                         ``{"records": N, "committed": {name: M}}``

and stops the broker, prints ``{"stopped": true}`` and exits when its
standard input closes. It imports the broker's fake and its codec only
(stdlib asyncio; no torch).
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import threading
from typing import Any

SCOPE = "langstream"


def _kafka_committed(broker, topic: str) -> dict:
    logs = broker.topics.get(topic) or []
    committed: dict[str, int] = {}
    for (group, name, _partition), offset in broker.committed.items():
        if name == topic:
            committed[group] = committed.get(group, 0) + int(offset)
    return {"records": sum(log.next_offset for log in logs), "committed": committed}


def _pulsar_committed(broker, topic: str) -> dict:
    from langstream_tpu_torch.messaging import pulsar_protocol as wire

    full = topic if "://" in topic else f"persistent://public/default/{topic}"
    names = [f"{full}-partition-{i}" for i in range(broker.partitioned.get(full, 0))] or [full]
    records, committed = 0, {}
    for name in names:
        data = broker.topics.get(name)
        if data is None:
            continue
        sizes = [int(wire.decode_message(wire.MESSAGE_METADATA, meta)
                     .get("num_messages_in_batch") or 1) for meta, _ in data.entries]
        records += sum(sizes)
        for sub_name, sub in data.subscriptions.items():
            # the mark-delete position: every entry before the first unacked
            head = 0
            while head < len(sizes) and head in sub.acked:
                head += 1
            committed[sub_name] = committed.get(sub_name, 0) + sum(sizes[:head])
    return {"records": records, "committed": committed}


def _pravega_events(seg) -> list[tuple[int, bytes]]:
    from langstream_tpu_torch.messaging import pravega_protocol as wire

    start = seg.start_offset
    return list(wire.iter_events(bytes(seg.data[start:]), start))


def _pravega_committed(broker, topic: str) -> dict:
    prefix = f"{SCOPE}/{topic}/"
    data = {name[len(prefix):].split(".", 1)[0]: seg
            for name, seg in broker.segments.items() if name.startswith(prefix)}
    ends = {number: [off + 8 + len(event) for off, event in _pravega_events(seg)]
            for number, seg in data.items()}
    meta_prefix = f"{SCOPE}/_ls_sub_{topic}_"
    committed = {}
    for name, seg in broker.segments.items():
        if not name.startswith(meta_prefix):
            continue
        sub = name[len(meta_prefix):].rsplit("/", 1)[0]
        # the consumers' metadata log: fold the offsets snapshots as they do
        offsets: dict[str, int] = {}
        for _, event in _pravega_events(seg):
            doc = json.loads(event.decode())
            if doc.get("type") == "offsets":
                offsets.update({k: int(v) for k, v in doc.get("offsets", {}).items()})
            elif doc.get("type") == "snapshot":
                offsets = {k: int(v) for k, v in doc.get("offsets", {}).items()}
        committed[sub] = sum(sum(1 for end in ends.get(number, ()) if end <= offset)
                             for number, offset in offsets.items())
    return {"records": sum(len(e) for e in ends.values()), "committed": committed}


_COMMITTED = {"kafka": _kafka_committed, "pulsar": _pulsar_committed,
              "pravega": _pravega_committed}


def committed(kind: str, broker, topic: str) -> dict:
    """``{"records": N, "committed": {group: M}}`` of ``topic`` on a
    ``kind`` fake broker (either package's: they keep the same state)."""
    return _COMMITTED[kind](broker, topic)


async def _start(kind: str) -> tuple[Any, dict, list[int]]:
    if kind == "kafka":
        from langstream_tpu_torch.messaging.kafka_fake import FakeKafkaBroker

        broker = await FakeKafkaBroker().start()
        return broker, {"admin": {"bootstrap.servers": broker.bootstrap}}, [broker.port]
    if kind == "pulsar":
        from langstream_tpu_torch.messaging.pulsar_fake import FakePulsarBroker

        broker = await FakePulsarBroker().start()
        config = {"service": {"serviceUrl": broker.service_url},
                  "admin": {"serviceUrl": broker.admin_url}}
        return broker, config, [broker.port, broker.admin_port]
    if kind == "pravega":
        from langstream_tpu_torch.messaging.pravega_fake import FakePravega

        broker = await FakePravega().start()
        config = {"client": {"controller-rest-uri": broker.controller_url,
                             "segment-store": broker.segment_store_url, "scope": SCOPE}}
        return broker, config, [broker.port, broker.rest_port]
    raise ValueError(f"unknown broker type {kind!r}; known: kafka, pulsar, pravega")


def _emit(doc: dict) -> None:
    sys.stdout.write(json.dumps(doc) + "\n")
    sys.stdout.flush()


async def serve(kind: str) -> None:
    broker, config, ports = await _start(kind)
    loop = asyncio.get_running_loop()
    lines: asyncio.Queue = asyncio.Queue()

    def pump() -> None:  # stdin on a thread: the loop never blocks on it
        for line in sys.stdin:
            loop.call_soon_threadsafe(lines.put_nowait, line)
        loop.call_soon_threadsafe(lines.put_nowait, None)

    threading.Thread(target=pump, name="fake-stdin", daemon=True).start()
    _emit({"type": kind, "pid": os.getpid(), "ports": ports, "configuration": config})
    try:
        while (line := await lines.get()) is not None:
            words = line.split()
            if len(words) == 2 and words[0] == "committed":
                _emit(committed(kind, broker, words[1]))
            elif words:
                _emit({"error": f"unknown command {line.strip()!r}"})
    finally:
        await broker.stop()
    _emit({"stopped": True})


def main(argv: list[str] | None = None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit("usage: python -m langstream_tpu_torch.messaging.fake_process "
                         "kafka|pulsar|pravega")
    asyncio.run(serve(args[0]))


if __name__ == "__main__":
    main()
