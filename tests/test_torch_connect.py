"""The port's Kafka Connect adapter agents and camel-source against a fake
Connect REST cluster and stub HTTP servers on the stdlib (the contract of
``tests/test_connect.py``, whose stubs run on aiohttp).

The agents manage connectors on an EXTERNAL Connect cluster (PUT config,
status watch, restart-on-FAILED) and bridge records through a topic on the
app's streaming cluster — reference kafkaconnect/KafkaConnectSinkAgent.java
behavior, minus the in-JVM task embedding this image cannot host.

The second half holds the port against the JAX package on the same
inputs: the cron parser and matcher on seeded schedules and instants, the
feed parser on seeded RSS and Atom documents, both packages' ``sink`` and
``source`` agents against one stub Connect cluster (the same requests,
records and agent info), and both packages' camel sources (timer, cron
under a frozen clock, file, exec, http, rss)."""

import asyncio
import json
import time as _time
import types

import numpy as np
import pytest
from torch_http_stub import Stub

import langstream_tpu.agents.connect as jax_connect
import langstream_tpu.api.metrics as jax_metrics
import langstream_tpu.api.record as jax_record
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.runtime.runner as jax_runner
import langstream_tpu_torch.agents.connect as port_connect
import langstream_tpu_torch.api.metrics as port_metrics
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.runtime.runner as port_runner
from langstream_tpu_torch.agents.connect import (
    KafkaConnectSinkAgent,
    KafkaConnectSourceAgent,
)
from langstream_tpu_torch.api.metrics import MetricsReporter
from langstream_tpu_torch.api.record import SimpleRecord
from langstream_tpu_torch.messaging.memory import (
    MemoryBroker,
    MemoryTopicConnectionsRuntime,
)
from langstream_tpu_torch.messaging import fake_rest as web
from langstream_tpu_torch.runtime.runner import SimpleAgentContext


def text_response(text, content_type="text/plain"):
    """aiohttp's ``web.Response(text=...)``."""
    return web.Response(200, text.encode(), f"{content_type}; charset=utf-8")


async def serve(routes):
    """A stdlib stub server on this loop → (server, port)."""
    server = web.FakeRestServer("127.0.0.1", routes)
    return server, await server.start()


class FakeConnectCluster:
    """The Kafka Connect REST interface surface the agents drive."""

    def __init__(self) -> None:
        self.connectors: dict[str, dict] = {}
        self.states: dict[str, dict] = {}
        self.restarts: list[tuple[str, object]] = []
        self.url = ""
        self._runner = None

    async def start(self) -> "FakeConnectCluster":
        self._runner, port = await serve([
            ("GET", "/", self._root),
            ("PUT", "/connectors/{name}/config", self._put_config),
            ("GET", "/connectors/{name}/status", self._status),
            ("POST", "/connectors/{name}/restart", self._restart),
            ("POST", "/connectors/{name}/tasks/{task}/restart", self._restart_task),
            ("DELETE", "/connectors/{name}", self._delete),
        ])
        self.url = f"http://127.0.0.1:{port}"
        return self

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.stop()

    async def _root(self, request):
        return web.json_response(
            {"version": "3.7.0-fake", "kafka_cluster_id": "fake"}
        )

    async def _put_config(self, request):
        name = request.match_info["name"]
        created = name not in self.connectors
        self.connectors[name] = await request.json()
        self.states.setdefault(name, {
            "name": name,
            "connector": {"state": "RUNNING", "worker_id": "fake:8083"},
            "tasks": [{"id": 0, "state": "RUNNING", "worker_id": "fake:8083"}],
        })
        return web.json_response(
            {"name": name, "config": self.connectors[name]},
            status=201 if created else 200,
        )

    async def _status(self, request):
        name = request.match_info["name"]
        if name not in self.states:
            return web.json_response({"message": "not found"}, status=404)
        return web.json_response(self.states[name])

    async def _restart(self, request):
        name = request.match_info["name"]
        self.restarts.append((name, None))
        if name in self.states:
            self.states[name]["connector"]["state"] = "RUNNING"
        return web.Response(status=204)

    async def _restart_task(self, request):
        name = request.match_info["name"]
        task = int(request.match_info["task"])
        self.restarts.append((name, task))
        if name in self.states:
            for t in self.states[name]["tasks"]:
                if t["id"] == task:
                    t["state"] = "RUNNING"
        return web.Response(status=204)

    async def _delete(self, request):
        name = request.match_info["name"]
        self.connectors.pop(name, None)
        self.states.pop(name, None)
        return web.Response(status=204)


async def _context(agent_id="app-connect"):
    MemoryBroker.reset()
    rt = MemoryTopicConnectionsRuntime()
    await rt.init({"broker": "connect-test"})
    return rt, SimpleAgentContext(agent_id, "t", rt, MetricsReporter())


def test_sink_creates_connector_and_bridges_records(run):
    async def main():
        cluster = await FakeConnectCluster().start()
        rt, ctx = await _context()
        agent = KafkaConnectSinkAgent()
        agent.agent_id = "snowflake-sink"
        agent.set_context(ctx)
        try:
            await agent.init({
                "connect": {"rest-url": cluster.url, "delete-on-close": True},
                "connector.class": "com.snowflake.kafka.connector.SnowflakeSinkConnector",
                "snowflake.url.name": "acct.snowflakecomputing.com",
                "agent.type": "kafka-connect",
            })
            await agent.start()
            # connector exists, pointed at the bridge topic, agent.type and
            # connect block NOT leaked into the connector config
            cfg = cluster.connectors["ls-snowflake-sink"]
            assert cfg["connector.class"].endswith("SnowflakeSinkConnector")
            assert cfg["topics"] == "ls-connect-snowflake-sink"
            assert "connect" not in cfg and "agent.type" not in cfg
            # records bridge onto the topic the connector consumes
            await agent.write(SimpleRecord(key="k", value=json.dumps({"x": 1})))
            await agent.write(SimpleRecord.of("plain"))
            consumer = rt.create_consumer("check", "ls-connect-snowflake-sink")
            await consumer.start()
            got = []
            for _ in range(20):
                got.extend(await consumer.read())
                if len(got) >= 2:
                    break
            assert len(got) == 2
            info = agent.agent_info()
            assert info["status"]["connector"]["state"] == "RUNNING"
            await consumer.close()
        finally:
            await agent.close()
            assert "ls-snowflake-sink" not in cluster.connectors  # delete-on-close
            await cluster.stop()

    run(main())


def test_source_consumes_bridge_topic_and_commits(run):
    async def main():
        cluster = await FakeConnectCluster().start()
        rt, ctx = await _context()
        agent = KafkaConnectSourceAgent()
        agent.agent_id = "jdbc-source"
        agent.set_context(ctx)
        try:
            await agent.init({
                "connect": {"rest-url": cluster.url},
                "connector.class": "io.confluent.connect.jdbc.JdbcSourceConnector",
                "connection.url": "jdbc:postgresql://db/x",
            })
            await agent.start()
            assert cluster.connectors["ls-jdbc-source"]["topic"] == "ls-connect-jdbc-source"
            # "the connector" (simulated) produces into the bridge topic
            producer = rt.create_producer("fake-connector", "ls-connect-jdbc-source")
            await producer.start()
            for i in range(3):
                await producer.write(SimpleRecord.of(f"row-{i}"))
            got = []
            for _ in range(20):
                got.extend(await agent.read())
                if len(got) >= 3:
                    break
            assert sorted(r.value for r in got) == ["row-0", "row-1", "row-2"]
            await agent.commit(got)
            await producer.close()
        finally:
            await agent.close()
            await cluster.stop()

    run(main())


def test_failed_connector_and_task_restarted(run):
    async def main():
        cluster = await FakeConnectCluster().start()
        rt, ctx = await _context()
        agent = KafkaConnectSinkAgent()
        agent.agent_id = "s"
        agent.set_context(ctx)
        try:
            await agent.init({
                "connect": {"rest-url": cluster.url, "status-interval": 0.0},
                "connector.class": "X",
            })
            await agent.start()
            cluster.states["ls-s"]["connector"]["state"] = "FAILED"
            cluster.states["ls-s"]["tasks"][0]["state"] = "FAILED"
            await agent.write(SimpleRecord.of("v"))  # watch fires inline
            assert ("ls-s", None) in cluster.restarts
            assert ("ls-s", 0) in cluster.restarts
            assert cluster.states["ls-s"]["connector"]["state"] == "RUNNING"
        finally:
            await agent.close()
            await cluster.stop()

    run(main())


def test_unreachable_cluster_fails_fast(run):
    async def main():
        rt, ctx = await _context()
        agent = KafkaConnectSinkAgent()
        agent.agent_id = "s"
        agent.set_context(ctx)
        await agent.init({
            "connect": {"rest-url": "http://127.0.0.1:9"},  # nothing listens
            "connector.class": "X",
        })
        with pytest.raises(Exception):
            await agent.start()
        await agent.close()

    run(main())


def test_camel_source_timer_file_http(run):
    """The native camel-source URI subset: timer ticks, directory polling
    with delete, HTTP polling; JVM-only schemes still gate."""
    import tempfile
    from pathlib import Path

    from langstream_tpu_torch.agents.connect import CamelSourceAgent

    async def main():
        # timer
        a = CamelSourceAgent()
        await a.init({"component-uri": "timer:tick?period=10&repeatCount=2"})
        got = []
        for _ in range(50):
            got.extend(await a.read())
            if len(got) >= 2:
                break
        assert len(got) == 2
        assert json.loads(got[0].value) == {"timer": "tick", "count": 1}
        assert (await a.read()) == []  # repeatCount reached
        await a.close()

        # file with delete=true: files survive until COMMIT (at-least-once)
        d = Path(tempfile.mkdtemp())
        (d / "a.txt").write_bytes(b"alpha")
        (d / "b.txt").write_bytes(b"bravo")
        f = CamelSourceAgent()
        await f.init({"component-uri": f"file:{d}?delete=true", "key-header": "camel-file"})
        records = await f.read()
        assert sorted(r.key for r in records) == ["a.txt", "b.txt"]
        assert {h.key: h.value for h in records[0].headers} == {"camel-file": "a.txt"}
        assert len(list(d.iterdir())) == 2  # NOT deleted before commit
        await f.commit(records)
        assert not list(d.iterdir())  # deleted after commit
        await f.close()

        # http poller
        async def page(request):
            assert request.query.get("token") == "t1"  # params preserved
            return text_response("polled-body")

        runner, port = await serve([("GET", "/feed", page)])
        h = CamelSourceAgent()
        # the token param must survive URI parsing; only delay is stripped
        await h.init({"component-uri": f"http://127.0.0.1:{port}/feed?delay=10&token=t1"})
        assert h.url.endswith("/feed?token=t1")
        got = []
        for _ in range(50):
            got.extend(await h.read())
            if got:
                break
        assert got[0].value == "polled-body"
        await h.close()
        await runner.stop()

        # JVM-only scheme gates
        g = CamelSourceAgent()
        with pytest.raises(NotImplementedError):
            await g.init({"component-uri": "jms:queue:orders"})

    run(main())


def test_camel_source_cron_exec_rss(run):
    """Round-5 native camel widening: Quartz cron ticks, exec polling,
    RSS/Atom feed polling with per-entry dedupe."""
    from langstream_tpu_torch.agents.connect import (
        CamelSourceAgent,
        _cron_due,
        _cron_parse,
        _parse_feed_entries,
    )

    # -- cron matcher unit coverage (pure) --
    import time as _time

    every_sec = _cron_parse("* * * * * ?")
    assert _cron_due(every_sec, _time.localtime())
    at_30 = _cron_parse("30 * * * * ?")
    assert _cron_due(at_30, _time.struct_time((2026, 7, 31, 12, 0, 30, 4, 212, 0)))
    assert not _cron_due(at_30, _time.struct_time((2026, 7, 31, 12, 0, 31, 4, 212, 0)))
    # steps, ranges, names, 5-field crontab, quartz day numbers (1=SUN)
    evens = _cron_parse("0/2 * * * * ?")
    assert _cron_due(evens, _time.struct_time((2026, 7, 31, 0, 0, 4, 4, 212, 0)))
    assert not _cron_due(evens, _time.struct_time((2026, 7, 31, 0, 0, 5, 4, 212, 0)))
    jan_mon = _cron_parse("0 0 9 * JAN MON")
    # 2026-01-05 is a Monday (tm_wday=0 → quartz 2=MON)
    assert _cron_due(jan_mon, _time.struct_time((2026, 1, 5, 9, 0, 0, 0, 5, 0)))
    assert not _cron_due(jan_mon, _time.struct_time((2026, 2, 2, 9, 0, 0, 0, 33, 0)))
    classic = _cron_parse("*/5 * * * *")  # 5-field crontab → second 0
    assert _cron_due(classic, _time.struct_time((2026, 7, 31, 8, 5, 0, 4, 212, 0)))
    assert not _cron_due(classic, _time.struct_time((2026, 7, 31, 8, 5, 1, 4, 212, 0)))
    with pytest.raises(ValueError):
        _cron_parse("99 * * * * ?")

    # -- feed parsing (pure) --
    rss_body = """<rss version="2.0"><channel>
      <item><guid>g1</guid><title>first</title><link>http://x/1</link>
        <description>d1</description></item>
      <item><guid>g2</guid><title>second</title><link>http://x/2</link></item>
    </channel></rss>"""
    entries = _parse_feed_entries(rss_body)
    assert [e["id"] for e in entries] == ["g1", "g2"]
    assert entries[0]["summary"] == "d1"
    atom_body = """<feed xmlns="http://www.w3.org/2005/Atom">
      <entry><id>a1</id><title>atom one</title>
        <link href="http://x/a1"/><updated>2026-01-01</updated></entry>
    </feed>"""
    aentries = _parse_feed_entries(atom_body)
    assert aentries[0]["id"] == "a1" and aentries[0]["link"] == "http://x/a1"
    assert _parse_feed_entries("not xml") == []

    async def main():
        # cron: every-second schedule fires within ~1.5s
        c = CamelSourceAgent()
        await c.init({"component-uri": "cron:tab?schedule=*+*+*+*+*+?"})
        got = []
        for _ in range(40):
            got.extend(await c.read())
            if got:
                break
        assert got, "cron never fired"
        payload = json.loads(got[0].value)
        assert payload["cron"] == "tab" and payload["count"] == 1
        await c.close()

        # exec: run a command per poll, stdout is the record
        e = CamelSourceAgent()
        await e.init({
            "component-uri": "exec:/bin/echo?args=camel+exec+works&delay=10"
        })
        got = []
        for _ in range(50):
            got.extend(await e.read())
            if got:
                break
        assert got[0].value.strip() == b"camel exec works"
        await e.close()

        # rss: one record per NEW entry across polls
        feed_versions = [
            """<rss version="2.0"><channel>
               <item><guid>r1</guid><title>one</title></item>
               </channel></rss>""",
            """<rss version="2.0"><channel>
               <item><guid>r1</guid><title>one</title></item>
               <item><guid>r2</guid><title>two</title></item>
               </channel></rss>""",
        ]
        polls = []

        async def feed(request):
            body = feed_versions[min(len(polls), 1)]
            polls.append(1)
            return text_response(body, "application/xml")

        runner, port = await serve([("GET", "/feed.xml", feed)])

        r = CamelSourceAgent()
        await r.init({
            "component-uri": f"rss:http://127.0.0.1:{port}/feed.xml?delay=10"
        })
        first = []
        for _ in range(50):
            first.extend(await r.read())
            if first:
                break
        assert [json.loads(rec.value)["id"] for rec in first] == ["r1"]
        second = []
        for _ in range(50):
            second.extend(await r.read())
            if second:
                break
        # only the NEW entry on the second poll — r1 deduped
        assert [json.loads(rec.value)["id"] for rec in second] == ["r2"]
        assert second[0].key == "r2"
        await r.close()
        await runner.stop()

    run(main())


def test_cron_classic_dow_wrap_and_catchup(run):
    """A classic 5-field crontab keeps crontab day
    numbering (0/7=SUN), wrap-around ranges work, and a stalled reader
    catches up missed seconds instead of dropping the fire."""
    import time as _time

    from langstream_tpu_torch.agents.connect import (
        CamelSourceAgent,
        _cron_due,
        _cron_parse,
    )

    # classic numeric dow: `0 9 * * 5` = FRIDAY 9am (crontab), not Thursday
    fri = _cron_parse("0 9 * * 5")
    # 2026-01-02 is a Friday (tm_wday=4)
    assert _cron_due(fri, _time.struct_time((2026, 1, 2, 9, 0, 0, 4, 2, 0)))
    assert not _cron_due(fri, _time.struct_time((2026, 1, 1, 9, 0, 0, 3, 1, 0)))
    # classic 0 and 7 both mean Sunday (2026-01-04, tm_wday=6)
    for tok in ("0", "7"):
        sun = _cron_parse(f"0 9 * * {tok}")
        assert _cron_due(sun, _time.struct_time((2026, 1, 4, 9, 0, 0, 6, 4, 0)))
    # quartz (6-field) numeric dow: 1 = Sunday
    qsun = _cron_parse("0 0 9 ? * 1")
    assert _cron_due(qsun, _time.struct_time((2026, 1, 4, 9, 0, 0, 6, 4, 0)))
    # wrap-around range FRI-SUN covers Fri, Sat, Sun
    wrap = _cron_parse("0 0 22 ? * FRI-SUN")
    for day, wday in ((2, 4), (3, 5), (4, 6)):  # 2026-01-02..04
        assert _cron_due(wrap, _time.struct_time((2026, 1, day, 22, 0, 0, wday, day, 0)))
    assert not _cron_due(wrap, _time.struct_time((2026, 1, 5, 22, 0, 0, 0, 5, 0)))
    # wrap-around hour range 22-2
    hours = _cron_parse("0 0 22-2 * * ?")[2]
    assert hours == {22, 23, 0, 1, 2}

    async def main():
        # catch-up: simulate a stalled reader by rewinding _checked_sec
        agent = CamelSourceAgent()
        await agent.init({"component-uri": "cron:t?schedule=*+*+*+*+*+?"})
        agent._checked_sec = int(__import__("time").time()) - 4
        got = await agent.read()
        # one record per missed second (~4), not just the current one
        assert len(got) >= 3
        counts = [json.loads(r.value)["count"] for r in got]
        assert counts == sorted(counts)
        await agent.close()

    run(main())


def test_cron_catchup_early_break_keeps_cursor(run):
    """When the catch-up scan fills max_buffered and breaks early, the
    cursor must rewind to the last second actually SCANNED — marking the
    whole window checked would silently drop every due second between the
    break point and now (a lost daily tick under a deep backlog)."""
    import time as _time

    from langstream_tpu_torch.agents.connect import CamelSourceAgent

    async def main():
        agent = CamelSourceAgent()
        await agent.init({
            "component-uri": "cron:t?schedule=*+*+*+*+*+?",
            "max-buffered-records": 2,
        })
        agent._checked_sec = int(_time.time()) - 10
        timestamps = []
        for _ in range(30):
            got = await agent.read()
            timestamps.extend(json.loads(r.value)["timestamp"] for r in got)
            if len(timestamps) >= 8:
                break
        # every-second schedule over a 10s backlog, drained 2 at a time:
        # the fires must be CONSECUTIVE seconds — any gap means the early
        # break discarded part of the scan window
        assert len(timestamps) >= 8
        assert timestamps == list(
            range(timestamps[0], timestamps[0] + len(timestamps))
        ), timestamps
        await agent.close()

    run(main())


# ---------------------------------------------------------------------------
# held against the JAX package: the same inputs through both modules
# ---------------------------------------------------------------------------

JAX = types.SimpleNamespace(name="jax", connect=jax_connect, memory=jax_memory,
                            runner=jax_runner, metrics=jax_metrics, record=jax_record)
PORT = types.SimpleNamespace(name="port", connect=port_connect, memory=port_memory,
                             runner=port_runner, metrics=port_metrics, record=port_record)
PACKAGES = (JAX, PORT)

_MONTHS = list(jax_connect._CRON_MONTHS)
_DAYS = list(jax_connect._CRON_DAYS)
# (lo, hi, names) of the six Quartz fields; out-of-range draws go one past
_FIELDS = [(0, 59, None), (0, 59, None), (0, 23, None), (1, 31, None),
           (1, 12, _MONTHS), (0, 7, _DAYS)]


def _cron_token(rng, lo, hi, names):
    """One value: a number (now and then one out of range, or not a number)
    or, where the field has them, a name in any case."""
    roll = rng.random()
    if names and roll < 0.35:
        name = names[rng.integers(len(names))]
        return name.lower() if rng.random() < 0.2 else name
    if roll < 0.04:
        return str(hi + 1 + int(rng.integers(3)))
    if roll < 0.06:
        return "X"
    return str(int(rng.integers(lo, hi + 1)))


def _cron_part(rng, lo, hi, names):
    kind = rng.integers(6)
    if kind == 0:
        return _cron_token(rng, lo, hi, names)
    if kind == 1:  # a range, wrapping where the first end is the larger
        return f"{_cron_token(rng, lo, hi, names)}-{_cron_token(rng, lo, hi, names)}"
    step = int(rng.integers(1, 9))
    if kind == 2:
        return f"*/{step}"
    if kind == 3:
        return f"{_cron_token(rng, lo, hi, names)}/{step}"
    if kind == 4:
        return f"{_cron_token(rng, lo, hi, names)}-{_cron_token(rng, lo, hi, names)}/{step}"
    return "?" if rng.random() < 0.5 else "*"


def _cron_expr(rng) -> str:
    fields = []
    for lo, hi, names in _FIELDS:
        if rng.random() < 0.3:
            fields.append("*")
            continue
        parts = [_cron_part(rng, lo, hi, names) for _ in range(int(rng.integers(1, 4)))]
        fields.append(",".join(parts))
    form = rng.integers(5)
    if form == 0:  # classic crontab: no seconds
        fields = fields[1:]
    elif form == 1:  # a year field, ignored
        fields = [*fields, str(int(rng.integers(2020, 2040)))]
    elif form == 2 and rng.random() < 0.2:  # a count no form accepts
        fields = fields[:4]
    return " ".join(fields)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error is compared
        return ("raised", type(e).__name__, str(e))


def test_cron_parse_and_due_match_jax():
    """Seeded Quartz and crontab schedules (values, names in any case,
    ranges that wrap, steps, lists, year fields, values out of range, field
    counts no form accepts) parse to the same field sets or the same error
    in both packages, and are due at the same seeded instants (each a
    ``struct_time`` in UTC)."""
    rng = np.random.default_rng(24)
    instants = [_time.gmtime(int(s)) for s in rng.integers(0, 2**31 - 1, 400)]
    # a week of instants an hour and seven seconds apart
    instants += [_time.gmtime(1767225600 + s) for s in range(0, 7 * 86400, 3607)]
    parsed = errors = due = 0
    for _ in range(600):
        expr = _cron_expr(rng)
        want = _outcome(jax_connect._cron_parse, expr)
        got = _outcome(port_connect._cron_parse, expr)
        assert got == want, expr
        if want[0] != "ok":
            errors += 1
            continue
        parsed += 1
        for tm in instants:
            hit = jax_connect._cron_due(want[1], tm)
            assert port_connect._cron_due(got[1], tm) == hit, (expr, tm)
            due += hit
    # the draws reach both outcomes, and schedules that fire
    assert parsed > 150 and errors > 50 and due > 100, (parsed, errors, due)


def _feed_text(rng, words=("alpha", "beta", "gamma", "delta", "río", "naïve", "x&amp;y")):
    roll = rng.random()
    if roll < 0.1:
        return ""
    if roll < 0.2:
        return "   \n  "
    text = " ".join(words[i] for i in rng.integers(len(words), size=int(rng.integers(1, 4))))
    if rng.random() < 0.15:
        return f"<![CDATA[{text} <b>bold</b>]]>"
    return f"  {text}\n" if rng.random() < 0.3 else text


def _rss_item(rng) -> str:
    children = []
    for tag in ("guid", "title", "link", "pubDate", "description"):
        if rng.random() < 0.7:
            children.append(f"<{tag}>{_feed_text(rng)}</{tag}>")
    rng.shuffle(children)
    return "<item>" + "".join(children) + "</item>"


def _atom_entry(rng) -> str:
    children = []
    for tag in ("id", "title", "published", "updated", "summary", "content"):
        if rng.random() < 0.6:
            children.append(f"<{tag}>{_feed_text(rng)}</{tag}>")
    if rng.random() < 0.7:
        href = f' href="http://x/{int(rng.integers(100))}"' if rng.random() < 0.8 else ""
        children.append(f"<link{href}/>")
    rng.shuffle(children)
    return "<entry>" + "".join(children) + "</entry>"


def _feed(rng) -> str:
    kind = rng.integers(4)
    rss = "".join(_rss_item(rng) for _ in range(int(rng.integers(0, 6))))
    atom = "".join(_atom_entry(rng) for _ in range(int(rng.integers(0, 6))))
    if kind == 0:
        body = f'<rss version="2.0"><channel><title>c</title>{rss}</channel></rss>'
    elif kind == 1:
        body = f'<feed xmlns="http://www.w3.org/2005/Atom"><title>f</title>{atom}</feed>'
    elif kind == 2:  # both kinds in one document
        body = (f'<root><channel>{rss}</channel>'
                f'<feed xmlns="http://www.w3.org/2005/Atom">{atom}</feed></root>')
    else:  # Atom elements outside the namespace are not entries
        body = f"<feed>{atom}</feed>"
    if rng.random() < 0.08:  # cut short: not XML
        body = body[: int(rng.integers(len(body)))]
    return body


def test_feed_entries_match_jax():
    """Seeded RSS 2.0 and Atom documents (children missing, empty, blank,
    in any order, CDATA, entities, non-ASCII text, links without href, both
    kinds in one document, documents cut short) give the same entries in
    both packages."""
    rng = np.random.default_rng(2024)
    entries = broken = 0
    for _ in range(400):
        body = _feed(rng)
        want = jax_connect._parse_feed_entries(body)
        assert port_connect._parse_feed_entries(body) == want, body
        entries += len(want)
        broken += not want
    assert entries > 400 and broken > 20, (entries, broken)


# -- the Connect agents against one stub Connect cluster ---------------------


class ConnectStub:
    """A Kafka Connect REST surface on the stdlib test stub (``Stub``),
    shared by both packages' agents; ``reset()`` between runs."""

    def __init__(self) -> None:
        self.reset()
        name = "(?P<name>[^/]+)"
        self.stub = Stub([
            ("GET", "/", lambda call: (200, {}, {"version": "3.7.0-stub"})),
            ("PUT", f"/connectors/{name}/config", self._put),
            ("GET", f"/connectors/{name}/status", self._status),
            ("POST", f"/connectors/{name}/restart", self._restart),
            ("POST", f"/connectors/{name}/tasks/(?P<task>[0-9]+)/restart", self._restart),
            ("DELETE", f"/connectors/{name}", self._delete),
        ])
        self.url = self.stub.base

    def reset(self) -> None:
        self.connectors: dict = {}
        self.states: dict = {}
        if hasattr(self, "stub"):
            self.stub.calls.clear()

    def _put(self, call):
        name = call.match["name"]
        config = call.json()
        if "connector.class" not in config:
            return 400, {}, {"error_code": 400, "message": "Missing connector.class"}
        created = name not in self.connectors
        self.connectors[name] = config
        self.states.setdefault(name, {
            "name": name, "connector": {"state": "RUNNING"},
            "tasks": [{"id": 0, "state": "RUNNING"}, {"id": 1, "state": "RUNNING"}]})
        return (201 if created else 200), {}, {"name": name, "config": config}

    def _status(self, call):
        state = self.states.get(call.match["name"])
        return (200, {}, state) if state else (404, {}, {"message": "not found"})

    def _restart(self, call):
        state = self.states.get(call.match["name"], {})
        task = call.match.get("task")
        if task is None:
            state.get("connector", {})["state"] = "RUNNING"
        for t in state.get("tasks", []):
            if str(t["id"]) == task:
                t["state"] = "RUNNING"
        return 204, {}, b""

    def _delete(self, call):
        self.connectors.pop(call.match["name"], None)
        self.states.pop(call.match["name"], None)
        return 204, {}, b""

    def fail(self, name: str, connector: bool, tasks: tuple) -> None:
        state = self.states[name]
        if connector:
            state["connector"]["state"] = "FAILED"
        for t in state["tasks"]:
            if t["id"] in tasks:
                t["state"] = "FAILED"

    def calls(self) -> list:
        """Each request as the cluster saw it: method, path, query, body
        bytes and content type."""
        return [(c.method, c.path, c.query, c.body,
                 c.headers.get("content-type", "").split(";")[0]) for c in self.stub.calls]


@pytest.fixture(scope="module")
def connect_stub():
    stub = ConnectStub()
    yield stub
    stub.stub.close()


def _plain(record) -> tuple:
    """A record without its timestamp: key, value, headers."""
    return (record.key, record.value, [(h.key, h.value) for h in record.headers])


async def _pkg_context(pkg, agent_id):
    rt = pkg.memory.MemoryTopicConnectionsRuntime()
    await rt.init({"broker": "connect-parity"})
    return rt, pkg.runner.SimpleAgentContext(agent_id, "t", rt, pkg.metrics.MetricsReporter())


async def _drain(consumer, n):
    got = []
    for _ in range(50):
        got.extend(await consumer.read())
        if len(got) >= n:
            break
    return got


async def _sink_scenario(pkg, cluster):
    """The sink: connector created (and updated by a second agent of the
    same name), records bridged, a failed connector and failed tasks
    restarted on the record path, the connector deleted on close."""
    rt, ctx = await _pkg_context(pkg, "parity-sink")
    agent = pkg.connect.KafkaConnectSinkAgent()
    agent.agent_id = "snowflake-sink"
    agent.set_context(ctx)
    config = {
        "connect": {"rest-url": cluster.url, "delete-on-close": True, "status-interval": 0.0},
        "connector.class": "com.snowflake.kafka.connector.SnowflakeSinkConnector",
        "snowflake.url.name": "acct.snowflakecomputing.com",
        "transforms": "unwrap", "tasks.max": 2, "buffer.flush.time": 1.5,
        "agent.type": "kafka-connect", "composable": False,
    }
    await agent.init(config)
    await agent.start()
    infos = [agent.agent_info()]
    of = pkg.record.SimpleRecord.of
    records = [
        of(json.dumps({"x": 1}), key="k1"),
        of("plain", headers=[("h", "v"), ("n", 3)]),
        of(b"\x00\xffbytes", key="k3"),
    ]
    await agent.write(records[0])
    cluster.fail("ls-snowflake-sink", connector=True, tasks=(1,))
    await agent.write(records[1])
    infos.append(agent.agent_info())
    cluster.fail("ls-snowflake-sink", connector=False, tasks=(0, 1))
    await agent.write(records[2])
    infos.append(agent.agent_info())
    # a second agent of the same connector name updates its config
    again = pkg.connect.KafkaConnectSinkAgent()
    again.agent_id = "snowflake-sink"
    again.set_context(ctx)
    await again.init({**config, "topics": "ls-connect-snowflake-sink", "tasks.max": 4,
                      "connect": {"rest-url": cluster.url}})
    await again.start()
    await again.close()
    consumer = rt.create_consumer("check", "ls-connect-snowflake-sink")
    await consumer.start()
    bridged = [_plain(r) for r in await _drain(consumer, 3)]
    await consumer.close()
    await agent.close()
    # a config the cluster refuses
    bad = pkg.connect.KafkaConnectSinkAgent()
    bad.agent_id = "bad"
    bad.set_context(ctx)
    await bad.init({"connect": {"rest-url": cluster.url}, "topics": "t"})
    refused = None
    try:
        await bad.start()
    except Exception as e:  # noqa: BLE001 — compared
        refused = (type(e).__name__, str(e))
    await bad.close()
    return {"calls": cluster.calls(), "bridged": bridged, "info": infos,
            "left": sorted(cluster.connectors), "refused": refused}


async def _source_scenario(pkg, cluster):
    """The source: connector pointed at the bridge topic, the connector's
    records read and committed, a failed task restarted on the read path."""
    rt, ctx = await _pkg_context(pkg, "parity-source")
    agent = pkg.connect.KafkaConnectSourceAgent()
    agent.agent_id = "jdbc-source"
    agent.set_context(ctx)
    await agent.init({
        "connect": {"rest-url": cluster.url, "name": "jdbc", "status-interval": 0.0},
        "connector.class": "io.confluent.connect.jdbc.JdbcSourceConnector",
        "connection.url": "jdbc:postgresql://db/x", "kafka.topic": "rows",
        "mode": "incrementing", "poll.interval.ms": 500,
    })
    await agent.start()
    producer = rt.create_producer("fake-connector", "rows")
    await producer.start()
    for i in range(4):
        await producer.write(pkg.record.SimpleRecord.of(
            json.dumps({"row": i}), key=f"id-{i}", headers=[("table", "orders")] if i % 2 else None))
    cluster.fail("jdbc", connector=False, tasks=(0,))
    got = await _drain(agent, 4)
    await agent.commit(got)
    info = agent.agent_info()
    await producer.close()
    await agent.close()
    return {"calls": cluster.calls(), "read": [_plain(r) for r in got],
            "info": info, "left": sorted(cluster.connectors)}


@pytest.mark.parametrize("scenario, connector", [(_sink_scenario, "ls-snowflake-sink"),
                                                 (_source_scenario, "jdbc")],
                         ids=["sink", "source"])
def test_connect_agents_match_jax(connect_stub, scenario, connector):
    """Both packages' ``sink`` / ``source`` agents against one stub Connect
    cluster: the same requests in the same order (method, path, query, body
    bytes, content type), so the same PUT bodies and restarts; the same
    records bridged or read; the same agent info and the same refusal."""
    out = {}
    for pkg in PACKAGES:
        jax_memory.MemoryBroker.reset()
        port_memory.MemoryBroker.reset()
        connect_stub.reset()
        out[pkg.name] = asyncio.run(scenario(pkg, connect_stub))
    jax_memory.MemoryBroker.reset()
    port_memory.MemoryBroker.reset()
    want, got = out["jax"], out["port"]
    assert got["calls"] == want["calls"]
    for key in want:
        assert got[key] == want[key], key
    # the scenario reached what it is about: a config PUT and a restart
    paths = [c[:2] for c in want["calls"]]
    assert ("PUT", f"/connectors/{connector}/config") in paths
    assert ("POST", f"/connectors/{connector}/tasks/0/restart") in paths


# -- camel-source ------------------------------------------------------------


def _frozen_clock(now: int):
    """A ``time`` module whose wall clock stands at ``now`` and whose local
    time is UTC; the monotonic clock runs."""
    return types.SimpleNamespace(time=lambda: float(now), monotonic=_time.monotonic,
                                 localtime=_time.gmtime)


async def _camel_records(pkg, config, reads, between=None):
    """``reads`` reads of a camel-source (``between(i)`` after the i-th),
    each read's records without their timestamps."""
    agent = pkg.connect.CamelSourceAgent()
    await agent.init(config)
    out = []
    for i in range(reads):
        out.append([_plain(r) for r in await agent.read()])
        if between is not None:
            await between(agent, out[-1])
    await agent.close()
    return out


def _camel_both(config, reads, between=None):
    return {pkg.name: asyncio.run(_camel_records(pkg, config, reads, between))
            for pkg in PACKAGES}


@pytest.mark.parametrize("schedule", ["0/7 * * * * ?", "*/13 5-50 * * * ?",
                                      "0,30 * 22-2 ? * FRI-SUN", "*/2 * * * *"])
def test_camel_cron_records_match_jax(monkeypatch, schedule):
    """A cron source 400 s behind a frozen clock (its catch-up reaches back
    300 s) catches up in reads of at most 20 records: the same ticks, counts
    and instants in both packages."""
    now = 1767397800  # Friday 2026-01-02 23:50:00 UTC
    for module in (jax_connect, port_connect):
        monkeypatch.setattr(module, "time", _frozen_clock(now))

    configs = {"component-uri": "cron:tab?schedule=" + schedule.replace(" ", "+"),
               "max-buffered-records": 20, "key-header": "camel-cron"}

    async def run(pkg):
        agent = pkg.connect.CamelSourceAgent()
        await agent.init(configs)
        agent._checked_sec = now - 400
        out = []
        for _ in range(30):
            got = await agent.read()
            if not got:
                break
            out.append([_plain(r) for r in got])
        await agent.close()
        return out

    want = asyncio.run(run(JAX))
    assert asyncio.run(run(PORT)) == want
    assert sum(len(batch) for batch in want) >= 3


def test_camel_timer_file_exec_match_jax(tmp_path):
    """timer ticks with a repeat count, a polled directory (deleted on
    commit) and exec's stdout give the same records in both packages."""
    timer = _camel_both({"component-uri": "timer:tick?period=5&repeatCount=3",
                         "key-header": "camel-timer"}, 6)
    assert timer["port"] == timer["jax"]
    assert sum(len(r) for r in timer["jax"]) == 3

    rng = np.random.default_rng(7)
    files = {f"f{i:02d}.txt": rng.bytes(int(rng.integers(0, 64))) for i in range(12)}
    left = {}
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg.name
        d.mkdir()
        for name, data in files.items():
            (d / name).write_bytes(data)

        async def commit_some(agent, records, d=d):
            if records:
                await agent.commit([types.SimpleNamespace(key=k) for k, _, _ in records[:3]])
            (d / "late.txt").write_bytes(b"late")

        out[pkg.name] = asyncio.run(_camel_records(
            pkg, {"component-uri": f"file:{d}?delete=true", "key-header": "camel-file",
                  "max-buffered-records": 5}, 4, commit_some))
        left[pkg.name] = sorted(p.name for p in d.iterdir())
    assert out["port"] == out["jax"] and left["port"] == left["jax"]
    assert sum(len(r) for r in out["jax"]) == 13

    exec_ = _camel_both({"component-uri": "exec:/bin/echo?args=camel+exec+%C3%A9+works&delay=5"},
                        2, lambda agent, records: asyncio.sleep(0.02))
    assert exec_["port"] == exec_["jax"] and exec_["jax"][0]


def test_camel_http_and_rss_pollers_match_jax():
    """The http poller (its own query kept, ``delay`` stripped, a cookie
    kept across polls, a failed poll skipped) and the rss poller (entries
    deduped across polls) give the same records, and send the same
    requests, in both packages."""
    state = {"polls": 0}
    feeds = [
        "<rss><channel><item><guid>r1</guid><title>one</title></item></channel></rss>",
        "<rss><channel><item><guid>r1</guid></item><item><guid>r2</guid>"
        "<description>two</description></item></channel></rss>",
        '<feed xmlns="http://www.w3.org/2005/Atom"><entry><id>r2</id></entry>'
        '<entry><title>three</title><link href="http://x/3"/></entry></feed>',
    ]

    def page(call):
        state["polls"] += 1
        n = state["polls"]
        if n == 2:
            return 503, {}, b"busy"
        headers = {"Content-Type": "text/plain; charset=utf-8"}
        if n == 1:
            headers["Set-Cookie"] = "session=abc; Path=/"
        return 200, headers, f"body {n} ü"

    def feed(call):
        state["polls"] += 1
        return 200, {"Content-Type": "application/rss+xml"}, feeds[min(state["polls"], 3) - 1]

    with Stub([("GET", "/page", page), ("GET", "/feed.xml", feed)]) as stub:
        out = {}
        for pkg in PACKAGES:
            stub.calls.clear()
            state["polls"] = 0

            async def pause(agent, records):
                await asyncio.sleep(0.02)

            # by name: neither package's cookie jar keeps a cookie an IP host sets
            page_url = stub.base.replace("127.0.0.1", "localhost") + "/page"
            http = asyncio.run(_camel_records(
                pkg, {"component-uri": f"{page_url}?delay=10&token=t1&q=a+b"}, 3, pause))
            state["polls"] = 0
            rss = asyncio.run(_camel_records(
                pkg, {"component-uri": f"rss:{stub.base}/feed.xml?delay=10&splitEntries=true"
                      "&lang=en", "key-header": "camel-rss"}, 3, pause))
            calls = [(c.method, c.path, c.query, c.headers.get("cookie")) for c in stub.calls]
            out[pkg.name] = (http, rss, calls)
    assert out["port"] == out["jax"]
    http, rss, calls = out["jax"]
    assert [len(r) for r in http] == [1, 0, 1] and [len(r) for r in rss] == [1, 1, 1]
    assert [c[3] for c in calls[:3]] == [None, "session=abc", "session=abc"]
