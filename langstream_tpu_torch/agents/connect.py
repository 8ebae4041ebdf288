"""Kafka Connect adapter agents + camel-source (gated).

Parity: reference ``kafkaconnect/KafkaConnectSinkAgent.java:1`` /
``KafkaConnectSourceAgent.java:1`` (types ``sink`` / ``source`` — run stock
Kafka Connect connectors as agents) and ``CamelSource.java:1``
(``camel-source``).

The reference EMBEDS the connector jar in its JVM runtime (instantiates the
SinkTask/SourceTask classes in-process). This image has no JVM, so that
path cannot exist; instead these agents drive an EXTERNAL Kafka Connect
cluster through its documented REST interface (the same API `curl` and the
Confluent tooling use), restoring the capability class natively:

- ``sink``: the agent creates/updates the connector
  (``PUT /connectors/{name}/config``) pointing it at a BRIDGE topic, then
  bridges every pipeline record into that topic. When the app runs on the
  kafka streaming cluster the external Connect workers consume the bridge
  topic directly — the standard Connect data path, zero copies beyond the
  broker. The agent watches ``GET /connectors/{name}/status`` and restarts
  FAILED tasks (``POST .../restart``).
- ``source``: the connector's config is pointed at the bridge topic
  (``topic``/``kafka.topic``) and the agent consumes it, emitting records
  into the pipeline with at-least-once commit semantics.

``camel-source`` interprets the COMMON Camel endpoint URI schemes
natively (timer:, file:, http(s): — CamelSourceAgent); the long tail of
JVM-only components gates with an explicit message.
"""

from __future__ import annotations

import http.client
import json
import logging
import time
from typing import Any, Optional

from langstream_tpu_torch.api.agent import AgentSink, AgentSource, ComponentType
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty
from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo
from langstream_tpu_torch.runtime import http_client

log = logging.getLogger(__name__)

_CAMEL_GATE = (
    "camel-source embeds JVM Camel components this image does not ship; "
    "use the http/webcrawler/storage sources, or a Kafka Connect source "
    "via an external Connect cluster (type: source)"
)


_CRON_MONTHS = {"JAN": 1, "FEB": 2, "MAR": 3, "APR": 4, "MAY": 5, "JUN": 6,
                "JUL": 7, "AUG": 8, "SEP": 9, "OCT": 10, "NOV": 11, "DEC": 12}
# Quartz numbering: 1 = Sunday (0 tolerated as Sunday too)
_CRON_DAYS = {"SUN": 1, "MON": 2, "TUE": 3, "WED": 4, "THU": 5, "FRI": 6, "SAT": 7}


def _cron_parse_field(
    spec: str, lo: int, hi: int, names: dict[str, int], classic_dow: bool = False
):
    """One Quartz field → set of matching ints, or None for */?.
    ``classic_dow``: numeric tokens use crontab numbering (0-7, 0 and
    7 = Sunday) and are translated to Quartz (1 = Sunday)."""
    spec = spec.strip().upper()
    if spec in ("*", "?"):
        return None

    def conv(token: str) -> int:
        if token in names:
            return names[token]
        v = int(token)
        if names is _CRON_DAYS:
            if classic_dow:
                return (v % 7) + 1  # crontab 0/7=SUN,1=MON → quartz 1=SUN
            return lo if v == 0 else v  # quartz tolerates 0 as Sunday
        return v

    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", "?", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = conv(a), conv(b)
        else:
            start = conv(part)
            end = hi if step > 1 else start
        if not (lo <= start <= hi and lo <= end <= hi):
            raise ValueError(f"cron field {spec!r} out of range [{lo},{hi}]")
        if start <= end:
            out.update(range(start, end + 1, step))
        else:
            # wrap-around range (FRI-SUN, 22-2): high side then low side
            span = list(range(start, hi + 1)) + list(range(lo, end + 1))
            out.update(span[::step])
    return out


def _cron_parse(expr: str) -> list:
    """Quartz cron: ``sec min hour dom month dow [year]`` (camel-cron's
    ``schedule=`` syntax, ``+`` already decoded to spaces). A classic
    5-field crontab is accepted by prepending second 0 — its numeric
    day-of-week keeps crontab numbering (0/7 = Sunday); a trailing year
    field is ignored."""
    fields = expr.split()
    classic = len(fields) == 5
    if classic:
        fields = ["0", *fields]
    if len(fields) == 7:
        fields = fields[:6]
    if len(fields) != 6:
        raise ValueError(f"cron schedule {expr!r}: expected 5-7 fields")
    sec, minute, hour, dom, month, dow = fields
    return [
        _cron_parse_field(sec, 0, 59, {}),
        _cron_parse_field(minute, 0, 59, {}),
        _cron_parse_field(hour, 0, 23, {}),
        _cron_parse_field(dom, 1, 31, {}),
        _cron_parse_field(month, 1, 12, _CRON_MONTHS),
        _cron_parse_field(dow, 1, 7, _CRON_DAYS, classic_dow=classic),
    ]


def _cron_due(fields: list, tm: time.struct_time) -> bool:
    quartz_dow = ((tm.tm_wday + 1) % 7) + 1  # tm: 0=Mon → quartz: 1=Sun
    values = (tm.tm_sec, tm.tm_min, tm.tm_hour, tm.tm_mday, tm.tm_mon, quartz_dow)
    return all(f is None or v in f for f, v in zip(fields, values))


def _parse_feed_entries(body: str) -> list[dict]:
    """RSS 2.0 ``channel/item`` or Atom ``entry`` elements → normalized
    dicts (id/title/link/published/summary). The id (guid / atom:id /
    link / title, first present) is the camel-rss dedupe key."""
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        log.warning("camel feed parse failed: %s", e)
        return []

    def text(el, *tags) -> str:
        for tag in tags:
            child = el.find(tag)
            if child is not None and (child.text or "").strip():
                return child.text.strip()
        return ""

    out: list[dict] = []
    # RSS 2.0 (no namespace)
    for item in root.iter("item"):
        entry = {
            "title": text(item, "title"),
            "link": text(item, "link"),
            "published": text(item, "pubDate"),
            "summary": text(item, "description"),
        }
        entry["id"] = text(item, "guid") or entry["link"] or entry["title"]
        out.append(entry)
    # Atom
    ns = "{http://www.w3.org/2005/Atom}"
    for item in root.iter(f"{ns}entry"):
        link_el = item.find(f"{ns}link")
        entry = {
            "title": text(item, f"{ns}title"),
            "link": link_el.get("href", "") if link_el is not None else "",
            "published": text(item, f"{ns}published", f"{ns}updated"),
            "summary": text(item, f"{ns}summary", f"{ns}content"),
        }
        entry["id"] = text(item, f"{ns}id") or entry["link"] or entry["title"]
        out.append(entry)
    return [e for e in out if e["id"]]


class ConnectRestError(RuntimeError):
    pass


class ConnectRestClient:
    """Minimal client for the Kafka Connect REST interface (every call is
    ``runtime/http_client`` in a worker thread)."""

    def __init__(self, rest_url: str) -> None:
        self.rest_url = rest_url.rstrip("/")

    async def close(self) -> None:
        pass

    async def request(
        self, method: str, path: str, body: Optional[Any] = None
    ) -> tuple[int, Any]:
        data, headers = http_client.json_body(body) if body is not None else (None, None)
        resp = await http_client.request(method, f"{self.rest_url}{path}", data, headers)
        try:
            doc = resp.json()
        except Exception:  # noqa: BLE001 — a body that is not JSON
            doc = None
        return resp.status, doc

    async def info(self) -> dict:
        status, doc = await self.request("GET", "/")
        if status != 200:
            raise ConnectRestError(f"connect cluster unreachable: HTTP {status}")
        return doc or {}

    async def put_config(self, name: str, config: dict) -> dict:
        status, doc = await self.request(
            "PUT", f"/connectors/{name}/config", config
        )
        if status not in (200, 201):
            raise ConnectRestError(
                f"connector {name} config rejected: HTTP {status} {doc}"
            )
        return doc or {}

    async def status(self, name: str) -> dict:
        status, doc = await self.request("GET", f"/connectors/{name}/status")
        if status == 404:
            return {}
        return doc or {}

    async def restart(self, name: str, task: Optional[int] = None) -> None:
        path = f"/connectors/{name}/restart"
        if task is not None:
            path = f"/connectors/{name}/tasks/{task}/restart"
        await self.request("POST", path)

    async def delete(self, name: str) -> None:
        await self.request("DELETE", f"/connectors/{name}")


class _ConnectAgentBase:
    """Shared lifecycle: config parsing, connector upsert, health watch."""

    def _parse(self, configuration: dict[str, Any]) -> None:
        connect = configuration.get("connect", {}) or {}
        self.rest = ConnectRestClient(
            connect.get("rest-url", "http://localhost:8083")
        )
        self.connector_name = connect.get("name") or f"ls-{self.agent_id or 'connector'}"
        self.delete_on_close = bool(connect.get("delete-on-close", False))
        self.status_interval = float(connect.get("status-interval", 10.0))
        # everything else (connector.class, transforms, …) IS the connector
        # config — the reference passes the agent configuration through the
        # same way (KafkaConnectSinkAgent.java adapter config pass-through)
        self.connector_config = {
            k: v
            for k, v in configuration.items()
            if k not in ("connect", "composable", "agent.type")
        }
        self._last_status: dict[str, Any] = {}
        self._last_check = 0.0

    async def _watch_once(self) -> None:
        """Poll status; restart FAILED connector/tasks (the reference's
        embedded runtime restarts crashed tasks the same way). Best-effort:
        it runs on the record hot path, and a blip in the Connect cluster's
        REST endpoint must not fail records whose bridge write succeeded."""
        now = time.monotonic()
        if now - self._last_check < self.status_interval:
            return
        self._last_check = now
        try:
            await self._watch_unguarded()
        except Exception:  # noqa: BLE001 — health polling never fails records
            log.warning(
                "connector %s status poll failed", self.connector_name, exc_info=True
            )

    async def _watch_unguarded(self) -> None:
        doc = await self.rest.status(self.connector_name)
        self._last_status = doc
        if not doc:
            return
        if doc.get("connector", {}).get("state") == "FAILED":
            log.warning("connector %s FAILED; restarting", self.connector_name)
            await self.rest.restart(self.connector_name)
        for task in doc.get("tasks", []):
            if task.get("state") == "FAILED":
                log.warning(
                    "connector %s task %s FAILED; restarting",
                    self.connector_name,
                    task.get("id"),
                )
                await self.rest.restart(self.connector_name, int(task.get("id", 0)))

    def _info(self) -> dict[str, Any]:
        return {
            "connector": self.connector_name,
            "rest-url": self.rest.rest_url,
            "status": self._last_status,
        }

    async def _teardown(self) -> None:
        if self.delete_on_close:
            try:
                await self.rest.delete(self.connector_name)
            except ConnectRestError:
                log.warning("connector %s delete failed", self.connector_name)
        await self.rest.close()


class KafkaConnectSinkAgent(AgentSink, _ConnectAgentBase):
    """type: sink — bridge pipeline records into the connector's topic on
    the app's streaming cluster and manage the connector remotely."""

    def component_type(self) -> ComponentType:
        return ComponentType.SINK

    async def init(self, configuration: dict[str, Any]) -> None:
        self._parse(configuration)
        self.bridge_topic = (
            configuration.get("topics") or f"ls-connect-{self.agent_id or 'sink'}"
        )
        self.connector_config.setdefault("topics", self.bridge_topic)
        self._producer = None

    async def start(self) -> None:
        await self.rest.info()  # fail fast when the cluster is unreachable
        await self.rest.put_config(self.connector_name, self.connector_config)
        assert self.context is not None
        admin = self.context.get_topic_admin()
        if not await admin.topic_exists(self.bridge_topic):
            await admin.create_topic(self.bridge_topic)
        self._producer = self.context.get_topic_producer(self.bridge_topic)
        await self._producer.start()
        await self._watch_once()

    async def write(self, record: Record) -> None:
        assert self._producer is not None, "agent not started"
        await self._producer.write(record)
        await self._watch_once()

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.close()
            self._producer = None
        await self._teardown()

    def agent_info(self) -> dict[str, Any]:
        return {**super().agent_info(), **self._info(), "bridge-topic": self.bridge_topic}


class KafkaConnectSourceAgent(AgentSource, _ConnectAgentBase):
    """type: source — the connector produces into the bridge topic; the
    agent consumes it into the pipeline (at-least-once via commit)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SOURCE

    async def init(self, configuration: dict[str, Any]) -> None:
        self._parse(configuration)
        self.bridge_topic = (
            configuration.get("topic")
            or configuration.get("kafka.topic")
            or f"ls-connect-{self.agent_id or 'source'}"
        )
        # the common config keys source connectors use for their target
        self.connector_config.setdefault("topic", self.bridge_topic)
        self.connector_config.setdefault("kafka.topic", self.bridge_topic)
        self._consumer = None

    async def start(self) -> None:
        await self.rest.info()
        assert self.context is not None
        admin = self.context.get_topic_admin()
        if not await admin.topic_exists(self.bridge_topic):
            await admin.create_topic(self.bridge_topic)
        await self.rest.put_config(self.connector_name, self.connector_config)
        self._consumer = self.context.get_topic_consumer(self.bridge_topic)
        await self._consumer.start()
        await self._watch_once()

    async def read(self) -> list[Record]:
        assert self._consumer is not None, "agent not started"
        records = await self._consumer.read()
        await self._watch_once()
        return records

    async def commit(self, records: list[Record]) -> None:
        assert self._consumer is not None
        await self._consumer.commit(records)

    async def close(self) -> None:
        if self._consumer is not None:
            await self._consumer.close()
            self._consumer = None
        await self._teardown()

    def agent_info(self) -> dict[str, Any]:
        return {**super().agent_info(), **self._info(), "bridge-topic": self.bridge_topic}


class CamelSourceAgent(AgentSource):
    """type: camel-source — NATIVE interpreters for the common Camel
    endpoint URI schemes (reference CamelSource.java:172-174 config
    surface: component-uri, max-buffered-records, key-header):

    - ``timer:name?period=N[&repeatCount=K]`` — periodic tick records
    - ``cron:name?schedule=<quartz expr>`` — Quartz-scheduled ticks
      (camel-cron; ``+`` separators decoded, 5/6/7-field accepted)
    - ``file:/dir[?delete=true]`` — poll a directory, one record per file
    - ``http(s)://url?delay=N`` — poll an HTTP endpoint, one record per
      response body
    - ``exec:command?args=...&delay=N`` — run a local command per poll,
      one record per stdout (camel-exec consumer)
    - ``rss:URL`` / ``atom:URL?delay=N`` — poll a feed, one record per
      NEW entry (split + dedupe — camel-rss/atom defaults)

    Anything else (kafka:, jms:, aws-sqs:, the ~300 JVM components) gates
    with an explicit message — interpreting Camel's component registry
    without a JVM is not honest to fake."""

    def component_type(self) -> ComponentType:
        return ComponentType.SOURCE

    async def init(self, configuration: dict[str, Any]) -> None:
        import urllib.parse

        uri = str(configuration.get("component-uri", ""))
        self.key_header = configuration.get("key-header") or ""
        self.max_buffered = int(configuration.get("max-buffered-records", 100))
        scheme, _, rest = uri.partition(":")
        self.scheme = scheme
        path, _, query = rest.partition("?")
        self.path = path.lstrip("/") if scheme == "timer" else path
        self.params = dict(urllib.parse.parse_qsl(query))
        if scheme == "timer":
            self.period = float(self.params.get("period", 1000)) / 1000.0
            self.repeat = int(self.params.get("repeatCount", 0))  # 0 = forever
            self._ticks = 0
        elif scheme == "file":
            self.delete = str(self.params.get("delete", "")).lower() == "true"
            self._seen: set = set()
        elif scheme in ("http", "https"):
            import urllib.parse as _up

            self.delay = float(self.params.get("delay", 1000)) / 1000.0
            # strip ONLY the camel-level delay param; everything else
            # (tokens, filters) belongs to the polled endpoint
            base, _, query = uri.partition("?")
            keep = [(k, v) for k, v in _up.parse_qsl(query) if k != "delay"]
            self.url = base + ("?" + _up.urlencode(keep) if keep else "")
            self._http = None
        elif scheme == "cron":
            self.path = path.lstrip("/")
            # camel encodes spaces in schedule= as '+'; parse_qsl already
            # decoded them
            schedule = self.params.get("schedule", "* * * * * ?")
            self.cron_fields = _cron_parse(schedule)
            self._ticks = 0
            self._checked_sec = int(time.time())  # fire on FUTURE matches
        elif scheme == "exec":
            import shlex as _shlex

            self.delay = float(self.params.get("delay", 1000)) / 1000.0
            self.exec_cmd = [path, *_shlex.split(self.params.get("args", ""))]
        elif scheme in ("rss", "atom"):
            import urllib.parse as _up

            self.delay = float(self.params.get("delay", 1000)) / 1000.0
            # the URI after the scheme IS the feed URL; strip camel-level
            # params, keep the feed's own query
            _camel = {"delay", "initialDelay", "splitEntries", "filter",
                      "sortEntries", "throttleEntries", "feedHeader",
                      "lastUpdate"}
            feed = rest
            base, _, query = feed.partition("?")
            keep = [(k, v) for k, v in _up.parse_qsl(query) if k not in _camel]
            self.url = base + ("?" + _up.urlencode(keep) if keep else "")
            self._http = None
            # insertion-ordered so the dedupe memory can rotate (see read)
            from collections import OrderedDict

            self._seen_entries: "OrderedDict[str, None]" = OrderedDict()
        else:
            raise NotImplementedError(
                f"camel component {scheme!r} needs the JVM Camel runtime; "
                "native schemes: timer:, cron:, file:, http(s):, exec:, "
                "rss:, atom:  — " + _CAMEL_GATE
            )
        self._last = 0.0
        # file scheme: records delivered but not yet committed → their
        # source paths; deletion happens in commit() (at-least-once)
        self._pending_delete: dict[str, str] = {}

    async def _throttled(self, now: float) -> bool:
        """Shared poll throttle (http/exec/rss): True = not yet time."""
        import asyncio as _asyncio

        wait = self.delay - (now - self._last)
        if wait > 0:
            await _asyncio.sleep(min(wait, 0.5))
            if self.delay - (time.monotonic() - self._last) > 0:
                return True
        self._last = time.monotonic()
        return False

    async def _fetch_url(self) -> Optional[str]:
        """Shared GET for the http/rss/atom pollers: response body, or
        None on transport/HTTP errors (logged; retried next poll)."""
        if self._http is None:  # one session a poller: its cookies persist
            self._http = http_client.build_opener(cookies=True)
        try:
            resp = await http_client.request("GET", self.url, opener=self._http)
            if resp.status >= 300:
                log.warning(
                    "camel %s poll %s -> HTTP %d; retrying next poll",
                    self.scheme, self.url, resp.status,
                )
                return None
            return resp.text()
        except (OSError, http.client.HTTPException) as e:  # aiohttp's ClientError
            log.warning(
                "camel %s poll %s failed (%s); retrying", self.scheme, self.url, e
            )
            return None

    def _rec(self, value, natural_key):
        """Build a record honoring key-header: the reference takes the
        record key from the named exchange header — natively, the natural
        key rides both as the key and under that header name."""
        from langstream_tpu_torch.api.record import SimpleRecord

        headers = (
            ((self.key_header, natural_key),)
            if self.key_header and natural_key is not None
            else None
        )
        return SimpleRecord.of(value, key=natural_key, headers=headers)

    async def read(self) -> list[Record]:
        import asyncio as _asyncio

        now = time.monotonic()
        if self.scheme == "timer":
            if self.repeat and self._ticks >= self.repeat:
                await _asyncio.sleep(0.05)
                return []
            wait = self.period - (now - self._last)
            if wait > 0:
                await _asyncio.sleep(min(wait, 0.5))
                if self.period - (time.monotonic() - self._last) > 0:
                    return []
            self._last = time.monotonic()
            self._ticks += 1
            return [self._rec(
                json.dumps({"timer": self.path, "count": self._ticks}),
                self.path,
            )]
        if self.scheme == "cron":
            await _asyncio.sleep(0.1)
            sec = int(time.time())
            if sec == self._checked_sec:
                return []
            # catch-up scan: a stall (>1s between reads — slow downstream,
            # busy loop) must not silently skip a scheduled second (a lost
            # daily tick). Bounded to the last 5 minutes.
            start = max(self._checked_sec + 1, sec - 300)
            self._checked_sec = sec
            out = []
            for s in range(start, sec + 1):
                if not _cron_due(self.cron_fields, time.localtime(s)):
                    continue
                self._ticks += 1
                out.append(self._rec(
                    json.dumps({"cron": self.path, "count": self._ticks,
                                "timestamp": s}),
                    self.path,
                ))
                if len(out) >= self.max_buffered:
                    # rewind the cursor to the last second actually SCANNED:
                    # marking all of (s, sec] checked would silently drop any
                    # due seconds between the buffer-full break and now
                    self._checked_sec = s
                    break
            return out
        if self.scheme == "exec":
            if await self._throttled(now):
                return []
            proc = await _asyncio.create_subprocess_exec(
                *self.exec_cmd,
                stdout=_asyncio.subprocess.PIPE,
                stderr=_asyncio.subprocess.PIPE,
            )
            stdout, stderr = await proc.communicate()
            if proc.returncode != 0:
                log.warning(
                    "camel exec %s exited %d: %s; retrying next poll",
                    self.exec_cmd[0], proc.returncode,
                    stderr.decode(errors="replace")[:200],
                )
                return []
            return [self._rec(stdout, None)]
        if self.scheme in ("rss", "atom"):
            if await self._throttled(now):
                return []
            body = await self._fetch_url()
            if body is None:
                return []
            out = []
            for entry in _parse_feed_entries(body):
                if entry["id"] in self._seen_entries:
                    # refresh recency so rotation evicts truly-gone ids
                    self._seen_entries.move_to_end(entry["id"])
                    continue
                self._seen_entries[entry["id"]] = None
                out.append(self._rec(json.dumps(entry), entry["id"]))
                if len(out) >= self.max_buffered:
                    break
            # bound the dedupe memory for immortal high-churn feeds: ids
            # not seen in the last 10k entries may re-emit (at-least-once)
            while len(self._seen_entries) > 10_000:
                self._seen_entries.popitem(last=False)
            return out
        if self.scheme == "file":
            import pathlib

            out = []
            directory = pathlib.Path(self.path)
            if directory.is_dir():
                live = {str(f) for f in directory.iterdir()}
                self._seen &= live  # rotated-away files never accumulate
                for f in sorted(directory.iterdir()):
                    if f.is_file() and str(f) not in self._seen:
                        out.append(self._rec(f.read_bytes(), f.name))
                        self._seen.add(str(f))
                        if self.delete:
                            self._pending_delete[f.name] = str(f)
                        if len(out) >= self.max_buffered:
                            break
            if not out:
                await _asyncio.sleep(0.05)
            return out
        # http(s) poller
        if await self._throttled(now):
            return []
        body = await self._fetch_url()
        return [] if body is None else [self._rec(body, None)]

    async def commit(self, records: list[Record]) -> None:
        """file scheme's delete=true happens HERE — after every downstream
        write landed — so a crash mid-pipeline never loses the file."""
        import pathlib

        for r in records:
            path = self._pending_delete.pop(str(r.key), None)
            if path is not None:
                pathlib.Path(path).unlink(missing_ok=True)

    async def close(self) -> None:
        self._http = None

    def agent_info(self) -> dict[str, Any]:
        return {**super().agent_info(), "component-uri": f"{self.scheme}:..."}


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="sink",
            component_type=ComponentType.SINK,
            factory=KafkaConnectSinkAgent,
            description=(
                "Stock Kafka Connect sink connector, managed on an external "
                "Connect cluster over its REST API."
            ),
            config_model=ConfigModel(
                type="sink",
                allow_unknown=True,
                properties={
                    "connector.class": ConfigProperty(
                        "connector.class", "Connect connector class", required=True
                    ),
                    "connect": ConfigProperty(
                        "connect",
                        "External cluster: rest-url, name, delete-on-close",
                        type="object",
                    ),
                },
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="source",
            component_type=ComponentType.SOURCE,
            factory=KafkaConnectSourceAgent,
            description=(
                "Stock Kafka Connect source connector, managed on an external "
                "Connect cluster over its REST API."
            ),
            config_model=ConfigModel(
                type="source",
                allow_unknown=True,
                properties={
                    "connector.class": ConfigProperty(
                        "connector.class", "Connect connector class", required=True
                    ),
                    "connect": ConfigProperty(
                        "connect",
                        "External cluster: rest-url, name, delete-on-close",
                        type="object",
                    ),
                },
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="camel-source",
            component_type=ComponentType.SOURCE,
            factory=CamelSourceAgent,
            description=(
                "Camel endpoint URI as a source: timer:/file:/http(s): "
                "interpreted natively; JVM-only components gate."
            ),
            config_model=ConfigModel(
                type="camel-source",
                allow_unknown=True,
                properties={
                    "component-uri": ConfigProperty(
                        "component-uri", "Camel endpoint URI", required=True
                    )
                },
            ),
        )
    )


_register()
