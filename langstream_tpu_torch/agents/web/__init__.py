"""Web crawler source on the stdlib — the port of
``langstream_tpu/agents/web/__init__.py`` (reference
``langstream-agent-webcrawler``: ``WebCrawlerSource.java`` +
``crawler/WebCrawler.java``): a seeded breadth-first crawl held to the
allowed domains, the forbidden paths and ``robots.txt``, with a politeness
delay and a checkpointed frontier (``webcrawler.status.json`` in the
agent's state directory, in the JAX package's format: a state either
package saved resumes in the other).

Each fetch runs ``urllib`` in a worker thread (the event loop is shared
with the gateway, the broker and the serving provider), held to the JAX
crawler's aiohttp semantics: redirects followed (at most 10), gzip /
deflate bodies decoded, ``http-timeout`` bounding the whole request, no
proxy taken from the environment, the content type the MIME type without
its parameters (``application/octet-stream`` when the header is missing or
malformed), a 4xx / 5xx answer a status (the page is visited and emits
nothing), and only a failed connection, a timeout or a broken answer an
error (the URL goes back to the end of the queue until ``max-error-count``
failures). A ``robots.txt`` that cannot be fetched or answers other than
200 allows everything. Links come from ``agents/text/html.py``.
"""

from __future__ import annotations

import asyncio
import codecs
import http.client
import json
import os
import time
import urllib.error
import urllib.request
import urllib.robotparser
import zlib
from typing import Any, Optional
from urllib.parse import urldefrag, urlparse

from langstream_tpu_torch.agents.text.html import html_links
from langstream_tpu_torch.api.agent import AgentSource, ComponentType
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo


class CrawlState:
    """Visited / pending frontier with JSON checkpointing. Commit-safe: a
    URL moves from ``emitted`` to ``visited`` only when the runtime commits
    its record, so a crash re-crawls it (at least once)."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self.pending: list[tuple[str, int]] = []  # (url, depth)
        self.visited: set[str] = set()
        self.emitted: set[str] = set()
        self.started_at = time.time()

    def load(self) -> bool:
        if not self.path:
            return False
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return False
        self.visited = set(data.get("visited", []))
        # emitted-but-uncommitted URLs are crawled again after a restart
        self.pending = [tuple(p) for p in data.get("pending", [])] + [
            (u, 0) for u in data.get("emitted", []) if u not in self.visited
        ]
        self.started_at = data.get("started_at", time.time())
        return True

    def save(self) -> None:
        if not self.path:
            return
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "pending": list(self.pending),
                    "visited": sorted(self.visited),
                    "emitted": sorted(self.emitted),
                    "started_at": self.started_at,
                },
                f,
            )
        os.replace(tmp, self.path)


class _RedirectLoop(Exception):
    """More redirects than the client follows: an error, as aiohttp's."""


# what makes a fetch fail (a retry), not answer with a status
_FETCH_ERRORS = (OSError, http.client.HTTPException, zlib.error, EOFError, asyncio.TimeoutError,
                 _RedirectLoop)
# no proxy from the environment (aiohttp's session default)
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _content_type(raw: Optional[str]) -> str:
    """aiohttp's ``content_type``: the MIME type, lower case, without its
    parameters; ``application/octet-stream`` when missing or malformed."""
    if raw is None:
        return "application/octet-stream"
    ctype = raw.lower().partition(";")[0].strip()
    return ctype if ctype.count("/") == 1 else "application/octet-stream"


def _decoded(body: bytes, encoding: Optional[str]) -> bytes:
    encoding = (encoding or "").strip().lower()
    if encoding in ("gzip", "x-gzip"):
        return zlib.decompress(body, 16 + zlib.MAX_WBITS)
    if encoding == "deflate":
        try:
            return zlib.decompress(body)
        except zlib.error:  # raw deflate, without the zlib header
            return zlib.decompress(body, -zlib.MAX_WBITS)
    return body


def http_get(url: str, user_agent: str, timeout: float) -> tuple[int, str, bytes, str]:
    """GET ``url`` → (status, content type, body, charset): a blocking call
    for a worker thread. A 4xx / 5xx answer returns its status; a redirect
    loop or a failed connection raises (a connection that drops before the
    answer is tried once more first)."""
    request = urllib.request.Request(url, headers={
        "User-Agent": user_agent, "Accept": "*/*", "Accept-Encoding": "gzip, deflate"})
    for retry in (True, False):
        try:
            resp = _OPENER.open(request, timeout=timeout)
            break
        except urllib.error.HTTPError as e:
            if e.code < 400:
                raise _RedirectLoop(f"{url}: {e.code} {e.reason}") from e
            resp = e
            break
        except ConnectionError:
            # the request went out and the connection dropped before an
            # answer: sent once more, as aiohttp sends an idempotent request
            # (a refused connection comes wrapped in URLError: no retry)
            if not retry:
                raise
    with resp:
        status, headers = resp.status, resp.headers
        ctype = _content_type(headers.get("Content-Type"))
        charset = headers.get_content_charset() or "utf-8"
        try:
            charset = codecs.lookup(charset).name
        except LookupError:
            charset = "utf-8"
        if status >= 400:  # a status: nothing reads its body
            return status, ctype, b"", charset
        return status, ctype, _decoded(resp.read(), headers.get("Content-Encoding")), charset


class WebCrawlerSource(AgentSource):
    """``webcrawler-source``: breadth-first crawl; one record per page
    (value: the raw body, key: the url, headers: url, content_type,
    depth)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.seed_urls = list(configuration.get("seed-urls", []))
        self.allowed_domains = list(configuration.get("allowed-domains", []))
        self.forbidden_paths = list(configuration.get("forbidden-paths", []))
        self.max_urls = int(configuration.get("max-urls", 1000))
        self.max_depth = int(configuration.get("max-depth", 50))
        self.min_time_between_requests = (
            float(configuration.get("min-time-between-requests", 500)) / 1000.0
        )
        self.user_agent = configuration.get("user-agent", "langstream-tpu-crawler")
        self.handle_robots = bool(configuration.get("handle-robots-file", True))
        self.http_timeout = float(configuration.get("http-timeout", 10000)) / 1000.0
        self.max_error_count = int(configuration.get("max-error-count", 5))
        self.reindex_interval = float(configuration.get("reindex-interval-seconds", 0))
        self._robots: dict[str, urllib.robotparser.RobotFileParser] = {}
        self._errors: dict[str, int] = {}
        self._last_request = 0.0
        self._state: Optional[CrawlState] = None

    async def start(self) -> None:
        state_path = None
        if self.context is not None:
            state_dir = self.context.get_persistent_state_directory()
            if state_dir is not None:
                state_path = str(state_dir / "webcrawler.status.json")
        self._state = CrawlState(state_path)
        if not self._state.load():
            self._state.pending = [(u, 0) for u in self.seed_urls]

    async def close(self) -> None:
        if self._state is not None:
            self._state.save()

    async def _get(self, url: str) -> tuple[int, str, bytes, str]:
        """One GET off the event loop, bounded as a whole by http-timeout."""
        return await asyncio.wait_for(
            asyncio.to_thread(http_get, url, self.user_agent, self.http_timeout),
            self.http_timeout,
        )

    # -- crawl policy -------------------------------------------------------

    def _domain_allowed(self, url: str) -> bool:
        host = urlparse(url).netloc.split(":")[0]
        if not self.allowed_domains:
            return True
        return any(host == d or host.endswith(f".{d}") for d in self.allowed_domains)

    def _path_allowed(self, url: str) -> bool:
        path = urlparse(url).path or "/"
        return not any(path.startswith(p) for p in self.forbidden_paths)

    async def _robots_allowed(self, url: str) -> bool:
        if not self.handle_robots:
            return True
        parsed = urlparse(url)
        origin = f"{parsed.scheme}://{parsed.netloc}"
        rp = self._robots.get(origin)
        if rp is None:
            rp = urllib.robotparser.RobotFileParser()
            try:
                status, _, body, charset = await self._get(f"{origin}/robots.txt")
                if status == 200:
                    rp.parse(body.decode(charset).splitlines())
                else:
                    rp.allow_all = True
            except _FETCH_ERRORS:
                rp.allow_all = True
            self._robots[origin] = rp
        return rp.can_fetch(self.user_agent, url)

    # -- source contract ----------------------------------------------------

    async def read(self) -> list[Record]:
        assert self._state is not None
        state = self._state
        while state.pending:
            if len(state.visited) + len(state.emitted) >= self.max_urls:
                break
            url, depth = state.pending.pop(0)
            url = urldefrag(url)[0]
            if url in state.visited or url in state.emitted:
                continue
            if not (self._domain_allowed(url) and self._path_allowed(url)):
                continue
            if not await self._robots_allowed(url):
                continue
            # politeness delay
            wait = self.min_time_between_requests - (time.monotonic() - self._last_request)
            if wait > 0:
                await asyncio.sleep(wait)
            self._last_request = time.monotonic()
            try:
                status, content_type, body, _ = await self._get(url)
            except _FETCH_ERRORS:
                self._errors[url] = self._errors.get(url, 0) + 1
                if self._errors[url] < self.max_error_count:
                    state.pending.append((url, depth))
                continue
            if status >= 400:
                state.visited.add(url)
                continue
            if "html" in content_type and depth < self.max_depth:
                for link in html_links(url, body):
                    if link not in state.visited and link not in state.emitted:
                        state.pending.append((link, depth + 1))
            state.emitted.add(url)
            state.save()
            self.processed(1)
            return [
                SimpleRecord.of(
                    body,
                    key=url,
                    headers=[
                        ("url", url),
                        ("content_type", content_type),
                        ("depth", str(depth)),
                    ],
                    origin="webcrawler-source",
                )
            ]

        # frontier exhausted: optionally reindex after the interval
        if (
            self.reindex_interval > 0
            and not state.pending
            and time.time() - state.started_at > self.reindex_interval
        ):
            state.started_at = time.time()
            state.visited.clear()
            state.pending = [(u, 0) for u in self.seed_urls]
            state.save()
        await asyncio.sleep(0.05)
        return []

    async def commit(self, records: list[Record]) -> None:
        assert self._state is not None
        for r in records:
            url = str(r.key)
            self._state.emitted.discard(url)
            self._state.visited.add(url)
        self._state.save()

    def agent_info(self) -> dict[str, Any]:
        info = super().agent_info()
        if self._state is not None:
            info["crawl"] = {
                "pending": len(self._state.pending),
                "visited": len(self._state.visited),
                "in-flight": len(self._state.emitted),
            }
        return info


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="webcrawler-source",
            component_type=ComponentType.SOURCE,
            factory=WebCrawlerSource,
            description="Crawl websites; one record per page; checkpointed frontier.",
            config_model=ConfigModel(
                type="webcrawler-source",
                properties=props(
                    ConfigProperty("seed-urls", "starting urls", type="array", required=True),
                    ConfigProperty("allowed-domains", "domain allowlist", type="array"),
                    ConfigProperty("forbidden-paths", "path prefixes to skip", type="array"),
                    ConfigProperty("max-urls", "crawl budget", type="integer", default=1000),
                    ConfigProperty("max-depth", "link depth limit", type="integer", default=50),
                    ConfigProperty("min-time-between-requests", "politeness delay (ms)",
                                   type="number", default=500),
                    ConfigProperty("user-agent", "User-Agent header",
                                   default="langstream-tpu-crawler"),
                    ConfigProperty("handle-robots-file", "respect robots.txt", type="boolean",
                                   default=True),
                    ConfigProperty("http-timeout", "request timeout (ms)", type="number",
                                   default=10000),
                    ConfigProperty("max-error-count", "retries per url", type="integer",
                                   default=5),
                    ConfigProperty("reindex-interval-seconds", "re-crawl period", type="number",
                                   default=0),
                ),
            ),
        )
    )


_register()
